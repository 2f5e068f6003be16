// Native media ingest: libavformat/libavcodec demux+decode, libswresample
// to interleaved s16, libswscale to NV21 on a CFR grid.
//
// This is the host ingest layer of the TPU encoder. It drives the same L0
// libraries the reference encoder drives (psxavenc/decoding.c) with the
// same observable semantics — stream validation and messages
// (decoding.c:168-200), swr/sws configuration incl. the forced ITU-601
// full-range scaler colorspace (decoding.c:237-311), the -R/-S option
// strings via av_opt_set_from_string (decoding.c:250-252,312-314), the
// one-receive-per-packet decode quirk (decoding.c:113-129), the CFR
// drop/duplicate retiming (decoding.c:408-478), and the absence of any
// decoder/resampler flush at EOF — but restructured around a streaming
// handle (packet-at-a-time poll + FIFO takes, the moral equivalent of the
// reference's poll_av_data sliding window, decoding.c:370-508) with three
// consumption modes:
//
//   psxn_ingest_open   — whole-file decode into malloc'd buffers (batch
//                        device encoding of small/medium inputs);
//                        with kCountOnly it runs the identical decode loop
//                        but only counts output samples/frames (the cheap
//                        schedule pass of the O(1)-memory streaming mode).
//   psxn_stream_*      — bounded-memory streaming: open, fill-to-need,
//                        take audio values / video frames, close.
//   psxn_probe         — open + find_stream_info only (duration estimate
//                        for the automatic streaming decision).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/dict.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

namespace {

constexpr int kUseAudio = 1 << 0;
constexpr int kUseVideo = 1 << 1;
constexpr int kAudioRequired = 1 << 2;
constexpr int kVideoRequired = 1 << 3;
constexpr int kCountOnly = 1 << 4;

struct Req {
    const char *path;
    int flags;
    int audio_frequency;
    int audio_channels;
    int video_width;   // requested (pre-aspect-adjust)
    int video_height;
    int ignore_aspect;
    int fps_num;
    int fps_den;
    int quiet;
    const char *swr_options;  // may be null
    const char *sws_options;  // may be null
};

struct Res {
    int16_t *audio;           // interleaved, malloc'd
    long long audio_count;    // total int16 values
    uint8_t *video;           // NV21 frames, malloc'd
    long long video_frames;
    int video_width;          // post-aspect-adjust
    int video_height;
    int has_audio;
    int has_video;
    int is_wav;
    int has_loop_meta;        // "loop_start" metadata tag present
    long long loop_meta_ms;
    int n_chapters;
    long long chapter0_ms;
    long long duration_us;    // container duration estimate (-1 unknown)
};

// decoding.c:113-129 — at most one receive per packet; EAGAIN leaves an
// empty (unref'd) frame but still reports success.
bool decode_frame(AVCodecContext *codec, AVFrame *frame, AVPacket *packet) {
    if (packet != nullptr) {
        if (avcodec_send_packet(codec, packet) != 0)
            return false;
    }
    int ret = avcodec_receive_frame(codec, frame);
    if (ret >= 0)
        return true;
    if (ret == AVERROR(EAGAIN))
        return true;
    return false;
}

struct Stream {
    // libav state (owned)
    AVFormatContext *format = nullptr;
    AVCodecContext *audio_ctx = nullptr;
    AVCodecContext *video_ctx = nullptr;
    SwrContext *resampler = nullptr;
    SwsContext *scaler = nullptr;
    AVFrame *frame = nullptr;

    int audio_index = -1, video_index = -1;
    AVStream *audio_stream = nullptr;
    AVStream *video_stream = nullptr;

    // configuration
    bool count_only = false;
    int sample_count_mul = 1;
    double pts_step = 0.0;
    long long frame_dst_size = 0;
    int plane_size = 0;
    int dst_w = 0, dst_h = 0;

    // CFR retiming state (decoding.c:408-478)
    long long video_frame_count = 0;  // frames emitted so far (global)
    double video_next_pts = 0.0;

    // FIFOs (head-indexed vectors, compacted as they drain)
    std::vector<int16_t> audio;
    size_t audio_head = 0;
    std::vector<uint8_t> video;       // video FIFO, frame granularity
    size_t video_head = 0;            // byte offset of first queued frame
    std::vector<uint8_t> last_frame;  // last emitted frame (dup source)
    std::vector<int16_t> scratch;     // count_only swr sink

    // count_only totals
    long long audio_total = 0;
    long long video_total = 0;

    bool eof = false;

    ~Stream() {
        if (frame) av_frame_free(&frame);
        if (scaler) sws_freeContext(scaler);
        if (resampler) swr_free(&resampler);
        if (audio_ctx) avcodec_free_context(&audio_ctx);
        if (video_ctx) avcodec_free_context(&video_ctx);
        if (format) avformat_close_input(&format);
    }
};

// Open + validate + configure decode/resample/rescale; fills Res metadata
// (geometry, loop-point candidates, duration). Returns 0 on success;
// nonzero on failure (any detail message already printed, like the
// reference's open_av_data).
int stream_setup(const Req *req, Res *res, Stream *st) {
    // -q silences libav* warnings, like the reference (decoding.c:158-159).
    // Set explicitly on every open: the auto-streaming probe runs quiet
    // before the real open, and the level is process-global, so a bare
    // "if quiet" would leave diagnostics suppressed for the real pass.
    av_log_set_level(req->quiet ? AV_LOG_QUIET : AV_LOG_INFO);
    memset(res, 0, sizeof(*res));
    res->loop_meta_ms = -1;
    res->chapter0_ms = -1;
    res->duration_us = -1;
    res->video_width = req->video_width;
    res->video_height = req->video_height;

    st->count_only = (req->flags & kCountOnly) != 0;

    st->format = avformat_alloc_context();
    if (avformat_open_input(&st->format, req->path, nullptr, nullptr))
        return 2;
    if (avformat_find_stream_info(st->format, nullptr) < 0)
        return 2;
    if (st->format->duration != AV_NOPTS_VALUE)
        res->duration_us = (long long)st->format->duration;

    if (req->flags & kUseAudio) {
        for (unsigned i = 0; i < st->format->nb_streams; i++) {
            if (st->format->streams[i]->codecpar->codec_type ==
                    AVMEDIA_TYPE_AUDIO) {
                if (st->audio_index >= 0) {
                    fprintf(stderr,
                            "Input file must have a single audio track\n");
                    return 1;
                }
                st->audio_index = (int)i;
            }
        }
        if ((req->flags & kAudioRequired) && st->audio_index == -1) {
            fprintf(stderr, "Input file has no audio data\n");
            return 1;
        }
    }
    if (req->flags & kUseVideo) {
        for (unsigned i = 0; i < st->format->nb_streams; i++) {
            if (st->format->streams[i]->codecpar->codec_type ==
                    AVMEDIA_TYPE_VIDEO) {
                if (st->video_index >= 0) {
                    fprintf(stderr,
                            "Input file must have a single video track\n");
                    return 1;
                }
                st->video_index = (int)i;
            }
        }
        if ((req->flags & kVideoRequired) && st->video_index == -1) {
            fprintf(stderr, "Input file has no video data\n");
            return 1;
        }
    }

    st->audio_stream = st->audio_index >= 0
        ? st->format->streams[st->audio_index] : nullptr;
    st->video_stream = st->video_index >= 0
        ? st->format->streams[st->video_index] : nullptr;

    if (st->audio_stream) {
        const AVCodec *codec =
            avcodec_find_decoder(st->audio_stream->codecpar->codec_id);
        st->audio_ctx = avcodec_alloc_context3(codec);
        if (!st->audio_ctx)
            return 2;
        if (avcodec_parameters_to_context(st->audio_ctx,
                                          st->audio_stream->codecpar) < 0)
            return 2;
        if (avcodec_open2(st->audio_ctx, codec, nullptr) < 0)
            return 2;

        AVChannelLayout layout;
        layout.nb_channels = req->audio_channels;
        if (req->audio_channels == 1) {
            layout.order = AV_CHANNEL_ORDER_NATIVE;
            layout.u.mask = AV_CH_LAYOUT_MONO;
        } else if (req->audio_channels == 2) {
            layout.order = AV_CHANNEL_ORDER_NATIVE;
            layout.u.mask = AV_CH_LAYOUT_STEREO;
        } else {
            layout.order = AV_CHANNEL_ORDER_UNSPEC;
        }
        if (req->audio_channels > st->audio_ctx->ch_layout.nb_channels &&
            !req->quiet)
            fprintf(stderr, "Warning: input file has less than %d channels\n",
                    req->audio_channels);

        if (swr_alloc_set_opts2(&st->resampler, &layout, AV_SAMPLE_FMT_S16,
                                req->audio_frequency,
                                &st->audio_ctx->ch_layout,
                                st->audio_ctx->sample_fmt,
                                st->audio_ctx->sample_rate, 0, nullptr) < 0)
            return 2;
        if (req->swr_options && req->swr_options[0]) {
            if (av_opt_set_from_string(st->resampler, req->swr_options,
                                       nullptr, "=", ":,") < 0)
                return 2;
        }
        if (swr_init(st->resampler) < 0)
            return 2;
    }

    if (st->video_stream) {
        const AVCodec *codec =
            avcodec_find_decoder(st->video_stream->codecpar->codec_id);
        st->video_ctx = avcodec_alloc_context3(codec);
        if (!st->video_ctx)
            return 2;
        if (avcodec_parameters_to_context(st->video_ctx,
                                          st->video_stream->codecpar) < 0)
            return 2;
        if (avcodec_open2(st->video_ctx, codec, nullptr) < 0)
            return 2;

        if ((res->video_width > st->video_ctx->width ||
             res->video_height > st->video_ctx->height) && !req->quiet)
            fprintf(stderr,
                    "Warning: input file has resolution lower than %dx%d\n",
                    res->video_width, res->video_height);

        if (!req->ignore_aspect) {
            // decoding.c:275-285 — shrink the request to the input's
            // aspect, rounding up to a multiple of 16.
            double src_ratio =
                (double)st->video_ctx->width / (double)st->video_ctx->height;
            double dst_ratio =
                (double)res->video_width / (double)res->video_height;
            if (src_ratio < dst_ratio)
                res->video_width =
                    ((int)round((double)res->video_height * src_ratio) + 15)
                    & ~15;
            else
                res->video_height =
                    ((int)round((double)res->video_width / src_ratio) + 15)
                    & ~15;
        }

        st->scaler = sws_getContext(
            st->video_ctx->width, st->video_ctx->height,
            st->video_ctx->pix_fmt, res->video_width, res->video_height,
            AV_PIX_FMT_NV21, SWS_BICUBIC, nullptr, nullptr, nullptr);
        if (!st->scaler)
            return 2;
        if (sws_setColorspaceDetails(
                st->scaler, sws_getCoefficients(st->video_ctx->colorspace),
                st->video_ctx->color_range == AVCOL_RANGE_JPEG,
                sws_getCoefficients(SWS_CS_ITU601), 1, 0, 1 << 16,
                1 << 16) < 0)
            return 2;
        if (req->sws_options && req->sws_options[0]) {
            if (av_opt_set_from_string(st->scaler, req->sws_options, nullptr,
                                       "=", ":,") < 0)
                return 2;
        }
    }

    st->frame = av_frame_alloc();
    if (!st->frame)
        return 2;

    st->sample_count_mul = req->audio_channels;
    st->pts_step = (double)req->fps_den / (double)req->fps_num;
    st->dst_w = res->video_width;
    st->dst_h = res->video_height;
    st->frame_dst_size = 3LL * res->video_width * res->video_height / 2;
    st->plane_size = res->video_width * res->video_height;

    // ---- loop-point candidates (get_av_loop_point, decoding.c:328-368);
    // format-level metadata, available before any decoding.
    res->is_wav = strcmp(st->format->iformat->name, "wav") == 0;
    AVDictionaryEntry *tag =
        av_dict_get(st->format->metadata, "loop_start", nullptr, 0);
    if (tag) {
        res->has_loop_meta = 1;
        res->loop_meta_ms =
            (long long)((strtoll(tag->value, nullptr, 10) * 1000) /
                        AV_TIME_BASE);
    }
    res->n_chapters = (int)st->format->nb_chapters;
    if (st->format->nb_chapters > 0) {
        AVChapter *ch = st->format->chapters[0];
        double pts = (double)ch->start * (double)ch->time_base.num /
                     (double)ch->time_base.den;
        res->chapter0_ms = (long long)llround(pts * 1000.0);
    }
    res->has_audio = st->audio_ctx != nullptr;
    res->has_video = st->video_ctx != nullptr;
    return 0;
}

// Emit one retimed frame: scale the decoded frame into the FIFO tail (or
// just count it in count_only mode) and remember it as the dup source.
void emit_scaled_frame(Stream *st) {
    st->video_total++;
    if (st->count_only) {
        st->video_frame_count++;
        return;
    }
    size_t base = st->video.size();
    st->video.resize(base + (size_t)st->frame_dst_size);
    uint8_t *dst = st->video.data() + base;
    uint8_t *dst_ptrs[2] = {dst, dst + st->plane_size};
    int dst_strides[2] = {st->dst_w, st->dst_w};
    sws_scale(st->scaler, (const uint8_t *const *)st->frame->data,
              st->frame->linesize, 0, st->frame->height, dst_ptrs,
              dst_strides);
    st->last_frame.assign(dst, dst + st->frame_dst_size);
    st->video_frame_count++;
}

void emit_dup_frame(Stream *st) {
    st->video_total++;
    if (!st->count_only) {
        // Copy of the previously emitted frame (decoding.c:455-462); the
        // FIFO may have drained it already, so dup from last_frame.
        st->video.insert(st->video.end(), st->last_frame.begin(),
                         st->last_frame.end());
    }
    st->video_frame_count++;
    st->video_next_pts += st->pts_step;
}

// Process exactly one packet (poll_av_data, decoding.c:370-406): decoded
// audio appends to the audio FIFO, retimed video frames (incl. CFR dupes)
// to the video FIFO. Returns false at end of input. Like the reference:
// no decoder drain and no swr flush at EOF — delayed frames/samples are
// dropped (decoding.c:480-508).
bool stream_poll(Stream *st) {
    if (st->eof)
        return false;
    AVPacket packet;
    if (av_read_frame(st->format, &packet) < 0) {
        st->eof = true;
        return false;
    }
    if (packet.stream_index == st->audio_index && st->audio_ctx) {
        if (decode_frame(st->audio_ctx, st->frame, &packet)) {
            int out_count =
                swr_get_out_samples(st->resampler, st->frame->nb_samples);
            if (out_count > 0) {
                int16_t *buf;
                size_t base = 0;
                if (st->count_only) {
                    st->scratch.resize((size_t)out_count *
                                       st->sample_count_mul);
                    buf = st->scratch.data();
                } else {
                    base = st->audio.size();
                    st->audio.resize(base + (size_t)out_count *
                                            st->sample_count_mul);
                    buf = st->audio.data() + base;
                }
                uint8_t *bufp = (uint8_t *)buf;
                int got = swr_convert(st->resampler, &bufp, out_count,
                                      (const uint8_t **)st->frame->data,
                                      st->frame->nb_samples);
                if (got < 0)
                    got = 0;
                if (!st->count_only)
                    st->audio.resize(base + (size_t)got *
                                            st->sample_count_mul);
                st->audio_total += (long long)got * st->sample_count_mul;
            }
        }
    } else if (packet.stream_index == st->video_index && st->video_ctx) {
        if (decode_frame(st->video_ctx, st->frame, &packet) &&
            st->frame->width && st->frame->height && st->frame->data[0]) {
            double pts = (double)st->frame->pts *
                         (double)st->video_stream->time_base.num /
                         (double)st->video_stream->time_base.den;
            bool drop = st->video_frame_count >= 1 && pts < st->video_next_pts;
            if (!drop) {
                if (st->video_frame_count < 1)
                    st->video_next_pts = pts;
                else
                    st->video_next_pts += st->pts_step;
                int dupes = (int)ceil((pts - st->video_next_pts) /
                                      st->pts_step);
                for (; dupes > 0; dupes--)
                    emit_dup_frame(st);
                emit_scaled_frame(st);
            }
        }
    }
    av_packet_unref(&packet);
    return true;
}

long long audio_buffered(const Stream *st) {
    return (long long)(st->audio.size() - st->audio_head);
}

long long video_buffered(const Stream *st) {
    return (long long)(st->video.size() - st->video_head) /
           st->frame_dst_size;
}

void maybe_compact(std::vector<int16_t> &v, size_t &head) {
    if (head > (4 << 20) && head * 2 > v.size()) {
        v.erase(v.begin(), v.begin() + head);
        head = 0;
    }
}

void maybe_compact(std::vector<uint8_t> &v, size_t &head) {
    if (head > (16 << 20) && head * 2 > v.size()) {
        v.erase(v.begin(), v.begin() + head);
        head = 0;
    }
}

}  // namespace

extern "C" void psxn_ingest_free(Res *res) {
    free(res->audio);
    free(res->video);
    res->audio = nullptr;
    res->video = nullptr;
}

// Whole-file decode (or count-only pass with kCountOnly). Returns 0 on
// success; nonzero on failure (any detail message already printed).
extern "C" int psxn_ingest_open(const Req *req, Res *res) {
    Stream st;
    int rc = stream_setup(req, res, &st);
    if (rc != 0)
        return rc;

    while (stream_poll(&st)) {
    }

    if (st.audio_ctx) {
        res->audio_count = st.audio_total;
        if (!st.count_only && !st.audio.empty()) {
            res->audio = (int16_t *)malloc(st.audio.size() *
                                           sizeof(int16_t));
            memcpy(res->audio, st.audio.data(),
                   st.audio.size() * sizeof(int16_t));
        }
    }
    if (st.video_ctx) {
        res->video_frames = st.video_total;
        if (!st.count_only && !st.video.empty()) {
            res->video = (uint8_t *)malloc(st.video.size());
            memcpy(res->video, st.video.data(), st.video.size());
        }
    }
    return 0;
}

// Open + find_stream_info only: stream presence/geometry + duration for
// the automatic streaming-mode decision. Never decodes. Quiet (no
// validation messages — the real open prints them once).
extern "C" int psxn_probe(const Req *req, Res *res) {
    Req q = *req;
    q.quiet = 1;
    q.flags &= ~(kAudioRequired | kVideoRequired);
    Stream st;
    // Suppress the validation messages entirely: redirect is overkill,
    // just drop the Required bits (presence still reported via has_*)
    // and note multi-track inputs fail later in the loud open.
    int rc = stream_setup(&q, res, &st);
    if (rc != 0)
        return rc;
    res->has_audio = st.audio_index >= 0;
    res->has_video = st.video_index >= 0;
    return 0;
}

// ---- streaming handle API -------------------------------------------------

extern "C" void *psxn_stream_open(const Req *req, Res *res, int *err) {
    Stream *st = new Stream();
    int rc = stream_setup(req, res, st);
    if (rc != 0) {
        delete st;
        *err = rc;
        return nullptr;
    }
    *err = 0;
    return st;
}

// Poll packets until >= min_audio_values audio values AND
// >= min_video_frames frames are buffered (or EOF). Returns 1 if EOF has
// been reached, else 0.
extern "C" int psxn_stream_fill(void *h, long long min_audio_values,
                                long long min_video_frames) {
    Stream *st = (Stream *)h;
    while ((st->audio_ctx && audio_buffered(st) < min_audio_values) ||
           (st->video_ctx && video_buffered(st) < min_video_frames)) {
        if (!stream_poll(st))
            return 1;
    }
    return st->eof ? 1 : 0;
}

extern "C" void psxn_stream_buffered(void *h, long long *audio_values,
                                     long long *video_frames) {
    Stream *st = (Stream *)h;
    *audio_values = audio_buffered(st);
    *video_frames = st->video_ctx ? video_buffered(st) : 0;
}

extern "C" long long psxn_stream_take_audio(void *h, int16_t *out,
                                            long long max_values) {
    Stream *st = (Stream *)h;
    long long n = audio_buffered(st);
    if (n > max_values)
        n = max_values;
    memcpy(out, st->audio.data() + st->audio_head, n * sizeof(int16_t));
    st->audio_head += (size_t)n;
    maybe_compact(st->audio, st->audio_head);
    return n;
}

extern "C" long long psxn_stream_take_video(void *h, uint8_t *out,
                                            long long max_frames) {
    Stream *st = (Stream *)h;
    long long n = video_buffered(st);
    if (n > max_frames)
        n = max_frames;
    memcpy(out, st->video.data() + st->video_head,
           (size_t)(n * st->frame_dst_size));
    st->video_head += (size_t)(n * st->frame_dst_size);
    maybe_compact(st->video, st->video_head);
    return n;
}

extern "C" void psxn_stream_close(void *h) {
    delete (Stream *)h;
}
