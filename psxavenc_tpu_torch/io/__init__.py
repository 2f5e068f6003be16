from .ingest import Decoder, open_av_data  # noqa: F401
