"""Host-side native code of psxavenc_tpu_torch, built with g++ at first use
into the package's ``build/`` directory: the FFmpeg ingest
(``ingest_ext``) and the CD sector code (``host``)."""
