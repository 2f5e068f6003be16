"""Host-side native code of psxavenc_tpu_torch, built with g++ at first use
into the package's ``build/`` directory: the FFmpeg ingest
(``ingest_ext``), the CD sector code (``host``) and the native encoder
tiers (``tiers``)."""
