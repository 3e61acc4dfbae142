"""Training: AdamW with float32 master weights (``optimizer``), the
microbatched train step (``train``), content-addressed delta checkpoints
(``checkpoint``) and the seekable synthetic data stream (``data``, a
verbatim copy of the JAX package's)."""
