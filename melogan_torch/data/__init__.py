"""Data layer (own copies of the JAX package's numpy code): the ``.npz``
sample schema and split resolution (``npz.py``), the feature scaler,
stratified splits, MIDI preprocessing, the synthetic corpus, corpus
expansion, and the in-memory datasets and batch indices."""
