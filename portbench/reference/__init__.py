"""The plain reference that decides ``correct``: float32 PyTorch with TF32 off.

Nothing here imports ``qst_tpu_torch``, ``qst_tpu`` or JAX. The modules are
written from the published descriptions of the models and the training
recipe; two pieces are frozen copies of algorithms whose bits both sides
must share: the WordPiece tokenizer (``wordpiece.py``) and the counter-based
dropout hash (``dropout.py``).

- ``encoder.py``: BERT (all-MiniLM-L6-v2) and MPNet (all-mpnet-base-v2)
  sentence encoders, mean pooling and L2 normalisation;
- ``train.py``: the γ-quadruplet loss, warmuplinear, clipped AdamW and a
  train step;
- ``search.py``: an exact blocked cosine scan with top-k;
- ``precision.py``: float32 with TF32 off, and the lower-precision control
  (fp8 e4m3 operands in every product).
"""
