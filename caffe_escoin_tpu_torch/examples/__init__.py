"""The repository's example scripts on the port (counterparts of
``examples/*.py``, which drive the JAX package): each runs as
``python -m caffe_escoin_tpu_torch.examples.<name>``, on the card unless
``--platform cpu`` is given."""
