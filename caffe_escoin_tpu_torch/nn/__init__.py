from caffe_escoin_tpu_torch.nn.net import (  # noqa: F401
    Layer, LayerSpec, Net, params_to, register_layer)
from caffe_escoin_tpu_torch.nn import layers as _layers  # noqa: F401  (registry population)
from caffe_escoin_tpu_torch.nn import data_layers as _data_layers  # noqa: F401  (registry population)
from caffe_escoin_tpu_torch.nn.fuse import fuse_inference  # noqa: F401
from caffe_escoin_tpu_torch.nn.convert import params_from_jax  # noqa: F401
