"""The benchmark of ``caffe_escoin_tpu_torch`` on one NVIDIA H100: sparse
CNN inference through the program's ``Net.inference_fn(cuda_graph=True)``,
offline and one query at a time, checked against a plain float32
reference. See README.md."""
