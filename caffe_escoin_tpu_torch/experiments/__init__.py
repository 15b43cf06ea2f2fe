"""The repository's probes of the sparse forward on the port (counterparts
of ``scripts/exp_*_r5.py`` and ``scripts/rss_probe.py``, which drive the
JAX package): each runs as ``python -m
caffe_escoin_tpu_torch.experiments.<name>``, on the card unless
``--platform cpu`` is given, and appends its rows to
``build/experiments/<name>.jsonl``.

* ``opprofile``: the whole forward op by op (``torch.profiler``), as CUDA
  graph replays and layer by layer, its kernels named and attributed to
  layers;
* ``pool``: three max-pool formulations on six shapes;
* ``k3``: every formulation of a block-sparse 3x3 on ResNet-50's k3 shapes,
  the hand ``sconv_fused`` kernel among them;
* ``s2d``: the space-to-depth stem fold against the strided stem conv;
* ``wpack``: the W-pair packed layout against the unpacked one, arm by arm;
* ``stability``: the same sparse forward timed in fresh processes;
* ``rss_probe``: host memory over a long training loop.
"""
