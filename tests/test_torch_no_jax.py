"""The port imports no jax and nothing of the JAX package (nor the
repository's examples/ scripts, which drive it, nor its ``bench.py``, whose
counterpart is the port's own ``bench`` module, nor its ``scripts/``, whose
suite and table renderers the port's ``tools`` carry, and whose probes its
``experiments`` carry): the machine with the
card has no jax. Importing every module needs neither PIL nor h5py either (the
data layers import them when they read images or HDF5 files), since that
machine may have neither, and no scikit-learn (the examples' digits are a
file of the port's own)."""

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    # forget any jax, PIL, h5py or scikit-learn a site hook may have
    # imported, and refuse new imports of them, of the JAX package, of
    # the repository's examples/ scripts or of its scripts/
    REFUSED = ("jax", "jaxlib", "caffe_escoin_tpu", "PIL", "h5py",
               "sklearn", "examples", "scripts")
    for name in [m for m in sys.modules if m.split(".")[0] in REFUSED]:
        del sys.modules[name]

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"the port imported {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import caffe_escoin_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    bad = [m for m in sys.modules if m.split(".")[0] in REFUSED]
    assert not bad, bad
    print(" ".join(names))
    print(len(names))
""")

# the modules that carry their own copies of JAX-package code (numpy-only
# helpers, the model specs, the model I/O, the command line and the
# training loop the port may not import, the example scripts, the
# measuring program, its suite and the table renderers of scripts/)
COPIES = ("ops.s2d", "ops.wpack", "ops.norm", "ops.structural",
          "ops.activations", "ops.losses", "utils.pruning",
          "models.alexnet", "models.caffenet", "models.cifar",
          "models.googlenet", "models.lenet", "models.resnet", "models.vgg",
          "nn.serialize", "tools.prototxt", "tools.caffemodel", "tools.draw",
          "tools.cli", "tools.parity", "data.datasets", "engine.checkpoint",
          "utils.timing", "utils.benchmark", "engine.lr_policies",
          "engine.solvers", "engine.solver", "utils.gradient_check",
          "data.pipeline", "nn.convert", "data.transformer",
          "data.lmdb_io", "data.native", "nn.data_layers", "ops.deconv",
          "ops.recurrent", "sparse.permute", "tools.vision", "tools.scaling",
          "parallel.mesh", "parallel.launch", "parallel.halo", "parallel.tp",
          "parallel.dp", "parallel.dryrun", "examples.digits",
          "examples.train_eval_sparse", "examples.net_surgery",
          "examples.siamese_digits", "bench", "tools.report",
          "tools.sweep_table", "tools.suite")
# the probes of scripts/ (exp_*_r5.py, rss_probe.py) and what they share:
# walk_packages must reach the subpackage
EXPERIMENTS = ("experiments", "experiments.common", "experiments.opprofile",
               "experiments.pool", "experiments.k3", "experiments.s2d",
               "experiments.wpack", "experiments.stability",
               "experiments.rss_probe")


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    *_, names, count = proc.stdout.strip().splitlines()
    assert int(count) >= 20  # every submodule
    imported = set(names.split())
    assert {f"caffe_escoin_tpu_torch.{m}" for m in COPIES} <= imported
    assert {f"caffe_escoin_tpu_torch.{m}" for m in EXPERIMENTS} <= imported
