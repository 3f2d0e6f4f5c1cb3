"""The port and chip_smoke.py import nothing of JAX and nothing of the JAX
package: every module is imported in a fresh interpreter whose import system
refuses ``jax``, ``flax``, ``optax`` and ``sliders_conceptmod_tpu`` (that exact
top-level name, so ``sliders_conceptmod_tpu_torch`` itself still imports), and
also ``yaml`` and ``pydantic``, which the GPU machine does not have."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = textwrap.dedent(
    """
    import importlib, importlib.util, pkgutil, sys

    REFUSED = {"jax", "jaxlib", "flax", "optax", "sliders_conceptmod_tpu", "yaml", "pydantic"}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"refused import of {name}")

    sys.meta_path.insert(0, Refuse())
    import sliders_conceptmod_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
    assert not leaked, leaked
    print(len(names), "modules:", " ".join(names))
    """
)

# modules the SD slice added or extended: the SD CLI, the k-grid backward
# (K4b/K4c), the SD model configs and loaders
SD_SLICE_MODULES = {
    "sliders_conceptmod_tpu_torch.cli.train_lora",
    "sliders_conceptmod_tpu_torch.cli.train_lora_scale",
    "sliders_conceptmod_tpu_torch.ops.flash_attention_kgrid",
    "sliders_conceptmod_tpu_torch.models.factory",
    "sliders_conceptmod_tpu_torch.models.clip",
    "sliders_conceptmod_tpu_torch.train.trainer",
}


def test_port_and_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", CHECK, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    n = int(res.stdout.split()[0])
    assert n >= 31  # every module of the package was walked (core/, train/ and cli/ included)
    assert SD_SLICE_MODULES <= set(res.stdout.split(":", 1)[1].split())


def test_refusal_hook_bites():
    """The hook above does refuse the JAX package (so a pass means something)."""
    code = CHECK.split("import sliders_conceptmod_tpu_torch as pkg")[0] + "import sliders_conceptmod_tpu\n"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "refused import of sliders_conceptmod_tpu" in res.stderr
