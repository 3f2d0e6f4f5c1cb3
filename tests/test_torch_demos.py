"""The port's two demos (``demos/demo_concept_sliders.py``,
``demos/demo_sdxl_turbo.py``) against the JAX package's ``demos/`` scripts
on the CPU.

Both packages' demos run on the tiny SDXL single file of
``tests/_baseline_assets.py`` (``--base``) with the port's draws patched to
JAX's: the initial latents ``normal(PRNGKey(seed))`` and Euler-A's step
noise, ``normal(sub)`` of each ``k, sub = split(k)`` from ``PRNGKey(seed)``
(``sample_loop(step_noise=...)``).

* The concept-slider demo: the slider both sweeps use is one seeded rank-4
  LoRA (each package's trainer is replaced by it: the trainers are held
  against each other in ``tests/test_torch_train.py`` and its siblings);
  fp32, 4 Euler-A steps, CFG 7.5, scales -1 and 1: pixels within 1 of 255.
  The port's demo then trains for real (2 steps: the up factors move) and
  sweeps.
* The turbo demo: in ``tests/test_torch_demo_turbo.py``.

The parsers of both demos have JAX's flags and defaults, and ``--device``."""

import importlib.util
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _baseline_assets as B
import _sweep_cli_assets as A
from sliders_conceptmod_tpu.adapters import lora as jlora
from sliders_conceptmod_tpu.models import factory as jfactory
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.demos import demo_concept_sliders as tconcept
from sliders_conceptmod_tpu_torch.demos import demo_sdxl_turbo as tturbo
from sliders_conceptmod_tpu_torch.io.png import decode_png
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLIDER = "turbo_full_rank2_alpha1.safetensors"


def _jax_demo(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "demos", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_step_noise(seed, steps, shape, device):
    """The JAX sampler's Euler-A draws: step i takes ``normal(sub)`` of the i-th split of ``PRNGKey(seed)``."""
    k, out = jax.random.PRNGKey(int(seed)), []
    for _ in range(steps):
        k, sub = jax.random.split(k)
        out.append(np.asarray(jax.random.normal(sub, tuple(shape), jnp.float32)))
    return torch.from_numpy(np.stack(out))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("demos")
    B.write_checkpoints(root)
    _, _, unet, _ = tfactory.load_models_xl(str(root / "tiny-xl.safetensors"), device="cpu")
    sites = tlora.create_sites(unet, rank=2, alpha=1.0, train_method="full", target_replace=(
        tlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + tlora.UNET_TARGET_REPLACE_MODULE_CONV))
    g = torch.Generator().manual_seed(10)
    lp = tlora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = 0.3 * torch.randn(leaf["up"].shape, generator=g)
    tlora.save_weights(str(root / SLIDER), sites, lp)
    return root


def _same_pngs(port_dir, jax_dir, names, fp32):
    from PIL import Image

    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == sorted(names)
    for name in names:
        got = decode_png((port_dir / name).read_bytes()).astype(int)
        want = np.asarray(Image.open(jax_dir / name)).astype(int)
        diff = np.abs(got - want)
        bound = (1, 0.05) if fp32 else (A.PIXEL_MAX, A.PIXEL_MEAN)
        assert got.shape == want.shape and diff.max() <= bound[0] and diff.mean() <= bound[1], \
            (name, diff.max(), diff.mean())


def test_concept_slider_demo_matches_jax(assets, tmp_path, monkeypatch):
    base = str(assets / "tiny-xl.safetensors")
    _, _, junet, _ = jfactory.load_models_xl(base)
    jsites = jlora.create_sites(junet.params, rank=4, alpha=1.0, train_method="full")
    rng = np.random.default_rng(11)
    jlp = jax.tree.map(lambda a: jnp.asarray(0.3 * rng.standard_normal(a.shape), jnp.float32),
                       jlora.init_lora_params(jax.random.PRNGKey(11), jsites))
    jdemo = _jax_demo("demo_concept_sliders")
    monkeypatch.setattr(jdemo, "trainer", SimpleNamespace(train=lambda *a, **k: SimpleNamespace(
        sites=jsites, lora_params=jlp, losses=[0.0], steps_per_sec=1.0)))
    argv = ["--base", base, "--scales=-1,1"]
    monkeypatch.setattr("sys.argv", ["demo"] + argv + ["--out", str(tmp_path / "jax")])
    jdemo.main()

    _, _, tunet, _ = tfactory.load_models_xl(base, device="cpu")
    tsites = tlora.create_sites(tunet, rank=4, alpha=1.0, train_method="full")
    tlp = tlora.load_weights_from_tensors(jlora.state_dict_numpy(jsites, jlp), tsites)
    monkeypatch.setattr(tconcept, "trainer", SimpleNamespace(train=lambda *a, **k: SimpleNamespace(
        sites=tsites, lora_params=tlp, losses=[0.0], steps_per_sec=1.0)))
    monkeypatch.setattr(tconcept, "draw_latents", A.jax_draw)
    monkeypatch.setattr(tconcept, "step_noise", jax_step_noise)
    tconcept.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    _same_pngs(tmp_path / "port", tmp_path / "jax", ["scale_-1.0.png", "scale_1.0.png"], True)


def test_concept_slider_demo_trains(tmp_path):
    res = tconcept.run(tconcept.build_parser().parse_args(
        ["--steps", "2", "--scales=-2,2", "--out", str(tmp_path), "--device", "cpu"]))
    assert len(res["result"].losses) == 2 and np.isfinite(res["result"].losses).all()
    moved = [float(leaf["up"].detach().abs().max()) for leaf in res["result"].lora_params.values()]
    assert max(moved) > 0  # the up factors start at 0
    assert {"scale_-2.0.png", "scale_2.0.png"} <= set(os.listdir(tmp_path))
    assert all(img.shape == (64, 64, 3) for img in res["images"].values())


def test_demo_parsers_have_the_jax_flags(monkeypatch):
    for name, mod, required in (("demo_concept_sliders", tconcept, []),
                                ("demo_sdxl_turbo", tturbo, ["--slider", "s", "--prompt", "p"])):
        captured = {}
        jdemo = _jax_demo(name)
        real = jdemo.argparse.ArgumentParser.parse_args

        def grab(self, *a, **k):
            captured["args"] = vars(real(self, required))
            raise SystemExit(0)

        monkeypatch.setattr(jdemo.argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            jdemo.main()
        monkeypatch.undo()
        port = vars(mod.build_parser().parse_args(required))
        assert port.pop("device") == "cuda"
        assert port == captured["args"], name
