"""The port's turbo demo (``demos/demo_sdxl_turbo.py``) against the JAX
package's ``demos/demo_sdxl_turbo.py`` on the CPU.

Both run on the tiny SDXL single file of ``tests/_baseline_assets.py``
(``--base``) with one slider file, 64px, 4 Euler-A steps at guidance 0 (the
cond-only path), ``start_noise`` 800, scales -2, 0 and 2, the port's draws
patched to JAX's (``tests/test_torch_demos.py::jax_step_noise``): pixels
within 1 of 255 with both packages' weights in fp32, within the bf16 bound
of ``tests/_sweep_cli_assets.py`` at the demo's own bf16."""

import numpy as np
import pytest

import _sweep_cli_assets as A
from sliders_conceptmod_tpu_torch.demos import demo_sdxl_turbo as tturbo
from sliders_conceptmod_tpu_torch.io.png import decode_png
from test_torch_demos import SLIDER, _jax_demo, _same_pngs, assets, jax_step_noise  # noqa: F401 (the fixture)
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_turbo_demo_matches_jax(assets, tmp_path, monkeypatch, fp32):
    argv = ["--base", str(assets / "tiny-xl.safetensors"), "--slider", str(assets / SLIDER), "--prompt",
            "a photo of a person", "--resolution", "64", "--scales=-2,0,2"]
    jdemo = _jax_demo("demo_sdxl_turbo")
    if fp32:
        A.fp32(monkeypatch, jdemo, tturbo)
    monkeypatch.setattr("sys.argv", ["demo"] + argv + ["--out", str(tmp_path / "jax")])
    jdemo.main()
    monkeypatch.setattr(tturbo, "draw_latents", A.jax_draw)
    monkeypatch.setattr(tturbo, "step_noise", jax_step_noise)
    tturbo.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    names = [f"turbo_scale_{s}.png" for s in (-2.0, 0.0, 2.0)]
    _same_pngs(tmp_path / "port", tmp_path / "jax", names, fp32)
    a, b = (decode_png((tmp_path / "port" / n).read_bytes()) for n in (names[0], names[2]))
    assert not np.array_equal(a, b)  # the slider bites
