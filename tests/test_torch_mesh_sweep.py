"""The sharded XL sweep (``cli/generate_images_xl.py --batch_scales
--mesh_data 2``, ``parallel/mesh.py``): the CLI spawns two gloo ranks, each
samples its share of the scale × sample rows, and rank 0 writes the images
the one-rank sweep writes (the same files, within 1/255) on a tiny-xl
single file the port's exporter wrote; JAX's guards refuse ``--mesh_data``
without ``--batch_scales`` and a data axis that does not divide the rows."""

import numpy as np
import pytest

import _baseline_assets as BA
from sliders_conceptmod_tpu_torch.cli import generate_images_xl as tcli_xl
from sliders_conceptmod_tpu_torch.io.png import decode_png
from test_torch_serve_registry import _unet_slider
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)


@pytest.fixture(scope="module")
def argv(tmp_path_factory):
    d = tmp_path_factory.mktemp("assets")
    BA.write_checkpoints(d)
    slider = _unet_slider(d / "slider_noxattn_rank4_alpha1.safetensors", "noxattn", 4, 1.0, 1)
    return ["--model_name", slider, "--prompts_path", str(d / "prompts.csv"), "--base", str(d / "tiny-xl.safetensors"),
            "--image_size", "64", "--ddim_steps", "3", "--num_samples", "2", "--scales=-1,0,1", "--till_case", "2",
            "--device", "cpu"]


def test_sharded_sweep_writes_the_one_rank_images(argv, tmp_path):
    tcli_xl.main(argv + ["--batch_scales", "--save_path", str(tmp_path / "one")])
    tcli_xl.main(argv + ["--batch_scales", "--save_path", str(tmp_path / "two"), "--mesh_data", "2"])
    files = BA.A.tree(tmp_path / "one")
    assert files == BA.A.tree(tmp_path / "two") and len(files) == 7  # 3 scales x 2 samples and the composite
    for f in files:
        one, two = (decode_png((tmp_path / d / f).read_bytes()).astype(int) for d in ("one", "two"))
        assert np.abs(one - two).max() <= 1, f


@pytest.mark.parametrize("flags,match", [(["--mesh_data", "2"], "requires --batch_scales"),
                                         (["--batch_scales", "--mesh_data", "4"], "must divide scales")])
def test_jax_guards_refuse_before_any_rank_starts(argv, tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        tcli_xl.main(argv + flags + ["--save_path", str(tmp_path / "out")])
