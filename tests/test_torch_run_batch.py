"""The port's ``cli/make_config.py`` and ``cli/run_batch.py`` against the
JAX package's on the CPU.

* ``make_config``: the port's YAML writer (``core/yaml_subset.py::dumps``)
  gives PyYAML's bytes for plain specs (the examples in JAX's
  ``cli/run_batch.py`` docstring, and more) and loads back equal through
  ``yaml.safe_load`` and ``core/yaml_subset.py`` for a spread of specs that
  need quoting; the CLI's file is byte-equal to JAX's.
* ``run_batch`` trains two specs of a tiny config in a temporary directory
  (make_config's pairs at 64px and batch 1): ``prompts-batch.yaml`` beside
  the config, JAX's prompts from it (with ``DEFAULT_ATTRIBUTES``), and each
  spec's decorated save."""

import os
import shutil

import numpy as np
import pytest
import yaml

from sliders_conceptmod_tpu.cli import make_config as jmake
from sliders_conceptmod_tpu.cli import run_batch as jbatch
from sliders_conceptmod_tpu.core import prompts as jprompts
from sliders_conceptmod_tpu_torch.cli import make_config as tmake
from sliders_conceptmod_tpu_torch.cli import run_batch as tbatch
from sliders_conceptmod_tpu_torch.core import prompts as tprompts
from sliders_conceptmod_tpu_torch.core import yaml_subset
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


PLAIN_SPECS = ["person|smiling person|person", "sky|stormy sky|sky", "car|red car", "dog", "a photo|an image|"]
QUOTED_SPECS = ["true|123|1.5", "a: b|#x|it's", " lead|trail |", "x #y|- a|?q", "null|~|yes", "2020-01-01|<<|=",
                "-1|+2|.5", "1e-4|1.0e+3|0x1F", "car, red|[a]|{b}", "@x|`y|%z", "a:b|a#b|-a", "on|Off|NO",
                "' q|\"dq|a'b", "1_000|0o7|07", "|||"]


@pytest.mark.parametrize("spec", PLAIN_SPECS + QUOTED_SPECS)
def test_make_config_yaml_matches_pyyaml(spec, tmp_path):
    prompts = tmake.make_prompts(spec)
    assert prompts == jmake.make_prompts(spec)
    text = yaml_subset.dumps(prompts)
    assert yaml.safe_load(text) == prompts and yaml_subset.loads(text) == prompts
    if spec in PLAIN_SPECS:
        assert text == yaml.dump(prompts)


def test_make_config_cli_writes_jax_bytes(tmp_path, monkeypatch):
    spec = "person|smiling person|person"
    tmake.main([spec, "--out", str(tmp_path / "port" / "prompts.yaml")])
    monkeypatch.setattr("sys.argv", ["make_config", spec, "--out", str(tmp_path / "jax" / "prompts.yaml")])
    jmake.main()
    assert (tmp_path / "port" / "prompts.yaml").read_bytes() == (tmp_path / "jax" / "prompts.yaml").read_bytes()


def small(spec):
    """make_config's pair at the tiny size: 64px and batch 1 (the spec's own
    512px at batch 12 costs the CPU a minute a slider)."""
    return [dict(p, resolution=64, batch_size=1) for p in MAKE_PROMPTS(spec)]


MAKE_PROMPTS = tmake.make_prompts


def test_run_batch_trains_each_spec(tmp_path, monkeypatch):
    monkeypatch.setattr(tmake, "make_prompts", small)
    cfg = (open(os.path.join(REPO, "data", "config-tiny-xl.yaml")).read()
           .replace("iterations: 4", "iterations: 1").replace("/tmp/slider_smoke", str(tmp_path / "ckpt")))
    (tmp_path / "cfg").mkdir()
    (tmp_path / "cfg" / "config.yaml").write_text(cfg)
    specs = ["person|smiling person|person", "sky|stormy sky|sky"]
    results = tbatch.main(["--config_file", str(tmp_path / "cfg" / "config.yaml"), "--specs", *specs, "--rank", "2",
                           "--device", "cpu"])
    assert tbatch.DEFAULT_ATTRIBUTES == jbatch.DEFAULT_ATTRIBUTES
    written = tmp_path / "cfg" / "prompts-batch.yaml"
    assert written.read_text() == yaml.dump(small(specs[-1]))  # the last spec's file stays
    attrs = [a.strip() for a in tbatch.DEFAULT_ATTRIBUTES.split(",")]
    want = [p.model_dump() for p in jprompts.load_prompts_from_yaml(str(written), attrs)]
    assert [p.model_dump() for p in tprompts.load_prompts_from_yaml(str(written), attrs)] == want
    assert len(results) == 2 and all(np.isfinite(r.losses).all() for r in results)
    for target in ("person", "sky"):
        name = f"{target}_alpha1.0_rank2_full"
        assert (tmp_path / "ckpt" / name / f"{name}_last.safetensors").exists()
    shutil.rmtree(tmp_path / "ckpt")
