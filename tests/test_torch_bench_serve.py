"""The port's ``cli/bench_serve.py`` against the JAX package's, on the CPU at
tiny sizes (tiny-xl, 64px, 2 DDIM steps):

* the two parsers action for action (``--device`` is the port's own), and
  the "--slider is required" exit;
* ``_percentile`` on hypothesis lists, empty and one-value lists included;
* ``--slider synth`` for tiny-xl, tiny (``--family sd1``), tiny-sd3 and
  tiny-flux: the file's keys, shapes, dtypes and alphas are those of the file
  JAX's ``run`` synthesizes (its service replaced by a stub that stops the
  run once the file is written), every factor its seeded draw + 0.01; and
  ``factory.denoiser_on_meta`` reads a single file's, an int8 artifact's
  and a directory's architecture as the loaders do;
* in-process runs: the JSON line's key set is JAX's ``run``'s on the same
  flags, with and without ``--no_microbatch`` (which cannot shed);
  ``--num_sliders 3`` rides one sampler call per micro-batch when stacked
  and one per slider with ``--no_stack`` (the spy of
  tests/test_torch_serve_registry.py); a bound queue sheds without raising;
* ``--url`` against ``make_handler`` over a service: every response a PNG,
  one of them bit-equal to ``generate`` with its parameters, and the key set
  JAX's ``--url`` run prints against the same server;
* the service's ``sites`` / ``lora_params`` properties follow the
  ``default`` registration.

Each package's services, and JAX's tiny-xl synth, share one load of the tiny-xl models (the full SDXL
VAE takes ~20 s to draw on the CPU); each run still builds its own service.
"""

import dataclasses
import inspect
import io
import json
import os
import threading
from http.server import ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sliders_conceptmod_tpu.cli import bench_serve as jbench
from sliders_conceptmod_tpu_torch import serve as tserve
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.cli import bench_serve as tbench
from sliders_conceptmod_tpu_torch.io import ldm_export, quant_cache
from sliders_conceptmod_tpu_torch.io.safetensors import load_file
from sliders_conceptmod_tpu_torch.models import factory as tfactory
from sliders_conceptmod_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from sliders_conceptmod_tpu_torch.models.flux import FluxConfig, FluxTransformer2DModel
from sliders_conceptmod_tpu_torch.models.mmdit import MMDiTConfig, SD3Transformer2DModel
from sliders_conceptmod_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

RUN = ["--base", "tiny-xl", "--image_size", "64", "--steps", "2", "--requests", "6", "--concurrency", "3",
       "--batch_window_ms", "200"]


def _cached(load, make_scheduler):
    """``load`` (a ``load_models_xl``) run once per name and options; the
    scheduler, the one output its name picks, is made anew on every call."""
    cache = {}
    signature = inspect.signature(load)

    def cached(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        options = dict(bound.arguments)
        scheduler_name = options.pop("scheduler_name")
        key = tuple(sorted(options.items(), key=lambda kv: kv[0]))
        if key not in cache:
            cache[key] = load(**options)
        toks, tes, unet, _, *rest = cache[key]
        return (toks, tes, unet, make_scheduler(scheduler_name), *rest)

    return cached


@pytest.fixture(scope="module", autouse=True)
def one_tiny_xl_load():
    """Every service of this module, the port's and JAX's, and JAX's
    ``--slider synth`` over tiny-xl get their package's one load of the
    tiny-xl models (the weightless family is the same draw every time)."""
    from sliders_conceptmod_tpu.models import factory as jfactory

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfactory, "load_models_xl", _cached(tfactory.load_models_xl, tfactory.create_noise_scheduler))
        mp.setattr(jfactory, "load_models_xl", _cached(jfactory.load_models_xl, jfactory.create_noise_scheduler))
        yield


@pytest.fixture(scope="module")
def slider(tmp_path_factory):
    return tbench.synth_slider("tiny-xl", "xl", str(tmp_path_factory.mktemp("bench") / "bench_slider.safetensors"))


def _actions(parser) -> list:
    return [(a.dest, tuple(a.option_strings), a.default, a.type, a.choices, a.nargs, a.help, type(a).__name__)
            for a in parser._actions]


def test_parser_matches_jax_action_for_action():
    port, jax_ = tbench.build_parser(), jbench.build_parser()
    assert port.prog == jax_.prog == "benchServe"
    actions = _actions(port)
    assert actions[-1][:3] == ("device", ("--device",), "cuda")
    assert actions[:-1] == _actions(jax_)
    with pytest.raises(SystemExit, match="--slider is required for in-process mode"):
        tbench.main(["--base", "tiny-xl"])


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(st.floats(allow_nan=False, allow_infinity=False), max_size=40),
       st.floats(min_value=0.0, max_value=1.0))
def test_percentile_matches_jax(values, q):
    values = sorted(values)
    assert tbench._percentile(values, q) == jbench._percentile(values, q)


@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 0.99, 1.0])
def test_percentile_of_empty_and_one_value_lists(q):
    assert tbench._percentile([], q) == jbench._percentile([], q) == 0.0
    assert tbench._percentile([2.5], q) == jbench._percentile([2.5], q) == 2.5


def _jax_synth(monkeypatch, base: str, family) -> dict:
    """The file JAX's ``run`` synthesizes for ``base``: its services are
    replaced by a stub that stops the run with the file's path."""
    import sliders_conceptmod_tpu.serve as jserve

    class Written(Exception):
        pass

    def stub(base, slider_path, *args, **kwargs):
        raise Written(slider_path)

    for name in ("SliderService", "SD1SliderService", "SD3SliderService", "FluxSliderService"):
        monkeypatch.setattr(jserve, name, stub)
    argv = ["--base", base, "--slider", "synth"] + (["--family", family] if family else [])
    with pytest.raises(Written) as written:
        jbench.run(jbench.build_parser().parse_args(argv))
    path = str(written.value)
    try:
        return load_file(path)
    finally:
        os.remove(path)


@pytest.mark.parametrize("base,family", [("tiny-xl", None), ("tiny", "sd1"), ("tiny-sd3", None), ("tiny-flux", None)])
def test_synth_slider_is_jaxs_file(monkeypatch, tmp_path, base, family):
    fam = family or tserve.detect_family(base)
    port = load_file(tbench.synth_slider(base, fam, str(tmp_path / "bench_slider.safetensors")))
    want = _jax_synth(monkeypatch, base, family)
    assert sorted(port) == sorted(want) and len(port) > 0
    for key, value in want.items():
        assert (tuple(port[key].shape), port[key].dtype) == (tuple(value.shape), value.dtype), key
        if key.endswith(".alpha"):
            assert float(port[key]) == float(value) == 1.0
    assert all(("-" in k) == (fam in ("sd3", "flux")) for k in port)
    sites = tbench.synth_sites(base, fam)
    assert {s.rank for s in sites} == {4}
    init = tlora.init_lora_params(sites, generator=torch.Generator().manual_seed(0))
    for site in sites:
        torch.testing.assert_close(port[f"{site.lora_name}.lora_down.weight"], init[site.lora_name]["down"] + 0.01,
                                   rtol=0, atol=0)
        assert torch.all(port[f"{site.lora_name}.lora_up.weight"] == torch.tensor(0.01))


def _unet_dir(root, cfg: UNetConfig):
    (root / "unet").mkdir(parents=True)
    (root / "unet" / "config.json").write_text(json.dumps({
        "down_block_types": list(cfg.down_block_types), "up_block_types": list(cfg.up_block_types),
        "block_out_channels": list(cfg.block_out_channels), "layers_per_block": cfg.layers_per_block,
        "cross_attention_dim": cfg.cross_attention_dim, "attention_head_dim": cfg.attention_head_dim,
        "norm_num_groups": cfg.norm_num_groups}))
    return str(root)


def _transformer_dir(root, cfg):
    (root / "transformer").mkdir(parents=True)
    (root / "transformer" / "config.json").write_text(json.dumps(dataclasses.asdict(cfg), default=list))
    return str(root)


def _weights(module_cls, cfg):
    return tfactory.build_module(lambda: module_cls(cfg), "cpu", torch.float32, 0).state_dict()


SD1_LPB1 = dataclasses.replace(UNetConfig.tiny(), layers_per_block=1)
XL_LPB1 = dataclasses.replace(UNetConfig.tiny_xl(), layers_per_block=1)
SD3_1 = dataclasses.replace(MMDiTConfig.tiny(), num_layers=1)
FLUX_1_2 = dataclasses.replace(FluxConfig.tiny(), num_layers=1, num_single_layers=2)


LOADED_DENOISER = {"sd1": lambda p: tfactory.load_models(p, device="cpu")[2],
                   "xl": lambda p: tfactory.load_models_xl(p, device="cpu")[2],
                   "sd3": lambda p: tfactory.load_models_sd3(p, device="cpu")[2],
                   "flux": lambda p: tfactory.load_models_flux(p, device="cpu")[2]}


@pytest.mark.parametrize("source", ["sd1_file", "xl_file", "sd3_file", "flux_file", "sd3_artifact", "flux_artifact",
                                    "sd1_dir", "sd3_dir", "flux_dir"])
def test_denoiser_on_meta_reads_the_architecture_the_loaders_build(tmp_path, source):
    """Each source's depth differs from its family's default; a file or an
    artifact is also loaded, and the meta denoiser's config is the loaded
    one's (a directory's is read by the loaders' own ``config.json`` rule)."""
    tiny_te = CLIPTextConfig.tiny(hidden_size=16, projection_dim=16)
    if source == "sd1_file":
        path, family, cfg = tmp_path / "tiny-sd1.safetensors", "sd1", SD1_LPB1
        ldm_export.save_ldm_checkpoint(str(path), ldm_export.export_ldm_checkpoint(
            _weights(UNet2DConditionModel, cfg), _weights(CLIPTextEncoder, CLIPTextConfig.tiny()), v2=False))
    elif source == "xl_file":
        path, family, cfg = tmp_path / "tiny-xl.safetensors", "xl", XL_LPB1
        ldm_export.save_ldm_checkpoint(str(path), ldm_export.export_sdxl_checkpoint(
            _weights(UNet2DConditionModel, cfg), _weights(CLIPTextEncoder, CLIPTextConfig.tiny(hidden_size=16)),
            _weights(CLIPTextEncoder, CLIPTextConfig.tiny(hidden_size=16, projection_dim=32))))
    elif source == "sd3_file":
        path, family, cfg = tmp_path / "tiny-sd3.safetensors", "sd3", SD3_1
        ldm_export.save_ldm_checkpoint(str(path), ldm_export.export_sd3_checkpoint(
            _weights(SD3Transformer2DModel, cfg), _weights(CLIPTextEncoder, tiny_te),
            _weights(CLIPTextEncoder, tiny_te)))
    elif source == "flux_file":
        path, family, cfg = tmp_path / "tiny-flux.safetensors", "flux", FLUX_1_2
        ldm_export.save_ldm_checkpoint(str(path), ldm_export.export_flux_bfl(_weights(FluxTransformer2DModel, cfg)))
    elif source == "sd3_artifact":
        path, family, cfg = tmp_path / "tiny-sd3.int8.safetensors", "sd3", SD3_1
        quant_cache.save_quantized(str(path), tfactory.build_module(lambda: SD3Transformer2DModel(cfg), "cpu",
                                                                    torch.float32, 0, quantize=True))
    elif source == "flux_artifact":
        path, family, cfg = tmp_path / "tiny-flux.int8.safetensors", "flux", FLUX_1_2
        quant_cache.save_quantized(str(path), tfactory.build_module(lambda: FluxTransformer2DModel(cfg), "cpu",
                                                                    torch.float32, 0, quantize=True))
    elif source == "sd1_dir":
        path, family, cfg = _unet_dir(tmp_path / "sd15", SD1_LPB1), "sd1", SD1_LPB1
    elif source == "sd3_dir":
        path, family, cfg = _transformer_dir(tmp_path / "sd3", SD3_1), "sd3", SD3_1
    else:
        path, family, cfg = _transformer_dir(tmp_path / "flux", FLUX_1_2), "flux", FLUX_1_2
    model = tfactory.denoiser_on_meta(str(path), family)
    assert next(model.parameters()).device.type == "meta"
    got = model.config
    for field in ("layers_per_block", "block_out_channels", "num_layers", "num_single_layers",
                  "attention_head_dim", "guidance_embeds"):
        assert getattr(got, field, None) == getattr(cfg, field, None), field
    if not source.endswith("_dir"):
        assert got == LOADED_DENOISER[family](str(path)).config


def _key_set(out: dict) -> list:
    return sorted(out)


@pytest.fixture(scope="module")
def jax_key_sets(tmp_path_factory, slider):
    """JAX's ``run`` on the port's test flags over the same slider file."""
    return {extra: _key_set(jbench.run(jbench.build_parser().parse_args(RUN + ["--slider", slider] + list(extra))))
            for extra in ((), ("--no_microbatch",))}


@pytest.mark.parametrize("extra", [(), ("--no_microbatch",)])
def test_in_process_run_and_jaxs_key_set(slider, jax_key_sets, extra):
    out = tbench.run(tbench.build_parser().parse_args(RUN + ["--slider", slider, "--device", "cpu"] + list(extra)))
    assert out["value"] > 0 and out["requests"] == 6
    assert _key_set(out) == jax_key_sets[extra]
    if extra:
        assert out["microbatch"] is False and "mean_batch" not in out
    else:
        assert out["mean_batch"] > 1.0 and out["completed"] == 6 and out["shed_429"] == 0


@pytest.fixture
def sampler_calls(monkeypatch):
    """Per micro-batch: (its slider names, [adapter_idx of each sampler call])."""
    batches = []
    run_batch, sample_group = tserve.SliderService._run_batch, tserve.SliderService._sample_group

    def spy_batch(self, reqs):
        batches.append((sorted({r[4] for r in reqs}), []))
        return run_batch(self, reqs)

    def spy_group(self, padded, guidance, entry, adapter_idx=None):
        batches[-1][1].append(adapter_idx)
        return sample_group(self, padded, guidance, entry, adapter_idx=adapter_idx)

    monkeypatch.setattr(tserve.SliderService, "_run_batch", spy_batch)
    monkeypatch.setattr(tserve.SliderService, "_sample_group", spy_group)
    return batches


@pytest.mark.parametrize("stack", [True, False])
def test_num_sliders_stack_one_call_per_batch_and_split_per_slider(slider, sampler_calls, stack):
    argv = RUN + ["--slider", slider, "--device", "cpu", "--num_sliders", "3"] + ([] if stack else ["--no_stack"])
    out = tbench.run(tbench.build_parser().parse_args(argv))
    assert out["num_sliders"] == 3 and out["cross_slider_stack"] is stack and out["completed"] == 6
    assert sum(len(names) for names, _ in sampler_calls) >= 2 * len(sampler_calls)  # mixed-slider batches
    assert {n for names, _ in sampler_calls for n in names} == {"default", "s1", "s2"}
    for names, calls in sampler_calls:
        if stack:  # one stacked call (per-row adapter indices) for a batch of several sliders
            assert len(calls) == 1 and (calls[0] is None) == (len(names) == 1), (names, calls)
        else:
            assert len(calls) == len(names) and all(c is None for c in calls), (names, calls)


def test_a_bound_queue_sheds_and_does_not_raise(slider):
    argv = ["--base", "tiny-xl", "--image_size", "64", "--steps", "2", "--slider", slider, "--device", "cpu",
            "--requests", "8", "--concurrency", "4", "--max_queue", "1", "--batch_window_ms", "0"]
    out = tbench.run(tbench.build_parser().parse_args(argv))
    assert out["shed_429"] > 0 and out["completed"] >= 1
    assert out["completed"] + out["shed_429"] == 8 and out["max_queue"] == 1


def test_no_microbatch_cannot_shed(slider, monkeypatch):
    """Without micro-batching the line has no shed count, so the queue holds
    every request: the flags that shed above shed nothing."""
    services = []
    make = tbench.make_service
    monkeypatch.setattr(tbench, "make_service", lambda args, path: services.append(make(args, path)) or services[-1])
    argv = ["--base", "tiny-xl", "--image_size", "64", "--steps", "2", "--slider", slider, "--device", "cpu",
            "--requests", "8", "--concurrency", "4", "--max_queue", "1", "--batch_window_ms", "0", "--no_microbatch"]
    out = tbench.run(tbench.build_parser().parse_args(argv))
    batcher = services[0]._batcher
    assert "shed_429" not in out and out["value"] > 0
    assert batcher.rejected == 0 and batcher.max_queue == 8 and list(batcher.batch_sizes) == [1] * (4 + 8)


@pytest.fixture(scope="module")
def served(slider):
    """A one-row-per-call service (so a request's image is its solo image)
    behind ``make_handler`` on an ephemeral port."""
    svc = tserve.SliderService("tiny-xl", slider, image_size=64, steps=2, device="cpu", max_batch=1)
    server = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield svc, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(30)
    svc.close()


def test_url_run_gets_pngs_equal_to_generate(served, monkeypatch):
    svc, url = served
    bodies = []
    real = tbench.urlopen

    def recording(u, timeout):
        with real(u, timeout=timeout) as resp:
            body = resp.read()
        bodies.append((u, body))
        return io.BytesIO(body)

    monkeypatch.setattr(tbench, "urlopen", recording)
    argv = ["--url", url, "--requests", "4", "--concurrency", "2"]
    out = tbench.run(tbench.build_parser().parse_args(argv))
    assert out["shed_429"] == 0 and out["value"] > 0 and len(bodies) == 2 + 4
    assert all(body[:8] == b"\x89PNG\r\n\x1a\n" for _, body in bodies)
    u, body = bodies[-1]
    q = {k: v[0] for k, v in parse_qs(urlparse(u).query).items()}
    assert q["prompt"] in tbench.PROMPTS
    want = svc.generate(q["prompt"], float(q["scale"]), int(q["seed"]), float(q["guidance"]))
    assert body == want
    monkeypatch.undo()
    assert _key_set(out) == _key_set(jbench.run(jbench.build_parser().parse_args(argv)))


def test_sites_and_lora_params_follow_the_default_registration(served, tmp_path):
    svc, _ = served
    sites, params, _ = svc._sliders["default"]
    assert svc.sites is sites and svc.lora_params is params
    other = {n: {k: v + 0.5 for k, v in leaf.items()} for n, leaf in params.items()}
    path = str(tmp_path / "other_bench_slider.safetensors")
    tlora.save_weights(path, sites, other)
    svc.add_slider("default", path)
    assert svc.lora_params is svc._sliders["default"][1] and svc.lora_params is not params
    assert [s.lora_name for s in svc.sites] == [s.lora_name for s in sites]
    for name, leaf in other.items():
        for k, v in leaf.items():
            np.testing.assert_array_equal(svc.lora_params[name][k].cpu().numpy(), v.numpy())
