"""The multi-slider serving surface of the port, on a tiny-xl service on the
CPU (the JAX ``_SliderRegistry`` semantics; the stacked numerics against JAX
are in tests/test_torch_stacked.py).

The service runs fp32 weights (see ``FP32Service``). Sliders: ``a`` (noxattn, rank 4, α 1), ``b`` (noxattn, rank 1, α 4: the stack
pads the rank axis), ``x`` (xattn: a site set that does not stack with ``a``
or ``b``) and ``te`` (a ``cli/combine_loras.py`` file: ``a``'s UNet part and
random parts for both CLIP towers).

* concurrent ``a`` + ``b`` ride one stacked sampler call, each image within
  2/255 of its solo image; ``a`` + ``x`` take two calls; so does ``a`` + ``b``
  with stacking off (``--no_stack``);
* ``te`` at scale 0 is ``a`` at scale 0, bit for bit; at +2 it differs from
  ``a`` at +2;
* ``--static_guidance 1.0``: requests with different guidances share one
  cond-only call; ``--no_microbatch`` (``--max_batch 1``) serves one request
  per call, on the batcher's one worker thread;
* the registry: ``max_sliders`` evicts the least recently used slider and
  keeps ``default``; ``remove_slider``; the stack cache's invalidation, LRU
  bound and generation counter; a stacking failure printed once, and a
  failing group poisoning only its own rows;
* ``POST /sliders``, ``DELETE /sliders/<name>`` and ``GET /metrics`` through
  ``make_handler``.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from sliders_conceptmod_tpu_torch import serve as tserve
from sliders_conceptmod_tpu_torch.adapters import lora as tlora
from sliders_conceptmod_tpu_torch.adapters import slider_file as tsfile
from sliders_conceptmod_tpu_torch.cli import combine_loras as tcombine
from sliders_conceptmod_tpu_torch.io.png import decode_png
from sliders_conceptmod_tpu_torch.models import unet as tunet
from sliders_conceptmod_tpu_torch.serve import SliderService, make_handler
from _torch_threads import share_cores_among_workers  # noqa: F401 (autouse: torch's share of the cores)

CONV = tlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER + tlora.UNET_TARGET_REPLACE_MODULE_CONV
PROMPT = "a photo of a person"


def _unet_slider(path, method, rank, alpha, seed):
    with torch.device("meta"):
        meta = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny_xl())
    targets = CONV if method != "xattn" else tlora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER
    sites = tlora.create_sites(meta, rank=rank, alpha=alpha, target_replace=targets, train_method=method)
    g = torch.Generator().manual_seed(seed)
    lp = tlora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.5
    tlora.save_weights(str(path), sites, lp)
    return str(path)


def _te_part(path, encoder, index, seed):
    sites = tlora.create_sites(encoder, rank=2, alpha=1.0, target_replace=["CLIPAttention"],
                               prefix=f"lora_te{index + 1}", train_method="full",
                               name_path_prefix=tsfile.CLIP_NAME_PATH_PREFIX)
    g = torch.Generator().manual_seed(seed)
    lp = tlora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.5
    tlora.save_weights(str(path), sites, lp)
    return str(path)


class FP32Service(SliderService):
    """The service in fp32 weights: a stacked row against its solo row then
    differs by the stack's arithmetic alone (fp32 sums in another order), not
    by bf16 roundings it flips, which the card's bf16 run bounds
    (``chip_smoke.py``'s serve_sliders phase)."""

    weight_dtype = torch.float32


@pytest.fixture(scope="module")
def svc(tmp_path_factory):
    root = tmp_path_factory.mktemp("sliders")
    paths = {"a": _unet_slider(root / "a_noxattn_rank4_alpha1.safetensors", "noxattn", 4, 1.0, 0),
             "b": _unet_slider(root / "b_noxattn.safetensors", "noxattn", 1, 4.0, 1),
             "x": _unet_slider(root / "x_xattn_full.safetensors", "xattn", 2, 1.0, 2)}  # "full": the name rule
    service = FP32Service("tiny-xl", paths["a"], image_size=64, steps=3, device="cpu", batch_window_ms=300.0)
    te1 = _te_part(root / "te1.safetensors", service.text_encoders[0].model, 0, 3)
    te2 = _te_part(root / "te2.safetensors", service.text_encoders[1].model, 1, 4)
    paths["te"] = str(root / "te_noxattn_rank4_alpha1.safetensors")
    tcombine.main([paths["a"], te1, te2, paths["te"], "1.0", "1.0", "1.0"])
    for name in ("a", "b", "x", "te"):
        service.add_slider(name, paths[name])
    service.paths = paths
    yield service
    service.close()


@pytest.fixture
def calls(svc, monkeypatch):
    """Each sampler call's (rows, adapter_idx, worker thread) while the test runs."""
    seen = []
    real = svc._sample_group

    def spy(padded, guidance, entry, adapter_idx=None):
        seen.append((len(padded), adapter_idx, threading.current_thread().name))
        return real(padded, guidance, entry, adapter_idx=adapter_idx)

    monkeypatch.setattr(svc, "_sample_group", spy)
    return seen


def _concurrent(svc, reqs):
    """``generate(*req)`` for every request at once → decoded images (or the exception)."""
    out = {}

    def client(i, req):
        try:
            out[i] = decode_png(svc.generate(*req))
        except Exception as e:  # noqa: BLE001 — the caller checks
            out[i] = e

    threads = [threading.Thread(target=client, args=(i, r)) for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    return [out[i] for i in range(len(reqs))]


def _solo(svc, req):
    return decode_png(svc.generate(*req))


def test_stacked_pair_rides_one_call_and_matches_its_solo_images(svc, calls):
    reqs = [(PROMPT, 1.5, 3, 7.5, "a"), (PROMPT, -2.0, 4, 7.5, "b")]
    solo = [_solo(svc, r) for r in reqs]
    assert [c[1] for c in calls] == [None, None]
    calls.clear()
    stacked = _concurrent(svc, reqs)
    assert len(calls) == 1 and calls[0][:2] == (2, [0, 1])  # one call, rows routed to a and b
    assert svc.stacked_combos_cached() >= 1
    for got, want in zip(stacked, solo):
        gap = np.abs(got.astype(int) - want.astype(int))
        assert gap.max() <= 2, (gap.max(), gap.mean())
    assert not np.array_equal(stacked[0], stacked[1])


def test_incompatible_and_unstacked_pairs_take_one_call_per_slider(svc, calls, monkeypatch):
    _concurrent(svc, [(PROMPT, 1.0, 3, 7.5, "a"), (PROMPT, 1.0, 3, 7.5, "x")])
    assert sorted(c[1] is None for c in calls) == [True, True] and len(calls) == 2
    assert svc._stack_cache[("a", "x")] is None  # cached as "does not stack"
    calls.clear()
    monkeypatch.setattr(svc, "_stack_enabled", False)  # --no_stack
    _concurrent(svc, [(PROMPT, 1.0, 3, 7.5, "a"), (PROMPT, 1.0, 3, 7.5, "b")])
    assert len(calls) == 2 and all(c[1] is None for c in calls)


def test_te_slider_is_its_unet_part_at_zero_and_differs_at_two(svc):
    assert {e["name"]: e["te"] for e in svc.list_sliders()}["te"] is True
    np.testing.assert_array_equal(_solo(svc, (PROMPT, 0.0, 5, 7.5, "te")), _solo(svc, (PROMPT, 0.0, 5, 7.5, "a")))
    te2, a2 = _solo(svc, (PROMPT, 2.0, 5, 7.5, "te")), _solo(svc, (PROMPT, 2.0, 5, 7.5, "a"))
    assert np.abs(te2.astype(int) - a2.astype(int)).max() > 2


def test_static_guidance_groups_guidances_into_one_cond_only_call(svc, calls, monkeypatch):
    rows = []
    hook = svc.unet.register_forward_pre_hook(lambda m, args: rows.append(args[0].shape[0]))
    try:
        monkeypatch.setattr(svc, "_static_guidance", 1.0)
        _concurrent(svc, [(PROMPT, 1.0, 3, 3.0, "a"), (PROMPT, -1.0, 3, 9.0, "a")])
    finally:
        hook.remove()
    assert len(calls) == 1 and calls[0][0] == 2
    assert rows == [2, 2, 2]  # cond-only: one row per request, no uncond half
    args = tserve.build_parser().parse_args(["--slider", "s", "--static_guidance", "1.0", "--no_stack",
                                             "--max_sliders", "3", "--no_microbatch"])
    cls, kwargs = tserve.service_settings(args)
    assert cls is SliderService and kwargs["static_guidance"] == 1.0 and kwargs["max_batch"] == 1
    assert kwargs["cross_slider_stack"] is False and kwargs["max_sliders"] == 3
    with pytest.raises(SystemExit, match="static_guidance applies to CFG families"):  # JAX's refusal
        tserve.service_settings(tserve.build_parser().parse_args(["--slider", "s", "--family", "flux",
                                                                  "--static_guidance", "1"]))


def test_no_microbatch_serves_one_request_per_call_on_the_worker(svc, calls, monkeypatch):
    batcher = tserve.MicroBatcher(svc._generate_batch, max_batch=1, window_ms=300.0)
    monkeypatch.setattr(svc, "_batcher", batcher)
    try:
        _concurrent(svc, [(PROMPT, 1.0, 3, 7.5, "a"), (PROMPT, 2.0, 3, 7.5, "a")])
    finally:
        batcher.close()
    assert len(calls) == 2 and all(c[0] == 1 for c in calls)
    assert {c[2] for c in calls} == {"microbatcher"}  # never an HTTP thread
    assert batcher.total_batches == 2 and list(batcher.batch_sizes) == [1, 1]


def test_registry_eviction_removal_and_the_stack_cache(svc, monkeypatch, capsys):
    path = svc.paths["b"]
    monkeypatch.setattr(svc, "max_sliders", None)
    for i in range(7):  # 21 stackable pairs, past the cache bound
        svc.add_slider(f"s{i}", path)
    pairs = [(f"s{i}", f"s{j}") for i in range(7) for j in range(i + 1, 7)]
    for p in pairs[:17]:
        assert svc._stacked_entry(p) is not None
    assert len(svc._stack_cache) == svc._STACK_CACHE_MAX == 16 and pairs[0] not in svc._stack_cache
    svc.add_slider("s0", path)  # any registry change clears the cache
    assert not svc._stack_cache

    real_stack = tlora.stack_adapters

    def stack_during_a_change(entries, pad_to=0):
        svc.add_slider("s6", path)  # a registry change lands while the stack is built
        return real_stack(entries, pad_to=pad_to)

    monkeypatch.setattr(tlora, "stack_adapters", stack_during_a_change)
    assert svc._stacked_entry(("s1", "s2")) is not None  # served once, never cached
    assert ("s1", "s2") not in svc._stack_cache
    monkeypatch.setattr(tlora, "stack_adapters", real_stack)
    for i in range(7):
        svc.remove_slider(f"s{i}")

    with pytest.raises(ValueError, match="pinned"):
        svc.remove_slider("default")
    with pytest.raises(KeyError):
        svc.remove_slider("missing")
    # max_sliders: registering past it evicts the least recently used, never default
    monkeypatch.setattr(svc, "max_sliders", 6)
    svc._resolve("a"), svc._resolve("x"), svc._resolve("te"), svc._resolve("b")  # LRU order: default, a, x, te, b
    svc.add_slider("c", path)
    names = [e["name"] for e in svc.list_sliders()]
    assert names == ["default", "a", "x", "te", "b", "c"]
    svc.add_slider("d", path)
    assert [e["name"] for e in svc.list_sliders()] == ["default", "x", "te", "b", "c", "d"]  # a evicted
    for n in ("c", "d"):
        svc.remove_slider(n)
    svc.add_slider("a", svc.paths["a"])

    # a stacking failure other than a vanished name: printed once, per-slider groups serve
    def boom(entries, pad_to=0):
        raise RuntimeError("stack failed")

    monkeypatch.setattr(tlora, "stack_adapters", boom)
    for _ in range(2):
        imgs = _concurrent(svc, [(PROMPT, 1.0, 3, 7.5, "a"), (PROMPT, 1.0, 3, 7.5, "b")])
        assert all(isinstance(i, np.ndarray) for i in imgs)
    assert capsys.readouterr().out.count("cross-slider stacking failed") == 1


def test_a_failing_group_poisons_only_its_rows(svc, monkeypatch):
    real = svc._sample_group

    def fail_for_x(padded, guidance, entry, adapter_idx=None):
        if padded[0][4] == "x":
            raise RuntimeError("x failed")
        return real(padded, guidance, entry, adapter_idx=adapter_idx)

    monkeypatch.setattr(svc, "_sample_group", fail_for_x)
    good, bad = _concurrent(svc, [(PROMPT, 1.0, 3, 7.5, "a"), (PROMPT, 1.0, 3, 7.5, "x")])
    assert isinstance(good, np.ndarray) and isinstance(bad, RuntimeError)


def test_http_sliders_and_metrics(svc):
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def call(method, path, body=None):
        req = urllib.request.Request(f"{base}{path}", method=method,
                                     data=None if body is None else json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        code, body = call("POST", "/sliders", {"name": "posted", "path": svc.paths["b"]})
        assert code == 200 and "posted" in [s["name"] for s in body["sliders"]]
        assert call("POST", "/sliders", {"name": "bad"})[0] == 400
        assert call("POST", "/sliders", {"name": "bad", "path": "/no/such.safetensors"})[0] == 400
        code, body = call("DELETE", "/sliders/posted")
        assert code == 200 and "posted" not in [s["name"] for s in body["sliders"]]
        assert call("DELETE", "/sliders/posted")[0] == 404
        assert call("DELETE", "/sliders/default")[0] == 400
        code, m = call("GET", "/metrics")
        assert code == 200 and set(m) == {
            "sliders", "stacked_combos_cached", "microbatch", "total_batches", "total_rows", "mean_batch",
            "max_batch", "queue_depth", "max_queue", "p50_seconds", "p99_seconds", "rejected", "errored",
            "error_rate"}
        assert m["sliders"] == len(svc.list_sliders()) and m["microbatch"] is True and m["total_batches"] > 0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def test_registry_holds_its_invariants_under_concurrent_changes(svc, monkeypatch):
    """16 threads (more than the host's cores) register, remove, resolve and
    stack sliders at once, the interpreter switching threads every 10 µs: the
    bound, the pinned default, and no text-encoder entry or cached stack that
    outlives its slider."""
    import sys

    monkeypatch.setattr(svc, "max_sliders", 6)
    paths = [svc.paths["b"], svc.paths["te"]]
    errors = []

    def worker(w):
        try:
            for i in range(3):
                name = f"w{(w + i) % 5}"
                svc.add_slider(name, paths[(w + i) % 2])
                for op in (lambda: svc._stacked_entry(tuple(sorted({name, "default"}))),
                           lambda: svc.remove_slider(name), lambda: svc._resolve(name)):
                    try:
                        op()
                    except KeyError:  # another thread removed or evicted it first
                        pass
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    names = [e["name"] for e in svc.list_sliders()]
    assert len(names) <= 6 and "default" in names
    assert set(svc._te) <= set(names)
    assert all(set(combo) <= set(names) for combo in svc._stack_cache)
    for n in names:
        if n.startswith("w"):
            svc.remove_slider(n)
    monkeypatch.setattr(svc, "max_sliders", None)
    for n in ("a", "b", "x", "te"):  # the ones the bound evicted
        if n not in names:
            svc.add_slider(n, svc.paths[n])
