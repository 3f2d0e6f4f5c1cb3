"""Load-bench the slider service: concurrent request throughput and latency
— counterpart of ``sliders_conceptmod_tpu/cli/bench_serve.py``.

Fires ``--requests`` generations from ``--concurrency`` client threads at an
in-process service (default) or an already-running server (``--url``), and
prints ONE JSON line with request throughput, latency percentiles, and the
micro-batcher's observed batch sizes, queue depth and sheds — the numbers
that show whether concurrent load rides the batched sampler call. The line's
keys are the JAX tool's for the same flags.

The warm-up sends ``min(concurrency, requests)`` requests through the client
pool before the timed window: on the card it pays the attention kernels'
first ``nvcc`` build and each shape's first-call costs (cuBLAS's and cuDNN's
plan choice) outside it. The service pads a micro-batch to a bucket of 1, 2
or 4 rows, and each bucket pays those costs at its first use; the warm-up
reaches only the buckets up to ``--concurrency``.

``--slider synth`` synthesizes a random rank-4, α 1 slider for ``--base``
(its family from ``--family`` or the name, ``serve.py::detect_family``):
the sites come from the denoiser on the meta device
(``models/factory.py::denoiser_on_meta``), so only the small LoRA factors
are made, on the CPU, and the base loads once, in the service. The file
lives in a temporary directory for the run. ``--no_microbatch`` is
``--max_batch 1`` on the batcher's one worker (the port's services always
run it; ``serve.py --no_microbatch`` is the same) with a queue bound of at
least ``--requests``, so that it sheds nothing, as JAX's path without a
batcher cannot; the line then omits the batcher's keys, as JAX's does. ``--num_sliders N`` registers N-1 more
sliders made from the first and sends requests round-robin over them;
compatible sliders stack into one sampler call, ``--no_stack`` splits them
(the A/B control). A shed (the bounded queue's ``QueueFullError``, HTTP
429) is counted, never a failure.

  # in-process, tiny smoke (CPU):
  python -m sliders_conceptmod_tpu_torch.cli.bench_serve --base tiny-xl --slider synth --device cpu \\
      --image_size 64 --steps 2 --requests 8 --concurrency 4

  # against a running server (serve.py):
  python -m sliders_conceptmod_tpu_torch.cli.bench_serve --url http://localhost:8500 --requests 32 --concurrency 4
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from urllib.error import HTTPError
from urllib.parse import quote
from urllib.request import urlopen

import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.core.device import torch_device
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.serve import (
    FluxSliderService,
    QueueFullError,
    SD1SliderService,
    SD3SliderService,
    SliderService,
    detect_family,
)

PROMPTS = ["a photo of a person", "a photo of a car", "a photo of a room", "a photo of the sky"]
SCALES = [-2.0, -1.0, 0.0, 1.0, 2.0]
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[i]


def synth_sites(base: str, family: str) -> list:
    """The rank-4, α 1 sites of JAX's synthesized slider over ``base``'s
    denoiser: the attention projections, ``-``-delimited for SD3 and Flux."""
    model = factory.denoiser_on_meta(base, family)
    if family in ("flux", "sd3"):
        return lora_lib.create_sites(model, rank=4, alpha=1.0, target_replace=["Attention"], train_method="full",
                                     delimiter="-")
    return lora_lib.create_sites(model, rank=4, alpha=1.0,
                                 target_replace=lora_lib.UNET_TARGET_REPLACE_MODULE_TRANSFORMER, train_method="full")


def synth_slider(base: str, family: str, path: str) -> str:
    """Write a random slider for ``base`` to ``path``: the factors drawn by
    ``init_lora_params`` from a generator seeded 0, then 0.01 added to every
    one (so ``up`` is non-zero), as JAX's ``run`` makes it."""
    sites = synth_sites(base, family)
    lp = lora_lib.init_lora_params(sites, generator=torch.Generator().manual_seed(0))
    lp = {name: {k: v + 0.01 for k, v in leaf.items()} for name, leaf in lp.items()}
    lora_lib.save_weights(path, sites, lp)
    return path


def make_service(args, slider: str):
    """The family's service over ``slider``, with the bench's batcher flags.
    ``--no_microbatch``: one row per call, and a queue that holds every
    request, so that it cannot shed (JAX's path without a batcher cannot,
    and the line then reports no sheds)."""
    family = args.family or detect_family(args.base)
    cls = {"flux": FluxSliderService, "sd3": SD3SliderService, "sd1": SD1SliderService}.get(family, SliderService)
    max_batch, max_queue = (1, max(args.max_queue, args.requests)) if args.no_microbatch else (args.max_batch,
                                                                                              args.max_queue)
    return cls(args.base, slider, args.image_size, args.steps, batch_window_ms=args.batch_window_ms,
               cross_slider_stack=not args.no_stack, max_batch=max_batch, max_queue=max_queue,
               device=torch_device(args.device))


def add_bench_sliders(service, n: int, tmp: str) -> list:
    """Register ``n - 1`` sliders ``s1 … s{n-1}`` made from the default
    one's factors plus ``0.01·k``; the names requests cycle over."""
    names = ["default"]
    for k in range(1, n):
        lp_k = {name: {key: v + 0.01 * k for key, v in leaf.items()} for name, leaf in service.lora_params.items()}
        path_k = os.path.join(tmp, f"bench_slider{k}.safetensors")
        lora_lib.save_weights(path_k, service.sites, lp_k)
        service.add_slider(f"s{k}", path_k)
        names.append(f"s{k}")
    return names


def run(args):
    """The bench the flags ask for (see the module docstring): prints its one
    JSON line and returns it. An in-process service is closed after."""
    with tempfile.TemporaryDirectory(prefix="bench_serve_") as tmp:
        service = None
        shed = []
        if args.url:
            def one(i):
                p, s = PROMPTS[i % len(PROMPTS)], SCALES[i % len(SCALES)]
                t0 = time.time()
                try:
                    with urlopen(f"{args.url}/generate?prompt={quote(p)}&scale={s}&seed={i}"
                                 f"&guidance={args.guidance}", timeout=600) as resp:
                        body = resp.read()
                except HTTPError as e:
                    if e.code == 429:  # bounded-queue shed: measured, not fatal
                        shed.append(i)
                        return None
                    raise
                if body[:8] != PNG_SIGNATURE:
                    raise ValueError(f"{args.url}: non-PNG response to request {i}")
                return time.time() - t0
        else:
            slider = args.slider
            if slider == "synth":
                slider = synth_slider(args.base, args.family or detect_family(args.base),
                                      os.path.join(tmp, "bench_slider.safetensors"))
            service = make_service(args, slider)
            slider_names = []

            def one(i):
                p, s = PROMPTS[i % len(PROMPTS)], SCALES[i % len(SCALES)]
                t0 = time.time()
                try:
                    png = service.generate(p, scale=s, seed=i, guidance=args.guidance,
                                           slider=slider_names[i % len(slider_names)])
                except QueueFullError:  # bounded-queue backpressure (HTTP 429): a shed, not a failure
                    shed.append(i)
                    return None
                if png[:8] != PNG_SIGNATURE:
                    raise ValueError(f"non-PNG image for request {i}")
                return time.time() - t0
        try:
            if service is not None:
                slider_names.extend(add_bench_sliders(service, args.num_sliders, tmp))
            return _timed(args, one, shed, None if service is None or args.no_microbatch else service._batcher)
        finally:
            if service is not None:
                service.close()


def _timed(args, one, shed: list, batcher):
    """The warm-up, then the timed window over ``range(requests)``; prints
    and returns the JSON line. ``batcher``: the in-process micro-batcher
    whose keys the line reports (None: omitted)."""
    # warm-up: every bucket up to --concurrency and the prompts' encodes, outside the timed window
    with ThreadPoolExecutor(args.concurrency) as pool:
        list(pool.map(one, range(min(args.concurrency, args.requests))))
    shed.clear()  # the warm-up can shed near the queue bound: the rates cover the timed run only
    rejected_before = batcher.rejected if batcher is not None else 0

    # queue depth during the run (overload: growth against bounded shedding)
    depth_samples = []
    stop_sampling = threading.Event()
    sampler_thread = None
    if batcher is not None:
        def _sample_depth():
            while not stop_sampling.is_set():
                depth_samples.append(batcher.queue_depth())
                time.sleep(0.05)

        sampler_thread = threading.Thread(target=_sample_depth, daemon=True)
        sampler_thread.start()

    t0 = time.time()
    with ThreadPoolExecutor(args.concurrency) as pool:
        results = list(pool.map(one, range(args.requests)))
    wall = time.time() - t0
    stop_sampling.set()
    if sampler_thread is not None:
        sampler_thread.join(timeout=1)
    lat = sorted(r for r in results if r is not None)

    completed = len(lat)
    out = {
        "metric": "serve_requests_per_sec",
        "value": round(completed / wall, 4),
        "unit": "req/s",
        "vs_baseline": 0.0,
        "requests": args.requests,
        "concurrency": args.concurrency,
        "p50_s": round(_percentile(lat, 0.50), 3),
        "p95_s": round(_percentile(lat, 0.95), 3),
        "microbatch": not args.no_microbatch and not args.url,
        "num_sliders": args.num_sliders if not args.url else 1,
        "cross_slider_stack": not args.no_stack and not args.url,
    }
    if args.url:
        out["shed_429"] = len(shed)
    if batcher is not None:
        sizes = batcher.batch_sizes
        out["mean_batch"] = round(sum(sizes) / max(len(sizes), 1), 2)
        out["p99_s"] = round(_percentile(lat, 0.99), 3)
        out["shed_429"] = batcher.rejected - rejected_before
        out["max_queue"] = batcher.max_queue
        out["max_queue_depth_seen"] = max(depth_samples, default=0)
        out["completed"] = completed
    print(json.dumps(out))
    return out


def build_parser():
    p = argparse.ArgumentParser(prog="benchServe")
    p.add_argument("--base", default="tiny-xl")
    p.add_argument(
        "--slider", default=None,
        help="slider checkpoint; 'synth' synthesizes a random rank-4 slider "
        "for --base (required unless --url)",
    )
    p.add_argument("--url", default=None, help="bench a running server instead of in-process")
    p.add_argument("--family", choices=["xl", "sd3", "flux", "sd1"], default=None)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--guidance", type=float, default=7.5)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--concurrency", type=int, default=4)
    p.add_argument("--no_microbatch", action="store_true")
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument(
        "--max_queue", type=int, default=64,
        help="bounded admission (serve --max_queue): overload sheds instead "
        "of queueing unboundedly; sheds are counted, not failures",
    )
    p.add_argument(
        "--no_stack", action="store_true",
        help="disable cross-slider stacked batching (per-slider groups — "
        "the A/B control for --num_sliders runs)",
    )
    p.add_argument("--batch_window_ms", type=float, default=8.0)
    p.add_argument(
        "--num_sliders", type=int, default=1,
        help="in-process only: register N sliders (N-1 synthesized from the "
        "first) and round-robin requests across them — the published-"
        "collection traffic shape; compatible adapters stack into one "
        "batched call (S-LoRA-style cross-slider batching)",
    )
    p.add_argument("--device", default="cuda", help="in-process only: the service's device (a CUDA ordinal or 'cpu')")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.url and not args.slider:
        raise SystemExit("--slider is required for in-process mode")
    return run(args)


if __name__ == "__main__":
    main()
