"""Slider serving on the GPU, SDXL and SD1.x/SD2.x — counterpart of
``sliders_conceptmod_tpu/serve.py``.

Models load once (bf16 weights, resident on the device); each request pays
the prompt encode (cached per prompt) and one batched DDIM trajectory with
the slider applied through the per-row LoRA overlay, then a VAE decode and a
PNG encode. Concurrent requests that arrive within a short window share one
sampler call (:class:`MicroBatcher`), padded to a {1, 2, 4} bucket.

  python -m sliders_conceptmod_tpu_torch.serve --slider s.safetensors --port 8500
  python -m sliders_conceptmod_tpu_torch.serve --base path/to/sd15 --family sd1 --slider s.safetensors

``--family`` (xl or sd1) is read off ``--base`` when omitted
(:func:`detect_family`); ``--base`` is a family name, a diffusers directory or
a single checkpoint file. :class:`SliderService` serves SDXL (both CLIP
towers, 25 DDIM steps by default), :class:`SD1SliderService` SD1.x/SD2.x (one
tower, no added conditioning, 50 steps; ``--v2``, ``--v_pred``).

  curl -s 'localhost:8500/generate?prompt=a+photo+of+a+person&scale=1.5&seed=7' > out.png
  curl -s localhost:8500/healthz
  curl -s localhost:8500/sliders

GET /generate params: prompt (required), scale (default 0), seed (default
0), guidance (default 7.5), slider (default "default"). A seed reproduces the
port's image for that request whatever it is batched with; it does not
reproduce the JAX package's images (the two draw different noise).
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters.slider_file import load_slider_file
from sliders_conceptmod_tpu_torch.cli.generate_images_xl import (  # noqa: F401 — re-exported, as JAX's serve has them
    infer_network_settings,
    load_prompts_csv,
    settings_from_checkpoint,
    settings_from_tensors,
    unet_slider,
)
from sliders_conceptmod_tpu_torch.diffusion.sampling import get_add_time_ids
from sliders_conceptmod_tpu_torch.infer.generate import (
    flip_step_for_start_noise,
    latents_to_images,
    sample_loop_scales,
)
from sliders_conceptmod_tpu_torch.io.png import encode_png
from sliders_conceptmod_tpu_torch.models import factory


class QueueFullError(Exception):
    """Backpressure: the micro-batcher's bounded queue is full; the caller
    should shed the request (HTTP 429)."""


class MicroBatcher:
    """Concurrent requests that arrive within ``window_ms`` of the first ride
    one ``run_batch(items) -> results`` call (at most ``max_batch`` items).

    A result item may be an ``Exception``, raised only for its own caller; if
    ``run_batch`` itself raises, every waiting caller gets the exception.
    ``max_queue`` bounds admission (:class:`QueueFullError`)."""

    def __init__(self, run_batch, max_batch: int = 4, window_ms: float = 8.0, max_queue: int = 64):
        self._q: "queue.Queue" = queue.Queue()
        self._run = run_batch
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.window = float(window_ms) / 1000.0
        self.batch_sizes: "collections.deque" = collections.deque(maxlen=2048)
        self.latencies: "collections.deque" = collections.deque(maxlen=2048)
        self.total_batches = 0
        self.total_rows = 0
        self.rejected = 0
        self.errored = 0
        self._stats_lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True, name="microbatcher")
        self._thread.start()

    def queue_depth(self) -> int:
        return self._q.qsize()

    def submit(self, item):
        fut: Future = Future()
        t0 = time.time()
        with self._stats_lock:
            if self._q.qsize() >= self.max_queue:
                self.rejected += 1
                raise QueueFullError(f"micro-batch queue full ({self.max_queue} waiting) — retry later")
            self._q.put((item, fut))
        try:
            res = fut.result()
        except Exception:
            with self._stats_lock:
                self.errored += 1
                self.latencies.append(time.time() - t0)
            raise
        with self._stats_lock:
            self.latencies.append(time.time() - t0)
        return res

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker after the batches already queued."""
        self._q.put(None)
        self._thread.join(timeout)

    def _worker(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            stop = False
            deadline = time.time() + self.window
            while len(batch) < self.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            with self._stats_lock:
                self.batch_sizes.append(len(batch))
                self.total_batches += 1
                self.total_rows += len(batch)
            try:
                results = self._run([item for item, _ in batch])
                for (_, fut), res in zip(batch, results):
                    if isinstance(res, Exception):
                        fut.set_exception(res)
                    else:
                        fut.set_result(res)
            except Exception as e:  # noqa: BLE001 — fan out to all waiters
                for _, fut in batch:
                    fut.set_exception(e)
            if stop:
                return


class SliderService:
    """SDXL slider serving: bf16 weights, DDIM, the slider through the per-row
    LoRA overlay gated off while ``t > start_noise``, a registry of sliders
    over one loaded base, and micro-batched requests. A subclass loads
    another family (:meth:`_load`) and encodes its way (:meth:`_encode_impl`,
    :meth:`_conditioning`); the registry, the batcher and the sampler call are
    shared."""

    _BUCKETS = (1, 2, 4)
    weight_dtype = torch.bfloat16  # the weights' and the sampled latents' dtype

    def __init__(self, base: str, slider_path: str, image_size: int = 512, steps: int = 25,
                 start_noise: float = 750, batch_window_ms: float = 8.0,
                 max_batch: int = 4, max_queue: int = 64, device: str = "cuda"):
        t0 = time.time()
        self.device = torch.device(device)
        self.image_size = image_size
        self.steps = steps
        self._load(base)
        self.schedule = self.scheduler.set_timesteps(steps)
        self.flip = flip_step_for_start_noise(self.schedule, start_noise)
        self._sliders: "collections.OrderedDict" = collections.OrderedDict()
        self._registry_lock = threading.Lock()
        # per-instance cache: a class-level lru_cache would pin every service
        self._encode = functools.lru_cache(maxsize=256)(self._encode_impl)
        self.add_slider("default", slider_path)
        # every sampler call runs on the batcher's one worker thread: the
        # overlay hooks live on the shared UNet, so calls must not overlap
        self._batcher = MicroBatcher(
            self._generate_batch, max_batch=max_batch, window_ms=batch_window_ms, max_queue=max_queue
        )
        self.load_seconds = time.time() - t0

    def _load(self, base: str) -> None:
        (self.tokenizers, self.text_encoders, self.unet, self.scheduler, self.vae) = factory.load_models_xl(
            base, scheduler_name="ddim", weight_dtype=self.weight_dtype, with_vae=True, device=self.device
        )

    # -- slider registry -----------------------------------------------------

    def add_slider(self, name: str, slider_path: str) -> None:
        """Register (or replace) a UNet slider checkpoint under ``name``."""
        parts = load_slider_file(slider_path)
        if parts.unet is None:
            raise ValueError(f"{slider_path} carries no unet slider part")
        sites, lora_params = unet_slider(self.unet, str(slider_path), parts.unet, device=self.device)
        overlay = lora_lib.LoRAOverlay(self.unet, sites, lora_params)
        with self._registry_lock:
            self._sliders[name] = (sites, lora_params, overlay)
            self._sliders.move_to_end(name)

    def _resolve(self, name: str):
        with self._registry_lock:
            if name not in self._sliders:
                raise KeyError(f"unknown slider {name!r} (loaded: {sorted(self._sliders)})")
            self._sliders.move_to_end(name)
            return self._sliders[name]

    def list_sliders(self) -> list:
        with self._registry_lock:
            return [{"name": n, "sites": len(entry[0])} for n, entry in self._sliders.items()]

    @property
    def sites(self):
        return self._sliders["default"][0]

    # -- requests --------------------------------------------------------------

    def generate(self, prompt: str, scale: float, seed: int, guidance: float, slider: str = "default") -> bytes:
        """One request → PNG bytes, through the micro-batcher (``max_batch=1``
        serves one request per sampler call)."""
        self._resolve(slider)  # fail fast on unknown names (KeyError)
        return self._batcher.submit((prompt, float(scale), int(seed), float(guidance), slider))

    def close(self) -> None:
        self._batcher.close()

    def _bucket_for(self, n: int) -> int:
        if n <= self._BUCKETS[-1]:
            return next(b for b in self._BUCKETS if b >= n)
        return n

    def _generate_batch(self, reqs) -> list:
        """Group by (guidance, slider), pad each group to a bucket, run one
        sampler call per group, PNG-encode, and route results back by request
        index. A failing group poisons only its own requests: their result is
        the exception."""
        groups: dict = {}
        for i, r in enumerate(reqs):
            groups.setdefault((r[3], r[4]), []).append((i, r))
        out: dict = {}
        for (guidance, slider), rows in groups.items():
            try:
                entry = self._resolve(slider)
                n = len(rows)
                padded = [r for _, r in rows] + [rows[-1][1]] * (self._bucket_for(n) - n)
                imgs = self._sample_group(padded, guidance, entry)
                for (i, _), img in zip(rows, imgs[:n]):
                    out[i] = encode_png(img)
            except Exception as e:  # noqa: BLE001 — contain to this group
                for i, _ in rows:
                    out[i] = e
        return [out[i] for i in range(len(reqs))]

    def _encode_impl(self, prompt: str):
        return factory.encode_prompts_xl(self.text_encoders, [prompt])

    def _conditioning(self, padded):
        """(embeddings [2B] uncond ++ cond, added conditioning) of a group."""
        bucket = len(padded)
        text_u, pooled_u = self._encode("")
        conds = [self._encode(r[0]) for r in padded]
        emb = torch.cat([text_u.expand(bucket, -1, -1)] + [t for t, _ in conds])
        added = {
            "text_embeds": torch.cat([pooled_u.expand(bucket, -1)] + [p for _, p in conds]),
            "time_ids": torch.from_numpy(get_add_time_ids(self.image_size, self.image_size))
            .to(self.device)
            .expand(2 * bucket, -1),
        }
        return emb, added

    def _initial_latents(self, gens) -> torch.Tensor:
        """Each row's N(0, 1) draw from its own generator, fp32."""
        res = self.image_size // 8
        return torch.cat(
            [torch.randn((1, 4, res, res), generator=g, device=self.device, dtype=torch.float32) for g in gens]
        )

    @torch.inference_mode()
    def _sample_group(self, padded, guidance: float, entry):
        sites, lora_params, overlay = entry
        dev = self.device
        emb, added = self._conditioning(padded)
        # one generator per row from its request's seed: the row's initial
        # latents (and any stochastic-scheduler noise) depend only on its seed
        gens = [torch.Generator(device=dev).manual_seed(r[2]) for r in padded]
        latents = self._initial_latents(gens) * self.schedule.init_noise_sigma
        scales = torch.tensor([r[1] for r in padded], dtype=torch.float32, device=dev)
        final = sample_loop_scales(
            self.unet, sites, lora_params, scales, self.flip, self.scheduler, self.schedule,
            latents.to(self.weight_dtype), emb, added_cond_kwargs=added,
            # a tensor guidance: CFG for every value, as the JAX service's
            # traced guidance
            guidance_scale=torch.tensor(guidance, dtype=torch.float32, device=dev),
            generators=gens, overlay=overlay,
        )
        return latents_to_images(self.vae.decode, final, self.vae.config.scaling_factor)


class SD1SliderService(SliderService):
    """SD1.x/SD2.x slider serving: one CLIP tower (its final hidden state), no
    added conditioning, DDIM with 50 steps by default and ``start_noise``
    750; ``v2`` loads SD2.x (the OpenCLIP tower and SD2.1's UNet widths from a
    family name or a single file), ``v_pred`` samples with v-prediction. The
    registry, the micro-batcher and the per-request generators are
    :class:`SliderService`'s."""

    def __init__(self, base: str, slider_path: str, image_size: int = 512, steps: int = 50,
                 start_noise: float = 750, batch_window_ms: float = 8.0, max_batch: int = 4,
                 max_queue: int = 64, v2: bool = False, v_pred: bool = False, device: str = "cuda"):
        self.v2, self.v_pred = v2, v_pred
        super().__init__(base, slider_path, image_size, steps, start_noise, batch_window_ms=batch_window_ms,
                         max_batch=max_batch, max_queue=max_queue, device=device)

    def _load(self, base: str) -> None:
        tok, te, self.unet, self.scheduler, self.vae = factory.load_models(
            base, scheduler_name="ddim", v2=self.v2, v_pred=self.v_pred, weight_dtype=self.weight_dtype,
            with_vae=True, device=self.device,
        )
        self.tokenizers, self.text_encoders = [tok], [te]

    def _encode_impl(self, prompt: str):
        return factory.encode_prompts(self.text_encoders[0], [prompt])

    def _conditioning(self, padded):
        conds = [self._encode(r[0]) for r in padded]
        return torch.cat([self._encode("").expand(len(padded), -1, -1)] + conds), None


def detect_family(base: str) -> str:
    """The family of a ``--base`` from its name (the JAX ``detect_family``):
    flux, sd3, sd1 (SD1.x and SD2.x names) or xl."""
    base_l = str(base).lower()
    if "flux" in base_l:
        return "flux"
    if "sd3" in base_l or "stable-diffusion-3" in base_l:
        return "sd3"
    if any(tag in base_l for tag in ("sd1", "v1-4", "v1-5", "stable-diffusion-v1", "sd2", "v2-1",
                                     "stable-diffusion-2")):
        return "sd1"
    return "xl"


def make_handler(service: SliderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print(f"[serve] {fmt % args}")

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "load_seconds": round(service.load_seconds, 1),
                    "sliders": sorted(e["name"] for e in service.list_sliders()),
                })
                return
            if url.path == "/sliders":
                self._json(200, {"sliders": service.list_sliders()})
                return
            if url.path != "/generate":
                self._json(404, {"error": f"no route {url.path}"})
                return
            q = parse_qs(url.query)
            prompt = q.get("prompt", [None])[0]
            if not prompt:
                self._json(400, {"error": "prompt required"})
                return
            try:
                scale = float(q.get("scale", ["0"])[0])
                seed = int(q.get("seed", ["0"])[0])
                guidance = float(q.get("guidance", ["7.5"])[0])
            except ValueError:
                self._json(400, {"error": "bad numeric parameter"})
                return
            slider = q.get("slider", ["default"])[0]
            t0 = time.time()
            try:
                png = service.generate(prompt, scale, seed, guidance, slider=slider)
            except QueueFullError as e:
                self.send_response(429)
                self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(json.dumps({"error": str(e)}).encode())
                return
            except KeyError as e:
                self._json(400, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            self.send_header("X-Generate-Seconds", f"{time.time() - t0:.3f}")
            self.end_headers()
            self.wfile.write(png)

    return Handler


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--base", default="stabilityai/stable-diffusion-xl-base-1.0")
    ap.add_argument("--slider", required=True)
    ap.add_argument("--add_slider", action="append", default=[], metavar="NAME=PATH",
                    help="register extra sliders over the same base (repeatable)")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--image_size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=None, help="default 25 (xl) / 50 (sd1)")
    ap.add_argument("--start_noise", type=float, default=None, help="default 750")
    ap.add_argument("--family", choices=["xl", "sd3", "flux", "sd1"], default=None,
                    help="read off --base when omitted")
    ap.add_argument("--v2", action="store_true", help="sd1 family only: SD2.x base (OpenCLIP tower, SD2.1 widths)")
    ap.add_argument("--v_pred", action="store_true", help="sd1 family only: v-prediction scheduler")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch_window_ms", type=float, default=8.0)
    ap.add_argument("--max_batch", type=int, default=4, help="1 serves one request per sampler call")
    ap.add_argument("--max_queue", type=int, default=64)
    return ap


def service_settings(args):
    """(service class, keyword arguments) for parsed ``main`` arguments: the
    family (``--family`` or :func:`detect_family`) and its step and
    ``start_noise`` defaults. SD3 and Flux are not ported yet."""
    family = args.family or detect_family(args.base)
    if family in ("sd3", "flux"):
        raise SystemExit(f"--family {family}: SD3 and Flux serving are not ported yet (ROADMAP.md queue 1, item 9)")
    kwargs = dict(image_size=args.image_size, start_noise=750 if args.start_noise is None else args.start_noise,
                  batch_window_ms=args.batch_window_ms, max_batch=args.max_batch, max_queue=args.max_queue,
                  device=args.device)
    if family == "sd1":
        return SD1SliderService, dict(kwargs, steps=50 if args.steps is None else args.steps, v2=args.v2,
                                      v_pred=args.v_pred)
    return SliderService, dict(kwargs, steps=25 if args.steps is None else args.steps)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    cls, kwargs = service_settings(args)
    service = cls(args.base, args.slider, **kwargs)
    for spec in args.add_slider:
        name, _, path = spec.partition("=")
        if not path:
            ap.error(f"--add_slider takes NAME=PATH, got {spec!r}")
        service.add_slider(name, path)
    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(service))
    print(f"slider server on :{args.port} (models loaded in {service.load_seconds:.1f}s)")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
