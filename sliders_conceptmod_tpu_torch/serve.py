"""Slider serving on the GPU, SDXL, SD1.x/SD2.x, SD3 and Flux — counterpart of
``sliders_conceptmod_tpu/serve.py``.

Models load once (bf16 weights, resident on the device); each request pays
the prompt encode (cached per prompt) and one batched DDIM trajectory with
the slider applied through the per-row LoRA overlay, then a VAE decode and a
PNG encode. Concurrent requests that arrive within a short window share one
sampler call (:class:`MicroBatcher`), padded to a {1, 2, 4} bucket.

  python -m sliders_conceptmod_tpu_torch.serve --slider s.safetensors --port 8500
  python -m sliders_conceptmod_tpu_torch.serve --base path/to/sd15 --family sd1 --slider s.safetensors

``--family`` (xl, sd1, sd3 or flux) is read off ``--base`` when omitted
(:func:`detect_family`); ``--base`` is a family name, a diffusers directory or
a single checkpoint file. :class:`SliderService` serves SDXL (both CLIP
towers, 25 DDIM steps by default), :class:`SD1SliderService` SD1.x/SD2.x (one
tower, no added conditioning, 50 steps; ``--v2``, ``--v_pred``),
:class:`SD3SliderService` SD3-Medium (the MMDiT and the flow-Euler sampler,
28 steps; ``-``-delimited sliders), :class:`FluxSliderService` FLUX.1
schnell/dev (the packed-token sampler, 8 un-guided steps, ``start_noise``
800; ``--static_guidance`` is refused, as in JAX).

  curl -s 'localhost:8500/generate?prompt=a+photo+of+a+person&scale=1.5&seed=7' > out.png
  curl -s localhost:8500/healthz
  curl -s localhost:8500/sliders          # LRU order, most recently used last
  curl -s localhost:8500/metrics
  curl -X POST localhost:8500/sliders -d '{"name": "age", "path": "age.safetensors"}'
  curl -X DELETE localhost:8500/sliders/age

Sliders are managed at run time over the loaded base: ``POST /sliders``
registers or replaces one (a UNet part, text-encoder parts, or a
``combine_loras`` file with both), ``DELETE /sliders/<name>`` drops one,
``--max_sliders N`` bounds the registry (least recently used evicted,
``default`` pinned). Concurrent requests for different sliders share one
sampler call when the sliders' site sets stack (``--no_stack`` splits them).
``--static_guidance g`` fixes the guidance (<= 1: cond-only);
``--no_microbatch`` is ``--max_batch 1``. ``--quantize_base`` loads the
UNet's large Linears as int8 (``adapters/quant.py``) and ``--w8a8`` (which
implies it) also quantizes their activations per token; sliders ride the
overlay on the int8 UNet, and text-encoder parts merge into the CLIP towers,
which are never quantized. ``--compilation_cache_dir DIR`` builds the CUDA
kernels into ``DIR`` and reuses them from there
(``utils/debug.py::apply_tpu_runtime_flags``), so a restart skips ``nvcc``.

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
import os
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from sliders_conceptmod_tpu_torch.adapters import lora as lora_lib
from sliders_conceptmod_tpu_torch.adapters import quant
from sliders_conceptmod_tpu_torch.adapters.slider_file import load_slider_file
from sliders_conceptmod_tpu_torch.cli.generate_images_xl import (  # noqa: F401 — re-exported, as JAX's serve has them
    infer_network_settings,
    load_prompts_csv,
    settings_from_checkpoint,
    settings_from_tensors,
    unet_slider,
)
from sliders_conceptmod_tpu_torch.cli.generate_images_sd3 import sd3_slider
from sliders_conceptmod_tpu_torch.diffusion.sampling import get_add_time_ids
from sliders_conceptmod_tpu_torch.infer import generate_flow
from sliders_conceptmod_tpu_torch.infer.generate import (
    flip_step_for_start_noise,
    latents_to_images,
    sample_loop_scales,
)
from sliders_conceptmod_tpu_torch.diffusion.flow_match import calculate_shift
from sliders_conceptmod_tpu_torch.io.png import encode_png
from sliders_conceptmod_tpu_torch.models import factory
from sliders_conceptmod_tpu_torch.models.flux import pack_latents, prepare_latent_image_ids, unpack_latents
from sliders_conceptmod_tpu_torch.utils.debug import apply_tpu_runtime_flags


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
    shared.

    The registry (JAX ``_SliderRegistry``): :meth:`add_slider` registers or
    replaces a slider — a UNet part, text-encoder parts, or both;
    :meth:`remove_slider` drops one; ``max_sliders`` bounds it, evicting the
    least recently used slider (``default`` is pinned). Rows of different
    sliders in one micro-batch ride one sampler call when their site sets
    stack (``adapters/lora.py::stack_adapters``, per-row ``adapter_idx``),
    else one call per slider (``cross_slider_stack=False`` always splits).
    A slider with text-encoder parts encodes its rows' uncond and cond
    prompts through the towers merged at the row's scale. ``static_guidance``
    fixes the guidance for every request: a Python float, so a value <= 1
    takes the sampler's cond-only path and per-request guidances no longer
    split a micro-batch. ``quantize_base``: an int8 UNet; ``w8a8`` (implies
    it): W8A8 on its int8 Linears."""

    _BUCKETS = (1, 2, 4)
    _STACK_CACHE_MAX = 16  # each stack holds fp32 copies of its members' factors
    weight_dtype = torch.bfloat16  # the weights' and the sampled latents' dtype
    te2_is_t5 = False  # Flux: a slider's te2 part binds to T5

    def __init__(self, base: str, slider_path: str, image_size: int = 512, steps: int = 25,
                 start_noise: float = 750, batch_window_ms: float = 8.0,
                 max_batch: int = 4, max_queue: int = 64, max_sliders: Optional[int] = None,
                 cross_slider_stack: bool = True, static_guidance: Optional[float] = None,
                 quantize_base: bool = False, w8a8: bool = False, device: str = "cuda"):
        t0 = time.time()
        self.device = torch.device(device)
        self.image_size = image_size
        self.steps = steps
        self._static_guidance = static_guidance
        self.quantize_base = quantize_base or w8a8
        self._load(base)
        quant.set_act_quant(self.unet, w8a8)
        self.schedule = self._schedule(steps)
        self.flip = self._flip(start_noise)
        self._sliders: "collections.OrderedDict" = collections.OrderedDict()
        self._te: dict = {}  # slider name -> (SliderParts with text-encoder parts, version)
        self._te_version = 0
        self._registry_lock = threading.Lock()
        self.max_sliders = max_sliders
        self._stack_enabled = cross_slider_stack
        # sorted names -> stacked entry, or None where the sites do not stack;
        # cleared on every registry change, and the generation counter keeps
        # a stack built across a change out of the cache
        self._stack_cache: "collections.OrderedDict" = collections.OrderedDict()
        self._registry_generation = 0
        self._stack_warned = False
        # per-instance caches: a class-level lru_cache would pin every service
        self._encode = functools.lru_cache(maxsize=256)(self._encode_impl)
        self._encode_te = functools.lru_cache(maxsize=256)(self._encode_te_impl)
        self.add_slider("default", slider_path)
        # every sampler call runs on the batcher's one worker thread: the
        # overlay hooks live on the shared UNet, so calls must not overlap
        self._batcher = MicroBatcher(
            self._generate_batch, max_batch=max_batch, window_ms=batch_window_ms, max_queue=max_queue
        )
        self.load_seconds = time.time() - t0

    def _load(self, base: str) -> None:
        (self.tokenizers, self.text_encoders, self.unet, self.scheduler, self.vae) = factory.load_models_xl(
            base, scheduler_name="ddim", weight_dtype=self.weight_dtype, with_vae=True, device=self.device,
            quantize_base=self.quantize_base,
        )

    def _schedule(self, steps: int):
        return self.scheduler.set_timesteps(steps)

    def _flip(self, start_noise: float) -> int:
        return flip_step_for_start_noise(self.schedule, start_noise)

    def _text_encoder_modules(self):
        """The towers a slider's text-encoder parts bind to (te1[, te2]), or
        None where there are none to merge into."""
        return [te.model for te in self.text_encoders]

    # -- slider registry -----------------------------------------------------

    def add_slider(self, name: str, slider_path: str) -> None:
        """Register (or replace) a slider file under ``name``: a UNet part,
        text-encoder parts (a notrigger save, a ``combine_loras`` output), or
        both. A text-encoder-only slider has no UNet sites."""
        parts = load_slider_file(slider_path, self._text_encoder_modules(), te2_is_t5=self.te2_is_t5)
        sites, lora_params = [], {}
        if parts.unet is not None:
            sites, lora_params = self._model_slider(str(slider_path), parts.unet)
        elif not parts.has_te:
            raise ValueError(f"{slider_path} carries neither unet nor text-encoder slider parts")
        overlay = lora_lib.LoRAOverlay(self.unet, sites, lora_params)
        with self._registry_lock:
            self._sliders[name] = (sites, lora_params, overlay)
            self._sliders.move_to_end(name)
            if parts.has_te:  # a new version: no cached embedding of a replaced slider is reused
                self._te_version += 1
                self._te[name] = (parts, self._te_version)
            else:
                self._te.pop(name, None)
            if self.max_sliders is not None:
                evictable = [n for n in self._sliders if n not in (name, "default")]
                while len(self._sliders) > self.max_sliders and evictable:
                    evicted = evictable.pop(0)  # least recently used first
                    del self._sliders[evicted]
                    self._te.pop(evicted, None)
            self._registry_changed()

    def _model_slider(self, path: str, part):
        """(sites, factors) of a slider file's model part."""
        return unet_slider(self.unet, path, part, device=self.device)

    def remove_slider(self, name: str) -> None:
        """Drop a slider; ``default`` is pinned (``ValueError``), an unknown
        name raises ``KeyError``."""
        if name == "default":
            raise ValueError("the 'default' slider is pinned and cannot be removed")
        with self._registry_lock:
            if name not in self._sliders:
                raise KeyError(f"unknown slider {name!r}")
            del self._sliders[name]
            self._te.pop(name, None)
            self._registry_changed()

    def _registry_changed(self) -> None:  # under the registry lock
        self._stack_cache.clear()
        self._registry_generation += 1

    def _resolve(self, name: str):
        with self._registry_lock:
            if name not in self._sliders:
                raise KeyError(f"unknown slider {name!r} (loaded: {sorted(self._sliders)})")
            self._sliders.move_to_end(name)
            return self._sliders[name]

    def list_sliders(self) -> list:
        """Names in LRU order (most recently used last), with their UNet site
        count and whether they carry text-encoder parts."""
        with self._registry_lock:
            return [{"name": n, "sites": len(entry[0]), "te": n in self._te} for n, entry in self._sliders.items()]

    def stacked_combos_cached(self) -> int:
        with self._registry_lock:
            return sum(v is not None for v in self._stack_cache.values())

    @property
    def sites(self):
        return self._sliders["default"][0]

    def _stacked_entry(self, names: tuple):
        """``(sites, stacked factors, overlay, name -> adapter index)`` for a
        sorted tuple of slider names, or None when their site sets do not
        stack. The adapter axis is padded to a power of two. A name gone from
        the registry raises ``KeyError``. The stack is built outside the
        lock and cached only if no registry change landed meanwhile."""
        with self._registry_lock:
            if names in self._stack_cache:
                self._stack_cache.move_to_end(names)
                for n in names:  # a stacked use touches every member's LRU slot
                    if n in self._sliders:
                        self._sliders.move_to_end(n)
                return self._stack_cache[names]
            generation = self._registry_generation
            entries = []
            for n in names:
                if n not in self._sliders:
                    raise KeyError(f"unknown slider {n!r}")
                self._sliders.move_to_end(n)
                entries.append(self._sliders[n])
        value = None
        if all(lora_lib.sites_stack_compatible(entries[0][0], e[0]) for e in entries[1:]):
            bucket = 1 << (len(names) - 1).bit_length()
            sites, stacked = lora_lib.stack_adapters([(e[0], e[1]) for e in entries], pad_to=bucket)
            value = (sites, stacked, lora_lib.LoRAOverlay(self.unet, sites, stacked),
                     {n: i for i, n in enumerate(names)})
        with self._registry_lock:
            if self._registry_generation == generation:
                self._stack_cache[names] = value
                self._stack_cache.move_to_end(names)
                while len(self._stack_cache) > self._STACK_CACHE_MAX:
                    self._stack_cache.popitem(last=False)
        return value

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

    def _groups(self, rows) -> list:
        """``[(rows, entry or slider name, adapter_idx or None)]`` of one
        guidance group: one stacked group when its sliders stack, else one
        group per slider. A stacking failure other than a vanished name is
        printed once, and the rows fall back to per-slider groups."""
        names = tuple(sorted({r[4] for _, r in rows}))
        stacked = None
        if len(names) > 1 and self._stack_enabled:
            try:
                stacked = self._stacked_entry(names)
            except KeyError:  # a vanished name: the per-slider groups poison exactly its rows
                stacked = None
            except Exception as e:  # noqa: BLE001 — traffic survives; say so once
                if not self._stack_warned:
                    self._stack_warned = True
                    print(f"[serve] cross-slider stacking failed ({e!r}) — falling back to per-slider batches")
        if stacked is not None:
            sites, params, overlay, name_to_idx = stacked
            return [(rows, (sites, params, overlay), [name_to_idx[r[4]] for _, r in rows])]
        by_slider: dict = {}
        for row in rows:
            by_slider.setdefault(row[1][4], []).append(row)
        return [(srows, name, None) for name, srows in by_slider.items()]

    def _generate_batch(self, reqs) -> list:
        """Group by guidance (or one group under ``static_guidance``), then
        by :meth:`_groups`; pad each group to a bucket, run one sampler call
        per group, PNG-encode, and route results back by request index. A
        failing group poisons only its own requests: their result is the
        exception."""
        by_guidance: dict = {}
        for i, r in enumerate(reqs):
            key = self._static_guidance if self._static_guidance is not None else r[3]
            by_guidance.setdefault(key, []).append((i, r))
        out: dict = {}
        for guidance, rows in by_guidance.items():
            for srows, entry, idx in self._groups(rows):
                try:
                    if idx is None:
                        entry = self._resolve(entry)
                    n = len(srows)
                    pad = self._bucket_for(n) - n
                    padded = [r for _, r in srows] + [srows[-1][1]] * pad
                    imgs = self._sample_group(padded, guidance, entry,
                                              adapter_idx=None if idx is None else idx + [idx[-1]] * pad)
                    for (i, _), img in zip(srows, imgs[:n]):
                        out[i] = encode_png(img)
                except Exception as e:  # noqa: BLE001 — contain to this group
                    for i, _ in srows:
                        out[i] = e
        return [out[i] for i in range(len(reqs))]

    def _encode_impl(self, prompt: str):
        return factory.encode_prompts_xl(self.text_encoders, [prompt])

    def _encode_te_impl(self, slider: str, version: int, prompt: str, scale: float):
        """``prompt`` through the towers with ``slider``'s text-encoder parts
        merged at ``scale`` (cached per slider, version, prompt and scale)."""
        with self._te[slider][0].merged_text_encoders(scale):
            return self._encode_impl(prompt)

    def _encode_row(self, prompt: str, row):
        """A row's embeddings of ``prompt``: through its slider's merged
        towers at its scale when the slider has text-encoder parts, else the
        plain cached encode."""
        te = self._te.get(row[4])
        if te is None:
            return self._encode(prompt)
        return self._encode_te(row[4], te[1], prompt, row[1])

    def _conditioning(self, padded):
        """(embeddings [2B] uncond ++ cond, added conditioning) of a group."""
        enc = [self._encode_row("", r) for r in padded] + [self._encode_row(r[0], r) for r in padded]
        added = {
            "text_embeds": torch.cat([p for _, p in enc]),
            "time_ids": torch.from_numpy(get_add_time_ids(self.image_size, self.image_size))
            .to(self.device)
            .expand(len(enc), -1),
        }
        return torch.cat([t for t, _ in enc]), added

    def _initial_latents(self, gens) -> torch.Tensor:
        """Each row's N(0, 1) draw from its own generator, fp32."""
        res = self.image_size // 8
        return torch.cat(
            [torch.randn((1, 4, res, res), generator=g, device=self.device, dtype=torch.float32) for g in gens]
        )

    @torch.inference_mode()
    def _sample_group(self, padded, guidance: float, entry, adapter_idx=None):
        sites, lora_params, overlay = entry
        dev = self.device
        emb, added = self._conditioning(padded)
        # one generator per row from its request's seed: the row's initial
        # latents (and any stochastic-scheduler noise) depend only on its seed
        gens = [torch.Generator(device=dev).manual_seed(r[2]) for r in padded]
        latents = self._initial_latents(gens) * self.schedule.init_noise_sigma
        scales = torch.tensor([r[1] for r in padded], dtype=torch.float32, device=dev)
        # per-request guidance is a tensor: CFG for every value, as the JAX
        # service's traced guidance; a static guidance is a Python float
        g = (self._static_guidance if self._static_guidance is not None
             else torch.tensor(guidance, dtype=torch.float32, device=dev))
        final = sample_loop_scales(
            self.unet, sites, lora_params, scales, self.flip, self.scheduler, self.schedule,
            latents.to(self.weight_dtype), emb, added_cond_kwargs=added, guidance_scale=g,
            generators=gens, overlay=overlay, adapter_idx=adapter_idx,
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
                 max_queue: int = 64, max_sliders: Optional[int] = None, cross_slider_stack: bool = True,
                 static_guidance: Optional[float] = None, v2: bool = False, v_pred: bool = False,
                 quantize_base: bool = False, w8a8: bool = False, device: str = "cuda"):
        self.v2, self.v_pred = v2, v_pred
        super().__init__(base, slider_path, image_size, steps, start_noise, batch_window_ms=batch_window_ms,
                         max_batch=max_batch, max_queue=max_queue, max_sliders=max_sliders,
                         cross_slider_stack=cross_slider_stack, static_guidance=static_guidance,
                         quantize_base=quantize_base, w8a8=w8a8, device=device)

    def _load(self, base: str) -> None:
        tok, te, self.unet, self.scheduler, self.vae = factory.load_models(
            base, scheduler_name="ddim", v2=self.v2, v_pred=self.v_pred, weight_dtype=self.weight_dtype,
            with_vae=True, device=self.device, quantize_base=self.quantize_base,
        )
        self.tokenizers, self.text_encoders = [tok], [te]

    def _encode_impl(self, prompt: str):
        return factory.encode_prompts(self.text_encoders[0], [prompt])

    def _conditioning(self, padded):
        return torch.cat([self._encode_row("", r) for r in padded] + [self._encode_row(r[0], r) for r in padded]), None


class SD3SliderService(SliderService):
    """SD3 (MMDiT) slider serving: the CFG flow-Euler sampler (28 steps and
    ``start_noise`` 750 by default) with the slider through the per-row LoRA
    overlay on the transformer (``self.unet``), the uncond rows first and
    every row's scale doubled over them (the slider is on in the uncond rows
    too, as JAX's service runs it), no merged weights ever built. The
    registry, the micro-batcher, cross-slider stacks, text-encoder parts
    (CLIP-L / bigG), ``static_guidance`` and ``quantize_base`` / ``w8a8`` are
    :class:`SliderService`'s. Sliders are ``-``-delimited SD3 files
    (``cli/train_lora_sd3.py``). The VAE (fp32, as JAX loads it) decodes
    when ``base`` is a directory with ``vae/``; otherwise each image is the
    JAX service's latent preview (the first three latent channels,
    normalised). The initial latents are each row's N(0, 1) draw from its
    seed (torch's numbers, not JAX's)."""

    def __init__(self, base: str, slider_path: str, image_size: int = 512, steps: int = 28,
                 start_noise: float = 750, batch_window_ms: float = 8.0, max_batch: int = 4,
                 max_queue: int = 64, max_sliders: Optional[int] = None, cross_slider_stack: bool = True,
                 static_guidance: Optional[float] = None, quantize_base: bool = False, w8a8: bool = False,
                 device: str = "cuda"):
        super().__init__(base, slider_path, image_size, steps, start_noise, batch_window_ms=batch_window_ms,
                         max_batch=max_batch, max_queue=max_queue, max_sliders=max_sliders,
                         cross_slider_stack=cross_slider_stack, static_guidance=static_guidance,
                         quantize_base=quantize_base, w8a8=w8a8, device=device)

    def _load(self, base: str) -> None:
        self.tokenizers, self.text_encoders, self.unet, self.scheduler = factory.load_models_sd3(
            base, weight_dtype=self.weight_dtype, device=self.device, quantize_base=self.quantize_base)
        self.vae = (factory.sd3_vae(base, self.device, torch.float32)
                    if os.path.isdir(os.path.join(str(base), "vae")) else None)
        self._t5_len = factory.sd3_t5_seq_len(base)

    def _flip(self, start_noise: float) -> int:  # continuous flow timesteps
        return generate_flow.flip_step_for_start_noise(self.schedule, start_noise)

    def _model_slider(self, path: str, part):
        return sd3_slider(self.unet, path, part, device=self.device)

    def _encode_impl(self, prompt: str):
        return factory.encode_prompts_sd3(self.text_encoders, [prompt], self.unet.config.joint_attention_dim,
                                          self._t5_len)

    def _conditioning(self, padded):
        """(text [2B], pooled [2B]) uncond ++ cond of a group."""
        enc = [self._encode_row("", r) for r in padded] + [self._encode_row(r[0], r) for r in padded]
        return torch.cat([t for t, _ in enc]), torch.cat([p for _, p in enc])

    def _draw_latents(self, seeds) -> torch.Tensor:
        """Each row's N(0, 1) draw from its own seed, fp32 ``[B, 16, h, w]``."""
        res = self.image_size // 8
        return torch.cat([torch.randn((1, self.unet.config.in_channels, res, res), device=self.device,
                                      generator=torch.Generator(device=self.device).manual_seed(s)) for s in seeds])

    @staticmethod
    def _latents_preview(lat: torch.Tensor) -> list:
        """The JAX service's weightless preview: the first 3 latent channels,
        each image normalised to [0, 255]."""
        imgs = []
        for row in lat.float().cpu().numpy()[:, :3]:
            a = (row - row.min()) / max(float(row.max() - row.min()), 1e-6)
            imgs.append(np.round(np.transpose(a, (1, 2, 0)) * 255).astype(np.uint8))
        return imgs

    @torch.inference_mode()
    def _sample_group(self, padded, guidance: float, entry, adapter_idx=None):
        _, _, overlay = entry
        dev = self.device
        text, pooled = self._conditioning(padded)
        latents = self._draw_latents([r[2] for r in padded])
        scales = torch.tensor([r[1] for r in padded], dtype=torch.float32, device=dev)
        idx = None if adapter_idx is None else torch.as_tensor(adapter_idx, dtype=torch.long, device=dev)
        # a static guidance <= 1 runs the cond rows only: the multipliers are not doubled then
        sg = self._static_guidance
        if sg is None or float(sg) > 1.0:
            scales = torch.cat([scales] * 2)
            idx = None if idx is None else torch.cat([idx] * 2)
        g = sg if sg is not None else torch.tensor(guidance, dtype=torch.float32, device=dev)
        final = generate_flow.sample_flow_loop(self.unet, self.flip, self.schedule, latents.to(self.weight_dtype),
                                               text, pooled, guidance_scale=g, overlay=overlay, row_scale=scales,
                                               adapter_idx=idx)
        if self.vae is None:
            return self._latents_preview(final)
        return generate_flow.sd3_latents_to_images(self.vae.decode, final, self.vae.config.scaling_factor,
                                                   self.vae.config.shift_factor)


class FluxSliderService(SD3SliderService):
    """Flux slider serving (schnell / dev): the few-step un-guided flow
    sampler over packed tokens (512px, 8 steps and ``start_noise`` 800 by
    default; the schedule shifted by μ from the image's token count) with
    the slider through the per-row LoRA overlay on the transformer
    (``self.unet``), never merged; a request's ``guidance`` is a dev model's
    distilled-guidance input (schnell ignores it) and still groups the
    micro-batch, as in JAX. The registry, the micro-batcher, cross-slider
    stacks (``adapter_idx`` over stacked factors), text-encoder parts (te1
    CLIP-L, te2 T5: a base directory's towers, merged per row's scale) and
    ``quantize_base`` / ``w8a8`` are :class:`SliderService`'s; the VAE decode
    or the latent preview :class:`SD3SliderService`'s. The initial latents
    are each row's N(0, 1) draw from its seed (torch's numbers, not JAX's)."""

    te2_is_t5 = True

    def __init__(self, base: str, slider_path: str, image_size: int = 512, steps: int = 8,
                 start_noise: float = 800, batch_window_ms: float = 8.0, max_batch: int = 4,
                 max_queue: int = 64, max_sliders: Optional[int] = None, cross_slider_stack: bool = True,
                 quantize_base: bool = False, w8a8: bool = False, device: str = "cuda"):
        super().__init__(base, slider_path, image_size, steps, start_noise, batch_window_ms=batch_window_ms,
                         max_batch=max_batch, max_queue=max_queue, max_sliders=max_sliders,
                         cross_slider_stack=cross_slider_stack, quantize_base=quantize_base, w8a8=w8a8,
                         device=device)

    def _load(self, base: str) -> None:
        self.tokenizers, self.encoder, self.unet, self.scheduler = factory.load_models_flux(
            base, weight_dtype=self.weight_dtype, device=self.device, quantize_base=self.quantize_base)
        self.vae = (factory.sd3_vae(base, self.device, torch.float32)
                    if os.path.isdir(os.path.join(str(base), "vae")) else None)
        self.latent_res = self.image_size // factory.flux_vae_scale(base)
        g = self.latent_res // 2
        self.img_ids = torch.from_numpy(prepare_latent_image_ids(g, g)).to(self.device)

    def _schedule(self, steps: int):
        return self.scheduler.set_timesteps(steps, mu=calculate_shift((self.latent_res // 2) ** 2))

    def _text_encoder_modules(self):
        return self.encoder.text_encoders

    def _encode_impl(self, prompt: str):
        text, pooled = self.encoder(prompt)
        return text[None], pooled[None]

    def _conditioning(self, padded):
        """(text [B], pooled [B]) of a group: the prompts only (no CFG)."""
        enc = [self._encode_row(r[0], r) for r in padded]
        return torch.cat([t for t, _ in enc]), torch.cat([p for _, p in enc])

    def _draw_latents(self, seeds) -> torch.Tensor:
        """Each row's N(0, 1) draw from its own seed, fp32 ``[B, 16, h, w]``."""
        c, res = self.unet.config.in_channels // 4, self.latent_res
        return torch.cat([torch.randn((1, c, res, res), device=self.device,
                                      generator=torch.Generator(device=self.device).manual_seed(s)) for s in seeds])

    @torch.inference_mode()
    def _sample_group(self, padded, guidance: float, entry, adapter_idx=None):
        _, _, overlay = entry
        dev = self.device
        text, pooled = self._conditioning(padded)
        tokens = pack_latents(self._draw_latents([r[2] for r in padded])).to(self.weight_dtype)
        scales = torch.tensor([r[1] for r in padded], dtype=torch.float32, device=dev)
        idx = None if adapter_idx is None else torch.as_tensor(adapter_idx, dtype=torch.long, device=dev)
        final = generate_flow.sample_packed_flow(self.unet, self.flip, self.schedule, tokens, text, pooled,
                                                 self.img_ids, guidance=float(guidance), overlay=overlay,
                                                 row_scale=scales, adapter_idx=idx)
        lat = unpack_latents(final, self.latent_res, self.latent_res)
        if self.vae is None:
            return self._latents_preview(lat)
        return generate_flow.sd3_latents_to_images(self.vae.decode, lat, self.vae.config.scaling_factor,
                                                   self.vae.config.shift_factor)


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


def metrics(service: SliderService) -> dict:
    """``GET /metrics``: the JAX service's keys — the registry, the stack
    cache, and the micro-batcher's batches, latency percentiles, queue and
    shed/error counts. ``microbatch`` is whether a batch may hold more than
    one request (``--no_microbatch`` is ``--max_batch 1``)."""
    b = service._batcher
    with b._stats_lock:
        recent, lats = list(b.batch_sizes), sorted(b.latencies)

    def pct(q):
        return round(lats[min(int(q * (len(lats) - 1) + 0.5), len(lats) - 1)], 4) if lats else 0.0

    return {
        "sliders": len(service.list_sliders()),
        "stacked_combos_cached": service.stacked_combos_cached(),
        "microbatch": b.max_batch > 1,
        "total_batches": b.total_batches,
        "total_rows": b.total_rows,
        "mean_batch": round(sum(recent) / max(len(recent), 1), 3),
        "max_batch": b.max_batch,
        "queue_depth": b.queue_depth(),
        "max_queue": b.max_queue,
        "p50_seconds": pct(0.50),
        "p99_seconds": pct(0.99),
        "rejected": b.rejected,
        "errored": b.errored,
        "error_rate": round((b.rejected + b.errored) / max(b.total_rows + b.rejected, 1), 4),
    }


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

        def do_POST(self):
            # POST /sliders {"name": ..., "path": ...}: register or replace a
            # slider over the loaded base, no restart
            if urlparse(self.path).path != "/sliders":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                spec = json.loads(self.rfile.read(int(self.headers.get("Content-Length", "0"))) or b"{}")
                name, path = spec["name"], spec["path"]
            except (ValueError, KeyError, TypeError) as e:
                self._json(400, {"error": f"body must be JSON with name+path ({e})"})
                return
            try:
                service.add_slider(str(name), str(path))
            except (ValueError, OSError, KeyError, NotImplementedError) as e:
                self._json(400, {"error": str(e)})
                return
            self._json(200, {"sliders": service.list_sliders()})

        def do_DELETE(self):
            # DELETE /sliders/<name>: 404 for an unknown name, 400 for the pinned default
            path = urlparse(self.path).path
            if not path.startswith("/sliders/"):
                self._json(404, {"error": f"no route {path}"})
                return
            try:
                service.remove_slider(path[len("/sliders/"):])
            except KeyError as e:
                self._json(404, {"error": str(e)})
                return
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            self._json(200, {"sliders": service.list_sliders()})

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/metrics":
                self._json(200, metrics(service))
                return
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
    ap.add_argument("--steps", type=int, default=None, help="default 25 (xl) / 28 (sd3) / 8 (flux) / 50 (sd1)")
    ap.add_argument("--start_noise", type=float, default=None, help="default 750 (xl/sd3/sd1) / 800 (flux)")
    ap.add_argument("--family", choices=["xl", "sd3", "flux", "sd1"], default=None,
                    help="read off --base when omitted")
    ap.add_argument("--v2", action="store_true", help="sd1 family only: SD2.x base (OpenCLIP tower, SD2.1 widths)")
    ap.add_argument("--v_pred", action="store_true", help="sd1 family only: v-prediction scheduler")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quantize_base", action="store_true",
                    help="int8 frozen UNet Linears (adapters/quant.py); sliders ride the overlay on it")
    ap.add_argument("--w8a8", action="store_true",
                    help="per-token int8 activations on the int8 Linears, int8 x int8 matmuls "
                         "(implies --quantize_base)")
    ap.add_argument("--batch_window_ms", type=float, default=8.0)
    ap.add_argument("--max_batch", type=int, default=4, help="1 serves one request per sampler call")
    ap.add_argument("--no_microbatch", action="store_true",
                    help="one request per sampler call: --max_batch 1. Requests still run one at a time on the "
                         "batcher's one worker thread, never from parallel HTTP threads (the overlay's hooks live "
                         "on the shared UNet)")
    ap.add_argument("--max_queue", type=int, default=64)
    ap.add_argument("--static_guidance", type=float, default=None,
                    help="a fixed guidance for every request (per-request ?guidance= is ignored and no longer "
                         "splits a micro-batch); <= 1 takes the cond-only path (half the UNet rows)")
    ap.add_argument("--no_stack", action="store_true",
                    help="no cross-slider batching: a micro-batch with several sliders runs one sampler call per "
                         "slider")
    ap.add_argument("--max_sliders", type=int, default=None,
                    help="bound the slider registry: registering past it (POST /sliders) evicts the least "
                         "recently used slider ('default' is pinned)")
    ap.add_argument("--compilation_cache_dir", default=None,
                    help="the directory the CUDA kernels are built into and reused from, so a restarted server "
                         "skips nvcc (utils/debug.apply_tpu_runtime_flags)")
    return ap


def service_settings(args):
    """(service class, keyword arguments) for parsed ``main`` arguments: the
    family (``--family`` or :func:`detect_family`) and its step and
    ``start_noise`` defaults (SD3: 28 steps and 750, Flux: 8 and 800, as
    JAX's). ``--static_guidance`` with Flux exits with JAX's message."""
    family = args.family or detect_family(args.base)
    if family == "flux":
        if args.static_guidance is not None:
            raise SystemExit("--static_guidance applies to CFG families (xl/sd3); flux "
                             "schnell has no CFG batch and dev's guidance embedding is "
                             "already a cheap per-request input")
        return FluxSliderService, dict(
            image_size=args.image_size, steps=8 if args.steps is None else args.steps,
            start_noise=800 if args.start_noise is None else args.start_noise, batch_window_ms=args.batch_window_ms,
            max_batch=1 if args.no_microbatch else args.max_batch, max_queue=args.max_queue,
            max_sliders=args.max_sliders, cross_slider_stack=not args.no_stack, quantize_base=args.quantize_base,
            w8a8=args.w8a8, device=args.device)
    kwargs = dict(image_size=args.image_size, start_noise=750 if args.start_noise is None else args.start_noise,
                  batch_window_ms=args.batch_window_ms, max_batch=1 if args.no_microbatch else args.max_batch,
                  max_queue=args.max_queue, max_sliders=args.max_sliders, cross_slider_stack=not args.no_stack,
                  static_guidance=args.static_guidance, quantize_base=args.quantize_base, w8a8=args.w8a8,
                  device=args.device)
    if family == "sd1":
        return SD1SliderService, dict(kwargs, steps=50 if args.steps is None else args.steps, v2=args.v2,
                                      v_pred=args.v_pred)
    if family == "sd3":
        return SD3SliderService, dict(kwargs, steps=28 if args.steps is None else args.steps)
    return SliderService, dict(kwargs, steps=25 if args.steps is None else args.steps)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.compilation_cache_dir:
        apply_tpu_runtime_flags(SimpleNamespace(compilation_cache_dir=args.compilation_cache_dir))
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
