#!/usr/bin/env python3
"""Smoke of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. build        — compile K1 (csrc/flash_attention_fwd.cu), K2/K3
                  (csrc/flash_attention_bwd.cu), K4a
                  (csrc/flash_attention_kgrid.cu) and K4b/K4c
                  (csrc/flash_attention_kgrid_bwd.cu) with nvcc for sm_90a, one
                  nvcc per source, started together; seconds, registers and
                  spills per kernel, card name and power limit.
1b. image_decode — host only: every committed fixture of
                  tests/data/image_decode (JPEG baseline and progressive,
                  4:4:4/4:2:2/4:2:0/4:4:0, grey, restart markers, Adobe RGB;
                  palette, 2-bit, 16-bit and Adam7 PNGs; the JPEG bank's
                  folders) through io/image.py::load_rgb, each held to the
                  stored SHA-256 of Pillow's RGB decode; seconds per image.
2. kernel       — K1 against its plain PyTorch version on the card at the four
                  attention shapes of 1024px SDXL serving with CFG (one
                  request, 2 rows), in bf16 (the tensor-core kernel) and in
                  fp32 (the SIMT kernel); max-abs error, kernel_ms, device_ms,
                  plain_ms, library_ms (F.scaled_dot_product_attention, timed
                  as a yardstick only), bound_ms; for bf16 the achieved
                  TFLOP/s, share of the bound and ratio to SDPA on device
                  times, and K1's host µs per call at 1024×77. bf16 K1 at
                  ragged Sq/Sk ∈ {1, 63, 65, 77, 129, 4097} (d 64 and 128),
                  on head slices of wider tensors and on views off TMA's
                  16-byte alignment (copied once by the wrapper).
3. kernel_bwd   — K2 (dQ) and K3 (dK, dV) against their plain versions at the
                  K1-class attention shapes of every training path
                  (TRAIN_SHAPES: 512px SDXL and SD1.5 ESD at batch 1, SD1.5
                  head dims 40 and 80 zero-padded to 64 and 128 as the path
                  pads them; SD1.5 image pairs at 256px, rows 2; SD2.1's
                  4096² with 5 heads), bf16 and fp32, plus ragged (Sq 65; Sk
                  77, 129) and strided-dO cases; bf16 K2 with its key split
                  and K3 with its query split forced to 1, 2 and 64 at every
                  training shape, against the plain versions over the same
                  splits, each call repeated bit for bit (K2's δ the same bits
                  at every split); bf16 K2 at ragged Sq/Sk ∈ {1, 63, 65, 77,
                  129, 4097} (d 64 and 128) and on head slices and views off
                  16 bytes of q, k, v, O and dO; K2's host µs per call; error
                  per gradient, K2's and K3's splits,
                  kernel_ms (CUDA events), device_ms (the kernels' summed
                  durations under torch.profiler), plain_ms, bound_ms (at the
                  unpadded head dim) and library_ms (SDPA's backward on the
                  unpadded head dim: the device time of forward+backward minus
                  that of the forward), TFLOP/s, share of the bound and
                  ratio to SDPA on device times. K1's out and lse, which
                  K2/K3 take, are held against the plain version at the same
                  shapes, at the student's rows (also the warm-up's) and the
                  ESD teacher's 3.
4. kernel_kgrid — K4a (O and lse) against its plain version at every path
                  shape (KGRID_PATH_SHAPES): the VAE mid-block (one head, d
                  512) at 16384² rows 1 and 2 (the 1024px decode of serving),
                  4096² rows 4 and 1 (the 512px encode) and 1024² rows 4 (the
                  256px encode), and SD1.5's d-160 (→ 192) UNet level at 256²,
                  256×77, 64², 64×77 (rows 1 and 3) and the image pairs' 64
                  and 16 tokens (rows 2), bf16 and fp32; bf16 with the
                  key-range split forced to 1, 2 and 64 at every path shape,
                  repeated calls bit for bit; bf16 at ragged Sq/Sk ∈ {1, 63,
                  65, 77, 129, 4097} at d 64, 192, 320 and 512, on head slices
                  and on views off 16 bytes; fp32 with forced splits. Times
                  the kernel (events, device time, host µs per call), its
                  plain version and SDPA's forward (a yardstick) at every
                  path shape in bf16, with the bound and its share.
5. kernel_kgrid_bwd — K4b (dQ, δ) and K4c (dK, dV) against their plain
                  versions at SD1.5's d-160 attentions (8 heads, zero-padded
                  to 192; bound_ms at d 160): the 512px ESD student (256²,
                  256×77, 64², 64×77) and
                  the 256px image-pair student (rows 2: 64², 64×77, 16²,
                  16×77), bf16 (the tensor-core kernels) and fp32 (the SIMT
                  kernels), on K4a's O and lse (K4a held against its plain
                  version there too), with the splits their rules pick;
                  ragged shapes, d 64 / 320 / 512, a strided dO, K4c's query
                  split forced to 1, 4 and 12, repeated calls bit-equal; bf16
                  K4b's key split and K4c's query split forced to 1, 2 and 64
                  at every path shape, repeats bit-equal and δ the same bits
                  at every split; bf16 at ragged Sq/Sk ∈ {1, 63, 65, 77, 129}
                  at d 64, 192, 256, 320 and 512; head slices and views off
                  16 bytes of q, k, v, O and dO bit-equal to contiguous
                  copies; at d 64 against K2/K3 at 300×77 (B 2, H 2) and
                  16384² (one head). Times K4b, K4c (events, device time and
                  host µs per call), their plain versions and SDPA's backward
                  (device time) at every path shape in bf16, with each
                  kernel's TFLOP/s, share of the bound, ratio to SDPA's whole
                  backward and split.
5b. kernel_sd_serve — K1 and K4a against their plain versions at SD1.5
                  serving's shapes (512px, CFG: rows 2 for one request and 4
                  for a pair), bf16: K1 at 4096² and 4096×77 (8 heads, d 40 →
                  64) and 1024² and 1024×77 (d 80 → 128), K4a at 256² and
                  256×77 (d 160 → 192). (The SD decode's 4096² at d 512 is
                  phase 4's encode_4096 at rows 1.)
5c. kernel_sd3 — SD3-Medium's joint attention (24 heads of 64, bf16): K1
                  against its plain version at 4429² rows 2 (1024px serving
                  with CFG: 4096 image + 77 CLIP + 256 zero T5 tokens) and
                  1357² rows 1, 2, 4, 16 and 32 (512px training: one
                  prompt's warm-up/student and teacher rows, and
                  data/prompts-sd3.yaml's batch of 8), K2/K3 at 1357² rows
                  2 and 16 with the splits their rules pick; device ms,
                  TFLOP/s, share of the bound, ratio to SDPA (forward, or
                  whole backward). Emitted as kernel / kernel_bwd rows.
5d. kernel_flux — Flux's joint attention at native d 128 (24 heads): the
                  same rows (phase_kernel_joint) for K1 at 1536² rows 1, 2
                  and 6 (512px: 512 T5 + 1024 image tokens; a request, the
                  student at batch 2, its 3-row teacher) and 4608² rows 1
                  (1024px), K2/K3 at 1536² rows 2 and 6; then K1 fp32 at
                  1536² and 4608², K2/K3 fp32 at 1536² rows 2, and bf16 K2/K3
                  with their splits forced to 1, 2 and 64, repeats and δ bit
                  for bit (phase_kernel_flux_checks).
5e. kernel_cascade — the Stable Cascade prior's attentions (32 heads of
                  64, bf16; phase_kernel_joint at CASCADE_K1_SHAPES and
                  CASCADE_K23_SHAPES): K1 at 144×229 (level 0 of the 12 × 12
                  grid of 512px) and 36×121 (level 1) rows 2 and 4, K2/K3 at
                  both rows 2; emitted as kernel / kernel_bwd rows.
6. parity       — the tiny-xl sampler on the card (K1 inside every UNet
                  attention) against the same weights and inputs on the CPU.
7. train_parity — one tiny-xl ESD step on the card (K1/K2/K3 inside) against
                  the same step on the CPU: weights, LoRA factors, draws, fp32.
8. sd_train_parity — one tiny-SD DDIM ESD step, card vs CPU, fp32, on
                  ``tiny`` (K1/K2/K3) and on its variant with a d-160 mid block
                  (K4a/K4b/K4c inside too).
8b. sd3_parity — the tiny MMDiT flow sampler (3 steps, CFG 7, the overlay)
                  and one tiny SD3 ESD step (CFG 7, blocks checkpointed),
                  card vs CPU, fp32; K1 2 per forward, K2/K3 2 per step.
8c. flux_parity — the tiny Flux packed sampler (3 steps, the overlay from
                  step 1) and one tiny Flux ESD micro-step (MultiSteps, the
                  overlay student, blocks checkpointed), card vs CPU, fp32.
8d. cascade_parity — the tiny Stable Cascade prior on a 5 × 5 grid (the
                  odd grid's bilinear resize) and one tiny Cascade ESD step
                  (the merged student, its layers checkpointed; euler_a, T 3),
                  card vs CPU, fp32; K1 4 per forward, K2/K3 4 per step.
9. imageslider_parity — the image bank through the full SDXL VAE at 64px (K4a
                  in the encoder's mid-block) and one tiny-xl image-pair step
                  (K1/K2/K3) on the card against the same on the CPU, fp32.
10. serve       — full-width SDXL (random weights from a seed) at 1024px, 8 DDIM
                  steps (the service's 25, cut): a rank-4 slider made with
                  create_sites, written with the port's .safetensors writer
                  and loaded through add_slider; four
                  requests (scale 0, +2, and -2/+1 concurrently in one micro-batch);
                  per sampler call K1 8×140 launches and one K4a (the decode);
                  latency, images/s, peak memory.
11. http        — one /generate through make_handler on localhost.
12. profile     — one more request under torch.profiler: device busy time,
                  the idle share, and the kernels that take the device time.
12b. serve_sliders — on the same service: sliders a (noxattn, rank 4, α 1),
                  b (noxattn, rank 1, α 4), x (xattn) and te (a
                  cli/combine_loras.py file: a's UNet part plus random
                  full-width lora_te1 parts over CLIP-L, 12 × 4, and lora_te3
                  parts over OpenCLIP bigG, 32 × 4). a and b sent together
                  ride one stacked sampler call (one call's K1 and K4a),
                  each image within a mean of 2/255 of its solo image; a and
                  x take two calls; te at 0 equals a at 0 bit for bit, and
                  te at +2 differs from it and from a at +2; the host ms of
                  one merged two-tower encode; POST /sliders, DELETE
                  /sliders/<name> (the pinned default: 400), GET /metrics
                  through make_handler; max_sliders 3 evicting the least
                  recently used slider and keeping default.
13. train       — full-width SDXL ESD slider training at 512px through
                  trainer.train from data/config-xl.yaml + data/prompts-xl.yaml
                  (only train.iterations and save.path overridden; the unset
                  tpu block resolves, as in JAX, to the overlay student with
                  the merged warm-up): finite losses, moving factors, the saved
                  file's keys, launch counts per step, steps/s, first-step
                  seconds, peak memory; then one more step under
                  torch.profiler (phase_esd).
13b. train_overlay_warmup — as 13 with tpu.overlay_warmup: true (the warm-up
                  through the overlay, the port's route before the default
                  followed JAX), 3 steps; then warmup_routes: steps/s, UNet
                  forwards/s and first-step seconds of both warm-up routes.
13c. train_merged — as 13 with tpu.student_overlay: false (the merged
                  student: autograd through the merge, full dL/dW′ per site),
                  3 steps, profiled; then merged_call_cost: the host cost of
                  one merged-weights forward (SDXL 512px, 560 merged weights),
                  by the port's parameter swap and by functional_call.
14. imageslider — full-width SDXL image-pair slider training at 512px through
                  cli/train_lora_scale.train from the same YAML files, four
                  folders of four synthetic PNGs at scales -2, -1, 1, 2 (the
                  first folder's at 600×400, resized by the bank): bank
                  build seconds, K4a launches at the bank build, K1/K2/K3 per
                  step, losses, moving factors, saved keys, steps/s, first
                  step, peak memory; then one more step under torch.profiler
                  (phase_image_pairs).
15. sd_train    — as 13 for SD1.5 at 512px (cli/train_lora.py's path) from
                  data/config.yaml + data/prompts.yaml (DDIM,
                  max_denoising_steps 50): K1 20 and K4a 12 launches per UNet
                  forward, K2/K3 20 and K4b/K4c 12 per step; not profiled
                  since the baseline phases joined (its profiled step, up to
                  50 warm-up forwards, took ~20 s; PERF.md §5 keeps F10's).
15b. sd_dora_train — as 15 with peft_type dora (the merged route), 3 steps:
                  every dora_scale moved, the saved .dora_scale keys [1, in],
                  the file reloaded through adapters/dora.py bit-equal; not
                  profiled (since the image-editing phases joined).
16. sd2_train   — the same YAML turned to SD2.1 (v2, v_pred), 2 steps: head
                  dim 64 everywhere, so K1/K2/K3 only (32 per forward / step);
                  not profiled.
17. sd_imageslider — as 14 for SD1.5 at 256px: K4a once per folder at the
                  bank build (the VAE mid-block, 1024², d 512); per step K1
                  20, K4a 12, K2/K3 20, K4b/K4c 12.
17b. sd_imageslider_merged — as 17 with tpu.student_overlay: false, 2 steps,
                  over the committed JPEG bank (tests/data/image_decode/bank:
                  two 96px JPEGs a folder, baseline and progressive, resized
                  to 256 by the bank): the merged ±s students, two 1-row
                  calls a step, so every kernel launches twice per step what
                  the overlay launches.
18. load        — a full-width SD1.5 diffusers directory written with the
                  port's .safetensors writer (seeded random bf16 weights;
                  unet/ in two shards with an index, vae/, text_encoder/ under
                  transformers names, config.json files, tokenizer/ with the
                  synthetic vocab.json/merges.txt of the CPU tests'
                  generator), loaded by factory.load_models(dir, "cuda", bf16,
                  with_vae=True): every tensor bit-equal to its source; load
                  seconds and bytes.
19. sd_serve    — SD1SliderService over that directory, 512px, 10 DDIM steps
                  (the service's 50, cut to 20 when Stable Cascade joined, to
                  10 with the image-editing phases),
                  a rank-4 slider: scale 0 and +2 solo (different images), -2
                  and +1 in one micro-batch, one /generate through
                  make_handler (sd_serve_http), one profiled request
                  (sd_serve_profile). Per sampler call K1 10×20 = 200 and K4a
                  10×12 + 1 = 121 launches.
20. sd2_serve   — SD1SliderService on stabilityai/stable-diffusion-2-1 with
                  v2 and v_pred, 512px, 5 steps, scales 0 and +2: per call K1
                  5×32 = 160, K4a 1 (the decode).
21. sweep_xl    — cli/generate_images_xl.run on the SDXL name at the CLI's
                  defaults (512px, start_noise 750) but 6 DDIM steps
                  (SWEEP_XL_STEPS, cut from 50), scales -2, 0, 2 and one
                  sample of prompts/prompts-person.csv's first case:
                  sequential (merged weights; K1 6×140 per
                  trajectory, 3 trajectories), --batch_scales (one
                  trajectory), and each scale alone with --batch_scales; one
                  K4a per decode. Files and composite, seconds per image, the
                  merged-vs-overlay pixel gap at the same batch and batched.
                  Then a combine_loras file with text-encoder parts (the UNet
                  slider, lora_te1 and lora_te3 at full width), merged and
                  --batch_scales at scales -2 and 2 (6 steps): the gap
                  between the two routes, its mean held to 2/255.
22. sweep_sd1   — cli/generate_images_sd1.run over the SD1.5 directory: LMS,
                  50 steps, start_noise 850, scales -2 and 2, one sample;
                  per trajectory K1 1000 and K4a 600, plus one K4a per decode;
                  the composite 512 × 1024.
22-1. scorers  — eval/clip_score.py over a seeded full-width ViT-B/32
                  CLIPModel directory (the port's writer, synthetic BPE
                  files) and eval/lpip_score.py over seeded AlexNet and
                  lin-head .pth files, both over sweep_xl's folders (scales
                  -2, 0, 2): on the card, then with --device cpu; finite
                  scores, the expected columns, card against CPU within 2e-4
                  relative (fp32). No kernel: the ViT's attention is plain.
22-2. edit      — demos/demo_image_editing.run over the SD1.5 directory at
                  512px in fp32 (the demo's default): a committed JPEG,
                  null-text inversion with EDIT_STEPS DDIM steps and
                  EDIT_INNER_STEPS inner steps (the demo's 50 and 10, cut),
                  edits at scales 0, -2, 2 with a seeded rank-4 slider
                  (start_noise 500). Per part (load, invert,
                  null_optimization, each edit) K1..K4c against the count
                  predicted from which inputs need a gradient: K1 20 and K4a
                  12 a forward, K2 = K3 = 19 and K4b = K4c = 12 an inner
                  backward (the first self-attention of down_blocks.0 has no
                  gradient path to the embedding); one K4a per encode and
                  decode; the scale-0 edit's reconstruction MSE against
                  latent0; seconds per part. Then one forward under
                  capture_attention_maps (K1 20 and K4a 12 fewer: every
                  attention materialised) and one under
                  reweight_cross_attention (10 and 6 fewer: the
                  cross-attentions), each against the kernels' forward.
22b. export     — cli/export_single_file over the SD1.5 directory and the
                  sd_serve slider at --scale 2 (fp32); the file reloaded in
                  bf16: every non-site tensor bit-equal to the directory's,
                  every site weight to the fp32 merge rounded once; one 512px
                  EXPORT_STEPS-step (20; 50 before the image-editing phases
                  joined) sampler call over it equal, pixel for pixel, to the
                  directory's model with those weights (K1 400, K4a 241);
                  write and reload seconds, and the gap to the sweeps' bf16
                  merge.
22c. quant      — the SDXL UNet (seeded random bf16) quantized in place on
                  the card (adapters/quant.py): 743 QuantLinears, the UNet's
                  bytes before and after (torch.cuda.memory_allocated), the
                  seconds; int8_matmul at three SDXL shapes (the 2-row
                  time_embedding padded for torch._int_mm among them) equal
                  to the CPU's int32 product; the weight-only QuantLinear
                  against F.linear of its dequantized weight in bf16; device
                  ms and host µs per call of nn.Linear, weight-only and W8A8.
22d. train_int8 — SDXL ESD (data/config-xl.yaml) 3 steps each on bf16,
                  tpu.quantize_base, the dual-tree tpu.w8a8_warmup, and both;
                  SD1.5 ESD on bf16 and quantize_base, 2 steps: steps/s on the
                  same timesteps_to draws, peak, K1..K4c per step equal to the
                  bf16 route's count, finite losses, moved factors.
22e. serve_int8 — one SDXL 1024px request (seed 7, scale 2) twice through
                  SliderService with quantize_base and with w8a8: latency,
                  peak, UNet bytes, the pixel gap to the bf16 image.
22f. quantize_checkpoint — cli/quantize_checkpoint on the SD1.5 directory:
                  artifact bytes and seconds; one UNet forward from the
                  artifact bit-equal to load_models(dir, quantize_base=True)'s.
22g. sd3_load  — a full-width SD3-Medium diffusers directory of seeded bf16
                  weights (transformer in two shards, CLIP-L with its
                  projection, bigG, the 16-channel VAE with use_quant_conv
                  false, scaling 1.5305, shift 0.0609, both tokenizers),
                  loaded by factory.load_models_sd3 bit for bit; GB, GB/s.
22h. sd3_train — cli/train_lora_sd3.train from data/config-sd3.yaml +
                  data/prompts-sd3.yaml over that directory (512px, batch 8,
                  CFG 7, 28 flow steps; iterations cut 1000 → 4): K1
                  24·(tₖ + 3), K2 = K3 = 24 per step; steps/s, first step,
                  peak memory, timesteps_to, saved keys; one step profiled.
22i. sd3_serve — SD3SliderService over the directory, 1024px, 28 steps, CFG
                  7: two solo requests, a concurrent pair, one over HTTP,
                  one profiled; 672 K1 per sampler call and 1 K4a per decode.
22j. sd3_sweep — cli/generate_images_sd3 at its defaults (512px, 28 steps),
                  scales -2, 0, 2 × 1 sample × case 0.
22k. sd3_int8  — 2 training steps with tpu.quantize_base, one 1024px
                  request under --w8a8 (its gap to the bf16 image), and the
                  quantize_checkpoint --family sd3 artifact loaded, its
                  forward bit-equal to the quantized directory's.
22l. sd3_export — cli/export_single_file --sd3 --half (a slider at scale 2;
                  fp16 since the image-editing phases joined, fp32 before)
                  reloaded in bf16: every tensor bit-equal to the directory's
                  or to the fp32 merge, each rounded to fp16 and then bf16.
22m. sd3_notrigger — cli/train_notrigger --model SD3-Medium in the
                  directory's bigG, 5 steps (no kernel: the towers'
                  attention is plain); the SD3 directory is deleted after.
22n. flux_train — FLUX.1-schnell at full width and depth (seeded bf16
                  weights, the stand-in encoder), cli/train_lora_flux.train
                  from data/config-flux.yaml + data/prompts-flux.yaml with
                  tpu.quantize_base off (512px, batch 2: 4 micro-steps per
                  optimizer step; 1000 → 2 optimizer steps = 9 micro-steps):
                  K1 57 × 3 and K2 = K3 = 57 per micro-step; micro- and
                  optimizer steps/s, first step, peak, 76 sites, saved keys;
                  one more micro-step profiled (idle share).
22o. flux_serve — FluxSliderService at its defaults (512px, 8 steps,
                  start_noise 800; no vae/: the latent preview): two solo
                  requests, a concurrent pair, one over HTTP, one profiled;
                  456 K1 per sampler call.
22p. flux_sweep — cli/generate_images_flux at its defaults, scales -2, 0, 2
                  × 1 sample × case 0 (latents as .npy); seconds per image.
22q. flux_load — a schnell diffusers directory (transformer at full width in
                  5 shards, its 19 + 38 blocks cut to 2 + 4 when Stable
                  Cascade joined; T5-XXL's width with 2 of its 24 layers;
                  CLIP-L; the 16-channel VAE with FLUX.1's factors; a
                  synthetic spiece.model) served: every tensor bit-equal,
                  one request decoded (48 K1, 1 K4a); GB, seconds, GB/s;
                  the directory deleted after.
22r. flux_int8  — 1 optimizer step (2 before Stable Cascade joined) on
                  tpu.quantize_base, one --w8a8 request
                  (its gap to the bf16 image), the quantize_checkpoint
                  --family flux artifact of the weightless schnell reloaded,
                  its forward bit-equal to the in-memory int8 base.
22s. flux_export — export_single_file --flux --half over flux_load's
                  directory (full width, 2 + 4 blocks since the image-editing
                  phases joined; the fp32 base, a slider at scale 2; BFL's
                  layout) read back through the BFL conversion bit-equal to
                  the file.
22t. flux_notrigger — cli/train_notrigger --model FLUX.1 --clip_index 1: a
                  slider in a seeded T5-XXL (full width and depth), 5 steps
                  (no kernel: T5's attention is plain), swept over the same
                  T5 at 0 (bit-equal to the tower without it) and +1.
22u. cascade_load — a full-width Stable Cascade diffusers directory of
                  seeded bf16 weights (prior/ in 4 shards, CLIP-G
                  text_encoder/, tokenizer/), loaded by
                  factory.load_models_cascade bit-equal.
22v. cascade_train — cli/train_lora_cascade.train over that directory from
                  data/config-cascade.yaml + data/prompts-cascade.yaml (512px,
                  euler_a, T 20, bf16, c3lier rank 4), 2 steps: K1 1408 and
                  K2 = K3 = 64 per step, the saved .pt's 256 sites; not
                  profiled since the baseline phases joined (PERF.md §5
                  keeps D16's). Then the routes, 2 steps each on the seeded
                  weightless prior: cascade_wuerstchen, cascade_dora,
                  cascade_w8a8 (the dual-tree warm-up), cascade_overlay and
                  cascade_samples2_share (K1 64 · (19 + 2 · 3) per step).
22w. baselines — the four baseline generators at 512px, one case, one
                  sample, BASELINE_STEPS steps: cli/generate_images_uce over
                  the load phase's SD1.5 directory (a seeded bf16 edit of its
                  attn2 K/V tensors as .safetensors; scales -1, 0, 0.5, 2:
                  the scale-0 trajectory bit-equal to the original UNet's),
                  cli/generate_images_textinversion over the directory (a
                  learned_embeds.safetensors), cli/generate_images_textinversion_xl
                  and cli/generate_images_customdiffusion (a delta.bin: one
                  plain and one compressed K/V entry, one token) on the SDXL
                  name; file trees, K1/K4a per trajectory and decode.
22x. acceptance — cli/acceptance --skip_train on sweep_xl's slider: a
                  3-scale SDXL sweep at ACCEPTANCE_STEPS, both scorers from
                  the scorers phase's files; acceptance.json's curves and
                  lpips_identity 0.0.
22y. demos      — demos/demo_sdxl_turbo on the SDXL name (4 Euler-A steps,
                  guidance 0, scales -2, 0, 2) and demos/demo_concept_sliders
                  (SDXL fp32 training, 2 steps at 512px: K2/K3; a 2-scale
                  Euler-A sweep).
22z. parity_dump — eval/parity dump of the SD1.5 directory on the card (fp32:
                  K1 20, K4a 12) and on the CPU, then compare (atol 5e-3).
23. kernels     — every ported kernel with its launches on its paths (each
                  path counted from 0 just before it; the inference paths
                  sd_serve, sd2_serve, sweep_xl, sweep_sd1 and export run K1
                  and K4a and no backward kernel; the SD3 and Flux paths join
                  K1, K2/K3 in training and K4a where they decode; the Cascade
                  paths K1, K2 and K3 and no k-grid kernel; the edit path all
                  six). On every path the
                  plain attention versions, forward and backward, ran 0 times
                  on the card.

Then the card as nvidia-smi names it, and the result line.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import functools
import gc
import hashlib
import itertools
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from sliders_conceptmod_tpu_torch.adapters import dora, lora, quant
from sliders_conceptmod_tpu_torch.adapters.slider_file import CLIP_NAME_PATH_PREFIX, load_slider_file
from sliders_conceptmod_tpu_torch.cli import acceptance, combine_loras, export_single_file, quantize_checkpoint
from sliders_conceptmod_tpu_torch.cli import generate_images_customdiffusion as gen_cd
from sliders_conceptmod_tpu_torch.cli import generate_images_textinversion as gen_ti
from sliders_conceptmod_tpu_torch.cli import generate_images_textinversion_xl as gen_ti_xl
from sliders_conceptmod_tpu_torch.cli import generate_images_uce as gen_uce
from sliders_conceptmod_tpu_torch.cli import generate_images_sd1 as gen_sd1
from sliders_conceptmod_tpu_torch.cli import generate_images_flux as gen_flux
from sliders_conceptmod_tpu_torch.cli import generate_images_sd3 as gen_sd3
from sliders_conceptmod_tpu_torch.cli import generate_images_xl as gen_xl
from sliders_conceptmod_tpu_torch.cli import (
    train_lora_cascade,
    train_lora_flux,
    train_lora_scale,
    train_lora_sd3,
    train_notrigger,
)
from sliders_conceptmod_tpu_torch.core import yaml_subset
from sliders_conceptmod_tpu_torch.core.config import load_config_from_yaml, resolve_student_overlay
from sliders_conceptmod_tpu_torch.core.prompts import PromptSettings, load_prompts_from_yaml
from sliders_conceptmod_tpu_torch.demos import demo_concept_sliders as demo_concept
from sliders_conceptmod_tpu_torch.demos import demo_image_editing as demo_edit
from sliders_conceptmod_tpu_torch.demos import demo_sdxl_turbo as demo_turbo
from sliders_conceptmod_tpu_torch.diffusion.flow_match import FlowMatchScheduler
from sliders_conceptmod_tpu_torch.diffusion.sampling import get_add_time_ids
from sliders_conceptmod_tpu_torch.eval import clip_score as clip_score_cli
from sliders_conceptmod_tpu_torch.eval import lpip_score as lpip_score_cli
from sliders_conceptmod_tpu_torch.eval import parity
from sliders_conceptmod_tpu_torch.infer.generate_flow import sample_flow_loop, sample_packed_flow
from sliders_conceptmod_tpu_torch.infer import null_inversion
from sliders_conceptmod_tpu_torch.infer.generate import latents_to_images, sample_loop, sample_loop_scales
from sliders_conceptmod_tpu_torch.io import ldm_export
from sliders_conceptmod_tpu_torch.io import torch_convert
from sliders_conceptmod_tpu_torch.io.image import load_rgb
from sliders_conceptmod_tpu_torch.io.png import decode_png, encode_png
from sliders_conceptmod_tpu_torch.io.safetensors import load_file, save_file
from sliders_conceptmod_tpu_torch.models import clip_vision, factory
from sliders_conceptmod_tpu_torch.models import lpips as lpips_model
from sliders_conceptmod_tpu_torch.models import unet as unet_module
from sliders_conceptmod_tpu_torch.models.cascade import CascadeConfig, StableCascadeUNet
from sliders_conceptmod_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from sliders_conceptmod_tpu_torch.models.flux import FluxConfig, FluxTransformer2DModel, prepare_latent_image_ids
from sliders_conceptmod_tpu_torch.models.mmdit import MMDiTConfig, SD3Transformer2DModel
from sliders_conceptmod_tpu_torch.models.t5 import T5Config, T5EncoderModel
from sliders_conceptmod_tpu_torch.models.tokenizer import HashTokenizer, write_synthetic_bpe_files, write_synthetic_spm
from sliders_conceptmod_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig
from sliders_conceptmod_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from sliders_conceptmod_tpu_torch.ops import flash_attention as fa
from sliders_conceptmod_tpu_torch.ops import flash_attention_kgrid as kg
from sliders_conceptmod_tpu_torch.serve import (
    FluxSliderService,
    SD1SliderService,
    SD3SliderService,
    SliderService,
    make_handler,
    metrics,
)
from sliders_conceptmod_tpu_torch.train import esd, esd_cascade, esd_flux, esd_sd3, imageslider, trainer
from sliders_conceptmod_tpu_torch.train.optim import MultiSteps, Optimizer, flat_params, get_lr_schedule, get_optimizer

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# K1 and K4a vs their fp32 plain versions. fp32: the same math up to
# summation order (1e-4 flat; at most the 1e-4·max(1, max|ref|) asked of K4a).
# bf16: rounding the output alone costs up to 2^-8·|out|, so the bound is
# 2e-2 of the reference's largest value (and never above 3e-2). At 4096² with
# N(0,1) inputs the output's typical value is ~sqrt(e/4096) ≈ 0.026 and this
# bound ~10× smaller, so a dropped K tile or a wrong P·V fails it.
FP32_TOL, BF16_REL, BF16_TOL = 1e-4, 2e-2, 3e-2
LSE_TOL = 1e-3
SDXL = "stabilityai/stable-diffusion-xl-base-1.0"
# Steps of the older phases, cut to keep the smoke inside its time limit on slower hosts: the same tree's
# smoke read 970-1294 s across calls, every phase slower on a slow host (PERF.md §6)
IMAGE_SIZE, STEPS = 1024, 8  # SDXL serving: the service's 25 DDIM steps, cut to 12 with Flux, to 8 with editing
SD2_STEPS = 5  # SD2.1 serving: the service's 50, cut to 10, then to 5 when the image-editing phases joined
SD1_STEPS = 10  # SD1.5 serving over the load phase's directory: the service's 50, 20 with Cascade, 10 with editing
EXPORT_STEPS = 20  # the export phase's sampler calls: 50 before the image-editing phases joined
# (name, Sq, Sk, heads): the attention calls of one SDXL UNet forward at 1024px
PATH_SHAPES = [
    ("self_4096", 4096, 4096, 10),
    ("cross_4096x77", 4096, 77, 10),
    ("self_1024", 1024, 1024, 20),
    ("cross_1024x77", 1024, 77, 20),
]
# (name, Sq, Sk, heads, head dim, student rows, teacher rows): K1 (forward, at
# the student's rows and the ESD teacher's) and K2/K3 (backward, the student's)
# on the training paths. Head dims 40 and 80 run zero-padded to 64 and 128, as
# ops/attention.py pads them.
TRAIN_SHAPES = [
    ("self_1024", 1024, 1024, 10, 64, 1, 3),  # SDXL ESD at 512px (data/config-xl.yaml)
    ("cross_1024x77", 1024, 77, 10, 64, 1, 3),
    ("self_256", 256, 256, 20, 64, 1, 3),
    ("cross_256x77", 256, 77, 20, 64, 1, 3),
    ("sd15_self_4096", 4096, 4096, 8, 40, 1, 3),  # SD1.5 ESD at 512px (data/config.yaml)
    ("sd15_cross_4096x77", 4096, 77, 8, 40, 1, 3),
    ("sd15_self_1024", 1024, 1024, 8, 80, 1, 3),
    ("sd15_cross_1024x77", 1024, 77, 8, 80, 1, 3),
    ("sd15_pair_self_1024", 1024, 1024, 8, 40, 2, 0),  # SD1.5 image pairs at 256px: one 2-row student
    ("sd15_pair_cross_1024x77", 1024, 77, 8, 40, 2, 0),
    ("sd15_pair_self_256", 256, 256, 8, 80, 2, 0),
    ("sd15_pair_cross_256x77", 256, 77, 8, 80, 2, 0),
    ("sd21_self_4096", 4096, 4096, 5, 64, 1, 3),  # SD2.1 ESD at 512px: 5 heads of 64 at level 0
]
TRAIN_ITERATIONS = 3  # SDXL and SD1.5 ESD: 500 / 1000 cut (6 before SD3 joined the smoke, 4 before image editing)
ROUTE_ITERATIONS = 3  # the other slider routes and DoRA: 3 steps each
# (name, rows, Sq, Sk, heads, head dim): K4a's calls on the paths — the VAE
# mid-block attention (one head, head dim = channels = 512) and SD1.5's
# 1280-channel UNet level (8 heads of 160, run zero-padded to 192; bound_ms
# at 160)
KGRID_PATH_SHAPES = [
    ("decode_16384", 1, 16384, 16384, 1, 512),  # serving: the decode of one 1024px image
    ("decode_16384", 2, 16384, 16384, 1, 512),  # serving: the concurrent pair's decode
    ("encode_4096", 4, 4096, 4096, 1, 512),  # SDXL image pairs: one folder of four 512px images
    ("encode_4096", 1, 4096, 4096, 1, 512),  # one image: the launcher splits the key range
    ("encode_1024", 4, 1024, 1024, 1, 512),  # SD1.5 image pairs: one folder of four 256px images
    ("sd15_self_256", 1, 256, 256, 8, 160),  # SD1.5 ESD at 512px: the student and warm-up (rows 1) ...
    ("sd15_cross_256x77", 1, 256, 77, 8, 160),
    ("sd15_self_64", 1, 64, 64, 8, 160),
    ("sd15_cross_64x77", 1, 64, 77, 8, 160),
    ("sd15_self_256", 3, 256, 256, 8, 160),  # ... and the teacher (rows 3)
    ("sd15_cross_256x77", 3, 256, 77, 8, 160),
    ("sd15_pair_self_64", 2, 64, 64, 8, 160),  # SD1.5 image pairs at 256px: rows 2
    ("sd15_pair_cross_64x77", 2, 64, 77, 8, 160),
    ("sd15_pair_self_16", 2, 16, 16, 8, 160),
    ("sd15_pair_cross_16x77", 2, 16, 77, 8, 160),
]
# SD1.5 serving at 512px: (name, Sq, Sk, heads, head dim), each at rows 2
# (one request with CFG) and 4 (a pair). K1's head dims 40 and 80 run padded
# to 64 and 128, K4a's 160 to 192.
SD15 = "runwayml/stable-diffusion-v1-5"
SD21 = "stabilityai/stable-diffusion-2-1"
SD_SERVE_K1_SHAPES = [
    ("sd15_serve_self_4096", 4096, 4096, 8, 40),
    ("sd15_serve_cross_4096x77", 4096, 77, 8, 40),
    ("sd15_serve_self_1024", 1024, 1024, 8, 80),
    ("sd15_serve_cross_1024x77", 1024, 77, 8, 80),
]
SD_SERVE_K4A_SHAPES = [
    ("sd15_serve_self_256", 256, 256, 8, 160),
    ("sd15_serve_cross_256x77", 256, 77, 8, 160),
]
# image-pair training: folder i holds the renders at IMAGE_SCALES[i]
IMAGE_FOLDERS = ["minus2", "minus1", "plus1", "plus2"]
IMAGE_SCALES = [-2.0, -1.0, 1.0, 2.0]
IMAGES_PER_FOLDER = 4
REPO = Path(__file__).resolve().parent


T_START = time.time()


def emit(obj) -> None:
    """One JSON line; a phase's row carries ``at_s``, the seconds since the
    smoke started (phase durations are the differences)."""
    if "phase" in obj:
        obj = dict(obj, at_s=round(time.time() - T_START, 1))
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def ptxas_summary(info: dict) -> list:
    """Registers and spill bytes per compiled kernel, from nvcc's -Xptxas -v."""
    out = []
    for lib in info.values():
        fn = None
        for line in lib.get("ptxas", "").splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                out.append(dict(kernel=fn, spill_stores=int(m.group(1)), spill_loads=int(m.group(2))))
            m = re.search(r"Used (\d+) registers", line)
            if m and out and out[-1]["kernel"] == fn:
                out[-1]["registers"] = int(m.group(1))
    return out


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(rows: int, sq: int, sk: int, h: int, d: int, dtype) -> tuple:
    """Least time the card needs for one call: max(flops / peak, bytes / HBM rate)."""
    flops = 4 * rows * h * sq * sk * d
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * rows * h * d * (2 * sq + 2 * sk) + 4 * rows * h * sq  # q,k,v,o + lse
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bwd_bound(kind: str, sq: int, sk: int, h: int, d: int, dtype) -> tuple:
    """Least time for K2 ("dq": 6·BH·Sq·Sk·D flops) or K3 ("dkv": 8·BH·Sq·Sk·D):
    max(flops / peak, bytes / HBM rate), ``h`` = batch·heads, ``d`` the head
    dim the attention needs (before padding); bytes are the kernel's inputs
    (q, k, v, o, dO, lse, δ) read once and its outputs written once."""
    item = torch.empty((), dtype=dtype).element_size()
    if kind == "dq":  # q, o, dO in, dQ out; k, v in; lse in, δ out
        flops, nbytes = 6 * h * sq * sk * d, item * h * d * (4 * sq + 2 * sk) + 8 * h * sq
    else:  # q, dO in; k, v in, dK, dV out; lse, δ in
        flops, nbytes = 8 * h * sq * sk * d, item * h * d * (2 * sq + 4 * sk) + 8 * h * sq
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def grad_tol(ref: torch.Tensor, dtype) -> float:
    """K2/K3 vs their fp32 plain version. fp32 as K1. bf16: rounding the
    gradient alone costs up to 2^-8 of its value, so 2e-2 of the largest —
    with no 3e-2 cap, since gradients are not bounded as softmax outputs are
    (bf16 rounding alone passes 3e-2 once |dK| or |dV| is above ~8) — and
    never below the fp32 bound. The same bound as tests/test_torch_cuda.py."""
    m = ref.abs().max().item()
    return FP32_TOL * max(1.0, m) if dtype == torch.float32 else max(FP32_TOL, BF16_REL * m)


def path_randn(gen: torch.Generator, lead: tuple, d: int, dtype) -> torch.Tensor:
    """N(0, 1) of shape ``lead + (d,)`` on the card, zero-padded up to a
    multiple of 64 in the head dim as ops/attention.py pads a path's q, k, v
    (and as autograd hands the backward a padded dO)."""
    x = torch.randn((*lead, d), generator=gen, device="cuda").to(dtype)
    return F.pad(x, (0, -d % 64)) if d % 64 else x


def check_fwd(name: str, kernel, plain, q, k, v, what: str, scale=None) -> dict:
    """A forward kernel (K1 or K4a) against its plain version on q, k, v in
    fp32; raises on disagreement. Returns (out, lse) and the errors with their
    bounds. ``scale`` defaults to the head dim's, as the path's unpadded
    attentions take it."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, lse = kernel(q, k, v, scale)
    torch.cuda.synchronize()
    ref_out, ref_lse = plain(q.float(), k.float(), v.float(), scale)
    err = (out.float() - ref_out).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    ref_max = ref_out.abs().max().item()
    tol = min(BF16_TOL, BF16_REL * ref_max) if q.dtype == torch.bfloat16 else FP32_TOL
    if not err <= tol or not lse_err <= LSE_TOL:
        raise AssertionError(f"{name} disagrees with its plain version at {what}: {err} > {tol} (lse {lse_err})")
    return dict(out=out, lse=lse, max_abs_err=err, ref_max_abs=ref_max, tol=tol, lse_max_abs_err=lse_err,
                lse_tol=LSE_TOL)


def check_k1(q, k, v, what: str, scale=None) -> dict:
    return check_fwd("K1", fa.flash_attention_fwd, fa.flash_attention_reference, q, k, v, what, scale)


def check_k4a(q, k, v, what: str, splits=None, scale=None) -> dict:
    """K4a with ``splits`` (None: the launcher's choice) against its plain
    version cut into the same key ranges, as the kernel for q's dtype cuts
    them."""
    return check_fwd("K4a", functools.partial(kg.flash_attention_kgrid_fwd, splits=splits),
                     functools.partial(kg.flash_attention_kgrid_reference, splits=splits, cut_as=q.dtype),
                     q, k, v, what, scale)


def device_ms(fn, iters: int):
    """Device time of one call of ``fn``: the summed durations of the kernels
    (and copies) it runs on the card, under torch.profiler. Unlike cuda_ms it
    leaves out the host's gaps between launches, which dominate a call of a
    few tens of microseconds. The profiler now and then returns a window
    with no device activity at all: such a window is taken again, up to
    three times, and then reported as not measured (None)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        prof = profiled_window(lambda: [fn() for _ in range(iters)])
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if us > 0:
            return us / 1e3 / iters
    return None


def profiled_window(fn):
    """``fn()`` (then a synchronize) under torch.profiler, tracing the
    card's activity alone: the host's operator events, which the device
    times here never read, cost tens of seconds to collect over a
    training step's ~10⁵ kernels. A window that shows no kernel is traced
    again with the host's events too (the tracer's older mode)."""
    from torch.profiler import ProfilerActivity, profile

    for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        if any(str(getattr(e, "device_type", "")).endswith("CUDA") for e in prof.events()):
            break
    return prof


def sdpa_backward_ms(q, k, v, do, iters: int) -> float:
    """SDPA's backward (dQ, dK, dV together): the device time of
    forward+backward minus that of the forward (device_ms; on the host's
    clock autograd's own cost swamps the difference at small shapes)."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    both, forward = device_ms(fwd_bwd, iters), device_ms(fwd, iters)
    return None if both is None or forward is None else both - forward


def phase_kernel_bwd(gen: torch.Generator) -> tuple:
    """K1 (out and lse) and K2/K3 vs their plain versions at the training
    paths' shapes (TRAIN_SHAPES: SDXL, SD1.5 ESD and image pairs, SD2.1), on
    inputs zero-padded to the kernel's head dim as the path pads them: K1 at
    the student's rows (also the ESD warm-up's) and the ESD teacher's 3
    ([positive, neutral, negative]), K2/K3 at the student's; ragged and
    strided-dO checks. Returns the K2/K3 rows (one per shape and dtype) and
    the K1 rows."""
    rows, k1_rows = [], []
    cases = [(*shape, dt) for dt in (torch.bfloat16, torch.float32) for shape in TRAIN_SHAPES]
    for name, sq, sk, h, d, n_rows, teacher_rows, dtype in cases:
        scale = d**-0.5
        checked = []
        if teacher_rows:
            q3, k3, v3 = (path_randn(gen, (teacher_rows, s, h), d, dtype) for s in (sq, sk, sk))
            checked.append((teacher_rows, check_k1(q3, k3, v3, f"{name} rows={teacher_rows} {dtype}", scale)))
            del q3, k3, v3
        q, do = (path_randn(gen, (n_rows, sq, h), d, dtype) for _ in range(2))
        k, v = (path_randn(gen, (n_rows, sk, h), d, dtype) for _ in range(2))
        student = check_k1(q, k, v, f"{name} rows={n_rows} {dtype}", scale)
        checked.append((n_rows, student))
        o, lse = student["out"], student["lse"]
        for r, c in checked:
            k1_rows.append(dict(shape=name, rows=r, head_dim=d, padded_head_dim=q.shape[-1], dtype=str(dtype),
                                **{key: val for key, val in c.items() if key not in ("out", "lse")}))
        del checked, student
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale)
        torch.cuda.synchronize()
        # K2's key-range and K3's query-range splits, as the wrappers chose them
        k2_splits = fa.pick_k2_splits(n_rows * h, sq, sk, dtype)
        splits = fa.pick_k3_splits(n_rows * h, sq, sk, dtype)
        ref = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale,
                                               splits, dq_splits=k2_splits)
        errs = {g: (got.float() - want).abs().max().item() for g, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
        tols = {g: grad_tol(want, dtype) for g, want in zip(("dq", "dk", "dv"), ref)}
        del dq, dk, dv, ref
        iters = 20 if sk > 77 else 50
        row = dict(
            phase="kernel_bwd", shape=name, rows=n_rows, sq=sq, sk=sk, heads=h, head_dim=d,
            padded_head_dim=q.shape[-1], dtype=str(dtype), k2_splits=k2_splits, k3_splits=splits,
            max_abs_err=errs, tol=tols,
            k2_ms=cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale), iters),
            k3_ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale), iters),
            k2_device_ms=device_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale), 10),
            k3_device_ms=device_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale), 10),
            k2_plain_ms=cuda_ms(lambda: fa.bwd_dq_reference(q, k, v, o, lse, do, scale), 5),
            k3_plain_ms=cuda_ms(lambda: fa.bwd_dkv_reference(q, k, v, lse, delta, do, scale), 5),
            # SDPA on the unpadded head dim: the same function the path needs
            library_ms=library_backward_ms(*(x[..., :d] for x in (q, k, v, do)), 10),
        )
        if dtype == torch.bfloat16:  # the wrapper's host cost per call (checks, allocations, launches)
            row["k2_host_us_per_call"] = host_us(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale))
        (row["k2_bound_ms"], row["k2_bound_by"]), (row["k3_bound_ms"], row["k3_bound_by"]) = (
            bwd_bound("dq", sq, sk, n_rows * h, d, dtype), bwd_bound("dkv", sq, sk, n_rows * h, d, dtype))
        # device times against the bound (at the unpadded head dim) and SDPA's whole backward
        for kern, mult in (("k2", 6), ("k3", 8)):
            row.update({f"{kern}_{key}": val for key, val in rates(
                mult * n_rows * h * sq * sk * d, row[f"{kern}_device_ms"], row[f"{kern}_bound_ms"],
                row["library_ms"]).items()})
        emit(row)
        bad = [g for g in errs if not errs[g] <= tols[g]]
        if bad:
            raise AssertionError(f"K2/K3 disagree with their plain versions at {name} {dtype}: {bad} {errs} > {tols}")
        rows.append(row)
        del q, k, v, o, lse, do, delta
        torch.cuda.empty_cache()

    # ragged tails and a strided dO (a head slice of a wider tensor), both dtypes
    d = 64
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        for sk in (77, 129):
            b, sq, h = 2, 65, 3
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
            wide = torch.randn((b, sq, 2 * h, d), generator=gen, device="cuda").to(dtype)
            do = wide[:, :, 1::2]
            o, lse = fa.flash_attention_fwd(q, k, v)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, d**-0.5)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), d**-0.5)
            ref = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                                   d**-0.5)
            errs = [(x.float() - w).abs().max().item() for x, w in zip(got, ref)]
            tols = [grad_tol(w, dtype) for w in ref]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            checks.append(dict(dtype=str(dtype), sq=sq, sk=sk, strided_do=True, max_abs_err=errs, tol=tols,
                               strided_equals_contiguous=same))
            if not same or any(not e <= t for e, t in zip(errs, tols)):
                raise AssertionError(f"K2/K3 ragged/strided check failed: {checks[-1]}")
    emit(dict(phase="kernel_bwd", ragged_and_strided=checks))

    # bf16 K2 with its key split and K3 with its query split forced to 1, 2
    # and the maximum (64: empty splits included) against the plain versions
    # over the same splits, and repeated calls bit for bit, at every training
    # shape; K2's δ is the same bits at every split count (split 0 writes it)
    forced, forced_k2 = [], []
    for name, sq, sk, h, d, n_rows, _ in TRAIN_SHAPES:
        scale = d**-0.5
        q, do = (path_randn(gen, (n_rows, sq, h), d, torch.bfloat16) for _ in range(2))
        k, v = (path_randn(gen, (n_rows, sk, h), d, torch.bfloat16) for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
        for splits in (1, 2, fa.MAX_SPLITS):
            got, got_delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, splits=splits)
            again, again_delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, splits=splits)
            want, _ = fa.bwd_dq_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale, splits)
            torch.cuda.synchronize()
            err, tol = (got.float() - want).abs().max().item(), grad_tol(want, torch.bfloat16)
            same = torch.equal(got, again) and torch.equal(got_delta, again_delta) and torch.equal(got_delta, delta)
            forced_k2.append(dict(shape=name, rows=n_rows, padded_head_dim=q.shape[-1], splits=splits,
                                  rule_splits=fa.pick_k2_splits(n_rows * h, sq, sk), max_abs_err_dq=err, tol=tol,
                                  repeat_and_delta_bit_equal=same))
            if not same or not err <= tol:
                raise AssertionError(f"K2 with forced splits failed: {forced_k2[-1]}")
            del got, again, want
            got = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits)
            again = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits)
            want = fa.bwd_dkv_reference(q.float(), k.float(), v.float(), lse, delta, do.float(), scale, splits)
            torch.cuda.synchronize()
            errs = [(x.float() - w).abs().max().item() for x, w in zip(got, want)]
            tols = [grad_tol(w, torch.bfloat16) for w in want]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            forced.append(dict(shape=name, rows=n_rows, padded_head_dim=q.shape[-1], splits=splits,
                               rule_splits=fa.pick_k3_splits(n_rows * h, sq, sk), max_abs_err_dk_dv=errs, tol=tols,
                               repeat_bit_equal=same))
            if not same or any(not e <= t for e, t in zip(errs, tols)):
                raise AssertionError(f"K3 with forced splits failed: {forced[-1]}")
            del got, again, want
        del q, k, v, o, lse, do, delta
        torch.cuda.empty_cache()
    emit(dict(phase="kernel_bwd", k2_forced_splits_bf16=forced_k2))
    emit(dict(phase="kernel_bwd", k3_forced_splits_bf16=forced))
    emit(dict(phase="kernel_bwd", k2_ragged_and_views_bf16=check_k2_edges(gen)))
    emit(dict(phase="kernel_bwd", k1_at_training_shapes=k1_rows))
    return rows, k1_rows


def check_k2(q, k, v, o, lse, do, what: str) -> dict:
    """K2 (with the split its rule picks) against its plain version over the
    same key splits, δ within the fp32 bound; raises on disagreement."""
    scale = q.shape[-1] ** -0.5
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
    b, sq, h, _ = q.shape
    splits = fa.pick_k2_splits(b * h, sq, k.shape[1], q.dtype)
    want, want_delta = fa.bwd_dq_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale,
                                           splits)
    err, tol = (dq.float() - want).abs().max().item(), grad_tol(want, q.dtype)
    delta_err, delta_tol = (delta - want_delta).abs().max().item(), grad_tol(want_delta, torch.float32)
    if not err <= tol or not delta_err <= delta_tol:
        raise AssertionError(f"K2 disagrees with its plain version at {what}: dq {err} > {tol} or delta "
                             f"{delta_err} > {delta_tol}")
    return dict(dq=dq, delta=delta, splits=splits, max_abs_err=err, tol=tol, delta_max_abs_err=delta_err)


def check_k2_edges(gen: torch.Generator) -> list:
    """bf16 K2 at ragged Sq/Sk around its 64-row and 64-key tiles (d 64 and
    128); on q, k, v, o and dO that are head slices of wider tensors (a
    strided dO as autograd hands it) and views off 16 bytes (copied once by
    the wrapper), bit-equal to contiguous copies."""
    checks = []
    bf = torch.bfloat16
    for dd in (64, 128):
        for s in (1, 63, 65, 77, 129, 4097):
            for sq, sk in ((s, s), (s, 77), (77, s)):
                q, do = (torch.randn((2, sq, 3, dd), generator=gen, device="cuda").to(bf) for _ in range(2))
                k, v = (torch.randn((2, sk, 3, dd), generator=gen, device="cuda").to(bf) for _ in range(2))
                o, lse = fa.flash_attention_fwd(q, k, v)
                c = check_k2(q, k, v, o, lse, do, f"ragged Sq {sq} Sk {sk} d {dd} bf16")
                checks.append(dict(sq=sq, sk=sk, head_dim=dd, splits=c["splits"], max_abs_err=c["max_abs_err"],
                                   tol=c["tol"], delta_max_abs_err=c["delta_max_abs_err"]))
        for kind, make in (("strided", lambda n: torch.randn((2, n, 6, dd), generator=gen, device="cuda").to(bf)[
                                :, :, 1::2]),
                           ("unaligned", lambda n: torch.randn((2, n, 3, dd + 8), generator=gen, device="cuda").to(bf)[
                                ..., 1:dd + 1])):
            q, k, v, o, do = make(300), make(200), make(200), make(300), make(300)
            out, lse = fa.flash_attention_fwd(q, k, v)
            o.copy_(out)
            before = fa.flash_attention_bwd_dq.launches
            c = check_k2(q, k, v, o, lse, do, f"{kind} views d {dd} bf16")
            contiguous = fa.flash_attention_bwd_dq(*(x.contiguous() for x in (q, k, v, o)), lse, do.contiguous(),
                                                   dd**-0.5)
            same = torch.equal(c["dq"], contiguous[0]) and torch.equal(c["delta"], contiguous[1])
            launched = fa.flash_attention_bwd_dq.launches - before
            checks.append(dict(sq=300, sk=200, head_dim=dd, views=kind, max_abs_err=c["max_abs_err"], tol=c["tol"],
                               equals_contiguous=same, launches=launched))
            if not same or launched != 2:
                raise AssertionError(f"K2 on {kind} views: {checks[-1]}")
    return checks


def rates(flops: float, ms, bound_ms: float, library_ms) -> dict:
    """Achieved TFLOP/s, the share of the bound, and the time over the
    library call's (None when there is none, or when ``ms`` was not
    measured)."""
    if not ms:
        return dict(tflops=None, share_of_bound=None, over_library=None)
    return dict(tflops=flops / ms / 1e9, share_of_bound=bound_ms / ms,
                over_library=ms / library_ms if library_ms else None)


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds of one call (the wrapper's checks, allocations and
    launch) on the host's clock, without waiting for the card: meaningful at
    a shape whose device time is below it."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


def phase_kernel(gen: torch.Generator) -> list:
    """K1 vs plain at the path's shapes; per bf16 row the device times of K1
    and SDPA's forward, and from them the achieved TFLOP/s, the share of the
    bound and the ratio to SDPA; K1's host microseconds per call at the
    smallest serving shape. bf16 K1 (the tensor-core kernel) on ragged
    lengths, a strided view and a view that fails TMA's alignment. Returns
    one row per path shape."""
    rows, d = 2, 64  # one 1024px request with CFG
    results = []
    cases = [(n, sq, sk, h, torch.bfloat16) for n, sq, sk, h in PATH_SHAPES]
    cases += [(n + "_fp32", sq, sk, h, torch.float32) for n, sq, sk, h in PATH_SHAPES]
    for name, sq, sk, h, dtype in cases:
        q, k, v = (torch.randn((rows, s, h, d), generator=gen, device="cuda").to(dtype) for s in (sq, sk, sk))
        c = check_k1(q, k, v, name)
        iters = 20 if sk > 77 else 50
        kernel_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), iters)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, d**-0.5), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
        bound_ms, bound_by = bound(rows, sq, sk, h, d, dtype)
        row = dict(
            phase="kernel", shape=name, rows=rows, sq=sq, sk=sk, heads=h, head_dim=d, dtype=str(dtype),
            **{key: val for key, val in c.items() if key not in ("out", "lse")},
            kernel_ms=kernel_ms, device_ms=device_ms(lambda: fa.flash_attention_fwd(q, k, v), 10), plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        )
        if dtype == torch.bfloat16:
            row["library_device_ms"] = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
            row.update(rates(4 * rows * h * sq * sk * d, row["device_ms"], bound_ms, row["library_device_ms"]))
        if name == "cross_1024x77":  # 12 µs on the card: the host's cost shows
            row["host_us_per_call"] = host_us(lambda: fa.flash_attention_fwd(q, k, v))
        emit(row)
        results.append(row)

    # bf16 K1 at ragged lengths around its 128-row tiles, at both head dims,
    # and on q/k/v that are head slices of wider tensors (as a fused
    # projection's view gives them), bit-equal to contiguous copies
    checks = []
    for dd in (64, 128):
        for s in (1, 63, 65, 77, 129, 4097):
            for sq, sk in ((s, s), (s, 77), (77, s)):
                q = torch.randn((2, sq, 3, dd), generator=gen, device="cuda").to(torch.bfloat16)
                k, v = (torch.randn((2, sk, 3, dd), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
                c = check_k1(q, k, v, f"ragged Sq {sq} Sk {sk} d {dd} bf16")
                checks.append(dict(sq=sq, sk=sk, head_dim=dd, max_abs_err=c["max_abs_err"], tol=c["tol"],
                                   lse_max_abs_err=c["lse_max_abs_err"]))
        wide = [torch.randn((2, 300, 6, dd), generator=gen, device="cuda").to(torch.bfloat16)[:, :, 1::2]
                for _ in range(3)]
        c = check_k1(*wide, f"strided head slices d {dd} bf16")
        same = all(torch.equal(a, b) for a, b in zip((c["out"], c["lse"]),
                                                      fa.flash_attention_fwd(*(x.contiguous() for x in wide))))
        checks.append(dict(sq=300, sk=300, head_dim=dd, strided=True, max_abs_err=c["max_abs_err"], tol=c["tol"],
                           lse_max_abs_err=c["lse_max_abs_err"], equals_contiguous=same))
        if not same:
            raise AssertionError(f"K1 on strided views differs from contiguous copies at d {dd}")
        # rows that start 2 bytes past 16: the wrapper copies them once (the
        # header's rule) and launches the tensor-core kernel on the copy
        odd = [torch.randn((2, 300, 3, dd + 8), generator=gen, device="cuda").to(torch.bfloat16)[..., 1:dd + 1]
               for _ in range(3)]
        before = fa.flash_attention_fwd.launches
        c = check_k1(*odd, f"views off TMA's 16-byte alignment d {dd} bf16")
        same = all(torch.equal(a, b) for a, b in zip((c["out"], c["lse"]),
                                                      fa.flash_attention_fwd(*(x.contiguous() for x in odd))))
        launched = fa.flash_attention_fwd.launches - before
        checks.append(dict(sq=300, sk=300, head_dim=dd, unaligned=True, max_abs_err=c["max_abs_err"], tol=c["tol"],
                           lse_max_abs_err=c["lse_max_abs_err"], equals_contiguous=same, launches=launched))
        if not same or launched != 2:
            raise AssertionError(f"K1 on unaligned views: {checks[-1]}")
    emit(dict(phase="kernel", k1_ragged_strided_unaligned_bf16=checks))
    return results


def sdpa_ms(q, k, v, iters: int):
    """F.scaled_dot_product_attention on the same BSHD tensors, or None when
    no backend takes them."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        return cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), iters)
    except RuntimeError:
        return None


def phase_kernel_kgrid(gen: torch.Generator) -> tuple:
    """K4a vs its plain version at every path shape (KGRID_PATH_SHAPES; bf16
    and fp32, timed in bf16: events, device time, host µs per call, the plain
    version, SDPA's forward on the unpadded head dim, the bound); bf16 with
    the key-range split forced to 1, 2 and 64 at every path shape, repeated
    calls bit for bit; ragged Sq/Sk at d 64, 192, 320 and 512 (one and two
    consumer warpgroups); head slices and views off 16 bytes bit-equal to
    contiguous copies; the fp32 kernel's forced splits. Returns the timed
    rows and every check's error."""
    rows_out, errors = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for name, rows, sq, sk, h, d in KGRID_PATH_SHAPES:
            q, k, v = (path_randn(gen, (rows, n, h), d, dtype) for n in (sq, sk, sk))
            scale = d**-0.5
            c = check_k4a(q, k, v, f"{name} rows={rows} {dtype}", scale=scale)
            row = dict(phase="kernel_kgrid", shape=name, rows=rows, sq=sq, sk=sk, heads=h, head_dim=d,
                       padded_head_dim=q.shape[-1], dtype=str(dtype),
                       splits=kg.pick_splits(rows * h, sq, sk, dtype),
                       **{key: val for key, val in c.items() if key not in ("out", "lse")})
            del c
            errors.append(row["max_abs_err"])
            if dtype == torch.bfloat16:
                big = rows * sq * sk >= 1 << 26
                k4a = lambda: kg.flash_attention_kgrid_fwd(q, k, v, scale)  # noqa: E731
                qt, kt, vt = (x[..., :d].transpose(1, 2) for x in (q, k, v))
                row.update(kernel_ms=cuda_ms(k4a, 5 if big else 50), device_ms=device_ms(k4a, 3 if big else 10),
                           host_us_per_call=host_us(k4a, 10 if big else 200),
                           plain_ms=cuda_ms(lambda: kg.flash_attention_kgrid_reference(q, k, v, scale), 2),
                           library_ms=sdpa_ms(*(x[..., :d] for x in (q, k, v)), 5 if big else 50))
                try:
                    row["library_device_ms"] = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
                except RuntimeError:
                    row["library_device_ms"] = None
                row["bound_ms"], row["bound_by"] = bound(rows, sq, sk, h, d, dtype)
                row.update(rates(4 * rows * h * sq * sk * d, row["device_ms"], row["bound_ms"],
                                 row["library_device_ms"]))
                rows_out.append(row)
            emit(row)
            del q, k, v
            torch.cuda.empty_cache()

    # bf16: the split forced to 1, 2 and the maximum (64: empty splits
    # included) at every path shape, against the plain version cut into the
    # same 64-key units; a repeated call gives the same bits
    forced = []
    for name, rows, sq, sk, h, d in KGRID_PATH_SHAPES:
        q, k, v = (path_randn(gen, (rows, n, h), d, torch.bfloat16) for n in (sq, sk, sk))
        for splits in (1, 2, fa.MAX_SPLITS):
            c = check_k4a(q, k, v, f"{name} rows={rows} splits {splits} bf16", splits=splits, scale=d**-0.5)
            again = kg.flash_attention_kgrid_fwd(q, k, v, d**-0.5, splits=splits)
            same = torch.equal(c["out"], again[0]) and torch.equal(c["lse"], again[1])
            forced.append(dict(shape=name, rows=rows, splits=splits, rule_splits=kg.pick_splits(
                rows * h, sq, sk, torch.bfloat16), max_abs_err=c["max_abs_err"], tol=c["tol"],
                lse_max_abs_err=c["lse_max_abs_err"], repeat_bit_equal=same))
            errors.append(c["max_abs_err"])
            if not same:
                raise AssertionError(f"K4a with forced splits changed its bits on repeat: {forced[-1]}")
            del c, again
        del q, k, v
        torch.cuda.empty_cache()
    emit(dict(phase="kernel_kgrid", k4a_forced_splits_bf16=forced))

    # bf16 at ragged lengths around the 64-row q tiles and the 32/64-key
    # tiles, one and two consumer warpgroups; head slices of wider tensors
    # and views off TMA's 16-byte alignment (copied once by the wrapper),
    # bit-equal to contiguous copies
    edges = []
    for dd in (64, 192, 320, 512):
        for s in (1, 63, 65, 77, 129, 4097):
            for sq, sk in ((s, s), (s, 77), (77, s)):
                q = torch.randn((2, sq, 2, dd), generator=gen, device="cuda").to(torch.bfloat16)
                k, v = (torch.randn((2, sk, 2, dd), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
                c = check_k4a(q, k, v, f"ragged Sq {sq} Sk {sk} d {dd} bf16")
                edges.append(dict(sq=sq, sk=sk, head_dim=dd, max_abs_err=c["max_abs_err"], tol=c["tol"],
                                  lse_max_abs_err=c["lse_max_abs_err"]))
                errors.append(c["max_abs_err"])
    for dd in (192, 512):
        for kind, make in (("strided", lambda: torch.randn((2, 300, 4, dd), generator=gen, device="cuda").to(
                               torch.bfloat16)[:, :, 1::2]),
                           ("unaligned", lambda: torch.randn((2, 300, 2, dd + 8), generator=gen, device="cuda").to(
                               torch.bfloat16)[..., 1:dd + 1])):
            q, k, v = make(), make(), make()
            before = kg.flash_attention_kgrid_fwd.launches
            c = check_k4a(q, k, v, f"{kind} views d {dd} bf16")
            out_c, lse_c = kg.flash_attention_kgrid_fwd(q.contiguous(), k.contiguous(), v.contiguous())
            same = torch.equal(c["out"], out_c) and torch.equal(c["lse"], lse_c)
            launched = kg.flash_attention_kgrid_fwd.launches - before
            edges.append(dict(sq=300, sk=300, head_dim=dd, views=kind, max_abs_err=c["max_abs_err"], tol=c["tol"],
                              equals_contiguous=same, launches=launched))
            errors.append(c["max_abs_err"])
            if not same or launched != 2:
                raise AssertionError(f"K4a on {kind} views: {edges[-1]}")
    emit(dict(phase="kernel_kgrid", k4a_ragged_and_views_bf16=edges))

    # fp32 (the SIMT kernel): the split forced to 1 and to more than 1, at one
    # 512px image (the launcher picks 3) and at the JAX test's ragged shape
    checks = []
    cases = [(1, 4096, 4096, 1, 512, sp) for sp in (1, 6)]
    cases += [(2, 300, 77, 2, dd, sp) for dd in (64, 512) for sp in (1, 3)]
    for b, sq, sk, h, dd, splits in cases:
        q = torch.randn((b, sq, h, dd), generator=gen, device="cuda")
        k, v = (torch.randn((b, sk, h, dd), generator=gen, device="cuda") for _ in range(2))
        c = check_k4a(q, k, v, f"B {b} Sq {sq} Sk {sk} H {h} d {dd} splits {splits} fp32", splits=splits)
        checks.append(dict(dtype="torch.float32", b=b, sq=sq, sk=sk, heads=h, head_dim=dd, splits=splits,
                           max_abs_err=c["max_abs_err"], tol=c["tol"], lse_max_abs_err=c["lse_max_abs_err"]))
        errors.append(c["max_abs_err"])
    emit(dict(phase="kernel_kgrid", forced_splits_fp32=checks))
    return rows_out, errors


# (name, rows, Sq, Sk): K4b/K4c's calls on the SD1.5 training paths, the
# 1280-channel level's attentions (8 heads of 160, run zero-padded to 192)
KGRID_BWD_HEADS, KGRID_BWD_D = 8, 160
KGRID_BWD_SHAPES = [
    ("esd_self_256", 1, 256, 256),  # ESD student at 512px, batch 1: down/up levels (16×16)
    ("esd_cross_256x77", 1, 256, 77),
    ("esd_self_64", 1, 64, 64),  # the mid block (8×8)
    ("esd_cross_64x77", 1, 64, 77),
    ("pair_self_64", 2, 64, 64),  # image-pair student at 256px, rows 2
    ("pair_cross_64x77", 2, 64, 77),
    ("pair_self_16", 2, 16, 16),
    ("pair_cross_16x77", 2, 16, 77),
]


def library_backward_ms(q, k, v, do, iters: int):
    """SDPA's backward (a yardstick), or None when no backend takes the shape."""
    try:
        return sdpa_backward_ms(q, k, v, do, iters)
    except RuntimeError:
        return None


def check_bwd(name: str, got, want, dtype) -> tuple:
    """(dQ, δ, dK, dV) against a reference's; raises on disagreement. The
    bounds are grad_tol's, of the reference's largest value."""
    keys = ("dq", "delta", "dk", "dv")
    errs = {g: (x.float() - w.float()).abs().max().item() for g, x, w in zip(keys, got, want)}
    tols = {g: grad_tol(w.float(), dtype) for g, w in zip(keys, want)}
    bad = [g for g in errs if not errs[g] <= tols[g]]
    if bad:
        raise AssertionError(f"{name}: {bad} {errs} > {tols}")
    return errs, tols


def kgrid_bwd_all(q, k, v, o, lse, do, scale, splits=None, dq_splits=None) -> tuple:
    """K4b then K4c: (dQ, δ, dK, dV); ``dq_splits`` is K4b's split of the key
    range, ``splits`` K4c's of the query range (None: the rules')."""
    dq, delta = kg.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, scale, splits=dq_splits)
    dk, dv = kg.flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits)
    return dq, delta, dk, dv


def kgrid_bwd_plain(q, k, v, o, lse, do, scale, splits=None, dq_splits=None) -> tuple:
    """The plain versions of K4b and K4c in fp32, over the key and query
    ranges the kernels for q's dtype cut (None: the rules' counts): (dQ, δ,
    dK, dV)."""
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, o, do))
    dq, delta = kg.kgrid_bwd_dq_reference(qf, kf, vf, of, lse, gf, scale, dq_splits, cut_as=q.dtype)
    dk, dv = kg.kgrid_bwd_dkv_reference(qf, kf, vf, lse, delta, gf, scale, splits, cut_as=q.dtype)
    return dq, delta, dk, dv


def check_kgrid_bwd(q, k, v, o, lse, do, what: str, scale=None, splits=None, dq_splits=None) -> dict:
    """K4b and K4c (splits as kgrid_bwd_all takes them) against their plain
    versions over the same ranges; raises on disagreement. Returns the
    gradients (dQ, δ, dK, dV), the errors and their bounds."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    got = kgrid_bwd_all(q, k, v, o, lse, do, scale, splits, dq_splits)
    torch.cuda.synchronize()
    errs, tols = check_bwd(f"K4b/K4c at {what}", got, kgrid_bwd_plain(q, k, v, o, lse, do, scale, splits, dq_splits),
                           q.dtype)
    return dict(grads=got, max_abs_err=errs, tol=tols)


def phase_kernel_kgrid_bwd(gen: torch.Generator) -> tuple:
    """K4b (dQ, δ) and K4c (dK, dV) against their plain versions at the SD1.5
    training paths' shapes (bf16 and fp32; timed in bf16), on d-160 inputs
    zero-padded to 192 as the path pads them, with K4a's O and lse as the
    forward gives them; ragged shapes, d 64 and 512, a strided dO, the
    query-range split forced to 1 and to more, two identical calls bit-equal;
    bf16 with both splits forced at every path shape; bf16 ragged lengths
    at five head dims, head slices and unaligned views; and at d 64 against
    K2/K3 on K1's O and lse. Returns the timed rows and every K4b and K4c
    error."""
    h, d = KGRID_BWD_HEADS, KGRID_BWD_D
    scale = d**-0.5
    rows_out, errs_b, errs_c, k4a_rows = [], [], [], []

    def note(c: dict) -> None:
        errs_b.append(c["max_abs_err"]["dq"])
        errs_c.append(max(c["max_abs_err"]["dk"], c["max_abs_err"]["dv"]))

    for dtype in (torch.bfloat16, torch.float32):
        for name, rows, sq, sk in KGRID_BWD_SHAPES:
            q, do = (path_randn(gen, (rows, sq, h), d, dtype) for _ in range(2))
            k, v = (path_randn(gen, (rows, sk, h), d, dtype) for _ in range(2))
            d_pad = q.shape[-1]
            fwd = check_k4a(q, k, v, f"{name} rows={rows} {dtype}", scale=scale)
            o, lse = fwd["out"], fwd["lse"]
            k4a_rows.append(dict(shape=name, rows=rows, dtype=str(dtype), max_abs_err=fwd["max_abs_err"],
                                 tol=fwd["tol"], lse_max_abs_err=fwd["lse_max_abs_err"]))
            c = check_kgrid_bwd(q, k, v, o, lse, do, f"{name} rows={rows} {dtype}", scale)
            note(c)
            row = dict(phase="kernel_kgrid_bwd", shape=name, rows=rows, sq=sq, sk=sk, heads=h, head_dim=d,
                       padded_head_dim=d_pad, dtype=str(dtype),
                       k4b_splits=kg.pick_k4b_splits(rows * h, sq, sk, d_pad, dtype),
                       dkv_splits=kg.pick_dkv_splits(rows * h, sq, sk, d_pad, dtype),
                       max_abs_err=c["max_abs_err"], tol=c["tol"])
            if dtype == torch.bfloat16:
                delta = c["grads"][1]
                k4b = lambda: kg.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, scale)  # noqa: E731
                k4c = lambda: kg.flash_attention_kgrid_bwd_dkv(q, k, v, lse, delta, do, scale)  # noqa: E731
                row.update(
                    k4b_ms=cuda_ms(k4b, 50), k4c_ms=cuda_ms(k4c, 50),
                    k4b_device_ms=device_ms(k4b, 10), k4c_device_ms=device_ms(k4c, 10),
                    k4b_host_us_per_call=host_us(k4b), k4c_host_us_per_call=host_us(k4c),
                    k4b_plain_ms=cuda_ms(lambda: kg.kgrid_bwd_dq_reference(q, k, v, o, lse, do, scale), 5),
                    k4c_plain_ms=cuda_ms(lambda: kg.kgrid_bwd_dkv_reference(q, k, v, lse, delta, do, scale), 5),
                    # SDPA on the unpadded head dim: the same function the path needs
                    library_ms=library_backward_ms(*(x[..., :d] for x in (q, k, v, do)), 10),
                )
                (row["k4b_bound_ms"], row["k4b_bound_by"]), (row["k4c_bound_ms"], row["k4c_bound_by"]) = (
                    bwd_bound("dq", sq, sk, rows * h, d, dtype), bwd_bound("dkv", sq, sk, rows * h, d, dtype))
                # device times against the bound (at the unpadded head dim) and SDPA's whole backward
                for kern, mult in (("k4b", 6), ("k4c", 8)):
                    row.update({f"{kern}_{key}": val for key, val in rates(
                        mult * rows * h * sq * sk * d, row[f"{kern}_device_ms"], row[f"{kern}_bound_ms"],
                        row["library_ms"]).items()})
                rows_out.append(row)
            emit(row)
            del q, k, v, o, lse, do, c
            torch.cuda.empty_cache()

    # ragged tails, every head-dim class's edge (d 64, 192, 320, 512), one
    # row / one key, the split forced to 1 and to more (empty splits
    # included), a strided dO (a head slice of a wider tensor) equal to a
    # contiguous one bit for bit, and two identical calls bit-equal
    checks = []
    cases = [(1, 65, 33, 3, 192, None), (2, 300, 77, 2, 512, None), (2, 300, 77, 2, 64, None),
             (1, 1, 1, 1, 512, None), (1, 70, 100, 1, 320, None)]
    cases += [(1, 256, 77, 8, 192, sp) for sp in (1, 4, 12)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, sq, sk, hh, dd, splits in cases:
            q = torch.randn((b, sq, hh, dd), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((b, sk, hh, dd), generator=gen, device="cuda").to(dtype) for _ in range(2))
            do = torch.randn((b, sq, 2 * hh, dd), generator=gen, device="cuda").to(dtype)[:, :, 1::2]
            o, lse = kg.flash_attention_kgrid_fwd(q, k, v)
            used = kg.pick_dkv_splits(b * hh, sq, sk, dd, dtype) if splits is None else splits
            c = check_kgrid_bwd(q, k, v, o, lse, do, f"B {b} Sq {sq} Sk {sk} H {hh} d {dd} splits {used} {dtype}",
                                splits=used)
            again = kgrid_bwd_all(q, k, v, o, lse, do.contiguous(), dd**-0.5, used)
            same = all(torch.equal(x, y) for x, y in zip(c["grads"], again))
            checks.append(dict(dtype=str(dtype), b=b, sq=sq, sk=sk, heads=hh, head_dim=dd, dkv_splits=used,
                               strided_do=True, max_abs_err=c["max_abs_err"], tol=c["tol"],
                               repeat_and_contiguous_bit_equal=same))
            if not same:
                raise AssertionError(f"K4b/K4c: strided dO or a repeated call changed the bits: {checks[-1]}")
            note(c)
    emit(dict(phase="kernel_kgrid_bwd", ragged_splits_strided=checks))

    # bf16: K4b's key split and K4c's query split forced to 1, 2 and the
    # maximum (64: empty splits included) at every path shape, against the
    # plain versions over the same 32-row units; repeated calls bit-equal,
    # and δ the same bits at every split (split 0 writes it)
    forced = []
    for name, rows, sq, sk in KGRID_BWD_SHAPES:
        q, do = (path_randn(gen, (rows, sq, h), d, torch.bfloat16) for _ in range(2))
        k, v = (path_randn(gen, (rows, sk, h), d, torch.bfloat16) for _ in range(2))
        o, lse = kg.flash_attention_kgrid_fwd(q, k, v, scale)
        _, delta = kg.flash_attention_kgrid_bwd_dq(q, k, v, o, lse, do, scale)
        for splits in (1, 2, fa.MAX_SPLITS):
            c = check_kgrid_bwd(q, k, v, o, lse, do, f"{name} rows={rows} splits {splits} bf16", scale, splits, splits)
            again = kgrid_bwd_all(q, k, v, o, lse, do, scale, splits, splits)
            same = all(torch.equal(x, y) for x, y in zip(c["grads"], again)) and torch.equal(c["grads"][1], delta)
            forced.append(dict(shape=name, rows=rows, splits=splits,
                               rule_k4b_splits=kg.pick_k4b_splits(rows * h, sq, sk, q.shape[-1], torch.bfloat16),
                               rule_dkv_splits=kg.pick_dkv_splits(rows * h, sq, sk, q.shape[-1], torch.bfloat16),
                               max_abs_err=c["max_abs_err"], tol=c["tol"], repeat_and_delta_bit_equal=same))
            if not same:
                raise AssertionError(f"K4b/K4c with forced splits changed their bits: {forced[-1]}")
            note(c)
            del c, again
        del q, k, v, o, lse, do, delta
        torch.cuda.empty_cache()
    emit(dict(phase="kernel_kgrid_bwd", k4b_k4c_forced_splits_bf16=forced))

    # bf16 at ragged lengths around the 32-row tiles and the 64/32-row
    # blocks, at one, two and four warps per slab; head slices of wider
    # tensors and views off 16 bytes (copied once by the wrappers) of q, k,
    # v, O and dO, bit-equal to contiguous copies
    edges = []
    for dd in (64, 192, 256, 320, 512):
        for s in (1, 63, 65, 77, 129):
            for sq, sk in ((s, s), (s, 77), (77, s)):
                q, do = (torch.randn((2, sq, 2, dd), generator=gen, device="cuda").to(torch.bfloat16)
                         for _ in range(2))
                k, v = (torch.randn((2, sk, 2, dd), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
                o, lse = kg.flash_attention_kgrid_fwd(q, k, v)
                c = check_kgrid_bwd(q, k, v, o, lse, do, f"ragged Sq {sq} Sk {sk} d {dd} bf16")
                edges.append(dict(sq=sq, sk=sk, head_dim=dd, max_abs_err=c["max_abs_err"], tol=c["tol"]))
                note(c)
    for dd in (192, 512):
        for kind, make in (("strided", lambda n: torch.randn((2, n, 4, dd), generator=gen, device="cuda").to(
                               torch.bfloat16)[:, :, 1::2]),
                           ("unaligned", lambda n: torch.randn((2, n, 2, dd + 8), generator=gen, device="cuda").to(
                               torch.bfloat16)[..., 1:dd + 1])):
            q, k, v, o, do = make(300), make(200), make(200), make(300), make(300)
            out, lse = kg.flash_attention_kgrid_fwd(q, k, v)
            o.copy_(out)
            before = kg.flash_attention_kgrid_bwd_dq.launches, kg.flash_attention_kgrid_bwd_dkv.launches
            c = check_kgrid_bwd(q, k, v, o, lse, do, f"{kind} views d {dd} bf16")
            contiguous = kgrid_bwd_all(*(x.contiguous() for x in (q, k, v, o)), lse, do.contiguous(), dd**-0.5)
            same = all(torch.equal(x, y) for x, y in zip(c["grads"], contiguous))
            launched = (kg.flash_attention_kgrid_bwd_dq.launches - before[0],
                        kg.flash_attention_kgrid_bwd_dkv.launches - before[1])
            edges.append(dict(sq=300, sk=200, head_dim=dd, views=kind, max_abs_err=c["max_abs_err"], tol=c["tol"],
                              equals_contiguous=same, launches=launched))
            note(c)
            if not same or launched != (2, 2):
                raise AssertionError(f"K4b/K4c on {kind} views: {edges[-1]}")
    emit(dict(phase="kernel_kgrid_bwd", k4b_k4c_ragged_and_views_bf16=edges))

    # d 64: K4b/K4c against K2/K3 on the same inputs and K1's O and lse
    versus = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, s_q, s_k, hh in ((2, 300, 77, 2), (1, 16384, 16384, 1)):
            q, do = (torch.randn((b, s_q, hh, 64), generator=gen, device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((b, s_k, hh, 64), generator=gen, device="cuda").to(dtype) for _ in range(2))
            o, lse = fa.flash_attention_fwd(q, k, v)
            k4 = kgrid_bwd_all(q, k, v, o, lse, do, 0.125)
            dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, 0.125)
            dk3, dv3 = fa.flash_attention_bwd_dkv(q, k, v, lse, delta2, do, 0.125)
            torch.cuda.synchronize()
            errs, tols = check_bwd(f"K4b/K4c vs K2/K3 at {s_q}x{s_k} B {b} H {hh} d 64 {dtype}", k4,
                                   (dq2, delta2, dk3, dv3), dtype)
            versus.append(dict(dtype=str(dtype), b=b, sq=s_q, sk=s_k, heads=hh, head_dim=64, max_abs_err=errs,
                               tol=tols))
            note(dict(max_abs_err=errs))
            del q, k, v, o, lse, do, k4, dq2, dk3, dv3
            torch.cuda.empty_cache()
    emit(dict(phase="kernel_kgrid_bwd", k4b_k4c_vs_k2_k3=versus))
    emit(dict(phase="kernel_kgrid_bwd", k4a_at_training_shapes=k4a_rows))
    return rows_out, errs_b, errs_c


def phase_parity() -> None:
    """tiny-xl sampler: card (K1 in every UNet attention) vs CPU (plain)."""
    _, _, unet_cpu, sched, _ = factory.load_models_xl("tiny-xl", scheduler_name="ddim", device="cpu", with_vae=True)
    unet_gpu = copy.deepcopy(unet_cpu).to("cuda")
    sites = lora.create_sites(unet_cpu, rank=2, train_method="full")
    g = torch.Generator().manual_seed(1)
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    schedule = sched.set_timesteps(3)
    lat = torch.randn((2, 4, 8, 8), generator=g)
    emb = torch.randn((4, 77, 32), generator=g)
    added = {"text_embeds": torch.randn((4, 32), generator=g), "time_ids": torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 4)}

    def run(unet, device):
        lp_d = {n: {k: t.to(device) for k, t in leaf.items()} for n, leaf in lp.items()}
        return sample_loop_scales(
            unet, sites, lp_d, [0.0, 1.5], 1, sched, schedule, lat.to(device), emb.to(device),
            guidance_scale=7.5, added_cond_kwargs={k: v.to(device) for k, v in added.items()},
        ).cpu()

    before = fa.flash_attention_fwd.launches
    got, want = run(unet_gpu, "cuda"), run(unet_cpu, "cpu")
    launches = fa.flash_attention_fwd.launches - before
    err = (got - want).abs().max().item()
    emit(dict(phase="parity", model="tiny-xl", steps=3, max_abs_err=err, tol=1e-3, k1_launches=launches))
    if not err <= 1e-3:
        raise AssertionError(f"tiny-xl sampler on the card differs from the CPU by {err}")
    if launches != 3 * unet_gpu.config.attention_calls_per_forward():
        raise AssertionError(f"tiny-xl sampler launched K1 {launches} times")


KERNEL_NAMES = ("K1", "K2", "K3", "K4a", "K4b", "K4c")
KERNEL_WRAPPERS = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                   kg.flash_attention_kgrid_fwd, kg.flash_attention_kgrid_bwd_dq, kg.flash_attention_kgrid_bwd_dkv)
PLAIN_VERSIONS = (fa.flash_attention_reference, fa.bwd_dq_reference, fa.bwd_dkv_reference,
                  kg.flash_attention_kgrid_reference, kg.kgrid_bwd_dq_reference, kg.kgrid_bwd_dkv_reference)


def counts() -> tuple:
    """Launches of K1, K2, K3, K4a, K4b, K4c."""
    return tuple(fn.launches for fn in KERNEL_WRAPPERS)


def plain_calls() -> tuple:
    """Calls of the kernels' plain versions (forward and backward, in the
    order of KERNEL_NAMES) on CUDA tensors."""
    return tuple(fn.cuda_calls for fn in PLAIN_VERSIONS)


def reset_counts() -> None:
    """Every launch count and plain-call count to 0, just before a path."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in PLAIN_VERSIONS:
        fn.cuda_calls = 0


def check_no_plain(path: str) -> None:
    if any(plain_calls()):
        raise AssertionError(f"{path}: a plain attention version ran on the card {plain_calls()} times")


def per_step_launches(unet_cfg: UNetConfig, forwards: int, steps: int) -> list:
    """Expected launches of K1..K4c for ``forwards`` UNet forwards and
    ``steps`` student backwards: head dims ≤ 128 run K1 (K2/K3 backward),
    129..512 K4a (K4b/K4c backward)."""
    by_dim = unet_cfg.attention_calls_by_head_dim()
    k1 = sum(n for d, n in by_dim.items() if d <= 128)
    k4 = sum(by_dim.values()) - k1
    return [forwards * k1, steps * k1, steps * k1, forwards * k4, steps * k4, steps * k4]


def esd_step_parity(phase: str, model: str, unet_cpu, sched, encode, seed: int, prompts: dict,
                    xl: bool) -> None:
    """One ESD step, fp32: card (the kernels in every attention) vs CPU (their
    plain versions), same weights, LoRA factors, prompt embeddings and draws;
    ``xl`` adds the pooled embeddings, add_time_ids and the 0.2 clip. Checks
    the launches of K1..K4c and that no plain version ran on the card."""
    unet_gpu = copy.deepcopy(unet_cpu).to("cuda")
    sites = lora.create_sites(unet_cpu, rank=2, train_method="full")
    g = torch.Generator().manual_seed(seed)
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    settings = [PromptSettings.from_dict(dict(target="person", neutral="person", action="enhance", resolution=64,
                                              **prompts))]
    bank = esd.build_prompt_bank(settings, encode)
    schedule = sched.set_timesteps(3)
    t_to = 2
    lat0 = torch.randn((1, 4, 8, 8), generator=g) * schedule.init_noise_sigma
    noise = torch.randn((t_to, 1, 4, 8, 8), generator=g)
    cfg = esd.ESDConfig(max_denoising_steps=3, height=64, width=64)

    def run(unet, device):
        lp_d = {n: {k: t.to(device).clone().requires_grad_(True) for k, t in leaf.items()} for n, leaf in lp.items()}
        bank_d = esd.PromptBank(bank.text.to(device), bank.guidance, bank.sign,
                                bank.pooled.to(device) if xl else None)
        opt = get_optimizer("adamw", get_lr_schedule("constant", 1e-3, 10), grad_clip_norm=0.2 if xl else None)
        add_time_ids = torch.from_numpy(get_add_time_ids(64, 64)).to(device) if xl else None
        step = esd.make_esd_train_step(unet, sites, lp_d, sched, schedule, opt, cfg, add_time_ids=add_time_ids)
        m = step(opt.init(flat_params(sites, lp_d)), bank_d,
                 draws=esd.Draws(0, t_to, lat0.to(device), noise.to(device)))
        return float(m["loss"]), float(m["grad_norm"]), lora.state_dict_numpy(sites, lp_d)

    reset_counts()
    got = run(unet_gpu, "cuda")
    launches = list(counts())
    check_no_plain(f"{phase} ({model})")
    want = run(unet_cpu, "cpu")
    want_launches = per_step_launches(unet_gpu.config, t_to + 2, 1)
    loss_err = abs(got[0] - want[0])
    factor_err = max(float(np.abs(got[2][k] - want[2][k]).max()) for k in want[2])
    emit(dict(phase=phase, model=model, timesteps_to=t_to, loss_card=got[0],
              loss_cpu=want[0], loss_abs_err=loss_err, grad_norm_card=got[1], grad_norm_cpu=want[1],
              factor_max_abs_err=factor_err, tol=1e-3, launches_k1_to_k4c=launches,
              expected_launches=want_launches))
    if not (loss_err <= 1e-3 * max(1.0, abs(want[0])) and factor_err <= 1e-3):
        raise AssertionError(f"{model} ESD step on the card differs from the CPU: loss {loss_err}, "
                             f"factors {factor_err}")
    if launches != want_launches:
        raise AssertionError(f"{model} ESD step launched K1..K4c {launches} times, expected {want_launches}")


def phase_train_parity() -> None:
    """One tiny-xl Euler-A ESD step (K1/K2/K3 inside), card vs CPU."""
    _, tes, unet_cpu, sched = factory.load_models_xl("tiny-xl", scheduler_name="euler_a", device="cpu")
    esd_step_parity("train_parity", "tiny-xl", unet_cpu, sched,
                    lambda p: tuple(t[0] for t in factory.encode_prompts_xl(tes, [p])), 2,
                    dict(positive="person, smiling", unconditional="person", guidance_scale=3), xl=True)


def write_image_folders(root: Path, folders, names, size: int, seed: int, first_wh=None) -> None:
    """Paired synthetic PNGs: every folder holds the same file names; image
    ``name`` is one smooth random pattern per name, a brightness step
    brighter in each next folder (the 'concept' the slider learns).
    ``first_wh`` = (w, h) writes the first folder's images stretched to that
    size (nearest pixel), so the bank resizes them back."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for name in names:
        freq, phase = rng.uniform(1, 4, (2, 3)), rng.uniform(0, 2 * np.pi, (3,))
        base = np.stack([np.sin(2 * np.pi * freq[0, c] * xx + phase[c]) * np.cos(2 * np.pi * freq[1, c] * yy)
                         for c in range(3)], -1) * 50 + 128 + rng.normal(0, 6, (size, size, 3))
        for i, folder in enumerate(folders):
            (root / folder).mkdir(parents=True, exist_ok=True)
            img = np.clip(base + 30 * (i - (len(folders) - 1) / 2), 0, 255).astype(np.uint8)
            if i == 0 and first_wh is not None:
                w, h = first_wh
                img = img[np.arange(h) * size // h][:, np.arange(w) * size // w]
            (root / folder / name).write_bytes(encode_png(img))


def phase_imageslider_parity(tmp: Path) -> None:
    """The image bank through the full SDXL VAE at 64px (K4a in the encoder's
    mid-block, 8×8 tokens × d 512) and one tiny-xl image-pair step (K1/K2/K3),
    fp32: card vs CPU, same weights, factors, prompts and draws."""
    _, tes, unet_cpu, sched, vae_cpu = factory.load_models_xl("tiny-xl", scheduler_name="euler_a", device="cpu",
                                                              with_vae=True)
    unet_gpu, vae_gpu = copy.deepcopy(unet_cpu).to("cuda"), copy.deepcopy(vae_cpu).to("cuda")
    root = tmp / "parity_images"
    write_image_folders(root, IMAGE_FOLDERS, ["a.png", "b.png"], 64, seed=3)
    sites = lora.create_sites(unet_cpu, rank=2, train_method="full")
    g = torch.Generator().manual_seed(5)
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    text, pooled = {}, {}
    for role, prompt in (("positive", "a photo of a person, smiling"), ("neutral", "a photo of a person")):
        t, p = factory.encode_prompts_xl(tes, [prompt])
        text[role], pooled[role] = t[0].clone(), p[0].clone()
    cfg = imageslider.ImageSliderConfig(max_denoising_steps=4, scaling_factor=vae_cpu.config.scaling_factor)
    draws = imageslider.Draws(pair=1, image=1, timesteps_to=2, posterior_noise=torch.randn((4, 8, 8), generator=g),
                              noise=torch.randn((1, 4, 8, 8), generator=g))

    def run(unet, vae, device):
        bank = imageslider.build_image_bank(str(root), IMAGE_FOLDERS, IMAGE_SCALES, vae.encode, 64, device=device)
        lp_d = {n: {k: t.to(device).clone().requires_grad_(True) for k, t in leaf.items()} for n, leaf in lp.items()}
        opt = get_optimizer("adamw", get_lr_schedule("constant", 1e-3, 10))
        step = imageslider.make_image_slider_step(
            unet, sites, lp_d, sched, sched.set_timesteps(cfg.max_denoising_steps), opt, cfg,
            text["positive"].to(device), text["neutral"].to(device),
            pooled={r: p.to(device) for r, p in pooled.items()},
            add_time_ids=torch.from_numpy(get_add_time_ids(64, 64)).to(device))
        d = imageslider.Draws(draws.pair, draws.image, draws.timesteps_to, draws.posterior_noise.to(device),
                              draws.noise.to(device))
        m = step(opt.init(flat_params(sites, lp_d)), bank, draws=d)
        return bank, float(m["loss"]), lora.state_dict_numpy(sites, lp_d)

    reset_counts()
    bank, loss, factors = run(unet_gpu, vae_gpu, "cuda")
    launches = list(counts())
    check_no_plain("imageslider_parity")
    want_bank, want_loss, want_factors = run(unet_cpu, vae_cpu, "cpu")
    moment_err = max((bank.mean.cpu() - want_bank.mean).abs().max().item(),
                     (bank.logvar.cpu() - want_bank.logvar).abs().max().item())
    moment_tol = 1e-3 * max(1.0, want_bank.mean.abs().max().item(), want_bank.logvar.abs().max().item())
    loss_err = abs(loss - want_loss)
    factor_err = max(float(np.abs(factors[k] - want_factors[k]).max()) for k in want_factors)
    per_fwd = unet_gpu.config.attention_calls_per_forward()
    want_launches = [per_fwd, per_fwd, per_fwd, len(IMAGE_FOLDERS), 0, 0]
    emit(dict(phase="imageslider_parity", model="tiny-xl + SDXL VAE", image_size=64, bank_shape=list(bank.mean.shape),
              pair_table=bank.pair_table, moment_max_abs_err=moment_err, moment_tol=moment_tol, loss_card=loss,
              loss_cpu=want_loss, loss_abs_err=loss_err, factor_max_abs_err=factor_err, tol=1e-3,
              launches_k1_to_k4c=launches))
    if not (moment_err <= moment_tol and loss_err <= 1e-3 * max(1.0, abs(want_loss)) and factor_err <= 1e-3):
        raise AssertionError(f"the image-pair bank or step on the card differs from the CPU: moments {moment_err}, "
                             f"loss {loss_err}, factors {factor_err}")
    if bank.pair_table != want_bank.pair_table or launches != want_launches:
        raise AssertionError(f"image-pair parity: pair table {bank.pair_table}, launches {launches} "
                             f"(expected {want_launches})")


def device_profile(fn) -> dict:
    """Run ``fn`` under torch.profiler: wall, device busy seconds (sum of
    kernel durations on the one stream), idle share, top kernels."""
    torch.cuda.synchronize()
    wall = []

    def timed():
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall.append(time.time() - t)

    prof = profiled_window(timed)
    wall = wall[-1]
    by_name: dict = {}
    n_kernels = 0
    for evt in prof.events():
        if str(getattr(evt, "device_type", "")).endswith("CUDA") and evt.time_range.elapsed_us() > 0:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e6
            n_kernels += 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = dict(wall_seconds_profiled=wall, device_kernels=n_kernels, device_busy_seconds=busy if by_name else "not measured",
               idle_share=1 - busy / wall if by_name else "not measured",
               top_kernels=[dict(name=n[:120], seconds=v, share_of_busy=v / busy) for n, v in top])
    # profiler names by substring: a tensor-core kernel's name does not
    # contain its SIMT sibling's ("flash_bwd_dq_tc_kernel")
    for key, names in (("k1", ("flash_fwd_kernel", "flash_fwd_tc_kernel")),
                       ("k2", ("flash_bwd_dq_kernel", "flash_bwd_dq_tc_kernel", "flash_dq_merge_kernel")),
                       ("k3", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_tc_kernel", "flash_dkv_merge_kernel")),
                       ("k4a", ("kgrid_fwd_kernel", "kgrid_fwd_tc_kernel", "kgrid_merge_kernel")),
                       ("k4b", ("kgrid_bwd_dq_kernel", "kgrid_bwd_dq_tc_kernel", "kgrid_dq_merge_kernel")),
                       ("k4c", ("kgrid_bwd_dkv_kernel", "kgrid_bwd_dkv_tc_kernel", "kgrid_dkv_merge_kernel"))):
        secs = sum(v for k, v in by_name.items() if any(n in k for n in names))
        out[f"{key}_seconds"] = secs
        out[f"{key}_share_of_busy"] = secs / busy if busy else "not measured"
    return out


def train_config(save_dir: Path, yaml_name: str = "config-xl.yaml", iterations: int = TRAIN_ITERATIONS):
    """data/<yaml_name> as it is, but for train.iterations and save.path."""
    cfg = load_config_from_yaml(str(REPO / "data" / yaml_name))
    cfg.prompts_file = str(REPO / cfg.prompts_file)
    cfg.train.iterations = iterations
    cfg.save.path = str(save_dir)
    return cfg, load_prompts_from_yaml(cfg.prompts_file)


def trained_summary(cfg, res, unet_cfg: UNetConfig, initial_scales=None) -> dict:
    """The saved ``_last.safetensors`` against the reference key schema for
    the config's sites, and how many LoRA ``up`` factors are still at their
    0 start. With DoRA's ``initial_scales`` (each site's ``dora_scale`` at
    init): the ``.dora_scale`` keys and their ``[1, in]`` shapes, how many
    scales never moved, and the file reloaded through
    ``adapters/dora.py::load_weights`` against the trained leaves, bit for bit."""
    path = str(Path(cfg.save.path) / f"{cfg.save.name}_last.safetensors")
    saved = load_file(path)
    with torch.device("meta"):
        meta_unet = UNet2DConditionModel(unet_cfg)
    ref_sites = lora.create_sites(meta_unet, rank=cfg.network.rank, alpha=cfg.network.alpha,
                                  train_method=cfg.network.training_method)
    leaves = ("lora_down.weight", "lora_up.weight", "alpha") + (("dora_scale",) if initial_scales else ())
    want_keys = {f"{s.lora_name}.{k}" for s in ref_sites for k in leaves}
    ups_zero = [n for n, leaf in res.lora_params.items() if not leaf["up"].detach().abs().max().item() > 0]
    out = dict(saved_keys=len(saved), saved_keys_match_reference=set(saved) == want_keys,
               up_factors_still_zero=len(ups_zero))
    if initial_scales:
        back = dora.load_weights(path, res.sites, device="cuda")
        out.update(
            dora_scale_shapes_ok=all(tuple(saved[f"{s.lora_name}.dora_scale"].shape) == (1, s.in_dim)
                                     for s in ref_sites),
            dora_scales_unmoved=sum(torch.equal(res.lora_params[n]["dora_scale"].detach().cpu(), t)
                                    for n, t in initial_scales.items()),
            reload_bit_equal=all(torch.equal(back[n][k], t.detach()) for n, leaf in res.lora_params.items()
                                 for k, t in leaf.items()))
    return out


def check_trained(what: str, res, summary: dict, launches, want_launches, iterations: int = TRAIN_ITERATIONS) -> None:
    if not all(np.isfinite(res.losses)) or len(res.losses) != iterations:
        raise AssertionError(f"{what}: losses {res.losses}")
    if summary["up_factors_still_zero"]:
        raise AssertionError(f"{what}: {summary['up_factors_still_zero']} LoRA up factors are still zero")
    if not summary["saved_keys_match_reference"]:
        raise AssertionError(f"{what}: the saved slider's keys are not the reference schema")
    if "dora_scales_unmoved" in summary and (summary["dora_scales_unmoved"] or not summary["dora_scale_shapes_ok"]
                                             or not summary["reload_bit_equal"]):
        raise AssertionError(f"{what}: DoRA's dora_scale {summary}")
    if launches != want_launches:
        raise AssertionError(f"{what} launched K1..K4c {launches} times, expected {want_launches}")


# the tiny SD UNet, and a variant whose mid block has one head of 160 (K4a
# forward, K4b/K4c backward on the card)
TINY_SD_D160 = dataclasses.replace(UNetConfig.tiny(), block_out_channels=(32, 160), attention_head_dim=1)


def phase_sd_train_parity() -> None:
    """One tiny-SD DDIM ESD step, fp32: card vs CPU, same weights, factors,
    prompt embeddings and draws — on ``tiny`` (K1/K2/K3 inside) and on its
    d-160 variant (K1/K2/K3 and K4a/K4b/K4c inside)."""
    _, te, tiny_unet, sched = factory.load_models("tiny", scheduler_name="ddim", device="cpu")
    for name, unet_cpu in (("tiny", tiny_unet),
                           ("tiny, mid block d 160", factory.build_module(
                               lambda: UNet2DConditionModel(TINY_SD_D160), "cpu", torch.float32, 1))):
        esd_step_parity("sd_train_parity", name, unet_cpu, sched,
                        lambda p: (factory.encode_prompts(te, [p])[0], None), 7,
                        dict(positive="person, very old", unconditional="person, young", guidance_scale=4),
                        xl=False)


def phase_esd(tmp: Path, what: str, yaml_name: str, yaml_edit=None, iterations: int = TRAIN_ITERATIONS,
              peft_type: str = "lora", profile: bool = True) -> dict:
    """Full-width ESD training at the prompts' resolution through
    trainer.train (the path of cli/train_lora_xl.py and cli/train_lora.py),
    from data/<yaml_name> and its prompts file (only train.iterations and
    save.path overridden, plus ``yaml_edit``: SD2.1, or a tpu route knob);
    then one more step under torch.profiler. The row names the slider's
    route as the trainer resolves it; returns it with the launches of
    K1..K4c."""
    cfg, prompts = train_config(tmp / what, yaml_name, iterations)
    if yaml_edit is not None:
        yaml_edit(cfg)
    model = cfg.pretrained_model
    unet_cfg = factory.unet_config_for(model.name_or_path, model.v2)
    route = resolve_student_overlay(cfg.tpu, False, peft_type, default_overlay=(peft_type == "lora"))
    initial_scales = {}
    real_init = dora.init_lora_params

    def recording_init(*a, **k):  # keeps each site's dora_scale at init, to see it move
        params = real_init(*a, **k)
        initial_scales.update({n: leaf["dora_scale"].clone() for n, leaf in params.items()})
        return params

    dora.init_lora_params = recording_init
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count this training path only
    t0 = time.time()
    try:
        res = trainer.train(cfg, prompts, rank=cfg.network.rank, peft_type=peft_type, device="cuda")
    finally:
        dora.init_lora_params = real_init
    wall = time.time() - t0
    launches = list(counts())
    check_no_plain(what)
    t_to = [row["timesteps_to"] for row in res.metrics]
    peak = torch.cuda.max_memory_allocated() / 2**30
    summary = trained_summary(cfg, res, unet_cfg, initial_scales)
    want_launches = per_step_launches(unet_cfg, sum(t + 2 for t in t_to), iterations)
    forwards_after_first = sum(t + 2 for t in t_to[1:])
    row = dict(
        phase=what, model=model.name_or_path, v2=model.v2, v_pred=model.v_pred, clip_skip=model.clip_skip,
        peft_type=peft_type, student_overlay=route[0], overlay_warmup=route[1],
        image_size=prompts[0].resolution, scheduler=cfg.train.noise_scheduler,
        max_denoising_steps=cfg.train.max_denoising_steps, precision=cfg.train.precision, train_cfg=cfg.train.cfg,
        lora_sites=len(res.sites), iterations=iterations, losses=res.losses,
        grad_norms=[r["grad_norm"] for r in res.metrics], timesteps_to=t_to,
        steps_per_sec_after_first=res.steps_per_sec, first_step_seconds=res.first_step_seconds,
        unet_forwards_per_sec_after_first=forwards_after_first / (iterations - 1) * res.steps_per_sec,
        setup_seconds_models_and_prompt_bank=res.setup_seconds, wall_seconds=wall, max_memory_allocated_gib=peak,
        attention_calls_by_head_dim=unet_cfg.attention_calls_by_head_dim(), launches_k1_to_k4c=launches,
        expected_launches=want_launches, **summary,
    )
    emit(row)
    check_trained(what, res, summary, launches, want_launches, iterations)

    if profile:
        profiled = {}
        prof = device_profile(lambda: profiled.update(res.next_step()))
        emit(dict(phase=f"{what}_profile", timesteps_to=profiled["timesteps_to"], **prof))
        row["profile"] = prof
    return row


def set_tpu(cfg, **knobs) -> None:
    """Set ``tpu.<knob>`` of a loaded config (a route of the slider)."""
    for k, v in knobs.items():
        setattr(cfg.tpu, k, v)


def sd21_config(cfg) -> None:
    """data/config.yaml turned to SD2.1: the model name, v2 and v_pred."""
    cfg.pretrained_model.name_or_path = "stabilityai/stable-diffusion-2-1"
    cfg.pretrained_model.v2 = True
    cfg.pretrained_model.v_pred = True


KNOB_ITERATIONS = 2  # steps of each trainer knob (train_knobs, 3 before the SD3 phases); 2 on SD1.5 too


def knob_forwards(cfg, metrics: list, remat: bool) -> tuple:
    """(UNet forwards, student backwards) the ESD step runs for ``metrics``'
    draws, counted from train/esd.py: a warm-up of tₖ forwards (fused
    samples and share_warmup: one call per step to max(tₖ)), one teacher
    and one student call (fuse_teacher_student: one call for both), the
    student's forward again in the backward when it is checkpointed, and
    under pipeline_warmup the warm-up drawn after the last step."""
    forwards = 0
    for m in metrics:
        t = m["timesteps_to"]
        if isinstance(t, list):
            forwards += max(t) + 2
        else:
            forwards += t + (1 if cfg.tpu.fuse_teacher_student else 2)
        forwards += int(remat)
    if cfg.tpu.pipeline_warmup:
        forwards += metrics[-1]["next_timesteps_to"]
    return forwards, len(metrics)


def phase_knob(tmp: Path, what: str, yaml_name: str, iterations: int = KNOB_ITERATIONS, tpu=None, train=None,
               resolution=None, prompt_edit=None) -> dict:
    """One trainer knob at full width through trainer.train from
    data/<yaml_name> (``tpu``/``train``: the config's fields to set;
    ``resolution``/``prompt_edit``: the prompts' fields): steps/s, peak
    memory, K1..K4c launches per step beside the count knob_forwards
    predicts, losses and grad norms finite, the factors moved, no plain
    attention version on the card."""
    cfg, prompts = train_config(tmp / what, yaml_name, iterations)
    set_tpu(cfg, **(tpu or {}))
    for k, v in (train or {}).items():
        setattr(cfg.train, k, v)
    edit = dict(prompt_edit or {}, **({"resolution": resolution} if resolution else {}))
    prompts = [dataclasses.replace(p, **edit) for p in prompts]
    model = cfg.pretrained_model
    unet_cfg = factory.unet_config_for(model.name_or_path, model.v2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count this knob's path only
    t0 = time.time()
    res = trainer.train(cfg, prompts, rank=cfg.network.rank, device="cuda")
    wall = time.time() - t0
    launches = list(counts())
    check_no_plain(what)
    size = prompts[0].resolution
    remat = max(size, size) > 512
    forwards, backwards = knob_forwards(cfg, res.metrics, remat)
    want = per_step_launches(unet_cfg, forwards, backwards)
    summary = trained_summary(cfg, res, unet_cfg)
    grad_norms = [r["grad_norm"] for r in res.metrics]
    row = dict(
        phase=what, model=model.name_or_path, image_size=size, iterations=iterations,
        tpu={k: getattr(cfg.tpu, k) for k in (tpu or {})}, train={k: getattr(cfg.train, k) for k in (train or {})},
        prompts={k: getattr(prompts[0], k) for k in edit}, remat_student=remat, losses=res.losses,
        grad_norms=grad_norms, timesteps_to=[r["timesteps_to"] for r in res.metrics],
        buckets=[(r["height"], r["width"]) for r in res.metrics if "height" in r],
        steps_per_sec_after_first=res.steps_per_sec, first_step_seconds=res.first_step_seconds,
        setup_seconds=res.setup_seconds, wall_seconds=wall,
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        unet_forwards=forwards, student_backwards=backwards, launches_k1_to_k4c=launches,
        expected_launches=want, launches_per_step=[n / iterations for n in launches],
        expected_per_step=[n / iterations for n in want], **summary,
    )
    emit(row)
    if not all(np.isfinite(grad_norms)):
        raise AssertionError(f"{what}: grad norms {grad_norms}")
    check_trained(what, res, summary, launches, want, iterations)
    return row


def phase_train_knobs(tmp: Path) -> dict:
    """The JAX trainer's knobs on full-width SDXL (seeded random bf16
    weights) from data/config-xl.yaml at 512px, KNOB_ITERATIONS steps each;
    then one 1024px step with the student under torch.utils.checkpoint
    beside the same step at 512px (which also writes tpu.profile_dir's
    trace). Returns each path's launches."""
    knobs = {
        "knob_samples2": dict(tpu=dict(samples_per_step=2)),
        "knob_fuse_teacher_student": dict(tpu=dict(fuse_teacher_student=True)),
        "knob_pipeline_warmup": dict(tpu=dict(pipeline_warmup=True)),
        "knob_share_warmup": dict(tpu=dict(samples_per_step=2, share_warmup=True)),
        "knob_dynamic_res_crops": dict(prompt_edit=dict(dynamic_resolution=True, dynamic_crops=True)),
        "knob_lion": dict(train=dict(optimizer="lion", lr=1e-4)),
        "knob_prodigy_restarts": dict(train=dict(optimizer="prodigy", lr=1.0, lr_scheduler="cosine_with_restarts")),
    }
    rows = {what: phase_knob(tmp, what, "config-xl.yaml", **kw) for what, kw in knobs.items()}
    rows["knob_1024_remat"] = phase_knob(tmp, "knob_1024_remat", "config-xl.yaml", iterations=1, resolution=1024)
    trace_dir = tmp / "profile_dir"
    rows["profile_dir"] = phase_knob(tmp, "profile_dir", "config-xl.yaml", iterations=1,
                                     tpu=dict(profile_dir=str(trace_dir)))
    traces = sorted(trace_dir.glob("*_trace.json"))
    text = traces[0].read_text() if traces else ""
    emit(dict(phase="profile_dir", files=[t.name for t in traces], trace_bytes=len(text),
              names_k1_symbol="flash_fwd_tc_kernel" in text, names_k2_symbol="flash_bwd_dq_tc_kernel" in text))
    if "flash_fwd_tc_kernel" not in text:
        raise AssertionError(f"profile_dir: no trace naming K1's kernel in {trace_dir}: {traces}")
    emit(dict(phase="knob_1024_remat", peak_gib_1024_checkpointed=rows["knob_1024_remat"]["max_memory_allocated_gib"],
              peak_gib_512=rows["profile_dir"]["max_memory_allocated_gib"],
              k1_per_step_1024=rows["knob_1024_remat"]["launches_per_step"][0],
              k1_per_step_512=rows["profile_dir"]["launches_per_step"][0]))
    return {what: row["launches_k1_to_k4c"] for what, row in rows.items()}


class GradSpy:
    """An optimizer that records the gradients it is handed and leaves the
    factors as they are (the card-side parities compare steps on one state)."""

    def __init__(self):
        self.grads = None

    def init(self, params):
        return {"count": 0}

    global_norm = staticmethod(Optimizer.global_norm)

    def step(self, params, grads, state, g_norm=None):
        self.grads = [g.detach().clone() for g in grads]


def phase_knob_parity(tmp: Path) -> None:
    """Three parities on full-width SDXL (bf16) at 512px, on the same draws
    and factors: pipeline_warmup at lr 0 reproduces the unpipelined losses
    (JAX: bit for bit; the largest gap printed); fuse_teacher_student's loss
    and gradient within esd_step_parity's tolerance of the separate teacher
    and student calls; the fused two-sample step within it of the mean of the
    two one-sample steps."""
    cfg, prompts = train_config(tmp / "knob_parity", "config-xl.yaml", 1)
    _, tes, unet, sched = factory.load_models_xl(SDXL, weight_dtype=torch.bfloat16, device="cuda")
    bank = esd.build_prompt_bank(prompts, lambda p: tuple(t[0] for t in factory.encode_prompts_xl(tes, [p])))
    del tes
    torch.cuda.empty_cache()
    sites = lora.create_sites(unet, rank=4, alpha=1.0, train_method="full")
    g = torch.Generator().manual_seed(12)
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.01
    lp = {n: {k: t.to("cuda").requires_grad_(True) for k, t in leaf.items()} for n, leaf in lp.items()}
    steps_n = cfg.train.max_denoising_steps
    schedule = sched.set_timesteps(steps_n)
    add = torch.from_numpy(get_add_time_ids(512, 512)).to("cuda")

    def make(opt, **knobs):
        ecfg = esd.ESDConfig(max_denoising_steps=steps_n, height=512, width=512, student_overlay=True,
                             overlay_warmup=False, **knobs)
        return esd.make_esd_train_step(unet, sites, lp, sched, schedule, opt, ecfg, add_time_ids=add)

    # (1) pipeline_warmup at lr 0 against the unpipelined steps, from one seed
    losses = {}
    for pipelined in (False, True):
        opt = get_optimizer("adamw", get_lr_schedule("constant", 0.0, 10), grad_clip_norm=0.2)
        step = make(opt, pipeline_warmup=pipelined)
        state = opt.init(flat_params(sites, lp))
        rng = esd.TrainRNG(21, "cuda")
        if pipelined:
            step.init_carry(bank, rng)
        losses[pipelined] = [float(step(state, bank, rng)["loss"]) for _ in range(KNOB_ITERATIONS)]
    pipe_gap = max(abs(a - b) for a, b in zip(losses[True], losses[False]))

    def loss_and_grads(step_knobs, draws):
        spy = GradSpy()
        m = make(spy, **step_knobs)(spy.init(None), bank, draws=draws)
        return float(m["loss"]), spy.grads

    def gap(got, want) -> dict:
        norm = lambda gs: float(torch.linalg.vector_norm(torch.stack([x.norm() for x in gs])))  # noqa: E731
        diff = norm([a - b for a, b in zip(got[1], want[1])])
        return dict(loss=got[0], loss_ref=want[0], loss_abs_err=abs(got[0] - want[0]), grad_norm=norm(got[1]),
                    grad_norm_ref=norm(want[1]), grad_diff_norm=diff,
                    grad_norm_abs_err=abs(norm(got[1]) - norm(want[1])))

    rng = esd.TrainRNG(22, "cuda")
    one = esd.draw(rng, bank.text.shape[0], schedule, esd.ESDConfig(max_denoising_steps=steps_n), "cuda")
    fuse = gap(loss_and_grads(dict(fuse_teacher_student=True), one), loss_and_grads({}, one))
    two = esd.draw_fused(rng, bank.text.shape[0], schedule,
                         esd.ESDConfig(max_denoising_steps=steps_n, samples_per_step=2), "cuda")
    singles = [loss_and_grads({}, esd.Draws(two.pairs[s], two.timesteps_to[s], two.latents0[s:s + 1],
                                             two.warm_noise[:two.timesteps_to[s], s:s + 1])) for s in range(2)]
    mean = (sum(x[0] for x in singles) / 2, [(a + b) / 2 for a, b in zip(singles[0][1], singles[1][1])])
    fused2 = gap(loss_and_grads(dict(samples_per_step=2), two), mean)
    emit(dict(phase="knob_parity", model=SDXL, image_size=512, dtype="bfloat16", tol=1e-3,
              pipeline_lr0_losses=losses[True], unpipelined_lr0_losses=losses[False],
              pipeline_lr0_max_gap=pipe_gap, fuse_teacher_student=fuse, fused_two_samples=fused2,
              two_sample_timesteps_to=two.timesteps_to, one_sample_timesteps_to=one.timesteps_to))
    for what, r in (("fuse_teacher_student", fuse), ("fused two samples", fused2)):
        if r["loss_abs_err"] > 1e-3 * max(1.0, abs(r["loss_ref"])) or \
                r["grad_norm_abs_err"] > 1e-3 * max(1.0, r["grad_norm_ref"]):
            raise AssertionError(f"knob_parity: {what} differs from the separate steps: {r}")
    if pipe_gap > 1e-3 * max(1.0, max(abs(x) for x in losses[False])):
        raise AssertionError(f"knob_parity: pipelined losses at lr 0 {losses[True]} vs {losses[False]}")
    del unet
    torch.cuda.empty_cache()


def phase_sd_train_knobs(tmp: Path) -> dict:
    """SD1.5 at full width from data/config.yaml (512px), 2 steps each: Lion
    with the step schedule; SGD with the linear schedule and a value clip
    (the trainer has no knob for it, as in JAX: the smoke hands get_optimizer
    grad_clip_value); DAdaptAdam with samples_per_step 2. K1..K4c counted as
    in sd_train."""
    real = trainer.get_optimizer
    rows = {"sd_knob_lion_step": phase_knob(tmp, "sd_knob_lion_step", "config.yaml", 2,
                                            train=dict(optimizer="lion", lr=1e-4, lr_scheduler="step"))}
    trainer.get_optimizer = functools.partial(real, grad_clip_value=1e-3)
    try:
        rows["sd_knob_sgd_linear_clip"] = phase_knob(tmp, "sd_knob_sgd_linear_clip", "config.yaml", 2,
                                                     train=dict(optimizer="sgd", lr=1.0, lr_scheduler="linear"))
    finally:
        trainer.get_optimizer = real
    rows["sd_knob_dadaptadam_samples2"] = phase_knob(tmp, "sd_knob_dadaptadam_samples2", "config.yaml", 2,
                                                     tpu=dict(samples_per_step=2), train=dict(optimizer="dadaptadam",
                                                                                             lr=1.0))
    return {what: row["launches_k1_to_k4c"] for what, row in rows.items()}


NOTRIGGER_STEPS = 5
NOTRIGGER_LR = 1.0  # the warm-up's lr is lr·k/100 (0 … 0.04 over 5 steps): the factors move past bf16's rounding


def phase_notrigger(tmp: Path) -> dict:
    """cli/train_notrigger.train on the full-width SDXL towers (CLIP-L and
    OpenCLIP bigG, bf16) from data/config-notrigger-xl.yaml: clip_index 0
    with DoRA (the CLI's default) and 1 with LoRA, NOTRIGGER_STEPS steps
    each; steps/s, pdist/ndist at the first and last step. Each file loads
    through load_slider_file as its tower's part; cli/combine_loras.py
    merges both (with an empty UNet part) into one file, which the
    sweep_xl CLI runs at scales 0 and +1 (SWEEP_XL_STEPS DDIM steps): at 0 the image is
    bit-equal to the image of a slider that changes nothing (a zero UNet
    slider), at +1 it differs. The trainer reaches no kernel."""
    runs, files = {}, []
    for clip_index, peft in ((0, "dora"), (1, "lora")):
        cfg = load_config_from_yaml(str(REPO / "data" / "config-notrigger-xl.yaml"))
        cfg.save.path = str(tmp / f"notrigger_{clip_index}")
        cfg.train.iterations, cfg.train.lr = NOTRIGGER_STEPS, NOTRIGGER_LR
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        train_notrigger.train(cfg, positive="a person, smiling", negative="a person, frowning",
                              clip_index=clip_index, peft_type=peft, model="SDXL", device="cuda")
        wall = time.time() - t0
        if any(counts()) or any(plain_calls()):
            raise AssertionError(f"notrigger launched attention kernels {counts()} / plain {plain_calls()}")
        lines = [json.loads(x) for x in (Path(cfg.save.path) / f"{cfg.save.name}_metrics.jsonl").read_text().splitlines()]
        rows, sps = [x for x in lines if "step" in x], lines[-1]["steps_per_sec"]
        files.append(Path(cfg.save.path) / f"{cfg.save.name}_{clip_index}_last.safetensors")
        runs[clip_index] = dict(peft_type=peft, steps=len(rows), steps_per_sec_after_first=sps, wall_seconds=wall,
                                max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                                pdist=(rows[0]["pdist"], rows[-1]["pdist"]), ndist=(rows[0]["ndist"], rows[-1]["ndist"]),
                                losses=[r["loss"] for r in rows], file_keys=len(load_file(str(files[-1]))))
        if len(rows) != NOTRIGGER_STEPS or not all(np.isfinite([r["loss"] for r in rows])):
            raise AssertionError(f"notrigger clip_index {clip_index}: {rows}")
    _, tes, _, _ = factory.load_models_xl(SDXL, weight_dtype=torch.bfloat16, device="cuda", with_unet=False)
    for clip_index, path in enumerate(files):
        parts = load_slider_file(str(path), text_encoders=[te.model for te in tes])
        bound = [(p.index, len(p.sites), p.peft.__name__.rsplit(".", 1)[-1]) for p in parts.te_parts]
        runs[clip_index]["loaded_parts"] = bound
        want_sites = 4 * tes[clip_index].model.config.num_hidden_layers
        if parts.unet is not None or bound != [(clip_index, want_sites, runs[clip_index]["peft_type"])]:
            raise AssertionError(f"notrigger file {path.name} loaded as {bound}")
    del tes
    torch.cuda.empty_cache()
    empty = tmp / "notrigger_empty_unet.safetensors"
    save_file({}, str(empty))
    combined = tmp / "notrigger_combined.safetensors"
    combine_loras.combine(str(empty), str(files[0]), str(files[1]), str(combined), 1.0, 1.0, 1.0)
    zero = tmp / "notrigger_zero_unet.safetensors"
    make_slider(zero, UNetConfig.sdxl())
    zsd = load_file(str(zero))
    save_file({k: (torch.zeros_like(v) if k.endswith("lora_up.weight") else v) for k, v in zsd.items()}, str(zero))
    steps = SWEEP_XL_STEPS
    imgs, launches = {}, [0] * len(KERNEL_NAMES)
    for name, slider, scales in (("no_slider", zero, "0.0"), ("notrigger", combined, "0.0,1.0")):
        save = tmp / f"notrigger_sweep_{name}"
        argv = ["--model_name", str(slider), "--prompts_path", str(REPO / "prompts" / "prompts-person.csv"),
                "--save_path", str(save), "--base", SDXL, "--num_samples", "1", "--till_case", "0",
                "--ddim_steps", str(steps), "--scales=" + scales]
        run = timed_sweep(gen_xl, argv)
        check_no_plain(f"notrigger sweep {name}")
        launches = [a + b for a, b in zip(launches, run["launches"])]
        for sc in scales.split(","):
            imgs[(name, float(sc))] = decode_png((save / slider.name / sc / "0_0.png").read_bytes())
    at0 = np.array_equal(imgs[("notrigger", 0.0)], imgs[("no_slider", 0.0)])
    at1 = image_gap(imgs[("notrigger", 1.0)], imgs[("no_slider", 0.0)])
    emit(dict(phase="notrigger", model=SDXL, steps_each=NOTRIGGER_STEPS, lr=NOTRIGGER_LR, runs=runs,
              combined_keys=len(load_file(str(combined))), sweep_steps=steps, scale0_bit_equal_to_no_slider=at0,
              scale1_vs_no_slider=at1, sweep_launches_k1_to_k4c=launches))
    if not at0 or at1["max_abs"] == 0:
        raise AssertionError(f"notrigger sweep: scale 0 bit-equal {at0}, scale +1 gap {at1}")
    return {"notrigger_sweep": launches}


def phase_image_pairs(tmp: Path, what: str, yaml_name: str, resolution: int, seed: int, yaml_edit=None,
                      iterations: int = TRAIN_ITERATIONS, first_wh=None, image_root=None) -> list:
    """Full-width image-pair slider training through
    cli/train_lora_scale.train from data/<yaml_name> and its prompts file
    (SDXL at 512px, SD1.5 at 256px: the trainer's resolution for the family),
    four folders of four synthetic PNGs at scales -2, -1, 1, 2 (``first_wh``:
    the first folder's at that size, resized on the host by the bank) or the
    folders under ``image_root`` (the committed JPEG bank: two 96px JPEGs a
    folder, baseline and progressive), plus ``yaml_edit`` (the merged
    students: ``tpu.student_overlay: false``); then one more step under
    torch.profiler. Returns the launches of K1..K4c."""
    cfg, prompts = train_config(tmp / what, yaml_name, iterations)
    if yaml_edit is not None:
        yaml_edit(cfg)
    root = image_root
    if root is None:
        root = tmp / f"{what}_images"
        write_image_folders(root, IMAGE_FOLDERS, [f"{i:03d}.png" for i in range(IMAGES_PER_FOLDER)], resolution,
                            seed, first_wh)
    names = imageslider.list_paired_images(str(root), IMAGE_FOLDERS)
    unet_cfg = factory.unet_config_for(cfg.pretrained_model.name_or_path, cfg.pretrained_model.v2)
    student_overlay = train_lora_scale.resolve_student(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count this image-pair training path only
    t0 = time.time()
    res = train_lora_scale.train(cfg, prompts, str(root), IMAGE_FOLDERS, IMAGE_SCALES, rank=cfg.network.rank,
                                 device="cuda")
    wall = time.time() - t0
    launches = list(counts())
    check_no_plain(what)
    peak = torch.cuda.max_memory_allocated() / 2**30
    summary = trained_summary(cfg, res, unet_cfg)
    # per step one 2-row student forward and backward through the overlay, or
    # two 1-row merged students; K4a also once per folder's encode (VAE mid-block)
    calls = iterations * (1 if student_overlay else 2)
    want_launches = per_step_launches(unet_cfg, calls, calls)
    want_launches[3] += len(IMAGE_FOLDERS)
    row = dict(
        phase=what, model=cfg.pretrained_model.name_or_path, image_size=resolution,
        student_overlay=student_overlay, student_calls_per_step=calls // iterations,
        folders=IMAGE_FOLDERS, scales=IMAGE_SCALES, images_per_folder=len(names), image_files=names,
        image_root=str(root.relative_to(REPO)) if image_root is not None else "synthetic PNGs",
        first_folder_image_wh=first_wh or (resolution, resolution),
        scheduler=cfg.train.noise_scheduler, max_denoising_steps=cfg.train.max_denoising_steps,
        precision=cfg.train.precision, lora_sites=len(res.sites), iterations=iterations,
        losses=res.losses, loss_high=[r["loss_high"] for r in res.metrics],
        loss_low=[r["loss_low"] for r in res.metrics], grad_norms=[r["grad_norm"] for r in res.metrics],
        pair_scales=[r["scale"] for r in res.metrics], timesteps_to=[r["timesteps_to"] for r in res.metrics],
        bank_build_seconds=res.bank_seconds, steps_per_sec_after_first=res.steps_per_sec,
        first_step_seconds=res.first_step_seconds, setup_seconds_models_prompts_bank=res.setup_seconds,
        wall_seconds=wall, max_memory_allocated_gib=peak, launches_k1_to_k4c=launches,
        expected_launches=want_launches, **summary,
    )
    emit(row)
    check_trained(what, res, summary, launches, want_launches, iterations)

    profiled = {}
    prof = device_profile(lambda: profiled.update(res.next_step()))
    emit(dict(phase=f"{what}_profile", timesteps_to=profiled["timesteps_to"], scale=profiled["scale"], **prof))
    return launches


def phase_merged_call_cost(iters: int = 10) -> dict:
    """The host cost of a merged-weights call: full-width SDXL (seeded random
    bf16 weights) at 512px, one ESD student's row, the 560 ``full``-method
    sites of data/config-xl.yaml merged once; median wall of ``iters``
    synchronised forwards of the plain module, of ``esd.merged_call`` (the
    port's route: ``lora.merged_weights`` swaps the module's parameter
    entries) and of ``torch.func.functional_call`` (the same kernels: the
    differences are the swaps)."""
    unet = factory.build_module(lambda: UNet2DConditionModel(UNetConfig.sdxl()), "cuda", torch.bfloat16, 2)
    sites = lora.create_sites(unet, rank=4, alpha=1.0, train_method="full")
    lp = lora.init_lora_params(sites, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    merged = lora.merge_lora_params(unet, sites, lp, 1.0)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 4, 64, 64), generator=g, device="cuda")
    text = torch.randn((1, 77, 2048), generator=g, device="cuda")
    added = {"text_embeds": torch.randn((1, 1280), generator=g, device="cuda"),
             "time_ids": torch.from_numpy(get_add_time_ids(512, 512)).cuda()}
    overlay = lora.LoRAOverlay(unet, sites, lp)

    def median_ms(fn) -> float:
        times = []
        for i in range(iters + 2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad(), overlay(None):
                fn(x, 500, text, added_cond_kwargs=added)
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    plain = median_ms(unet)
    swapped = median_ms(esd.merged_call(unet, merged))
    func = median_ms(lambda *a, **k: functional_call(unet, merged, a, k))
    row = dict(phase="merged_call_cost", model=SDXL, image_size=512, rows=1, merged_tensors=len(merged), iters=iters,
               plain_forward_ms=plain, merged_weights_forward_ms=swapped, functional_call_forward_ms=func,
               merged_weights_host_ms_per_call=swapped - plain, functional_call_host_ms_per_call=func - plain)
    emit(row)
    del unet, merged, lp, overlay
    torch.cuda.empty_cache()
    return row


def phase_export(tmp: Path, sd_dir: Path) -> list:
    """cli/export_single_file over the load phase's SD1.5 directory and the
    sd_serve slider at --scale 2, in fp32; the file reloaded with
    factory.load_models in bf16: every non-site tensor bit-equal to the
    directory's (loaded in bf16), every site weight bit-equal to
    merge_lora_params over the fp32 directory at 2.0 rounded once to bf16;
    then one 512px, EXPORT_STEPS-step DDIM sample_loop over the reloaded model against
    the directory's model with those merged weights (swapped in per call),
    pixel for pixel, and against the sweeps' merge over the bf16 weights (the
    double rounding, reported). Returns the launches of the reloaded model's
    sampler call and decode."""
    slider = tmp / "sd_serve_noxattn_rank4_alpha1.safetensors"
    out = tmp / "sd15_slider_x2.safetensors"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    n_tensors = len(export_single_file.main(["--base", str(sd_dir), "--slider", str(slider), "--scale", "2",
                                             "--output", str(out)]))
    torch.cuda.synchronize()
    write_s = time.time() - t0
    t0 = time.time()
    _, te, unet, sched, vae = factory.load_models(str(out), device="cuda", weight_dtype=torch.bfloat16,
                                                  with_vae=True)
    torch.cuda.synchronize()
    reload_s = time.time() - t0

    _, _, unet32, _ = factory.load_models(str(sd_dir), device="cuda", weight_dtype=torch.float32)
    parts = load_slider_file(str(slider))
    sites, lp = gen_xl.unet_slider(unet32, str(slider), parts.unet, "cuda")
    exact = {k: v.to(torch.bfloat16) for k, v in lora.merge_lora_params(unet32, sites, lp, 2.0).items()}
    del unet32
    _, te_b, unet_b, _, vae_b = factory.load_models(str(sd_dir), device="cuda", weight_dtype=torch.bfloat16,
                                                    with_vae=True)
    mismatched = [f"{comp}.{k}" for comp, got, src in (("text_encoder", te.model, te_b.model), ("vae", vae, vae_b),
                                                       ("unet", unet, unet_b))
                  for k, v in got.state_dict().items()
                  if not torch.equal(v, exact[k] if comp == "unet" and k in exact else src.state_dict()[k])]

    schedule = sched.set_timesteps(EXPORT_STEPS)
    with torch.inference_mode():
        emb = torch.cat([factory.encode_prompts(te, [""]), factory.encode_prompts(te, ["a photo of a person"])])
    lat = torch.randn((1, 4, 64, 64), generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    lat = (lat * schedule.init_noise_sigma).to(torch.bfloat16)

    def images(model, merged):
        final = sample_loop(model, merged, 0, sched, schedule, lat, emb, guidance_scale=7.5)
        return latents_to_images(vae.decode, final, vae.config.scaling_factor)[0]

    reset_counts()  # the exported model's sampler call and decode
    t0 = time.time()
    got = images(unet, None)
    torch.cuda.synchronize()
    sample_s = time.time() - t0
    launches = list(counts())
    check_no_plain("export")
    want = images(unet_b, exact)
    sweep = images(unet_b, lora.merge_lora_params(unet_b, sites, lp, 2.0))
    k1, k4a = per_sampler_call(UNetConfig.sd15(), EXPORT_STEPS)
    row = dict(phase="export", sampler_steps=EXPORT_STEPS, model=f"{SD15} (the load phase's directory)", slider=slider.name, scale=2.0,
               file_bytes=out.stat().st_size, tensors=n_tensors, export_dtype="float32",
               reload_dtype="bfloat16", baked_sites=len(sites), write_seconds=write_s, reload_seconds=reload_s,
               bit_equal=not mismatched, sample_seconds=sample_s,
               pixels_equal_to_directory_merged=bool(np.array_equal(got, want)),
               pixel_max_abs_vs_directory_merged=int(np.abs(got.astype(int) - want).max()),
               pixel_max_abs_vs_bf16_merge=int(np.abs(got.astype(int) - sweep).max()),
               pixel_mean_abs_vs_bf16_merge=float(np.abs(got.astype(int) - sweep).mean()),
               launches_k1_to_k4c=launches, max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    emit(row)
    if mismatched:
        raise AssertionError(f"export: {len(mismatched)} tensors differ (e.g. {mismatched[:3]})")
    if (launches[0], launches[3]) != (k1, k4a) or any(launches[i] for i in (1, 2, 4, 5)):
        raise AssertionError(f"export: the sampler launched K1..K4c {launches}, expected K1 {k1} and K4a {k4a}")
    if not row["pixels_equal_to_directory_merged"]:
        raise AssertionError(f"export: the reloaded file's image differs from the merged directory's by "
                             f"{row['pixel_max_abs_vs_directory_merged']}")
    del te, unet, vae, te_b, unet_b, vae_b, exact
    torch.cuda.empty_cache()
    return launches


def make_slider(path: Path, unet_cfg: UNetConfig, rank: int = 4, alpha: float = 1.0, train_method: str = "noxattn",
                seed: int = 4) -> None:
    """A slider over ``unet_cfg``'s module tree (rank-4 noxattn/c3lier by
    default; xattn: the attention sites only), non-zero up."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(unet_cfg)
    targets = lora.UNET_TARGET_REPLACE_MODULE_TRANSFORMER
    if train_method != "xattn":
        targets = targets + lora.UNET_TARGET_REPLACE_MODULE_CONV
    sites = lora.create_sites(unet, rank=rank, alpha=alpha, target_replace=targets, train_method=train_method)
    g = torch.Generator().manual_seed(seed)
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    lora.save_weights(str(path), sites, lp)


def make_te_slider(tmp: Path, unet_slider: Path, name: str) -> Path:
    """A cli/combine_loras.py file: ``unet_slider`` plus random rank-4
    lora_te1 parts over CLIP-L (12 layers × 4 projections) and lora_te2 parts
    over OpenCLIP bigG (32 × 4), which the combiner writes as lora_te3."""
    g = torch.Generator().manual_seed(9)
    parts = []
    for i, cfg in enumerate((CLIPTextConfig.sdxl_te1(), CLIPTextConfig.sdxl_te2())):
        with torch.device("meta"):
            tower = CLIPTextEncoder(cfg)
        sites = lora.create_sites(tower, rank=4, alpha=1.0, target_replace=["CLIPAttention"], prefix=f"lora_te{i + 1}",
                                  train_method="full", name_path_prefix=CLIP_NAME_PATH_PREFIX)
        if len(sites) != 4 * cfg.num_hidden_layers:
            raise AssertionError(f"te{i + 1}: {len(sites)} sites, not 4 × {cfg.num_hidden_layers}")
        lp = lora.init_lora_params(sites, generator=g)
        for leaf in lp.values():
            leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
        parts.append(tmp / f"{name}_te{i + 1}.safetensors")
        lora.save_weights(str(parts[-1]), sites, lp)
    out = tmp / f"{name}_noxattn_rank4_alpha1.safetensors"
    combine_loras.combine(str(unet_slider), str(parts[0]), str(parts[1]), str(out), 1.0, 1.0, 1.0)
    return out


def image_gap(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a.astype(int) - b.astype(int))
    return dict(max_abs=int(d.max()), mean_abs=float(d.mean()))


def per_sampler_call(unet_cfg: UNetConfig, steps: int, decode: bool = True) -> tuple:
    """(K1, K4a) launches of one sampler call and its decode: ``steps`` UNet
    forwards, then (``decode``) one K4a in the VAE's mid-block."""
    k1, _, _, k4a, _, _ = per_step_launches(unet_cfg, steps, 0)
    return k1, k4a + int(decode)


def phase_serve(svc: SliderService, what: str, model: str, load_s: float, pair: bool = True,
                guidance: float = 7.5) -> dict:
    """Requests through ``svc`` (every count set to 0 first): scale 0 and +2
    solo (their images must differ), then, with ``pair``, -2 and +1
    concurrently in one micro-batch. K1 and K4a launch their per-call counts
    in every sampler call; latency, images/s, peak memory."""
    size, steps = svc.image_size, svc.steps
    decodes = getattr(svc, "vae", None) is not None  # else the latent preview (a weightless flow family)
    side = size if decodes else size // 8
    k1_call, k4a_call = per_sampler_call(svc.unet.config, steps, decodes)
    batcher = svc._batcher
    reset_counts()  # count this serving path only
    requests = []

    def timed(scale, seed):
        t = time.time()
        png = svc.generate("a photo of a person", scale, seed, guidance, slider="smoke")
        return png, time.time() - t

    images = {}
    for scale in (0.0, 2.0):
        (l0, _, _, d0, _, _), b0 = counts(), batcher.total_batches
        png, secs = timed(scale, 7)
        images[scale] = decode_png(png)
        requests.append(dict(scale=scale, seconds=secs, batch=batcher.batch_sizes[-1],
                             k1_launches=fa.flash_attention_fwd.launches - l0,
                             k4a_launches=kg.flash_attention_kgrid_fwd.launches - d0,
                             sampler_calls=batcher.total_batches - b0))
    for r in requests:
        if r["k1_launches"] != k1_call or r["k4a_launches"] != k4a_call or r["sampler_calls"] != 1:
            raise AssertionError(f"{what} request {r}: expected {k1_call} K1 and {k4a_call} K4a launches in one "
                                 "sampler call")
    extra = {}
    if pair:
        (l0, _, _, d0, _, _), b0 = counts(), batcher.total_batches
        got: dict = {}
        errors: list = []

        def client(scale, seed):
            try:
                got[scale] = timed(scale, seed)
            except Exception as e:  # noqa: BLE001 — re-raised below on the main thread
                errors.append(e)

        t = time.time()
        threads = [threading.Thread(target=client, args=(s, 11)) for s in (-2.0, 1.0)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        pair_wall = time.time() - t
        if errors:
            raise errors[0]
        if any(th.is_alive() for th in threads) or len(got) != 2:
            raise AssertionError(f"{what}: concurrent requests did not finish")
        pair_calls = batcher.total_batches - b0
        for scale, (png, secs) in got.items():
            images[scale] = decode_png(png)
            requests.append(dict(scale=scale, seconds=secs, batch=2, concurrent=True))
        pair_k1 = fa.flash_attention_fwd.launches - l0
        pair_k4a = kg.flash_attention_kgrid_fwd.launches - d0
        if pair_calls != 1 or list(batcher.batch_sizes)[-1] != 2:
            raise AssertionError(f"{what}: the concurrent pair took {pair_calls} sampler calls")
        if pair_k1 != k1_call or pair_k4a != k4a_call:
            raise AssertionError(f"{what}: the pair's sampler call launched K1 {pair_k1} and K4a {pair_k4a} times, "
                                 f"not {k1_call} and {k4a_call}")
        extra = dict(pair_wall_seconds=pair_wall, pair_images_per_second=2 / pair_wall, pair_k1_launches=pair_k1,
                     pair_k4a_launches=pair_k4a)
    for scale, img in images.items():
        if img.dtype != np.uint8 or img.shape != (side, side, 3):
            raise AssertionError(f"{what} scale {scale}: image {img.dtype} {img.shape}")
    if np.array_equal(images[0.0], images[2.0]):
        raise AssertionError(f"{what}: scale 0 and scale +2 gave the same image")
    solo = [r["seconds"] for r in requests[:2]]
    row = dict(
        phase=what, model=model, image_size=size, steps=steps, guidance=guidance,
        weights="random, seeded per module, bf16",
        slider_sites=len(svc.sites), load_seconds=load_s, requests=requests,
        k1_launches_per_sampler_call=k1_call, k4a_launches_per_sampler_call=k4a_call,
        k1_launches=fa.flash_attention_fwd.launches, k4a_launches=kg.flash_attention_kgrid_fwd.launches,
        solo_seconds_first=solo[0], solo_seconds_second=solo[1], images_per_second_solo=1 / solo[1], **extra,
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        scale0_vs_scale2_max_abs=int(np.abs(images[0.0].astype(int) - images[2.0]).max()),
    )
    emit(row)
    return row


def phase_http(svc: SliderService, what: str = "http", guidance: float = 7.5) -> int:
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=60).read())
        sliders = json.loads(urllib.request.urlopen(f"{base}/sliders", timeout=60).read())
        l0, d0 = fa.flash_attention_fwd.launches, kg.flash_attention_kgrid_fwd.launches
        t = time.time()
        with urllib.request.urlopen(f"{base}/generate?prompt=a+photo+of+a+cat&scale=1.5&seed=3&slider=smoke"
                                    f"&guidance={guidance}", timeout=600) as resp:
            status, png = resp.status, resp.read()
        secs = time.time() - t
        img = decode_png(png)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    launches = fa.flash_attention_fwd.launches - l0
    k4a = kg.flash_attention_kgrid_fwd.launches - d0
    decodes = getattr(svc, "vae", None) is not None
    side = svc.image_size if decodes else svc.image_size // 8
    k1_call, k4a_call = per_sampler_call(svc.unet.config, svc.steps, decodes)
    emit(dict(phase=what, status=status, seconds=secs, shape=list(img.shape), healthz=health["status"],
              sliders=[s["name"] for s in sliders["sliders"]], k1_launches=launches, k4a_launches=k4a))
    if status != 200 or img.shape != (side, side, 3) or health["status"] != "ok":
        raise AssertionError(f"{what}: HTTP /generate failed")
    if launches != k1_call or k4a != k4a_call:
        raise AssertionError(f"{what}: the HTTP request launched K1 {launches} and K4a {k4a} times, not "
                             f"{k1_call} and {k4a_call}")
    return launches


def phase_profile(svc: SliderService, what: str = "profile", guidance: float = 7.5) -> dict:
    """One solo request under torch.profiler."""
    prof = device_profile(lambda: svc.generate("a photo of a person", 1.0, 5, guidance, slider="smoke"))
    row = dict(phase=what, **{k: v for k, v in prof.items() if not k.startswith(("k2", "k3", "k4b", "k4c"))})
    emit(row)
    return row


def phase_serve_sliders(tmp: Path, svc: SliderService) -> tuple:
    """Several sliders on one loaded service (every count set to 0 first):
    the stacked pair, the incompatible pair, the text-encoder slider, one
    merged encode's host time, the registry over HTTP and its LRU bound.
    Returns the path's launches of K1..K4c."""
    t_phase = time.time()
    cfg, batcher = svc.unet.config, svc._batcher
    k1_call, k4a_call = per_sampler_call(cfg, svc.steps)
    paths = {"a": tmp / "ss_a_noxattn_rank4_alpha1.safetensors", "b": tmp / "ss_b_noxattn.safetensors",
             "x": tmp / "ss_x_xattn_full.safetensors"}  # "full": the file-name rule then keeps every site kind
    make_slider(paths["a"], cfg, 4, 1.0, "noxattn", seed=21)
    make_slider(paths["b"], cfg, 1, 4.0, "noxattn", seed=22)
    make_slider(paths["x"], cfg, 2, 1.0, "xattn", seed=23)
    paths["te"] = make_te_slider(tmp, paths["a"], "ss_te")
    t = time.time()
    for name, path in paths.items():
        svc.add_slider(name, str(path))
    register_s = time.time() - t
    idx_seen = []
    real_group = svc._sample_group

    def spy(padded, guidance, entry, adapter_idx=None):
        idx_seen.append(adapter_idx)
        return real_group(padded, guidance, entry, adapter_idx=adapter_idx)

    svc._sample_group = spy
    reset_counts()  # count this path only

    def solo(name, scale, seed):
        return decode_png(svc.generate("a photo of a person", scale, seed, 7.5, slider=name))

    def together(reqs) -> tuple:
        """(images, sampler calls, K1 and K4a launches, wall seconds) of requests sent at once."""
        (l0, _, _, d0, _, _), b0, n0 = counts(), batcher.total_batches, len(idx_seen)
        got, errors = {}, []

        def client(i, name, scale, seed):
            try:
                got[i] = solo(name, scale, seed)
            except Exception as e:  # noqa: BLE001 — re-raised below on the main thread
                errors.append(e)

        t = time.time()
        threads = [threading.Thread(target=client, args=(i, *r)) for i, r in enumerate(reqs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        wall = time.time() - t
        if errors:
            raise errors[0]
        if any(th.is_alive() for th in threads) or len(got) != len(reqs):
            raise AssertionError(f"serve_sliders: concurrent requests {reqs} did not finish")
        (l1, _, _, d1, _, _) = counts()
        return ([got[i] for i in range(len(reqs))], len(idx_seen) - n0, l1 - l0, d1 - d0, wall,
                batcher.total_batches - b0, idx_seen[n0:])

    try:
        pair = [("a", 1.5, 3), ("b", -2.0, 4)]
        t = time.time()
        solos = [solo(*r) for r in pair]
        solo_s = (time.time() - t) / 2
        imgs, calls, k1, k4a, pair_wall, batches, idx = together(pair)
        if (calls, batches, k1, k4a) != (1, 1, k1_call, k4a_call) or idx != [[0, 1]]:
            raise AssertionError(f"serve_sliders: a + b took {calls} sampler calls (adapter_idx {idx}) launching K1 "
                                 f"{k1} and K4a {k4a} times, not one call of {k1_call} and {k4a_call}")
        stacked_gaps = [image_gap(i, j) for i, j in zip(imgs, solos)]
        if any(g["mean_abs"] > 2.0 for g in stacked_gaps):
            raise AssertionError(f"serve_sliders: stacked images against their solo images: {stacked_gaps}")
        if np.array_equal(imgs[0], imgs[1]):
            raise AssertionError("serve_sliders: the stacked rows of a and b gave the same image")
        cached = metrics(svc)["stacked_combos_cached"]
        if cached < 1:
            raise AssertionError(f"serve_sliders: /metrics stacked_combos_cached {cached}")
        _, calls_ax, k1_ax, k4a_ax, _, _, idx_ax = together([("a", 1.0, 5), ("x", 1.0, 5)])
        if calls_ax != 2 or idx_ax != [None, None] or (k1_ax, k4a_ax) != (2 * k1_call, 2 * k4a_call):
            raise AssertionError(f"serve_sliders: a + x took {calls_ax} calls ({idx_ax}), K1 {k1_ax}, K4a {k4a_ax}")

        te0, a0, te2, a2 = (solo(n, s, 6) for n, s in (("te", 0.0), ("a", 0.0), ("te", 2.0), ("a", 2.0)))
        te_gaps = dict(te0_vs_a0=image_gap(te0, a0), te2_vs_te0=image_gap(te2, te0), te2_vs_a2=image_gap(te2, a2))
        if not np.array_equal(te0, a0):
            raise AssertionError(f"serve_sliders: te at 0 is not its UNet part at 0: {te_gaps}")
        if np.array_equal(te2, te0) or np.array_equal(te2, a2):
            raise AssertionError(f"serve_sliders: te at +2 did not differ: {te_gaps}")

        version = svc._te["te"][1]
        encode_ms = []
        for scale in (1.0, -1.0, 0.5, 1.5, 2.5):
            torch.cuda.synchronize()
            t = time.time()
            svc._encode_te_impl("te", version, "a photo of a person", scale)
            torch.cuda.synchronize()
            encode_ms.append((time.time() - t) * 1e3)
        launches = list(counts())
        check_no_plain("serve_sliders")
    finally:
        svc._sample_group = real_group

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(method, path, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}{path}", method=method,
                                     data=None if body is None else json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:  # /metrics first: any registry change clears the stack cache
        got_metrics = call("GET", "/metrics")
        post = call("POST", "/sliders", {"name": "posted", "path": str(paths["b"])})
        delete = call("DELETE", "/sliders/posted")
        delete_default = call("DELETE", "/sliders/default")
        delete_missing = call("DELETE", "/sliders/posted")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    http = dict(post=post[0], delete=delete[0], delete_default=delete_default[0], delete_missing=delete_missing[0],
                metrics=got_metrics[1])
    if (post[0], delete[0], delete_default[0], delete_missing[0], got_metrics[0]) != (200, 200, 400, 404, 200) or \
            "posted" not in [e["name"] for e in post[1]["sliders"]] or got_metrics[1]["stacked_combos_cached"] < 1:
        raise AssertionError(f"serve_sliders: HTTP registry {http}")

    for name in ("smoke", "x", "te"):
        svc.remove_slider(name)
    svc.max_sliders = 3
    svc._resolve("b"), svc._resolve("a")  # LRU order: default, b, a
    svc.add_slider("d", str(paths["b"]))
    registry = [e["name"] for e in svc.list_sliders()]
    svc.max_sliders = None
    if registry != ["default", "a", "d"]:
        raise AssertionError(f"serve_sliders: max_sliders 3 left {registry}, not default, a, d (b evicted)")
    emit(dict(phase="serve_sliders", model=SDXL, image_size=svc.image_size, steps=svc.steps,
              sliders={n: str(p.name) for n, p in paths.items()}, register_seconds=register_s,
              solo_seconds=solo_s, pair_wall_seconds=pair_wall, pair_sampler_calls=1, pair_k1_launches=k1,
              pair_k4a_launches=k4a, k1_launches_per_sampler_call=k1_call, k4a_launches_per_sampler_call=k4a_call,
              stacked_vs_solo=stacked_gaps, incompatible_pair_sampler_calls=calls_ax, te_gaps=te_gaps,
              merged_two_tower_encode_host_ms=encode_ms, stacked_combos_cached=cached, http=http,
              registry_after_eviction=registry, launches_k1_to_k4c=launches, seconds=time.time() - t_phase))
    return tuple(launches)


def served(tmp: Path, what: str, make, unet_cfg: UNetConfig, model: str, pair: bool = True,
           http: bool = True, profile: bool = True, after=None, guidance: float = 7.5, slider=None) -> tuple:
    """Build a service with ``make(slider_path)``, register the smoke slider,
    drive :func:`phase_serve`, the HTTP request and one profiled request;
    the path's launches, counted from 0 just before its first request.
    ``after(svc)`` then runs on the same service (a path of its own, which
    counts its own launches). ``slider(path)`` writes the slider (default:
    make_slider over ``unet_cfg``)."""
    path = tmp / f"{what}_noxattn_rank4_alpha1.safetensors"
    (slider or functools.partial(make_slider, unet_cfg=unet_cfg))(path)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    svc = make(str(path))
    load_s = time.time() - t0
    svc.add_slider("smoke", str(path))
    try:
        phase_serve(svc, what, model, load_s, pair, guidance)
        if http:
            phase_http(svc, "http" if what == "serve" else f"{what}_http", guidance)
        launches = counts()
        check_no_plain(what)
        if profile:
            phase_profile(svc, "profile" if what == "serve" else f"{what}_profile", guidance)
        if after is not None:
            after(svc)
    finally:
        svc.close()
    del svc
    torch.cuda.empty_cache()
    return launches


def clip_transformers_names(sd: dict) -> dict:
    """The port's CLIP state dict under the transformers names a diffusers
    directory's text_encoder/ holds (the inverse of
    io/torch_convert.py::clip_state_dict)."""
    out = {}
    for k, v in sd.items():
        k = k.replace("mlp_fc1.", "mlp.fc1.").replace("mlp_fc2.", "mlp.fc2.")
        if k.startswith(("token_embedding.", "position_embedding.")):
            k = "text_model.embeddings." + k
        elif k.startswith("layers."):
            k = "text_model.encoder." + k
        elif k.startswith("final_layer_norm."):
            k = "text_model." + k
        out[k] = v
    return out


def phase_load(tmp: Path) -> Path:
    """A full-width SD1.5 diffusers directory (seeded random bf16 weights):
    unet/ in two shards with an index, vae/, text_encoder/ (transformers
    names), each with its config.json, and tokenizer/ with the synthetic
    vocab.json/merges.txt of the CPU tests' generator; then
    factory.load_models(dir, device="cuda", bf16, with_vae=True), every
    tensor bit-equal to its source. Returns the directory."""
    root = tmp / "sd15-diffusers"
    t0 = time.time()
    src = {
        "text_encoder": factory.build_module(lambda: CLIPTextEncoder(CLIPTextConfig.sd15_te()), "cuda",
                                             torch.bfloat16, 0),
        "unet": factory.build_module(lambda: UNet2DConditionModel(UNetConfig.sd15()), "cuda", torch.bfloat16, 1),
        "vae": factory.build_module(lambda: AutoencoderKL(VAEConfig.sd()), "cuda", torch.bfloat16, 2),
    }
    configs = {"unet": dataclasses.asdict(UNetConfig.sd15()), "vae": dataclasses.asdict(VAEConfig.sd()),
               "text_encoder": dataclasses.asdict(CLIPTextConfig.sd15_te())}
    nbytes = 0
    for comp, module in src.items():
        sd = {k: v.cpu() for k, v in module.state_dict().items()}
        if comp == "text_encoder":
            sd = clip_transformers_names(sd)
        sub = root / comp
        sub.mkdir(parents=True)
        (sub / "config.json").write_text(json.dumps(configs[comp]))
        keys = sorted(sd)
        shards = 2 if comp == "unet" else 1
        weight_map = {}
        for i in range(shards):
            name = (f"diffusion_pytorch_model-{i + 1:05d}-of-{shards:05d}.safetensors" if shards > 1
                    else "model.safetensors")
            save_file({k: sd[k] for k in keys[i::shards]}, str(sub / name))
            weight_map.update({k: name for k in keys[i::shards]})
            nbytes += (sub / name).stat().st_size
        if shards > 1:
            (sub / "diffusion_pytorch_model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    prompts = [p for f in sorted((REPO / "data").glob("prompts*.yaml"))
               for e in yaml_subset.load_file(str(f)) or [] for k, p in e.items()
               if k in ("target", "positive", "negative", "neutral", "unconditional") and isinstance(p, str)]
    write_synthetic_bpe_files(str(root / "tokenizer"), prompts)
    write_s = time.time() - t0

    torch.cuda.synchronize()
    t0 = time.time()
    tok, te, unet, _, vae = factory.load_models(str(root), device="cuda", weight_dtype=torch.bfloat16, with_vae=True)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    mismatched = [f"{comp}.{k}" for comp, got in (("text_encoder", te.model), ("unet", unet), ("vae", vae))
                  for k, v in got.state_dict().items()
                  if v.dtype != torch.bfloat16 or not torch.equal(v, src[comp].state_dict()[k])]
    n_tensors = sum(len(m.state_dict()) for m in src.values())
    ids = tok(["a photo of a person, smiling"])
    emit(dict(phase="load", model=SD15, layout="diffusers directory (unet in 2 shards)", tensors=n_tensors,
              bytes=nbytes, write_seconds=write_s, load_seconds=load_s, load_gb_per_second=nbytes / load_s / 1e9,
              tokenizer=type(tok).__name__, first_ids=ids[0, :8].tolist(), bit_equal=not mismatched))
    if mismatched or type(tok).__name__ != "CLIPTokenizerFiles":
        raise AssertionError(f"load: {len(mismatched)} tensors differ from their source (e.g. {mismatched[:3]}); "
                             f"tokenizer {type(tok).__name__}")
    del src, te, unet, vae
    torch.cuda.empty_cache()
    return root


def timed_sweep(module, argv: list) -> dict:
    """One sweep CLI run: wall seconds, and the seconds from the first
    sampler call to the end (the sweep without the model load)."""
    marks = {}
    wrapped = {}
    for name in ("sample_loop", "sample_loop_scales"):
        real = getattr(module, name, None)
        if real is None:
            continue

        def timed_call(*a, _real=real, **k):
            torch.cuda.synchronize()
            marks.setdefault("first", time.time())
            return _real(*a, **k)

        wrapped[name] = real
        setattr(module, name, timed_call)
    reset_counts()
    t0 = time.time()
    try:
        module.main(argv)
    finally:
        for name, real in wrapped.items():
            setattr(module, name, real)
    torch.cuda.synchronize()
    end = time.time()
    return dict(wall_seconds=end - t0, sweep_seconds=end - marks["first"], launches=counts())


def check_sweep_tree(root: Path, scales, case: int, size: int) -> dict:
    """Every scale's PNG and the composite: shapes, and the images differ."""
    imgs = {s: decode_png((root / str(s) / f"{case}_0.png").read_bytes()) for s in scales}
    comp = decode_png((root / "all" / f"{case}.png").read_bytes())
    for s, img in imgs.items():
        if img.shape != (size, size, 3):
            raise AssertionError(f"{root}: scale {s} image {img.shape}")
    if comp.shape != (size, size * len(scales), 3):
        raise AssertionError(f"{root}: composite {comp.shape}, not {(size, size * len(scales), 3)}")
    if np.array_equal(imgs[scales[0]], imgs[scales[-1]]):
        raise AssertionError(f"{root}: scales {scales[0]} and {scales[-1]} gave the same image")
    return imgs


SWEEP_XL_STEPS = 6  # the XL sweep CLI's 50 DDIM steps, cut (to 25 with SD3, to 12 with Flux, to 6 with editing)


def phase_sweep_xl(tmp: Path) -> tuple:
    """cli/generate_images_xl.run on the SDXL family name at the CLI's
    defaults (512px, start_noise 750) but SWEEP_XL_STEPS DDIM steps, reduced
    to scales -2, 0, 2 and one sample of the first case of prompts/prompts-person.csv:
    once sequential (merged weights) and once with --batch_scales (the
    overlay, all scales in one trajectory). Launches per trajectory and
    seconds per image. Then each scale alone with --batch_scales (the
    overlay at the merged run's batch of 2 rows), so the pixel gap between
    merged and overlay at a scale is that of the bf16 merge alone, and the
    gap to the batched run shows what the batch's size adds."""
    slider = tmp / "sweep_xl_noxattn_rank4_alpha1.safetensors"
    make_slider(slider, UNetConfig.sdxl())
    scales = [-2.0, 0.0, 2.0]
    k1_traj = per_step_launches(UNetConfig.sdxl(), SWEEP_XL_STEPS, 0)[0]
    out, launches = {}, [0] * len(KERNEL_NAMES)
    runs = [("merged", [None], []), ("batch_scales", [None], ["--batch_scales"]),
            ("overlay_per_scale", scales, ["--batch_scales"])]
    for mode, only, extra in runs:
        save = tmp / f"sweep_xl_{mode}"
        torch.cuda.reset_peak_memory_stats()
        res = dict(wall_seconds=0.0, sweep_seconds=0.0)
        trajectories = 0
        for scale in only:
            argv = ["--model_name", str(slider), "--prompts_path", str(REPO / "prompts" / "prompts-person.csv"),
                    "--save_path", str(save), "--base", SDXL, "--num_samples", "1", "--till_case", "0",
                    "--ddim_steps", str(SWEEP_XL_STEPS),
                    "--scales=" + (",".join(str(x) for x in scales) if scale is None else str(scale)), *extra]
            run = timed_sweep(gen_xl, argv)
            n_scales = len(scales) if scale is None else 1
            n_traj = 1 if extra else n_scales
            want = (n_traj * k1_traj, n_scales)  # SDXL's UNet has no K4a: one per decode
            got = (run["launches"][0], run["launches"][3])
            check_no_plain(f"sweep_xl {mode}")
            if got != want:
                raise AssertionError(f"sweep_xl {mode} scale {scale}: K1/K4a launched {got}, expected {want}")
            launches = [a + b for a, b in zip(launches, run["launches"])]
            res["wall_seconds"] += run["wall_seconds"]
            res["sweep_seconds"] += run["sweep_seconds"]
            trajectories += n_traj
        out[mode] = {s: decode_png((save / slider.name / str(s) / "0_0.png").read_bytes()) for s in scales}
        if mode != "overlay_per_scale":
            check_sweep_tree(save / slider.name, scales, 0, 512)
        emit(dict(phase="sweep_xl", mode=mode, model=SDXL, image_size=512, steps=SWEEP_XL_STEPS, start_noise=750,
                  scales=scales, num_samples=1, trajectories=trajectories, k1_per_trajectory=k1_traj,
                  k4a_per_decode=1, seconds_per_image=res["sweep_seconds"] / len(scales),
                  max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, **res))
        torch.cuda.empty_cache()

    def gap(a: str, b: str) -> dict:
        return {str(s): dict(max_abs=int(np.abs(out[a][s].astype(int) - out[b][s]).max()),
                             mean_abs=float(np.abs(out[a][s].astype(int) - out[b][s]).mean())) for s in scales}

    emit(dict(phase="sweep_xl", merged_vs_overlay_same_batch=gap("merged", "overlay_per_scale"),
              merged_vs_overlay_batched=gap("merged", "batch_scales"),
              overlay_same_batch_vs_batched=gap("overlay_per_scale", "batch_scales")))

    # a combine_loras file with text-encoder parts: each scale's encode through the merged towers
    te_slider = make_te_slider(tmp, slider, "sweep_xl_te")
    te_scales, te_steps = [-2.0, 2.0], SWEEP_XL_STEPS
    k1_te = per_step_launches(UNetConfig.sdxl(), te_steps, 0)[0]
    te_out = {}
    for mode, extra in (("te_merged", []), ("te_batch_scales", ["--batch_scales"])):
        save = tmp / f"sweep_xl_{mode}"
        argv = ["--model_name", str(te_slider), "--prompts_path", str(REPO / "prompts" / "prompts-person.csv"),
                "--save_path", str(save), "--base", SDXL, "--num_samples", "1", "--till_case", "0",
                "--ddim_steps", str(te_steps), "--scales=-2.0,2.0", *extra]
        run = timed_sweep(gen_xl, argv)
        check_no_plain(f"sweep_xl {mode}")
        want = ((1 if extra else 2) * k1_te, 2)
        if (run["launches"][0], run["launches"][3]) != want:
            raise AssertionError(f"sweep_xl {mode}: K1/K4a launched {run['launches']}, expected {want}")
        launches = [a + b for a, b in zip(launches, run["launches"])]
        te_out[mode] = check_sweep_tree(save / te_slider.name, te_scales, 0, 512)
        emit(dict(phase="sweep_xl", mode=mode, slider=te_slider.name, steps=te_steps, scales=te_scales,
                  seconds_per_image=run["sweep_seconds"] / 2, wall_seconds=run["wall_seconds"]))
    te_gap = {str(sc): image_gap(te_out["te_merged"][sc], te_out["te_batch_scales"][sc]) for sc in te_scales}
    emit(dict(phase="sweep_xl", te_merged_vs_batch_scales=te_gap))
    if any(g["mean_abs"] > 2.0 for g in te_gap.values()):
        raise AssertionError(f"sweep_xl: the te file's merged and batched routes differ: {te_gap}")
    return tuple(launches)


def phase_sweep_sd1(tmp: Path, sd_dir: Path) -> tuple:
    """cli/generate_images_sd1.run over the SD1.5 directory: LMS, 50 steps,
    start_noise 850, scales -2 and 2, one sample; the composite 512 × 1024."""
    slider = tmp / "sweep_sd1_noxattn_rank4_alpha1.safetensors"
    make_slider(slider, UNetConfig.sd15())
    scales = [-2.0, 2.0]
    k1_traj, _, _, k4a_traj, _, _ = per_step_launches(UNetConfig.sd15(), 50, 0)
    save = tmp / "sweep_sd1"
    argv = ["--model_name", str(slider), "--prompts_path", str(REPO / "prompts" / "prompts-person.csv"),
            "--save_path", str(save), "--base", str(sd_dir), "--num_samples", "1", "--scales=-2,2", "--till_case", "0"]
    torch.cuda.reset_peak_memory_stats()
    res = timed_sweep(gen_sd1, argv)
    launches = res.pop("launches")
    want = (len(scales) * k1_traj, len(scales) * (k4a_traj + 1))
    got = (launches[0], launches[3])
    check_no_plain("sweep_sd1")
    if got != want:
        raise AssertionError(f"sweep_sd1: K1/K4a launched {got}, expected {want}")
    check_sweep_tree(save / slider.name, scales, 0, 512)
    emit(dict(phase="sweep_sd1", model=f"{SD15} (the load phase's directory)", scheduler="lms", image_size=512,
              steps=50, start_noise=850, scales=scales, num_samples=1, k1_launches=got[0], k4a_launches=got[1],
              seconds_per_image=res["sweep_seconds"] / len(scales), composite_shape=[512, 1024, 3],
              max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, **res))
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the int8 / W8A8 frozen base
# ---------------------------------------------------------------------------

# (rows, in, out) of int8_matmul's exact check: SDXL's time_embedding.linear_1
# with CFG (2 rows, padded for torch._int_mm), a 1024px level-1 to_q with CFG,
# a level-2 feed-forward net_2 at 1024px with CFG
INT8_SHAPES = [(2, 320, 1280), (2 * 4096, 640, 640), (2 * 1024, 5120, 1280)]
INT8_REQUEST = ("a photo of a person", 2.0, 7, 7.5)  # the serve phase's second solo request


def phase_quant() -> dict:
    """The SDXL UNet (seeded random bf16) quantized in place on the card:
    QuantLinear count, bytes before and after (torch.cuda.memory_allocated),
    seconds; int8_matmul at INT8_SHAPES against the CPU's int32 product
    (exact); the weight-only QuantLinear against F.linear of its dequantized
    weight in bf16; device ms and host µs per call of nn.Linear and of the
    QuantLinear weight-only and W8A8."""
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    unet = factory.build_module(lambda: UNet2DConditionModel(UNetConfig.sdxl()), "cuda", torch.bfloat16, 2)
    torch.cuda.synchronize()
    bf16_bytes = torch.cuda.memory_allocated() - m0
    n_linears = sum(isinstance(m, torch.nn.Linear) for m in unet.modules())
    # bf16 copies of two Linears for the per-call timings, left out of the int8 bytes
    to_q, emb2 = "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q", "time_embedding.linear_2"
    m1 = torch.cuda.memory_allocated()
    lin, small_lin = (copy.deepcopy(unet.get_submodule(n)) for n in (to_q, emb2))
    kept = torch.cuda.memory_allocated() - m1
    t0 = time.time()
    scales = quant.quantize_module(unet)
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    int8_bytes = torch.cuda.memory_allocated() - m0 - kept
    n_quant = sum(isinstance(m, quant.QuantLinear) for m in unet.modules())
    if n_quant != len(scales) or n_quant != 743:
        raise AssertionError(f"quant: {n_quant} QuantLinears, {len(scales)} scales; SDXL has 743 by JAX's rule")

    gen = torch.Generator(device="cuda").manual_seed(13)
    exact = []
    for m, k, n in INT8_SHAPES:
        xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        got = quant.int8_matmul(xq, wq)
        want = torch._int_mm(xq.cpu(), wq.cpu().t())
        exact.append(dict(shape=[m, k, n], equal=bool(torch.equal(got.cpu(), want)),
                          ms=cuda_ms(lambda: quant.int8_matmul(xq, wq), 20)))
    if not all(e["equal"] for e in exact):
        raise AssertionError(f"quant: int8_matmul on the card is not the CPU's int32 product: {exact}")

    # the codes and scales the card computes are the CPU's (the JAX package's rule), bit for bit
    same_codes = all(torch.equal(a.cpu(), b) for m in (lin, small_lin)
                     for a, b in zip(quant.quantize_leaf(m.weight), quant.quantize_leaf(m.weight.cpu())))
    if not same_codes:
        raise AssertionError("quant: quantize_leaf on the card differs from the CPU's")
    ql = unet.get_submodule(to_q)  # 640 → 640
    x = torch.randn((2, 4096, 640), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        got = ql(x).float()
        ref = F.linear(x, quant.dequantize(ql.weight_q, ql.scale, torch.bfloat16)).float()
    wo_err = float((got - ref).abs().max() / ref.abs().max())
    if not wo_err <= 2e-2:
        raise AssertionError(f"quant: weight-only QuantLinear vs F.linear of its dequantized weight: {wo_err}")
    small = unet.get_submodule(emb2)  # 1280 → 1280 on the 2 CFG rows
    x2 = torch.randn((2, 1280), generator=gen, device="cuda").to(torch.bfloat16)
    per_call = {}
    with torch.inference_mode():
        for mode in ("linear", "weight_only", "w8a8"):
            if mode != "linear":
                quant.set_act_quant(unet, mode == "w8a8")
            big, tiny = (lin, small_lin) if mode == "linear" else (ql, small)
            per_call[mode] = dict(device_ms_to_q_8192x640=cuda_ms(lambda: big(x), 50),
                                  host_us_time_embedding_2x1280=host_us(lambda: tiny(x2)))
        quant.set_act_quant(unet, False)
    row = dict(phase="quant", model=SDXL, weights="random, seeded, bf16", quant_linears=n_quant,
               linears_before=n_linears, unet_bytes_bf16=bf16_bytes, unet_bytes_int8=int8_bytes,
               int8_over_bf16=int8_bytes / bf16_bytes, quantize_seconds=quant_s, codes_equal_to_cpu=same_codes,
               int8_matmul_exact=exact,
               weight_only_vs_dequantized_linear_rel_err=wo_err, per_call=per_call)
    emit(row)
    del unet, lin, small_lin
    torch.cuda.empty_cache()
    return row


def phase_train_int8(tmp: Path) -> dict:
    """SDXL ESD (data/config-xl.yaml, 512px) for 3 steps on bf16 and on each
    int8 route — quantize_base, the dual-tree w8a8_warmup, both — and SD1.5
    ESD (data/config.yaml) for 2 steps on bf16 and quantize_base, through
    trainer.train (phase_knob: K1..K4c per step as the bf16 route's count,
    finite losses, moved factors); the runs of one model draw the same
    timesteps_to, so their steps/s and peaks compare inside this call."""
    rows = {
        "int8_bf16_reference": phase_knob(tmp, "int8_bf16_reference", "config-xl.yaml"),
        "int8_quantize_base": phase_knob(tmp, "int8_quantize_base", "config-xl.yaml", tpu=dict(quantize_base=True)),
        "int8_w8a8_dual": phase_knob(tmp, "int8_w8a8_dual", "config-xl.yaml", tpu=dict(w8a8_warmup=True)),
        "int8_both": phase_knob(tmp, "int8_both", "config-xl.yaml", tpu=dict(quantize_base=True, w8a8_warmup=True)),
        "sd_int8_bf16_reference": phase_knob(tmp, "sd_int8_bf16_reference", "config.yaml", iterations=2),
        "sd_int8_quantize_base": phase_knob(tmp, "sd_int8_quantize_base", "config.yaml", iterations=2,
                                            tpu=dict(quantize_base=True)),
    }
    keys = ("steps_per_sec_after_first", "max_memory_allocated_gib", "first_step_seconds", "timesteps_to")
    emit(dict(phase="train_int8", **{name: {k: row[k] for k in keys} for name, row in rows.items()}))
    for name, ref in (("int8_quantize_base", "int8_bf16_reference"), ("sd_int8_quantize_base", "sd_int8_bf16_reference")):
        if rows[name]["timesteps_to"] != rows[ref]["timesteps_to"]:
            raise AssertionError(f"train_int8: {name} drew {rows[name]['timesteps_to']}, {ref} "
                                 f"{rows[ref]['timesteps_to']}")
    torch.cuda.empty_cache()
    return {what: row["launches_k1_to_k4c"] for what, row in rows.items()}


def phase_serve_int8(tmp: Path, ref_png: bytes) -> dict:
    """One SDXL 1024px request (INT8_REQUEST, the serve slider) through
    SliderService with quantize_base and one with w8a8, each twice (the
    second is the steady-state latency): load seconds, latency, peak, the
    pixel gap to the bf16 service's image of the same request, K1/K4a per
    sampler call."""
    path = tmp / "serve_noxattn_rank4_alpha1.safetensors"
    ref = decode_png(ref_png)
    k1_call, k4a_call = per_sampler_call(UNetConfig.sdxl(), STEPS)
    out = {}
    for mode in ("quantize_base", "w8a8"):
        what = f"serve_int8_{mode}"
        gc.collect()  # a closed service is held by reference cycles (its lru caches) until collected
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        svc = SliderService(SDXL, str(path), image_size=IMAGE_SIZE, steps=STEPS, device="cuda", **{mode: True})
        load_s = time.time() - t0
        try:
            reset_counts()  # count this serving path only
            secs = []
            for _ in range(2):
                t = time.time()
                png = svc.generate(*INT8_REQUEST)
                secs.append(time.time() - t)
            launches = counts()
            check_no_plain(what)
            unet_bytes = sum(t.numel() * t.element_size() for t in itertools.chain(svc.unet.parameters(),
                                                                                    svc.unet.buffers()))
            acts = {m.act_quant for m in svc.unet.modules() if isinstance(m, quant.QuantLinear)}
        finally:
            svc.close()
        del svc
        img = decode_png(png)
        row = dict(phase=what, model=SDXL, image_size=IMAGE_SIZE, steps=STEPS, request=INT8_REQUEST,
                   load_seconds=load_s, seconds_first=secs[0], seconds_second=secs[1],
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, unet_bytes=unet_bytes,
                   act_quant=sorted(acts), launches_k1_to_k4c=list(launches),
                   gap_to_bf16_image=image_gap(img, ref))
        emit(row)
        if img.shape != ref.shape or acts != {mode == "w8a8"}:
            raise AssertionError(f"{what}: image {img.shape}, act_quant {acts}")
        if launches[0] != 2 * k1_call or launches[3] != 2 * k4a_call or any(launches[i] for i in (1, 2, 4, 5)):
            raise AssertionError(f"{what}: launched K1..K4c {launches}, expected {2 * k1_call} K1, "
                                 f"{2 * k4a_call} K4a")
        out[what] = launches
    torch.cuda.empty_cache()
    return out


def phase_quantize_checkpoint(tmp: Path, sd_dir: Path) -> list:
    """cli/quantize_checkpoint on the load phase's SD1.5 directory: the
    artifact's bytes against the directory's UNet and seconds; then one
    UNet forward from the artifact (load_models(artifact)) against
    load_models(dir, quantize_base=True)'s, bit for bit."""
    out = tmp / "sd15.int8.safetensors"
    t0 = time.time()
    n_q = quantize_checkpoint.main(["--base", str(sd_dir), "--family", "sd1", "--out", str(out)])
    cli_s = time.time() - t0
    dir_bytes = sum(f.stat().st_size for f in (sd_dir / "unet").glob("*.safetensors"))
    reset_counts()  # count this path only
    t0 = time.time()
    _, _, from_artifact, _ = factory.load_models(str(out), weight_dtype=torch.bfloat16, device="cuda")
    reload_s = time.time() - t0
    _, _, from_dir, _ = factory.load_models(str(sd_dir), weight_dtype=torch.bfloat16, device="cuda",
                                            quantize_base=True)
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((2, 4, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((2, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.tensor([261.0, 761.0], device="cuda")
    with torch.inference_mode():
        a, b = from_artifact(x, t, ctx), from_dir(x, t, ctx)
    launches = list(counts())
    check_no_plain("quantize_checkpoint")
    want = per_step_launches(UNetConfig.sd15(), 2, 0)
    row = dict(phase="quantize_checkpoint", model=f"{SD15} (the load phase's directory)", int8_kernels=n_q,
               artifact_bytes=out.stat().st_size, directory_unet_bytes=dir_bytes, cli_seconds=cli_s,
               reload_seconds=reload_s, forward_bit_equal=bool(torch.equal(a, b)),
               forward_finite=bool(torch.isfinite(a).all()), launches_k1_to_k4c=launches, expected_launches=want)
    emit(row)
    if n_q != 184 or not row["forward_bit_equal"] or not row["forward_finite"] or launches != want:
        raise AssertionError(f"quantize_checkpoint: {row}")
    del from_artifact, from_dir
    torch.cuda.empty_cache()
    return launches


def phase_kernel_sd_serve(gen: torch.Generator) -> tuple:
    """K1 and K4a against their plain versions at SD1.5 serving's shapes
    (512px with CFG: rows 2 for one request, 4 for a pair), bf16, on inputs
    zero-padded as the path pads them: K1 at 4096² and 4096×77 (8 heads, d
    40 → 64) and 1024² and 1024×77 (d 80 → 128); K4a at 256² and 256×77 (d
    160 → 192). Returns the errors of K1 and of K4a."""
    k1_errors, k4a_errors, checks = [], [], []
    for kernel, shapes in (("K1", SD_SERVE_K1_SHAPES), ("K4a", SD_SERVE_K4A_SHAPES)):
        for name, sq, sk, h, d in shapes:
            for rows in (2, 4):
                q, k, v = (path_randn(gen, (rows, n, h), d, torch.bfloat16) for n in (sq, sk, sk))
                what = f"{name} rows={rows} bf16"
                c = (check_k1 if kernel == "K1" else check_k4a)(q, k, v, what, scale=d**-0.5)
                (k1_errors if kernel == "K1" else k4a_errors).append(c["max_abs_err"])
                checks.append(dict(kernel=kernel, shape=name, rows=rows, heads=h, head_dim=d,
                                   padded_head_dim=q.shape[-1], max_abs_err=c["max_abs_err"], tol=c["tol"],
                                   lse_max_abs_err=c["lse_max_abs_err"]))
                del q, k, v, c
    emit(dict(phase="kernel_sd_serve", checks=checks))
    return k1_errors, k4a_errors


# ---------------------------------------------------------------------------
# SD3-Medium: the MMDiT's joint attention (24 heads of 64) and its paths
# ---------------------------------------------------------------------------

SD3 = "stabilityai/stable-diffusion-3-medium"
SD3_TRAIN_ITERATIONS = 4  # data/config-sd3.yaml's 1000, cut
SD3_SERVE_SIZE, SD3_SERVE_STEPS, SD3_GUIDANCE = 1024, 28, 7.0
# (name, rows, S, heads, head dim): K1 at the joint sequence (image tokens +
# 77 CLIP + 256 zero T5 tokens). 1024px serving with CFG: 4096 + 333 = 4429
# at rows 2; 512px training: 1024 + 333 = 1357 at rows 1, 2 and 4 (one
# prompt: the warm-up and student with CFG, the 4-row teacher) and at the
# path's own rows for data/prompts-sd3.yaml's batch of 8 (16: warm-up and
# student, 32: the teacher)
SD3_K1_SHAPES = [
    ("sd3_serve_joint_4429", 2, 4429, 24, 64),
    ("sd3_train_joint_1357", 1, 1357, 24, 64),
    ("sd3_train_joint_1357", 2, 1357, 24, 64),
    ("sd3_train_joint_1357", 4, 1357, 24, 64),
    ("sd3_train_joint_1357", 16, 1357, 24, 64),
    ("sd3_train_joint_1357", 32, 1357, 24, 64),
]
SD3_K23_SHAPES = [("sd3_train_joint_1357", 2, 1357, 24, 64), ("sd3_train_joint_1357", 16, 1357, 24, 64)]
SD3_INT8_REQUEST = ("a photo of a person", 2.0, 7, SD3_GUIDANCE, "smoke")


def joint_dims(shape) -> tuple:
    """(name, rows, Sq, Sk, heads, head dim) of a kernel-row shape; a
    self-attention row (name, rows, S, heads, head dim) has Sq = Sk = S."""
    return tuple(shape) if len(shape) == 6 else tuple(shape[:3]) + tuple(shape[2:])


def phase_kernel_joint(gen: torch.Generator, k1_shapes=SD3_K1_SHAPES, k23_shapes=SD3_K23_SHAPES) -> tuple:
    """K1 (bf16) against its plain version at a model's attention shapes
    (SD3-Medium's SD3_K1_SHAPES, Flux's FLUX_K1_SHAPES, Stable Cascade's
    CASCADE_K1_SHAPES) and K2/K3 at its student's (SD3_K23_SHAPES,
    FLUX_K23_SHAPES, CASCADE_K23_SHAPES), with the splits their rules pick:
    errors, events, device ms, the plain versions, SDPA (forward; whole
    backward), the bound, TFLOP/s, share of the bound. Returns (K1 rows,
    K2/K3 rows)."""
    k1_rows, bwd_rows = [], []
    for name, rows, sq, sk, h, d in map(joint_dims, k1_shapes):
        q, k, v = (torch.randn((rows, n, h, d), generator=gen, device="cuda").to(torch.bfloat16) for n in (sq, sk, sk))
        c = check_k1(q, k, v, f"{name} rows={rows} bf16")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bound_ms, bound_by = bound(rows, sq, sk, h, d, torch.bfloat16)
        row = dict(phase="kernel", shape=name, rows=rows, sq=sq, sk=sk, heads=h, head_dim=d, dtype="torch.bfloat16",
                   **{key: val for key, val in c.items() if key not in ("out", "lse")},
                   kernel_ms=cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), 10),
                   device_ms=device_ms(lambda: fa.flash_attention_fwd(q, k, v), 5),
                   plain_ms=cuda_ms(lambda: fa.flash_attention_reference(q, k, v, d**-0.5), 2),
                   library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10),
                   library_device_ms=device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 5),
                   bound_ms=bound_ms, bound_by=bound_by)
        row.update(rates(4 * rows * h * sq * sk * d, row["device_ms"], bound_ms, row["library_device_ms"]))
        emit(row)
        k1_rows.append(row)
        del q, k, v, qt, kt, vt, c
        torch.cuda.empty_cache()
    for name, rows, sq, sk, h, d in map(joint_dims, k23_shapes):
        scale = d**-0.5
        q, k, v, do = (torch.randn((rows, n, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                       for n in (sq, sk, sk, sq))
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale)
        torch.cuda.synchronize()
        k2_splits = fa.pick_k2_splits(rows * h, sq, sk, torch.bfloat16)
        k3_splits = fa.pick_k3_splits(rows * h, sq, sk, torch.bfloat16)
        ref = fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale,
                                               k3_splits, dq_splits=k2_splits)
        errs = {g: (got.float() - want).abs().max().item() for g, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref)}
        tols = {g: grad_tol(want, torch.bfloat16) for g, want in zip(("dq", "dk", "dv"), ref)}
        del dq, dk, dv, ref
        row = dict(phase="kernel_bwd", shape=name, rows=rows, sq=sq, sk=sk, heads=h, head_dim=d,
                   padded_head_dim=d, dtype="torch.bfloat16", k2_splits=k2_splits, k3_splits=k3_splits,
                   max_abs_err=errs, tol=tols,
                   k2_ms=cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale), 10),
                   k3_ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale), 10),
                   k2_device_ms=device_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale), 5),
                   k3_device_ms=device_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale), 5),
                   k2_plain_ms=cuda_ms(lambda: fa.bwd_dq_reference(q, k, v, o, lse, do, scale), 2),
                   k3_plain_ms=cuda_ms(lambda: fa.bwd_dkv_reference(q, k, v, lse, delta, do, scale), 2),
                   library_ms=library_backward_ms(q, k, v, do, 5))
        (row["k2_bound_ms"], row["k2_bound_by"]), (row["k3_bound_ms"], row["k3_bound_by"]) = (
            bwd_bound("dq", sq, sk, rows * h, d, torch.bfloat16), bwd_bound("dkv", sq, sk, rows * h, d, torch.bfloat16))
        for kern, mult in (("k2", 6), ("k3", 8)):
            row.update({f"{kern}_{key}": val for key, val in rates(
                mult * rows * h * sq * sk * d, row[f"{kern}_device_ms"], row[f"{kern}_bound_ms"],
                row["library_ms"]).items()})
        emit(row)
        bad = [g for g in errs if not errs[g] <= tols[g]]
        if bad:
            raise AssertionError(f"K2/K3 disagree with their plain versions at {name} rows={rows}: {errs} > {tols}")
        bwd_rows.append(row)
        del q, k, v, o, lse, do, delta
        torch.cuda.empty_cache()
    return k1_rows, bwd_rows


def sd3_lora(model, seed: int, rank: int = 2):
    """Sites over ``model``'s MMDiT and factors with a non-zero up (CPU)."""
    sites = lora.create_sites(model, rank=rank, target_replace=["Attention"], train_method="full", delimiter="-")
    g = torch.Generator().manual_seed(seed)
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    return sites, lp


def phase_sd3_parity() -> None:
    """The tiny SD3 flow sampler (3 steps, CFG 7, the slider through the
    overlay from step 1) and one tiny SD3 ESD step (train.cfg 7, the overlay
    student with the merged warm-up, each block checkpointed), fp32: card
    (K1 in every joint attention, K2/K3 in the student's backward) against
    the CPU, same weights, factors, inputs and draws."""
    cpu = factory.build_module(lambda: SD3Transformer2DModel(MMDiTConfig.tiny()), "cpu", torch.float32, 5)
    sites, lp = sd3_lora(cpu, 1)
    g = torch.Generator().manual_seed(2)
    lat = torch.randn((2, 16, 8, 8), generator=g)
    text, pooled = torch.randn((4, 81, 32), generator=g), torch.randn((4, 32), generator=g)
    sched = FlowMatchScheduler().set_timesteps(3)
    row_scale = torch.tensor([1.5, -1.0, 1.5, -1.0])

    def sample(model, device):
        lp_d = {n: {k: t.to(device) for k, t in leaf.items()} for n, leaf in lp.items()}
        return sample_flow_loop(model, 1, sched, lat.to(device), text.to(device), pooled.to(device),
                                guidance_scale=SD3_GUIDANCE, overlay=lora.LoRAOverlay(model, sites, lp_d),
                                row_scale=row_scale.to(device)).cpu()

    gpu = copy.deepcopy(cpu).to("cuda")
    reset_counts()
    got = sample(gpu, "cuda")
    launches = list(counts())
    check_no_plain("sd3_parity sampler")
    err = (got - sample(cpu, "cpu")).abs().max().item()
    emit(dict(phase="sd3_parity", what="sampler", model="tiny MMDiT", steps=3, max_abs_err=err, tol=1e-3,
              launches_k1_to_k4c=launches))
    if not err <= 1e-3 or launches != per_step_launches(gpu.config, 3, 0):
        raise AssertionError(f"tiny SD3 sampler on the card: error {err}, launches {launches}")

    bank_g = torch.Generator().manual_seed(3)
    bank = esd.PromptBank(torch.randn((1, 5, 81, 32), generator=bank_g), [3.0], [1.0],
                          torch.randn((1, 5, 32), generator=bank_g))
    t_to = 2
    lat0 = torch.randn((1, 16, 8, 8), generator=bank_g)

    def step(model, device):
        lp_d = {n: {k: t.to(device).clone().requires_grad_(True) for k, t in leaf.items()} for n, leaf in lp.items()}
        opt = get_optimizer("adamw", get_lr_schedule("constant", 1e-3, 10), grad_clip_norm=0.2)
        cfg = esd_sd3.SD3ESDConfig(max_denoising_steps=3, train_cfg_scale=SD3_GUIDANCE, height=64, width=64,
                                   remat=True, student_overlay=True, overlay_warmup=False)
        st = esd_sd3.make_sd3_esd_train_step(model, sites, lp_d, FlowMatchScheduler().set_timesteps(3), opt, cfg)
        bank_d = esd.PromptBank(bank.text.to(device), bank.guidance, bank.sign, bank.pooled.to(device))
        m = st(opt.init(flat_params(sites, lp_d)), bank_d, draws=[esd_sd3.Draw(0, t_to, lat0.to(device))])
        return float(m["loss"]), lora.state_dict_numpy(sites, lp_d)

    reset_counts()
    got = step(gpu, "cuda")
    launches = list(counts())
    check_no_plain("sd3_parity ESD step")
    want = step(cpu, "cpu")
    want_launches = per_step_launches(gpu.config, t_to + 3, 1)
    loss_err = abs(got[0] - want[0])
    factor_err = max(float(np.abs(got[1][k] - want[1][k]).max()) for k in want[1])
    emit(dict(phase="sd3_parity", what="esd_step", model="tiny MMDiT", timesteps_to=t_to, loss_card=got[0],
              loss_cpu=want[0], loss_abs_err=loss_err, factor_max_abs_err=factor_err, tol=1e-3,
              launches_k1_to_k4c=launches, expected_launches=want_launches))
    if not (loss_err <= 1e-3 * max(1.0, abs(want[0])) and factor_err <= 1e-3) or launches != want_launches:
        raise AssertionError(f"tiny SD3 ESD step on the card: loss {loss_err}, factors {factor_err}, "
                             f"launches {launches} (expected {want_launches})")


def write_component(root: Path, comp: str, sd: dict, config: dict, shards: int = 1) -> int:
    """One diffusers component: ``shards`` safetensors files (an index above
    one), its config.json; the bytes written."""
    sub = root / comp
    sub.mkdir(parents=True)
    (sub / "config.json").write_text(json.dumps(config))
    keys, weight_map, nbytes = sorted(sd), {}, 0
    for i in range(shards):
        name = (f"diffusion_pytorch_model-{i + 1:05d}-of-{shards:05d}.safetensors" if shards > 1
                else "model.safetensors")
        save_file({key: sd[key] for key in keys[i::shards]}, str(sub / name))
        weight_map.update({key: name for key in keys[i::shards]})
        nbytes += (sub / name).stat().st_size
    if shards > 1:
        (sub / "diffusion_pytorch_model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    return nbytes


SD3_TE_CONFIGS = {"text_encoder": CLIPTextConfig(projection_dim=768), "text_encoder_2": CLIPTextConfig.sdxl_te2()}


def phase_sd3_load(tmp: Path) -> Path:
    """A full-width SD3-Medium diffusers directory of seeded random bf16
    weights: transformer/ (MMDiTConfig.sd3_medium(), two shards and an
    index), text_encoder/ (CLIP-L with its 768-dim projection) and
    text_encoder_2/ (bigG) under transformers names, vae/ (VAEConfig.sd3():
    16 channels, use_quant_conv false, scaling 1.5305, shift 0.0609),
    config.json files, tokenizer/ and tokenizer_2/ (the synthetic BPE
    files); then factory.load_models_sd3(dir, "cuda", bf16, with_vae=True),
    every tensor bit-equal to its source; GB and GB/s."""
    root = tmp / "sd3-medium-diffusers"
    t0 = time.time()
    src = {comp: factory.build_module(lambda c=c: CLIPTextEncoder(c), "cuda", torch.bfloat16, seed)
           for seed, (comp, c) in enumerate(SD3_TE_CONFIGS.items())}
    src["transformer"] = factory.build_module(lambda: SD3Transformer2DModel(MMDiTConfig.sd3_medium()), "cuda",
                                              torch.bfloat16, 2)
    src["vae"] = factory.build_module(lambda: AutoencoderKL(VAEConfig.sd3()), "cuda", torch.bfloat16, 3)
    configs = {"transformer": MMDiTConfig.sd3_medium(), "vae": VAEConfig.sd3(), **SD3_TE_CONFIGS}
    nbytes = 0
    for comp, module in src.items():
        sd = module.state_dict()
        if comp.startswith("text_encoder"):
            sd = clip_transformers_names(sd)
        nbytes += write_component(root, comp, sd, dataclasses.asdict(configs[comp]), 2 if comp == "transformer" else 1)
    prompts = [p for f in sorted((REPO / "data").glob("prompts*.yaml"))
               for e in yaml_subset.load_file(str(f)) or [] for k, p in e.items()
               if k in ("target", "positive", "negative", "neutral", "unconditional") and isinstance(p, str)]
    for tok in ("tokenizer", "tokenizer_2"):
        write_synthetic_bpe_files(str(root / tok), prompts)
    write_s = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    toks, tes, transformer, sched, vae = factory.load_models_sd3(str(root), weight_dtype=torch.bfloat16,
                                                                 device="cuda", with_vae=True)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    got = {"text_encoder": tes[0].model, "text_encoder_2": tes[1].model, "transformer": transformer, "vae": vae}
    mismatched = [f"{comp}.{k}" for comp, m in got.items() for k, v in m.state_dict().items()
                  if v.dtype != torch.bfloat16 or not torch.equal(v, src[comp].state_dict()[k])]
    emit(dict(phase="sd3_load", model=f"{SD3} (seeded random weights)",
              layout="diffusers directory (transformer in 2 shards)",
              params={c: sum(p.numel() for p in m.parameters()) for c, m in got.items()},
              tensors=sum(len(m.state_dict()) for m in src.values()), gb=nbytes / 1e9, write_seconds=write_s,
              load_seconds=load_s, load_gb_per_second=nbytes / load_s / 1e9,
              tokenizers=[type(t).__name__ for t in toks], vae_shift_factor=vae.config.shift_factor,
              vae_quant_convs=vae.quant_conv is not None, scheduler_shift=sched.shift, bit_equal=not mismatched))
    if mismatched or vae.quant_conv is not None or transformer.config != MMDiTConfig.sd3_medium():
        raise AssertionError(f"sd3_load: {len(mismatched)} tensors differ from their source (e.g. {mismatched[:3]})")
    del src, got, tes, transformer, vae
    torch.cuda.empty_cache()
    return root


def phase_sd3_train(tmp: Path, sd3_dir: Path, what: str = "sd3_train", iterations: int = SD3_TRAIN_ITERATIONS,
                    yaml_edit=None, profile: bool = True) -> list:
    """Full-width SD3-Medium ESD training at 512px through
    cli/train_lora_sd3.train from data/config-sd3.yaml + data/prompts-sd3.yaml
    (batch 8, CFG 7, 28 flow steps; only the model — the sd3_load directory —,
    train.iterations and save.path overridden): per step K1 24·(tₖ + 3) (the
    warm-up, teacher, student and the student's recompute) and K2 = K3 = 24;
    steps/s after the first, first-step seconds, peak memory, the drawn
    timesteps_to, the saved keys; one more step profiled."""
    cfg, prompts = train_config(tmp / what, "config-sd3.yaml", iterations)
    cfg.pretrained_model.name_or_path = str(sd3_dir)
    if yaml_edit is not None:
        yaml_edit(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    res = train_lora_sd3.train(cfg, prompts, rank=cfg.network.rank, device="cuda")
    wall = time.time() - t0
    launches = list(counts())
    check_no_plain(what)
    t_to = [r["timesteps_to"] for r in res.metrics]
    mm_cfg = MMDiTConfig.sd3_medium()
    want = per_step_launches(mm_cfg, sum(t + 3 for t in t_to), iterations)
    saved = load_file(str(Path(cfg.save.path) / f"{cfg.save.name}_last.safetensors"))
    with torch.device("meta"):
        ref_sites = lora.create_sites(SD3Transformer2DModel(mm_cfg), rank=cfg.network.rank,
                                      target_replace=["Attention"], train_method=cfg.network.training_method,
                                      delimiter="-")
    keys_ok = set(saved) == {f"{s.lora_name}.{k}" for s in ref_sites
                             for k in ("lora_down.weight", "lora_up.weight", "alpha")}
    ups_zero = sum(not leaf["up"].detach().abs().max().item() > 0 for leaf in res.lora_params.values())
    row = dict(phase=what, model=f"{SD3} (the sd3_load directory)", image_size=prompts[0].resolution,
               batch_size=prompts[0].batch_size, train_cfg=cfg.train.cfg,
               max_denoising_steps=cfg.train.max_denoising_steps, precision=cfg.train.precision,
               quantize_base=cfg.tpu.quantize_base, lora_sites=len(res.sites), iterations=iterations,
               losses=res.losses, grad_norms=[r["grad_norm"] for r in res.metrics], timesteps_to=t_to,
               steps_per_sec_after_first=res.steps_per_sec, first_step_seconds=res.first_step_seconds,
               setup_seconds=res.setup_seconds, wall_seconds=wall,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, launches_k1_to_k4c=launches,
               expected_launches=want, saved_keys=len(saved), saved_keys_match_reference=keys_ok,
               up_factors_still_zero=ups_zero)
    emit(row)
    if (not all(np.isfinite(res.losses)) or len(res.losses) != iterations or ups_zero or not keys_ok
            or len(res.sites) != 96 or launches != want):
        raise AssertionError(f"{what}: {row}")
    if profile:
        profiled = {}
        prof = device_profile(lambda: profiled.update(res.next_step()))
        emit(dict(phase=f"{what}_profile", timesteps_to=profiled["timesteps_to"], **prof))
    del res
    torch.cuda.empty_cache()
    return launches


def make_sd3_slider(path: Path, rank: int = 4, seed: int = 4) -> None:
    """A rank-4 '-'-delimited slider over SD3-Medium's 96 image-stream sites
    (the trainer's under train_method full), non-zero up."""
    with torch.device("meta"):
        model = SD3Transformer2DModel(MMDiTConfig.sd3_medium())
    lora.save_weights(str(path), *sd3_lora(model, seed, rank))


def phase_sd3_serve(tmp: Path, sd3_dir: Path, ref: dict) -> tuple:
    """SD3SliderService over the sd3_load directory at 1024px, 28 flow steps,
    CFG 7: two solo requests, a concurrent pair, one /generate over HTTP, one
    profiled request; 24 × 28 = 672 K1 launches per sampler call and one K4a
    per decode (the fp32 VAE's mid-block). Keeps the slider and the bf16
    image of SD3_INT8_REQUEST in ``ref`` for sd3_int8."""
    ref["slider"] = str(tmp / "sd3_serve_noxattn_rank4_alpha1.safetensors")

    def after(svc):
        ref["png"] = svc.generate(*SD3_INT8_REQUEST)

    return served(tmp, "sd3_serve", lambda p: SD3SliderService(str(sd3_dir), p, image_size=SD3_SERVE_SIZE,
                                                               steps=SD3_SERVE_STEPS, device="cuda",
                                                               batch_window_ms=50.0),
                  MMDiTConfig.sd3_medium(), f"{SD3} (the sd3_load directory)", guidance=SD3_GUIDANCE,
                  slider=make_sd3_slider, after=after)


def phase_sd3_sweep(tmp: Path, sd3_dir: Path, slider: str) -> list:
    """cli/generate_images_sd3 at its defaults (512px, 28 steps, CFG 7,
    start_noise 750) over the sd3_load directory, scales -2, 0, 2 × one
    sample × case 0 of prompts/prompts-person.csv: per trajectory 24 × 28 K1,
    one K4a per decode; seconds per image."""
    save = tmp / "sd3_sweep"
    scales = ("-2.0", "0.0", "2.0")
    argv = ["--model_name", slider, "--prompts_path", str(REPO / "prompts" / "prompts-person.csv"),
            "--save_path", str(save), "--base", str(sd3_dir), "--scales=" + ",".join(scales), "--till_case", "0"]
    reset_counts()
    t0 = time.time()
    gen_sd3.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = list(counts())
    check_no_plain("sd3_sweep")
    imgs = {s: decode_png((save / Path(slider).name / s / "0_0.png").read_bytes()) for s in scales}
    k1_call, k4a_call = per_sampler_call(MMDiTConfig.sd3_medium(), 28)
    want = [len(scales) * k1_call, 0, 0, len(scales) * k4a_call, 0, 0]
    row = dict(phase="sd3_sweep", model=f"{SD3} (the sd3_load directory)", image_size=512, steps=28,
               scales=list(scales), wall_seconds=wall, seconds_per_image=wall / len(scales),
               launches_k1_to_k4c=launches, expected_launches=want, shapes=[list(i.shape) for i in imgs.values()],
               scale_minus2_vs_2=image_gap(imgs["-2.0"], imgs["2.0"]))
    emit(row)
    if launches != want or any(i.shape != (512, 512, 3) for i in imgs.values()) or np.array_equal(
            imgs["-2.0"], imgs["2.0"]):
        raise AssertionError(f"sd3_sweep: {row}")
    return launches


def phase_sd3_int8(tmp: Path, sd3_dir: Path, ref: dict) -> dict:
    """SD3's int8 base: 2 training steps with tpu.quantize_base (launches as
    bf16's, finite, moved factors); one 1024px request under --w8a8
    (latency, peak, the gap to the bf16 image); the quantize_checkpoint
    --family sd3 artifact (bytes, seconds) loaded as the base, one forward
    bit-equal to load_models_sd3(dir, quantize_base=True)'s."""
    paths = {"sd3_int8_train": phase_sd3_train(tmp, sd3_dir, "sd3_int8_train", 2,
                                               functools.partial(set_tpu, quantize_base=True), profile=False)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    svc = SD3SliderService(str(sd3_dir), ref["slider"], image_size=SD3_SERVE_SIZE, steps=SD3_SERVE_STEPS,
                           device="cuda", w8a8=True)
    load_s = time.time() - t0
    try:
        svc.add_slider("smoke", ref["slider"])
        reset_counts()
        t0 = time.time()
        png = svc.generate(*SD3_INT8_REQUEST)
        secs = time.time() - t0
        paths["sd3_int8_serve"] = list(counts())
        check_no_plain("sd3_int8_serve")
        n_q = sum(isinstance(m, quant.QuantLinear) for m in svc.unet.modules())
    finally:
        svc.close()
    del svc
    torch.cuda.empty_cache()
    img, bf16 = decode_png(png), decode_png(ref["png"])
    k1_call, k4a_call = per_sampler_call(MMDiTConfig.sd3_medium(), SD3_SERVE_STEPS)
    row = dict(phase="sd3_int8_serve", mode="w8a8", load_seconds=load_s, request_seconds=secs, quant_linears=n_q,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               gap_to_bf16=image_gap(img, bf16), launches_k1_to_k4c=paths["sd3_int8_serve"])
    emit(row)
    if paths["sd3_int8_serve"] != [k1_call, 0, 0, k4a_call, 0, 0] or img.shape != bf16.shape:
        raise AssertionError(f"sd3_int8_serve: {row}")

    out = tmp / "sd3-medium.int8.safetensors"
    t0 = time.time()
    n_q = quantize_checkpoint.main(["--base", str(sd3_dir), "--family", "sd3", "--out", str(out)])
    cli_s = time.time() - t0
    reset_counts()
    t0 = time.time()
    _, _, from_artifact, _ = factory.load_models_sd3(str(out), weight_dtype=torch.bfloat16, device="cuda")
    reload_s = time.time() - t0
    _, _, from_dir, _ = factory.load_models_sd3(str(sd3_dir), weight_dtype=torch.bfloat16, device="cuda",
                                                quantize_base=True)
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((2, 16, 64, 64), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((2, 333, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    pooled = torch.randn((2, 2048), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.tensor([261.0, 761.0], device="cuda")
    with torch.inference_mode():
        a, b = from_artifact(x, t, ctx, pooled), from_dir(x, t, ctx, pooled)
    paths["sd3_quantize_checkpoint"] = list(counts())
    check_no_plain("sd3_quantize_checkpoint")
    dir_bytes = sum(f.stat().st_size for f in (sd3_dir / "transformer").glob("*.safetensors"))
    row = dict(phase="sd3_quantize_checkpoint", int8_kernels=n_q, artifact_bytes=out.stat().st_size,
               directory_transformer_bytes=dir_bytes, cli_seconds=cli_s, reload_seconds=reload_s,
               forward_bit_equal=bool(torch.equal(a, b)), forward_finite=bool(torch.isfinite(a).all()),
               launches_k1_to_k4c=paths["sd3_quantize_checkpoint"])
    emit(row)
    if (not row["forward_bit_equal"] or not row["forward_finite"]
            or paths["sd3_quantize_checkpoint"] != per_step_launches(MMDiTConfig.sd3_medium(), 2, 0)):
        raise AssertionError(f"sd3_quantize_checkpoint: {row}")
    del from_artifact, from_dir, a, b
    out.unlink()
    torch.cuda.empty_cache()
    return paths


def phase_sd3_export(tmp: Path, sd3_dir: Path, slider: str) -> None:
    """cli/export_single_file --sd3 over the sd3_load directory and the serve
    slider at --scale 2 (fp16 --half, the *_incl_clips layout; fp32 before the
    image-editing phases joined: the 11.4 GB round trip took 38-48 s); the
    file reloaded through factory.load_models_sd3 in bf16: every non-site
    tensor bit-equal to the directory's, every site weight to the fp32 merge,
    each rounded to fp16 and then to bf16; write and reload seconds."""
    out = tmp / "sd3-medium-merged_incl_clips.safetensors"
    t0 = time.time()
    export_single_file.main(["--base", str(sd3_dir), "--slider", slider, "--scale", "2", "--output", str(out),
                             "--sd3", "--half", "--device", "0"])
    write_s = time.time() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    _, tes, merged_model, _ = factory.load_models_sd3(str(out), weight_dtype=torch.bfloat16, device="cuda")
    reload_s = time.time() - t0
    _, dir_tes, base, _ = factory.load_models_sd3(str(sd3_dir), weight_dtype=torch.float32, device="cuda")
    sites, lp = gen_sd3.sd3_slider(base, slider, load_slider_file(slider).unet, "cuda")
    merged = lora.merge_lora_params(base, sites, lp, 2.0)  # the CLI's fp32 merge
    def via_file(t):  # the CLI writes fp16, the reload casts to bf16
        return t.to(torch.float16).to(torch.bfloat16)

    want = {k: via_file(v) for k, v in base.state_dict().items()}
    want.update({k: via_file(v) for k, v in merged.items()})
    got = merged_model.state_dict()
    bad = [k for k, v in want.items() if not torch.equal(got[k], v)]
    bad += [f"te{i}.{k}" for i, (a, b) in enumerate(zip(tes, dir_tes)) for k, v in b.model.state_dict().items()
            if not torch.equal(a.model.state_dict()[k], via_file(v))]
    row = dict(phase="sd3_export", model=f"{SD3} (the sd3_load directory)", scale=2.0, sites=len(sites),
               export_dtype="float16",
               file_bytes=out.stat().st_size, write_seconds=write_s, reload_seconds=reload_s,
               tensors_checked=len(want), mismatched=len(bad))
    emit(row)
    out.unlink()
    del tes, merged_model, dir_tes, base, got, want, merged
    torch.cuda.empty_cache()
    if bad or len(sites) != 96:
        raise AssertionError(f"sd3_export: {len(bad)} tensors differ (e.g. {bad[:3]}), {len(sites)} sites")


def phase_sd3_notrigger(tmp: Path, sd3_dir: Path) -> None:
    """cli/train_notrigger.train with --model SD3-Medium over the sd3_load
    directory's towers: a LoRA slider in bigG (clip_index 1), NOTRIGGER_STEPS
    steps; finite losses, the saved keys (lora_te2_…, 4 sites per bigG
    layer); no attention kernel (the towers' causal attention is plain)."""
    cfg = load_config_from_yaml(str(REPO / "data" / "config-notrigger-xl.yaml"))
    cfg.pretrained_model.name_or_path = str(sd3_dir)
    cfg.save.path = str(tmp / "sd3_notrigger")
    cfg.train.iterations, cfg.train.lr = NOTRIGGER_STEPS, NOTRIGGER_LR
    reset_counts()
    t0 = time.time()
    train_notrigger.train(cfg, positive="a person, smiling", negative="a person, frowning", clip_index=1,
                          peft_type="lora", model="SD3-Medium", device="cuda")
    wall = time.time() - t0
    lines = [json.loads(x) for x in (Path(cfg.save.path) / f"{cfg.save.name}_metrics.jsonl").read_text().splitlines()]
    rows = [x for x in lines if "step" in x]
    saved = load_file(str(Path(cfg.save.path) / f"{cfg.save.name}_1_last.safetensors"))
    row = dict(phase="sd3_notrigger", model=f"{SD3} (the sd3_load directory's bigG)", steps=len(rows),
               losses=[r["loss"] for r in rows], wall_seconds=wall,
               steps_per_sec_after_first=lines[-1]["steps_per_sec"], saved_keys=len(saved),
               launches_k1_to_k4c=list(counts()))
    emit(row)
    if (len(rows) != NOTRIGGER_STEPS or not all(np.isfinite(row["losses"])) or any(counts()) or any(plain_calls())
            or len(saved) != 3 * 4 * CLIPTextConfig.sdxl_te2().num_hidden_layers
            or not all(k.startswith("lora_te2_") for k in saved)):
        raise AssertionError(f"sd3_notrigger: {row}")
    torch.cuda.empty_cache()


FLUX = "black-forest-labs/FLUX.1-schnell"
FLUX_TRAIN_ITERATIONS = 2  # data/config-flux.yaml's 1000, cut: 2 optimizer steps = 2 × 4 + 1 micro-steps
FLUX_GUIDANCE = 3.5  # the requests' guidance (a dev model's input; schnell ignores it)
FLUX_T5_LAYERS = 2  # flux_load's text_encoder_2: T5-XXL's width, its 24 layers cut to 2 in its config.json
# flux_load's transformer/: schnell's width, its 19 + 38 blocks cut to 2 + 4 in its config.json when
# Stable Cascade joined; flux_export exports that directory since the image-editing phases joined
# (flux_quantize_checkpoint still writes and reads a 12 GB file)
FLUX_LOAD_BLOCKS = dict(num_layers=2, num_single_layers=4)
FLUX_SHARDS = 5
FLUX_VAE = dict(scaling_factor=0.3611, shift_factor=0.1159)  # FLUX.1's vae/config.json
FLUX_INT8_REQUEST = ("a photo of a person", 2.0, 7, FLUX_GUIDANCE, "smoke")
# (name, rows, S, heads, head dim): K1 at Flux's joint sequence (512 T5
# tokens first, then the image's). 512px: 1024 + 512 = 1536 at rows 1 (a
# request), 2 (the student at data/prompts-flux.yaml's batch 2) and 6 (its
# 3-row teacher); 1024px: 4096 + 512 = 4608 at rows 1. K2/K3 at the
# student's rows 2, and at rows 6.
FLUX_K1_SHAPES = [
    ("flux_joint_1536", 1, 1536, 24, 128),
    ("flux_joint_1536", 2, 1536, 24, 128),
    ("flux_joint_1536", 6, 1536, 24, 128),
    ("flux_joint_4608", 1, 4608, 24, 128),
]
FLUX_K23_SHAPES = [("flux_joint_1536", 2, 1536, 24, 128), ("flux_joint_1536", 6, 1536, 24, 128)]


def phase_kernel_flux_checks(gen: torch.Generator) -> tuple:
    """At Flux's shapes, beyond phase_kernel_joint's bf16 rows: K1 fp32 at
    1536² and 4608² (rows 1), K2/K3 fp32 at 1536² rows 2, and bf16 K2's key
    split and K3's query split forced to 1, 2 and 64 at FLUX_K23_SHAPES
    against the plain versions over the same splits, each call repeated bit
    for bit (K2's δ the same bits at every split). Returns the max errors
    of (K1, K2, K3)."""
    errs = {"k1": [], "k2": [], "k3": []}
    fp32 = []
    for name, rows, s, h, d in (FLUX_K1_SHAPES[0], FLUX_K1_SHAPES[3]):
        q, k, v = (torch.randn((rows, s, h, d), generator=gen, device="cuda") for _ in range(3))
        c = check_k1(q, k, v, f"{name} rows={rows} fp32")
        errs["k1"].append(c["max_abs_err"])
        fp32.append(dict(kernel="K1", shape=name, rows=rows, max_abs_err=c["max_abs_err"]))
        del q, k, v, c
    name, rows, s, h, d = FLUX_K23_SHAPES[0]
    scale = d**-0.5
    q, k, v, do = (torch.randn((rows, s, h, d), generator=gen, device="cuda") for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, scale)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, scale)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
    e = [(x - w).abs().max().item() for x, w in zip(got, ref)]
    t = [grad_tol(w, torch.float32) for w in ref]
    fp32.append(dict(kernel="K2/K3", shape=name, rows=rows, max_abs_err=e, tol=t))
    if any(not a <= b for a, b in zip(e, t)):
        raise AssertionError(f"K2/K3 fp32 at {name}: {e} > {t}")
    errs["k2"].append(e[0])
    errs["k3"].append(max(e[1:]))
    del q, k, v, do, o, lse, got, ref
    forced = []
    for name, rows, s, h, d in FLUX_K23_SHAPES:
        scale = d**-0.5
        q, k, v, do = (torch.randn((rows, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, scale)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
        for splits in (1, 2, fa.MAX_SPLITS):
            got, got_delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, splits=splits)
            again, again_delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, scale, splits=splits)
            want, _ = fa.bwd_dq_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(), scale, splits)
            dkv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits)
            dkv_again = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, scale, splits=splits)
            dkv_want = fa.bwd_dkv_reference(q.float(), k.float(), v.float(), lse, delta, do.float(), scale, splits)
            torch.cuda.synchronize()
            e2 = (got.float() - want).abs().max().item()
            e3 = [(x.float() - w).abs().max().item() for x, w in zip(dkv, dkv_want)]
            t2, t3 = grad_tol(want, torch.bfloat16), [grad_tol(w, torch.bfloat16) for w in dkv_want]
            same = (torch.equal(got, again) and torch.equal(got_delta, again_delta) and torch.equal(got_delta, delta)
                    and all(torch.equal(x, y) for x, y in zip(dkv, dkv_again)))
            forced.append(dict(shape=name, rows=rows, splits=splits,
                               k2_rule_splits=fa.pick_k2_splits(rows * h, s, s, torch.bfloat16),
                               k3_rule_splits=fa.pick_k3_splits(rows * h, s, s, torch.bfloat16),
                               max_abs_err_dq=e2, max_abs_err_dk_dv=e3, tol_dq=t2, tol_dk_dv=t3,
                               repeats_and_delta_bit_equal=same))
            if not same or not e2 <= t2 or any(not a <= b for a, b in zip(e3, t3)):
                raise AssertionError(f"K2/K3 with forced splits at Flux's shapes: {forced[-1]}")
            errs["k2"].append(e2)
            errs["k3"].append(max(e3))
            del got, again, want, dkv, dkv_again, dkv_want
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    emit(dict(phase="kernel_flux", fp32=fp32, forced_splits_bf16=forced))
    return max(errs["k1"]), max(errs["k2"]), max(errs["k3"])


def flux_lora(model, seed: int, rank: int = 2):
    """Sites over ``model``'s Flux transformer and factors with a non-zero up
    (CPU)."""
    sites = lora.create_sites(model, rank=rank, target_replace=["Attention"], train_method="full", delimiter="-")
    g = torch.Generator().manual_seed(seed)
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    return sites, lp


def phase_flux_parity() -> None:
    """The tiny Flux packed sampler (3 steps, the slider through the overlay
    from step 1) and one tiny Flux ESD micro-step (MultiSteps k 2, the
    overlay student, each block checkpointed), fp32: card (K1 in every
    attention, K2/K3 in the student's backward) against the CPU, same
    weights, factors, inputs and draws."""
    cpu = factory.build_module(lambda: FluxTransformer2DModel(FluxConfig.tiny()), "cpu", torch.float32, 5)
    sites, lp = flux_lora(cpu, 1)
    g = torch.Generator().manual_seed(2)
    tokens, text, pooled = torch.randn((2, 16, 16), generator=g), torch.randn((2, 8, 32), generator=g), \
        torch.randn((2, 32), generator=g)
    sched = FlowMatchScheduler(use_dynamic_shifting=True).set_timesteps(3, mu=0.7)
    ids = torch.from_numpy(prepare_latent_image_ids(4, 4))
    row_scale = torch.tensor([1.5, -1.0])

    def sample(model, device):
        lp_d = {n: {k: t.to(device) for k, t in leaf.items()} for n, leaf in lp.items()}
        return sample_packed_flow(model, 1, sched, tokens.to(device), text.to(device), pooled.to(device),
                                  ids.to(device), overlay=lora.LoRAOverlay(model, sites, lp_d),
                                  row_scale=row_scale.to(device)).cpu()

    gpu = copy.deepcopy(cpu).to("cuda")
    reset_counts()
    got = sample(gpu, "cuda")
    launches = list(counts())
    check_no_plain("flux_parity sampler")
    err = (got - sample(cpu, "cpu")).abs().max().item()
    emit(dict(phase="flux_parity", what="sampler", model="tiny Flux", steps=3, max_abs_err=err, tol=1e-3,
              launches_k1_to_k4c=launches))
    if not err <= 1e-3 or launches != per_step_launches(gpu.config, 3, 0):
        raise AssertionError(f"tiny Flux sampler on the card: error {err}, launches {launches}")

    bank_g = torch.Generator().manual_seed(3)
    bank = esd.PromptBank(torch.randn((1, 5, 8, 32), generator=bank_g), [3.0], [1.0],
                          torch.randn((1, 5, 32), generator=bank_g))
    lat = torch.randn((2, 4, 16, 16), generator=bank_g)

    def step(model, device):
        lp_d = {n: {k: t.to(device).clone().requires_grad_(True) for k, t in leaf.items()} for n, leaf in lp.items()}
        opt = MultiSteps(get_optimizer("adamw", get_lr_schedule("cosine", 1e-3, 50, 1e-6), weight_decay=1e-6,
                                       grad_clip_value=1.0), 1)
        cfg = esd_flux.FluxESDConfig(batch_size=2, height=32, width=32, latent_channels=4, vae_scale=2, remat=True,
                                     student_overlay=True)
        st = esd_flux.make_flux_esd_train_step(model, sites, lp_d, FlowMatchScheduler(use_dynamic_shifting=True)
                                               .set_timesteps(8, mu=0.6), opt, cfg)
        bank_d = esd.PromptBank(bank.text.to(device), bank.guidance, bank.sign, bank.pooled.to(device))
        m = st(opt.init(flat_params(sites, lp_d)), bank_d, draws=[esd_flux.Draw(0, lat.to(device))])
        return float(m["loss"]), lora.state_dict_numpy(sites, lp_d)

    reset_counts()
    got = step(gpu, "cuda")
    launches = list(counts())
    check_no_plain("flux_parity ESD step")
    want = step(cpu, "cpu")
    want_launches = per_step_launches(gpu.config, 3, 1)
    loss_err = abs(got[0] - want[0])
    factor_err = max(float(np.abs(got[1][k] - want[1][k]).max()) for k in want[1])
    emit(dict(phase="flux_parity", what="esd_step", model="tiny Flux", loss_card=got[0], loss_cpu=want[0],
              loss_abs_err=loss_err, factor_max_abs_err=factor_err, tol=1e-3, launches_k1_to_k4c=launches,
              expected_launches=want_launches))
    if not (loss_err <= 1e-3 * max(1.0, abs(want[0])) and factor_err <= 1e-3) or launches != want_launches:
        raise AssertionError(f"tiny Flux ESD step on the card: loss {loss_err}, factors {factor_err}, "
                             f"launches {launches} (expected {want_launches})")


def phase_flux_train(tmp: Path, what: str = "flux_train", iterations: int = FLUX_TRAIN_ITERATIONS,
                     quantize_base: bool = False, profile: bool = True) -> list:
    """Full-width FLUX.1-schnell ESD training at 512px through
    cli/train_lora_flux.train from data/config-flux.yaml +
    data/prompts-flux.yaml (batch 2: 4 micro-steps per optimizer step, 8
    flow steps; the seeded weightless family at bf16; only train.iterations,
    save.path and tpu.quantize_base overridden, the last to
    ``quantize_base``): per micro-step K1 57 × 3 (the 6-row teacher, the
    student and its recompute) and K2 = K3 = 57; micro-steps/s and
    optimizer steps/s after the first, first-step seconds, peak memory, the
    saved keys (76 sites); one more micro-step profiled."""
    cfg, prompts = train_config(tmp / what, "config-flux.yaml", iterations)
    set_tpu(cfg, quantize_base=quantize_base)
    k = train_lora_flux.accumulation_steps(prompts[0].batch_size, max(cfg.tpu.samples_per_step, 1))
    micro = iterations * k + 1
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    res = train_lora_flux.train(cfg, prompts, rank=cfg.network.rank, device="cuda")
    wall = time.time() - t0
    launches = list(counts())
    check_no_plain(what)
    flux_cfg = FluxConfig.schnell()
    want = per_step_launches(flux_cfg, 3 * micro, micro)
    saved = load_file(str(Path(cfg.save.path) / f"{cfg.save.name}_last.safetensors"))
    with torch.device("meta"):
        ref_sites = lora.create_sites(FluxTransformer2DModel(flux_cfg), rank=cfg.network.rank,
                                      target_replace=["Attention"], train_method=cfg.network.training_method,
                                      delimiter="-")
    keys_ok = set(saved) == {f"{s.lora_name}.{key}" for s in ref_sites
                             for key in ("lora_down.weight", "lora_up.weight", "alpha")}
    ups_zero = sum(not leaf["up"].detach().abs().max().item() > 0 for leaf in res.lora_params.values())
    row = dict(phase=what, model=f"{FLUX} (seeded random weights)", image_size=prompts[0].resolution,
               batch_size=prompts[0].batch_size, micro_steps_per_optimizer_step=k, precision=cfg.train.precision,
               quantize_base=quantize_base, lora_sites=len(res.sites), iterations=iterations, micro_steps=micro,
               losses=res.losses, grad_norms=[r["grad_norm"] for r in res.metrics],
               micro_steps_per_sec_after_first=res.steps_per_sec,
               optimizer_steps_per_sec_after_first=res.steps_per_sec / k,
               first_step_seconds=res.first_step_seconds, setup_seconds=res.setup_seconds, wall_seconds=wall,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, launches_k1_to_k4c=launches,
               expected_launches=want, saved_keys=len(saved), saved_keys_match_reference=keys_ok,
               up_factors_still_zero=ups_zero)
    emit(row)
    if (not all(np.isfinite(res.losses)) or len(res.losses) != micro or ups_zero or not keys_ok
            or len(res.sites) != 76 or launches != want):
        raise AssertionError(f"{what}: {row}")
    if profile:
        reset_counts()
        prof = device_profile(res.next_step)
        emit(dict(phase=f"{what}_profile", launches_k1_to_k4c=list(counts()), **prof))
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def make_flux_slider(path: Path, rank: int = 4, seed: int = 4) -> None:
    """A rank-4 '-'-delimited slider over schnell's 76 dual-stream sites (the
    trainer's under train_method full), non-zero up."""
    with torch.device("meta"):
        model = FluxTransformer2DModel(FluxConfig.schnell())
    lora.save_weights(str(path), *flux_lora(model, seed, rank))


def phase_flux_serve(tmp: Path, ref: dict) -> tuple:
    """FluxSliderService at its defaults (512px, 8 steps, start_noise 800;
    the seeded weightless schnell, no vae/: JAX's latent preview): two solo
    requests (scales 0 and +2), a concurrent pair (-2 and +1), one
    /generate over HTTP, one profiled request; 8 × 57 = 456 K1 launches per
    sampler call and no K4a. Keeps the slider and the bf16 image of
    FLUX_INT8_REQUEST in ``ref`` for flux_int8."""
    ref["slider"] = str(tmp / "flux_serve_noxattn_rank4_alpha1.safetensors")

    def after(svc):
        ref["png"] = svc.generate(*FLUX_INT8_REQUEST)

    return served(tmp, "flux_serve", lambda p: FluxSliderService(FLUX, p, device="cuda", batch_window_ms=50.0),
                  FluxConfig.schnell(), f"{FLUX} (seeded random weights)", guidance=FLUX_GUIDANCE,
                  slider=make_flux_slider, after=after)


def phase_flux_sweep(tmp: Path, slider: str) -> list:
    """cli/generate_images_flux at its defaults (512px, 8 steps, start_noise
    800, the weightless schnell: the final latents as .npy), scales -2, 0,
    2 × one sample × case 0 of prompts/prompts-person.csv: 456 K1 per
    trajectory; seconds per image."""
    save = tmp / "flux_sweep"
    scales = ("-2.0", "0.0", "2.0")
    argv = ["--model_name", slider, "--prompts_path", str(REPO / "prompts" / "prompts-person.csv"),
            "--save_path", str(save), "--scales=" + ",".join(scales), "--till_case", "0"]
    reset_counts()
    t0 = time.time()
    gen_flux.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = list(counts())
    check_no_plain("flux_sweep")
    lats = {s: np.load(save / Path(slider).name / s / "0_0.npy") for s in scales}
    k1_call, _ = per_sampler_call(FluxConfig.schnell(), 8, decode=False)
    want = [len(scales) * k1_call, 0, 0, 0, 0, 0]
    row = dict(phase="flux_sweep", model=f"{FLUX} (seeded random weights)", image_size=512, steps=8,
               scales=list(scales), wall_seconds=wall, seconds_per_image=wall / len(scales),
               launches_k1_to_k4c=launches, expected_launches=want, shapes=[list(v.shape) for v in lats.values()],
               scale_minus2_vs_2_max_abs=float(np.abs(lats["-2.0"] - lats["2.0"]).max()))
    emit(row)
    if (launches != want or any(v.shape != (1, 16, 64, 64) or not np.isfinite(v).all() for v in lats.values())
            or np.array_equal(lats["-2.0"], lats["2.0"])):
        raise AssertionError(f"flux_sweep: {row}")
    torch.cuda.empty_cache()
    return launches


def phase_flux_load(tmp: Path, ref: dict) -> list:
    """A FLUX.1-schnell diffusers directory of seeded bf16 weights —
    transformer/ at full width with its depth cut to FLUX_LOAD_BLOCKS in its
    config.json (FLUX_SHARDS shards and an index),
    text_encoder_2/ T5-XXL's width with its depth cut to FLUX_T5_LAYERS in
    its config.json, text_encoder/ CLIP-L under transformers names, vae/
    (16 channels, FLUX.1's scaling and shift), tokenizer_2/spiece.model and
    tokenizer/ (synthetic) — served: FluxSliderService over it (its load is
    factory.load_models_flux) holds every tensor bit-equal to its source,
    then one 512px request decoded through the VAE (48 K1, 1 K4a). GB, write
    and load seconds, GB/s; the directory stays for flux_export (``ref["dir"]``)."""
    root = tmp / "flux1-schnell-diffusers"
    t0 = time.time()
    t5_cfg = T5Config(num_layers=FLUX_T5_LAYERS)
    flux_cfg = dataclasses.replace(FluxConfig.schnell(), **FLUX_LOAD_BLOCKS)
    vae_cfg = dataclasses.replace(VAEConfig.sd3(), **FLUX_VAE)
    src = {"transformer": factory.build_module(lambda: FluxTransformer2DModel(flux_cfg), "cuda", torch.bfloat16, 0),
           "text_encoder_2": factory.build_module(lambda: T5EncoderModel(t5_cfg), "cuda", torch.bfloat16, 1),
           "text_encoder": factory.build_module(lambda: CLIPTextEncoder(CLIPTextConfig.sd15_te()), "cuda",
                                                torch.bfloat16, 2),
           "vae": factory.build_module(lambda: AutoencoderKL(vae_cfg), "cuda", torch.bfloat16, 3)}
    configs = {"transformer": dataclasses.asdict(flux_cfg), "text_encoder_2": dataclasses.asdict(t5_cfg),
               "text_encoder": dataclasses.asdict(CLIPTextConfig.sd15_te()), "vae": dataclasses.asdict(vae_cfg)}
    nbytes = 0
    for comp, module in src.items():
        sd = module.state_dict()
        if comp == "text_encoder":
            sd = clip_transformers_names(sd)
        nbytes += write_component(root, comp, sd, configs[comp], FLUX_SHARDS if comp == "transformer" else 1)
    prompts = [p for f in sorted((REPO / "data").glob("prompts*.yaml"))
               for e in yaml_subset.load_file(str(f)) or [] for k, p in e.items()
               if k in ("target", "positive", "negative", "neutral", "unconditional") and isinstance(p, str)]
    (root / "tokenizer_2").mkdir()
    write_synthetic_spm(str(root / "tokenizer_2" / "spiece.model"), prompts)
    write_synthetic_bpe_files(str(root / "tokenizer"), prompts)
    write_s = time.time() - t0
    torch.cuda.synchronize()
    svc = FluxSliderService(str(root), ref["slider"], device="cuda")
    try:
        got = {"transformer": svc.unet, "text_encoder_2": svc.encoder.t5, "text_encoder": svc.encoder.clip.model,
               "vae": svc.vae}
        mismatched = [f"{comp}.{key}" for comp, m in got.items() for key, v in m.state_dict().items()
                      if not torch.equal(v, src[comp].state_dict()[key].to(v.dtype))]
        del src
        gc.collect()
        torch.cuda.empty_cache()
        svc.add_slider("smoke", ref["slider"])
        reset_counts()
        t1 = time.time()
        img = decode_png(svc.generate(*FLUX_INT8_REQUEST))
        secs = time.time() - t1
        launches = list(counts())
        check_no_plain("flux_load")
        row = dict(phase="flux_load", model=f"{FLUX} (seeded random weights)",
                   layout=f"diffusers directory (transformer in {FLUX_SHARDS} shards)",
                   reduced={"text_encoder_2.num_layers": [24, FLUX_T5_LAYERS],
                            "transformer.num_layers": [19, FLUX_LOAD_BLOCKS["num_layers"]],
                            "transformer.num_single_layers": [38, FLUX_LOAD_BLOCKS["num_single_layers"]]},
                   params={c: sum(p.numel() for p in m.parameters()) for c, m in got.items()},
                   gb=nbytes / 1e9, write_seconds=write_s, load_seconds=svc.load_seconds,
                   load_gb_per_second=nbytes / svc.load_seconds / 1e9, tokenizer=type(svc.tokenizers[0]).__name__,
                   vae_factors=[svc.vae.config.scaling_factor, svc.vae.config.shift_factor], bit_equal=not mismatched,
                   request_seconds=secs, image_shape=list(img.shape), launches_k1_to_k4c=launches)
        emit(row)
        k1_call, k4a_call = per_sampler_call(flux_cfg, 8)
        if (mismatched or launches != [k1_call, 0, 0, k4a_call, 0, 0] or img.shape != (512, 512, 3)
                or type(svc.tokenizers[0]).__name__ != "T5SpmTokenizer"):
            raise AssertionError(f"flux_load: {len(mismatched)} tensors differ (e.g. {mismatched[:3]}); {row}")
    finally:
        svc.close()
    del svc, got
    gc.collect()
    torch.cuda.empty_cache()
    ref["dir"] = root
    return launches


def phase_flux_int8(tmp: Path, ref: dict) -> dict:
    """Flux's int8 base: 1 optimizer step (5 micro-steps; 2 before Stable
    Cascade joined the smoke) with tpu.quantize_base (launches as bf16's,
    finite, moved factors); one 512px request under --w8a8 (latency, peak,
    the gap to the bf16 image of flux_serve); the quantize_checkpoint
    --family flux artifact of flux_load's directory (full width, its depth
    cut to FLUX_LOAD_BLOCKS: the full depth's 12 GB round trip and two 12 B
    builds took ~29 s of the smoke before the baseline phases joined; bytes,
    seconds) loaded as the base at the artifact's depth, one forward
    bit-equal to load_models_flux(dir, quantize_base=True)'s, the file
    deleted after."""
    paths = {"flux_int8_train": phase_flux_train(tmp, "flux_int8_train", 1, quantize_base=True, profile=False)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    svc = FluxSliderService(FLUX, ref["slider"], device="cuda", w8a8=True)
    load_s = time.time() - t0
    try:
        svc.add_slider("smoke", ref["slider"])
        reset_counts()
        t0 = time.time()
        png = svc.generate(*FLUX_INT8_REQUEST)
        secs = time.time() - t0
        paths["flux_int8_serve"] = list(counts())
        check_no_plain("flux_int8_serve")
        n_q = sum(isinstance(m, quant.QuantLinear) for m in svc.unet.modules())
    finally:
        svc.close()
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    img, bf16 = decode_png(png), decode_png(ref["png"])
    k1_call, _ = per_sampler_call(FluxConfig.schnell(), 8, decode=False)
    row = dict(phase="flux_int8_serve", mode="w8a8", load_seconds=load_s, request_seconds=secs, quant_linears=n_q,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
               gap_to_bf16=image_gap(img, bf16), launches_k1_to_k4c=paths["flux_int8_serve"])
    emit(row)
    if paths["flux_int8_serve"] != [k1_call, 0, 0, 0, 0, 0] or img.shape != bf16.shape:
        raise AssertionError(f"flux_int8_serve: {row}")

    out = tmp / "flux1-schnell-cut.int8.safetensors"
    t0 = time.time()
    n_q = quantize_checkpoint.main(["--base", str(ref["dir"]), "--family", "flux", "--out", str(out)])
    cli_s = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.time()
    _, _, from_artifact, _ = factory.load_models_flux(str(out), weight_dtype=torch.bfloat16, device="cuda")
    reload_s = time.time() - t0
    _, _, in_memory, _ = factory.load_models_flux(str(ref["dir"]), weight_dtype=torch.bfloat16, device="cuda",
                                                  quantize_base=True)
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((1, 1024, 64), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((1, 512, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    pooled = torch.randn((1, 768), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.tensor([0.7], device="cuda")
    txt_ids, img_ids = torch.zeros((512, 3), device="cuda"), torch.from_numpy(prepare_latent_image_ids(32, 32)).cuda()
    with torch.inference_mode():
        a = from_artifact(x, t, ctx, pooled, txt_ids, img_ids)
        b = in_memory(x, t, ctx, pooled, txt_ids, img_ids)
    paths["flux_quantize_checkpoint"] = list(counts())
    check_no_plain("flux_quantize_checkpoint")
    cut = dataclasses.replace(FluxConfig.schnell(), **FLUX_LOAD_BLOCKS)
    depth = [from_artifact.config.num_layers, from_artifact.config.num_single_layers]
    row = dict(phase="flux_quantize_checkpoint", base="flux_load's directory", int8_kernels=n_q,
               artifact_bytes=out.stat().st_size, depth=depth, cli_seconds=cli_s, reload_seconds=reload_s,
               forward_bit_equal=bool(torch.equal(a, b)), forward_finite=bool(torch.isfinite(a).all()),
               launches_k1_to_k4c=paths["flux_quantize_checkpoint"],
               reduced={"transformer.num_layers": [19, cut.num_layers],
                        "transformer.num_single_layers": [38, cut.num_single_layers]})
    emit(row)
    if (not row["forward_bit_equal"] or not row["forward_finite"]
            or depth != [cut.num_layers, cut.num_single_layers]
            or paths["flux_quantize_checkpoint"] != per_step_launches(cut, 2, 0)):
        raise AssertionError(f"flux_quantize_checkpoint: {row}")
    del from_artifact, in_memory, a, b
    out.unlink()
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def phase_flux_export(tmp: Path, slider: str, flux_dir: Path) -> None:
    """cli/export_single_file --flux --half over flux_load's directory (its
    transformer at schnell's full width, 19 + 38 blocks cut to
    FLUX_LOAD_BLOCKS when the image-editing phases joined: the full depth's
    24 GB write and reload took 75 s) as the fp32 base, with the serve
    slider baked at --scale 2 on the sites that depth has (BFL's layout,
    fp16); the file reloaded through the BFL loader at fp16
    (factory.load_models_flux: schnell, and the depth the file's blocks
    hold) and exported again: every tensor bit-equal to the file's; bytes,
    write and reload seconds; the file and the directory deleted after."""
    out = tmp / "flux1-schnell-merged.safetensors"
    t0 = time.time()
    sd = export_single_file.main(["--base", str(flux_dir), "--slider", slider, "--scale", "2", "--output", str(out),
                                  "--flux", "--half", "--device", "0"])
    write_s = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    _, _, model, _ = factory.load_models_flux(str(out), weight_dtype=torch.float16, device="cuda")
    reload_s = time.time() - t0
    back = ldm_export.export_flux_bfl(model.state_dict())
    bad = [k for k, v in sd.items() if k not in back or not torch.equal(back[k], v.to(back[k].device))]
    depth = {"num_layers": model.config.num_layers, "num_single_layers": model.config.num_single_layers}
    row = dict(phase="flux_export", model=f"{FLUX} (seeded random weights, fp32 base; flux_load's directory)",
               reduced={"transformer.num_layers": [19, FLUX_LOAD_BLOCKS["num_layers"]],
                        "transformer.num_single_layers": [38, FLUX_LOAD_BLOCKS["num_single_layers"]]},
               scale=2.0, dtype="float16", tensors=len(sd), file_bytes=out.stat().st_size, write_seconds=write_s,
               reload_seconds=reload_s, reloaded_depth=depth, guidance_embeds=model.config.guidance_embeds,
               mismatched=len(bad) + len(set(back) - set(sd)))
    emit(row)
    out.unlink()
    shutil.rmtree(flux_dir)
    del sd, model, back
    gc.collect()
    torch.cuda.empty_cache()
    if row["mismatched"] or row["guidance_embeds"] or depth != FLUX_LOAD_BLOCKS:
        raise AssertionError(f"flux_export: {len(bad)} tensors differ (e.g. {bad[:3]}); {row}")


def phase_flux_notrigger(tmp: Path) -> None:
    """cli/train_notrigger.train with --model FLUX.1 and clip_index 1: a LoRA
    slider in a seeded T5-XXL at full width and depth (bf16, the hash
    tokenizer, 512 tokens; the t5attn method), NOTRIGGER_STEPS steps;
    finite losses, the saved keys (lora_te2_encoder_block_…, 4 sites per
    layer); no attention kernel (T5's attention is plain). Then the saved
    part swept over the same seeded T5 at 0 and +1 (a prompt's encode with
    the part merged): 0 bit-equal to the tower without it, +1 not."""
    cfg = load_config_from_yaml(str(REPO / "data" / "config-notrigger-xl.yaml"))
    cfg.save.path = str(tmp / "flux_notrigger")
    cfg.train.iterations, cfg.train.lr = NOTRIGGER_STEPS, NOTRIGGER_LR
    reset_counts()
    t0 = time.time()
    train_notrigger.train(cfg, positive="a person, smiling", negative="a person, frowning", clip_index=1,
                          peft_type="lora", model="FLUX.1", device="cuda")
    wall = time.time() - t0
    gc.collect()
    torch.cuda.empty_cache()
    lines = [json.loads(x) for x in (Path(cfg.save.path) / f"{cfg.save.name}_metrics.jsonl").read_text().splitlines()]
    rows = [x for x in lines if "step" in x]
    path = Path(cfg.save.path) / f"{cfg.save.name}_1_last.safetensors"
    saved = load_file(str(path))
    t5_cfg = T5Config.xxl()
    t5 = factory.build_module(lambda: T5EncoderModel(t5_cfg), "cuda", torch.bfloat16, 0)  # the trainer's tower
    tok = HashTokenizer(vocab_size=t5_cfg.vocab_size, max_length=512, bos=0, eos=1, pad=0)
    ids = torch.from_numpy(tok(["a photo of a person"]).astype(np.int64)).cuda()
    parts = load_slider_file(str(path), [None, t5], te2_is_t5=True)
    with torch.inference_mode():
        base = t5(ids)
        sweep = {}
        for scale in (0.0, 1.0):
            with parts.merged_text_encoders(scale):
                sweep[scale] = t5(ids)
    at0 = bool(torch.equal(sweep[0.0], base))
    at1 = float((sweep[1.0].float() - base.float()).abs().max())
    row = dict(phase="flux_notrigger", model="T5-XXL (seeded random weights, bf16, 24 layers)", steps=len(rows),
               losses=[r["loss"] for r in rows], wall_seconds=wall,
               steps_per_sec_after_first=lines[-1]["steps_per_sec"], saved_keys=len(saved),
               sweep_scale0_bit_equal=at0, sweep_scale1_max_abs_diff=at1, launches_k1_to_k4c=list(counts()))
    emit(row)
    del t5, parts, base, sweep
    gc.collect()
    torch.cuda.empty_cache()
    if (len(rows) != NOTRIGGER_STEPS or not all(np.isfinite(row["losses"])) or any(counts()) or any(plain_calls())
            or len(saved) != 3 * 4 * t5_cfg.num_layers or not all(k.startswith("lora_te2_encoder_block_")
                                                                   for k in saved)
            or not at0 or not at1 > 0):
        raise AssertionError(f"flux_notrigger: {row}")


# ---------------------------------------------------------------------------
# Stable Cascade: the Stage-C prior (32 heads of 64) and its trainer
# ---------------------------------------------------------------------------

CASCADE = "stabilityai/stable-cascade-prior"
CASCADE_TRAIN_ITERATIONS = 2  # data/config-cascade.yaml's 2000, cut (3 before the baseline phases joined)
CASCADE_ROUTE_ITERATIONS = 2  # the route phases' steps
CASCADE_SHARDS = 4
# (name, rows, Sq, Sk, heads, head dim): the prior's attentions at
# data/prompts-cascade.yaml's 512px, a 12 × 12 effnet grid (ceil(512 /
# 42.67)): 144 queries over the 144 image tokens + 77 text + 4 pooled + 4
# image slots at level 0, 36 over 36 + 85 after the stride-2 conv at level
# 1; rows 2 (the warm-up's and the student's CFG pair) and 4 (the teacher).
# K2/K3 at the student's rows 2.
CASCADE_K1_SHAPES = [
    ("cascade_l0_144x229", 2, 144, 229, 32, 64),
    ("cascade_l0_144x229", 4, 144, 229, 32, 64),
    ("cascade_l1_36x121", 2, 36, 121, 32, 64),
    ("cascade_l1_36x121", 4, 36, 121, 32, 64),
]
CASCADE_K23_SHAPES = [("cascade_l0_144x229", 2, 144, 229, 32, 64), ("cascade_l1_36x121", 2, 36, 121, 32, 64)]


def tiny_cascade_prior() -> StableCascadeUNet:
    """The tiny prior (CPU, fp32) from seed 5, its GlobalResponseNorms'
    gamma and beta drawn too (the flax default leaves them 0: an identity)."""
    prior = factory.build_module(lambda: StableCascadeUNet(CascadeConfig.tiny()), "cpu", torch.float32, 5)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, p in prior.named_parameters():
            if name.endswith(("gamma", "beta")):
                p.copy_(0.5 * torch.randn(p.shape, generator=g))
    return prior


def phase_cascade_parity() -> None:
    """The tiny prior, fp32, card (K1 in every attention; K2/K3 in the
    student's backward) against the CPU with the same weights, factors,
    inputs and draws: one forward on the odd 5 × 5 grid (the up path's
    bilinear resize), then one ESD step on the default route (the merged
    student, its layers checkpointed; euler_a, T 3) with exact launches."""
    cpu = tiny_cascade_prior()
    cfg = cpu.config
    gpu = copy.deepcopy(cpu).to("cuda")
    g = torch.Generator().manual_seed(2)
    args = (torch.randn((2, 16, 5, 5), generator=g), torch.rand(2, generator=g), torch.randn((2, 77, 16), generator=g),
            torch.randn((2, 1, 16), generator=g), torch.randn((2, 1, 16), generator=g))
    reset_counts()
    with torch.no_grad():
        got = gpu(*(a.to("cuda") for a in args)).cpu()
    launches = list(counts())
    check_no_plain("cascade_parity forward")
    with torch.no_grad():
        err = (got - cpu(*args)).abs().max().item()
    want_launches = per_step_launches(cfg, 1, 0)
    emit(dict(phase="cascade_parity", what="forward_5x5", model="tiny Stable Cascade prior", max_abs_err=err,
              tol=1e-3, launches_k1_to_k4c=launches, expected_launches=want_launches))
    if not err <= 1e-3 or launches != want_launches:
        raise AssertionError(f"tiny prior on the card: error {err}, launches {launches}")

    sites = lora.create_sites(cpu, rank=2, target_replace=["Attention"])
    lp = lora.init_lora_params(sites, generator=g)
    for leaf in lp.values():
        leaf["up"] = torch.randn(leaf["up"].shape, generator=g) * 0.05
    bank = esd.PromptBank(torch.randn((1, 5, 77, 16), generator=g), [4.0], [1.0],
                          torch.randn((1, 5, 1, 16), generator=g))
    empty_text, empty_pooled = torch.randn((77, 16), generator=g), torch.randn((1, 16), generator=g)
    steps = 3
    draw = esd_cascade.Draw(0, torch.randn((1, 16, 5, 5), generator=g),
                            torch.randn((steps - 1, 1, 16, 5, 5), generator=g))
    sched = factory.create_noise_scheduler("euler_a")

    def step(model, device):
        lp_d = {n: {k: t.to(device).clone().requires_grad_(True) for k, t in leaf.items()} for n, leaf in lp.items()}
        opt = get_optimizer("adamw", get_lr_schedule("constant", 1e-3, 10))
        ccfg = esd_cascade.CascadeESDConfig(max_denoising_steps=steps, height=200, width=200, remat=True)
        st = esd_cascade.make_cascade_esd_train_step(model, sites, lp_d, sched, sched.set_timesteps(steps), opt, ccfg,
                                                     empty_text.to(device), empty_pooled.to(device), 16)
        bank_d = esd.PromptBank(bank.text.to(device), bank.guidance, bank.sign, bank.pooled.to(device))
        d = esd_cascade.Draw(0, draw.latents0.to(device), draw.warm_noise.to(device))
        m = st(opt.init(flat_params(sites, lp_d)), bank_d, draws=[d])
        return float(m["loss"]), lora.state_dict_numpy(sites, lp_d)

    reset_counts()
    got = step(gpu, "cuda")
    launches = list(counts())
    check_no_plain("cascade_parity ESD step")
    want = step(cpu, "cpu")
    want_launches = per_step_launches(cfg, steps - 1 + 3, 1)
    loss_err = abs(got[0] - want[0])
    factor_err = max(float(np.abs(got[1][k] - want[1][k]).max()) for k in want[1])
    emit(dict(phase="cascade_parity", what="esd_step", model="tiny Stable Cascade prior", max_denoising_steps=steps,
              loss_card=got[0], loss_cpu=want[0], loss_abs_err=loss_err, factor_max_abs_err=factor_err, tol=1e-3,
              launches_k1_to_k4c=launches, expected_launches=want_launches))
    if not (loss_err <= 1e-3 * max(1.0, abs(want[0])) and factor_err <= 1e-3) or launches != want_launches:
        raise AssertionError(f"tiny Cascade ESD step on the card: loss {loss_err}, factors {factor_err}, "
                             f"launches {launches} (expected {want_launches})")


def phase_cascade_load(tmp: Path) -> Path:
    """A full-width Stable Cascade diffusers directory of seeded random bf16
    weights: prior/ (CascadeConfig.prior(), CASCADE_SHARDS shards and an
    index), text_encoder/ (CLIP-G with its projection, transformers names),
    config.json files and tokenizer/ (the synthetic BPE files); then
    factory.load_models_cascade(dir, "euler_a", bf16, "cuda"), every tensor
    bit-equal to its source; GB and GB/s."""
    root = tmp / "stable-cascade-diffusers"
    t0 = time.time()
    te_cfg = CLIPTextConfig.sdxl_te2()
    src = {"text_encoder": factory.build_module(lambda: CLIPTextEncoder(te_cfg), "cuda", torch.bfloat16, 0),
           "prior": factory.build_module(lambda: StableCascadeUNet(CascadeConfig.prior()), "cuda", torch.bfloat16, 1)}
    nbytes = write_component(root, "prior", src["prior"].state_dict(), dataclasses.asdict(CascadeConfig.prior()),
                             CASCADE_SHARDS)
    nbytes += write_component(root, "text_encoder", clip_transformers_names(src["text_encoder"].state_dict()),
                              dataclasses.asdict(te_cfg))
    prompts = [p for f in sorted((REPO / "data").glob("prompts*.yaml"))
               for e in yaml_subset.load_file(str(f)) or [] for k, p in e.items()
               if k in ("target", "positive", "negative", "neutral", "unconditional") and isinstance(p, str)]
    write_synthetic_bpe_files(str(root / "tokenizer"), prompts)
    write_s = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    tok, te, prior, sched = factory.load_models_cascade(str(root), "euler_a", torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    load_s = time.time() - t0
    got = {"text_encoder": te.model, "prior": prior}
    mismatched = [f"{comp}.{k}" for comp, m in got.items() for k, v in m.state_dict().items()
                  if v.dtype != torch.bfloat16 or not torch.equal(v, src[comp].state_dict()[k])]
    emit(dict(phase="cascade_load", model=f"{CASCADE} (seeded random weights)",
              layout=f"diffusers directory (prior in {CASCADE_SHARDS} shards)",
              params={c: sum(p.numel() for p in m.parameters()) for c, m in got.items()},
              tensors=sum(len(m.state_dict()) for m in src.values()), gb=nbytes / 1e9, write_seconds=write_s,
              load_seconds=load_s, load_gb_per_second=nbytes / load_s / 1e9, tokenizer=type(tok).__name__,
              scheduler=sched.kind, bit_equal=not mismatched))
    if mismatched or prior.config != CascadeConfig.prior() or type(tok).__name__ == "HashTokenizer":
        raise AssertionError(f"cascade_load: {len(mismatched)} tensors differ from their source "
                             f"(e.g. {mismatched[:3]})")
    del src, got, te, prior
    gc.collect()
    torch.cuda.empty_cache()
    return root


def phase_cascade_train(tmp: Path, cascade_dir, what: str = "cascade_train",
                        iterations: int = CASCADE_TRAIN_ITERATIONS, yaml_edit=None, peft_type: str = "lora",
                        profile: bool = True) -> list:
    """Full-width Stable Cascade ESD training through
    cli/train_lora_cascade.train from data/config-cascade.yaml +
    data/prompts-cascade.yaml (512px, euler_a, T 20, bf16, c3lier rank 4,
    batch 1; only train.iterations, save.path, the model — the cascade_load
    directory, or the seeded weightless prior of the YAML's name where
    ``cascade_dir`` is None — and ``yaml_edit``'s route overridden): per
    step and sample K1 64·(19 + 3) (the warm-up, teacher, student and its
    recompute; 64·(19 + 3·S) with share_warmup) and K2 = K3 = 64; steps/s
    after the first, first-step and set-up seconds, peak memory, the saved
    .pt keys (256 sites, JAX's names), moved up factors; one more step
    profiled."""
    cfg, prompts = train_config(tmp / what, "config-cascade.yaml", iterations)
    if cascade_dir is not None:
        cfg.pretrained_model.name_or_path = str(cascade_dir)
    if yaml_edit is not None:
        yaml_edit(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    res = train_lora_cascade.train(cfg, prompts, rank=cfg.network.rank, peft_type=peft_type, device="cuda")
    wall = time.time() - t0
    launches = list(counts())
    check_no_plain(what)
    samples = max(cfg.tpu.samples_per_step, 1)
    warm = cfg.train.max_denoising_steps - 1
    forwards = warm + 3 * samples if cfg.tpu.share_warmup else samples * (warm + 3)
    prior_cfg = CascadeConfig.prior()
    want = per_step_launches(prior_cfg, forwards * iterations, samples * iterations)
    saved = torch.load(str(Path(cfg.save.path) / f"{cfg.save.name}_last.pt"))
    with torch.device("meta"):
        ref_sites = lora.create_sites(StableCascadeUNet(prior_cfg), rank=cfg.network.rank,
                                      target_replace=lora.DEFAULT_TARGET_REPLACE + lora.UNET_TARGET_REPLACE_MODULE_CONV,
                                      train_method=cfg.network.training_method)
    want_keys = {f"{s.lora_name}.{key}" for s in ref_sites for key in ("lora_down.weight", "lora_up.weight", "alpha")}
    if peft_type == "dora":
        want_keys |= {f"{s.lora_name}.dora_scale" for s in ref_sites}
    keys_ok = set(saved) == want_keys and all(v.dtype == torch.bfloat16 for v in saved.values())
    ups_zero = sum(not leaf["up"].detach().abs().max().item() > 0 for leaf in res.lora_params.values())
    source = "the cascade_load directory" if cascade_dir else "seeded random weights"
    row = dict(phase=what, model=f"{CASCADE} ({source})",
               image_size=prompts[0].resolution, batch_size=prompts[0].batch_size,
               noise_scheduler=cfg.train.noise_scheduler, max_denoising_steps=cfg.train.max_denoising_steps,
               precision=cfg.train.precision, peft_type=peft_type, student_overlay=cfg.tpu.student_overlay,
               w8a8_warmup=cfg.tpu.w8a8_warmup, samples_per_step=samples, share_warmup=cfg.tpu.share_warmup,
               lora_sites=len(res.sites), iterations=iterations, losses=res.losses,
               grad_norms=[r["grad_norm"] for r in res.metrics], steps_per_sec_after_first=res.steps_per_sec,
               first_step_seconds=res.first_step_seconds, setup_seconds=res.setup_seconds, wall_seconds=wall,
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30, launches_k1_to_k4c=launches,
               expected_launches=want, saved_keys=len(saved), saved_keys_match_reference=keys_ok,
               saved_sites=len(ref_sites), up_factors_still_zero=ups_zero)
    emit(row)
    if (not all(np.isfinite(res.losses)) or len(res.losses) != iterations or ups_zero or not keys_ok
            or len(res.sites) != 256 or launches != want):
        raise AssertionError(f"{what}: {row}")
    if profile:
        reset_counts()
        prof = device_profile(res.next_step)
        emit(dict(phase=f"{what}_profile", launches_k1_to_k4c=list(counts()), **prof))
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_cascade_routes(tmp: Path) -> dict:
    """The Cascade trainer's other routes, CASCADE_ROUTE_ITERATIONS steps
    each on the seeded weightless prior: the wuerstchen scheduler, DoRA (the
    merged student), the dual-tree W8A8 warm-up, the overlay student, and
    samples_per_step 2 with share_warmup. Returns each route's launches."""
    routes = {
        "cascade_wuerstchen": (lambda c: setattr(c.train, "noise_scheduler", "wuerstchen"), "lora"),
        "cascade_dora": (None, "dora"),
        "cascade_w8a8": (functools.partial(set_tpu, w8a8_warmup=True), "lora"),
        "cascade_overlay": (functools.partial(set_tpu, student_overlay=True), "lora"),
        "cascade_samples2_share": (functools.partial(set_tpu, samples_per_step=2, share_warmup=True), "lora"),
    }
    return {what: phase_cascade_train(tmp, None, what, CASCADE_ROUTE_ITERATIONS, edit, peft, profile=False)
            for what, (edit, peft) in routes.items()}


# ---------------------------------------------------------------------------
# image decoding, the scorers and null-text inversion editing
# ---------------------------------------------------------------------------

IMAGE_FIXTURES = REPO / "tests" / "data" / "image_decode"  # written with Pillow by tests/_make_image_fixtures.py
EDIT_STEPS, EDIT_INNER_STEPS = 10, 2  # the demo's 50 DDIM steps and null_optimization's 10 inner steps, cut
EDIT_SCALES = (0.0, -2.0, 2.0)
SCORER_TOL = 2e-4  # card against CPU, fp32, relative


def phase_image_decode() -> None:
    """Host only: every committed fixture (JPEG baseline and progressive at
    4:4:4/4:2:2/4:2:0/4:4:0, grey, restart markers, Adobe RGB; palette,
    2-bit, 16-bit and Adam7 PNGs; the JPEG bank's folders) through
    io/image.py::load_rgb, each held to the SHA-256 of Pillow's decode stored
    beside it; seconds per image."""
    digests = json.loads((IMAGE_FIXTURES / "digests.json").read_text())
    seconds, bad = {}, []
    for name, want in sorted(digests.items()):
        t0 = time.time()
        img = load_rgb(str(IMAGE_FIXTURES / name))
        seconds[name] = time.time() - t0
        if list(img.shape) != want["shape"] or hashlib.sha256(img.tobytes()).hexdigest() != want["sha256"]:
            bad.append(name)
    emit(dict(phase="image_decode", files=len(digests), mismatched=bad, seconds_total=sum(seconds.values()),
              seconds_per_image_mean=sum(seconds.values()) / len(seconds), seconds_per_image_max=max(seconds.values()),
              seconds_by_file=seconds))
    if bad or len(digests) < 20:
        raise AssertionError(f"image_decode: the port's decode differs from Pillow's on {bad}")


def write_clip_dir(root: Path) -> Path:
    """A transformers CLIPModel directory of a seeded full-width ViT-B/32
    scorer (vision 768 × 12, text 512 × 12, projections 512; fp32 under
    transformers names, the port's writer) with synthetic BPE files."""
    torch.manual_seed(11)
    vcfg, tcfg = clip_vision.CLIPVisionConfig.vit_b32(), CLIPTextConfig(
        hidden_size=512, intermediate_size=2048, num_hidden_layers=12, num_attention_heads=8, projection_dim=512)
    scorer = clip_vision.CLIPScorer(vcfg, tcfg)
    root.mkdir(parents=True, exist_ok=True)
    save_file(clip_vision.hf_state_dict(scorer), str(root / "model.safetensors"))
    config = {"projection_dim": 512,
              "vision_config": {k: getattr(vcfg, k) for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                                                              "num_attention_heads", "image_size", "patch_size")},
              "text_config": {k: getattr(tcfg, k) for k in ("vocab_size", "hidden_size", "intermediate_size",
                                                            "num_hidden_layers", "num_attention_heads")}}
    (root / "config.json").write_text(json.dumps(config))
    write_synthetic_bpe_files(str(root), ["a photo of a person", "image of a person, smiling"])
    return root


def write_lpips_files(root: Path) -> tuple:
    """Seeded torchvision-AlexNet and lpips lin-head state dicts (the real
    files' keys and shapes), as .pth."""
    root.mkdir(parents=True, exist_ok=True)
    g = torch.Generator().manual_seed(12)
    alex = {}
    for idx, (cin, cout, k, _, _) in zip(lpips_model.TORCHVISION_CONV_INDEX, lpips_model._ALEX_CONVS):
        alex[f"features.{idx}.weight"] = torch.randn((cout, cin, k, k), generator=g) * 0.05
        alex[f"features.{idx}.bias"] = torch.randn((cout,), generator=g) * 0.01
    lin = {f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=g) * 0.1
           for i, c in enumerate(lpips_model.ALEX_CHANNELS)}
    torch.save(alex, root / "alexnet.pth")
    torch.save(lin, root / "lpips_alex.pth")
    return root / "alexnet.pth", root / "lpips_alex.pth"


def read_score_csv(path: str) -> tuple:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def phase_scorers(tmp: Path) -> None:
    """eval/clip_score.py (a seeded ViT-B/32) and eval/lpip_score.py (seeded
    AlexNet + lin heads) over the SDXL sweep's folders (sweep_xl, merged:
    scales -2, 0, 2, case 0 at 512px) on the card, then the same CLIs with
    --device cpu: finite scores, the expected columns, card against CPU
    within 2e-4 relative. The ViT's attention is a plain product (as in JAX):
    no kernel runs."""
    (sweep,) = [p for p in (tmp / "sweep_xl_merged").iterdir() if p.is_dir()]
    prompts = str(REPO / "prompts" / "prompts-person.csv")
    t0 = time.time()
    clip_dir = write_clip_dir(tmp / "clip_vit_b32")
    alex, lin = write_lpips_files(tmp / "lpips")
    seconds = {"write_weights": time.time() - t0}
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.time()
        path = clip_score_cli.run(clip_score_cli.build_parser().parse_args(
            ["--im_path", str(sweep), "--prompt", "a photo of a person", "--prompts_path", prompts,
             "--clip_model", str(clip_dir), "--device", device]))
        seconds[f"clip_score_{device}"] = time.time() - t0
        t0 = time.time()
        lpath = lpip_score_cli.run(lpip_score_cli.build_parser().parse_args(
            ["--im_path", str(sweep), "--prompts_path", prompts, "--true", "0.0", "--alexnet_weights", str(alex),
             "--lpips_weights", str(lin), "--device", device]))
        seconds[f"lpip_score_{device}"] = time.time() - t0
        out[device] = (read_score_csv(path), read_score_csv(lpath))
    c_head, l_head = out["cuda"][0][0], out["cuda"][1][0]
    want_clip, want_lpips = ["clip_-2.0", "clip_0.0", "clip_2.0"], ["lpips_-2.0", "lpips_2.0"]
    if c_head[-3:] != want_clip or sorted(h for h in l_head if h.startswith("lpips_")) != want_lpips:
        raise AssertionError(f"scorers: columns {c_head}, {l_head}")
    scores, worst = {}, 0.0
    for (head, rows), (_, cpu_rows) in ((out["cuda"][0], out["cpu"][0]), (out["cuda"][1], out["cpu"][1])):
        for col in [h for h in head if h.startswith(("clip_", "lpips_"))]:
            j = head.index(col)
            card, cpu = float(rows[0][j]), float(cpu_rows[0][j])  # case 0, the sweep's one case
            scores[col] = dict(card=card, cpu=cpu)
            if not (np.isfinite(card) and np.isfinite(cpu)):
                raise AssertionError(f"scorers: {col} is not finite: {card}, {cpu}")
            worst = max(worst, abs(card - cpu) / max(abs(cpu), 1e-6))
    emit(dict(phase="scorers", clip_model="ViT-B/32 (seeded, full width)", sweep=str(sweep.relative_to(tmp)),
              scores_case0=scores, max_rel_err_card_vs_cpu=worst, tol=SCORER_TOL, seconds=seconds))
    if worst > SCORER_TOL:
        raise AssertionError(f"scorers: the card's scores differ from the CPU's by {worst} relative")


def attention_kinds(unet) -> list:
    """(is_cross, 'K1' or 'K4a') of every attention of ``unet``, as the dispatch routes it."""
    return [(m.is_cross, "K1" if m.to_q.out_features // m.heads <= 128 else "K4a")
            for m in unet.modules() if isinstance(m, unet_module.Attention)]


def phase_edit(tmp: Path, sd_dir: Path) -> list:
    """Null-text inversion editing (demos/demo_image_editing.run) on the SD1.5
    directory at 512px in fp32 (the demo's default): a committed JPEG,
    EDIT_STEPS DDIM steps, EDIT_INNER_STEPS inner steps, a seeded rank-4
    slider at scales 0, -2, 2 (start_noise 500). Each part's K1..K4c
    launches against the count predicted from which inputs need a gradient
    (the first self-attention of down_blocks.0 has no gradient path to the
    embedding, so its backward never launches); the scale-0 edit's
    reconstruction MSE against latent0; seconds per part. Then one forward
    each under capture_attention_maps and reweight_cross_attention: each
    launches one K1/K4a fewer per attention it materialises, and agrees with
    the kernels' forward."""
    slider = tmp / "edit_noxattn_rank4_alpha1.safetensors"
    make_slider(slider, UNetConfig.sd15())
    args = demo_edit.build_parser().parse_args(
        ["--base", str(sd_dir), "--image", str(IMAGE_FIXTURES / "bank" / "plus1" / "000.jpg"),
         "--prompt", "a photo of a person", "--slider", str(slider), "--scales", ",".join(map(str, EDIT_SCALES)),
         "--ddim_steps", str(EDIT_STEPS), "--out", str(tmp / "edit")])
    parts = {}
    total = [0] * 6

    def after_part(name: str) -> None:
        parts[name] = list(counts())
        for i, c in enumerate(parts[name]):
            total[i] += c
        reset_counts()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # count the edit path only
    t0 = time.time()
    res = demo_edit.run(args, null_inversion.NullOptConfig(num_inner_steps=EDIT_INNER_STEPS), after_part)
    wall = time.time() - t0
    check_no_plain("edit")
    kinds = attention_kinds(res["unet"])
    k1, k4a = sum(k == "K1" for _, k in kinds), sum(k == "K4a" for _, k in kinds)
    first_cross = next(i for i, (cross, _) in enumerate(kinds) if cross)
    no_grad = kinds[:first_cross]  # attentions before the first cross-attention: no path from the embedding
    k1_bwd, k4_bwd = k1 - sum(k == "K1" for _, k in no_grad), k4a - sum(k == "K4a" for _, k in no_grad)
    inner = sum(res["inner_steps"])
    fwd_null = 2 * EDIT_STEPS + inner  # per step the cond forward, each inner step's, the final guided one
    want = {"load": [0] * 6,
            "invert": [k1 * EDIT_STEPS, 0, 0, k4a * EDIT_STEPS + 1, 0, 0],  # + the VAE encoder's mid-block
            "null_optimization": [k1 * fwd_null, k1_bwd * inner, k1_bwd * inner, k4a * fwd_null, k4_bwd * inner,
                                  k4_bwd * inner]}
    for s in EDIT_SCALES:
        want[f"edit_{s}"] = [2 * k1 * EDIT_STEPS, 0, 0, 2 * k4a * EDIT_STEPS + 1, 0, 0]  # + the decode
    mse = float(torch.mean((res["finals"][0.0] - res["latent0"]) ** 2))
    moved = {s: float(np.abs(res["images"][s].astype(int) - res["images"][0.0]).mean()) for s in EDIT_SCALES}

    unet, x = res["unet"], res["trajectory"][-1]
    controllers = {}
    with torch.no_grad():
        plain = unet(x, 500, res["cond"])
        scale = float(plain.abs().max())
        for name, make, materialised in (("capture", unet_module.capture_attention_maps, kinds),
                                         ("reweight", lambda: unet_module.reweight_cross_attention(torch.ones(77)),
                                          [k for k in kinds if k[0]])):
            reset_counts()
            with make():
                got = unet(x, 500, res["cond"])
            launched = counts()
            fewer = (sum(k == "K1" for _, k in materialised), sum(k == "K4a" for _, k in materialised))
            controllers[name] = dict(k1=launched[0], k4a=launched[3], k1_fewer=k1 - launched[0],
                                     k4a_fewer=k4a - launched[3], materialised_k1=fewer[0], materialised_k4a=fewer[1],
                                     max_rel_diff_to_kernels=float((got - plain).abs().max()) / scale)
            if (k1 - launched[0], k4a - launched[3]) != fewer or any(launched[1:3] + launched[4:]):
                raise AssertionError(f"edit: {name} launched K1/K4a {launched}, expected {fewer} fewer than "
                                     f"{k1}/{k4a}")
        weights = torch.ones(77)
        weights[2:4] = 2.0  # the prompt's first two tokens doubled: the output moves
        with unet_module.reweight_cross_attention(weights):
            controllers["reweight"]["moved_by_weights"] = float((unet(x, 500, res["cond"]) - plain).abs().max())
        check_no_plain("edit_controllers")
    emit(dict(phase="edit", model=f"{SD15} (the load phase's directory)", precision="float32", image_size=512,
              image=str((IMAGE_FIXTURES / "bank" / "plus1" / "000.jpg").relative_to(REPO)), ddim_steps=EDIT_STEPS,
              num_inner_steps=EDIT_INNER_STEPS, inner_steps_taken=res["inner_steps"], scales=list(EDIT_SCALES),
              flip_step=res["flip_step"], reconstruction_mse_scale0=mse, mean_abs_pixel_change_vs_scale0=moved,
              launches_by_part=parts, expected_by_part=want, controllers=controllers, seconds_by_part=res["seconds"],
              wall_seconds=wall, max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30))
    if parts != want:
        raise AssertionError(f"edit: launches by part {parts}, expected {want}")
    if not (np.isfinite(mse) and all(torch.isfinite(f).all() for f in res["finals"].values())):
        raise AssertionError(f"edit: non-finite latents (reconstruction MSE {mse})")
    if min(moved[s] for s in EDIT_SCALES if s != 0.0) <= 0.0:
        raise AssertionError(f"edit: a ±s edit gave the scale-0 image: {moved}")
    if max(c["max_rel_diff_to_kernels"] for c in controllers.values()) > 1e-3 \
            or controllers["reweight"]["moved_by_weights"] <= 0:
        raise AssertionError(f"edit: a controller's forward differs from the kernels': {controllers}")
    del res, unet
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# the baseline generators, the acceptance chain, the demos, the parity dump
# ---------------------------------------------------------------------------

BASELINE_STEPS = 4  # the baseline CLIs' 50 steps, cut
ACCEPTANCE_STEPS = 4  # the acceptance chain's sweep: 50 DDIM steps, cut
TURBO_STEPS = 4  # the turbo demo's default
CONCEPT_DEMO_STEPS = 2  # the concept-slider demo's 8 training steps, cut


def one_case_csv(path: Path) -> Path:
    """prompts/prompts-person.csv's first case alone (the acceptance chain
    scores every case of its CSV, so it holds only the sampled one)."""
    lines = (REPO / "prompts" / "prompts-person.csv").read_text().splitlines()
    path.write_text("\n".join(lines[:2]) + "\n")
    return path


def counted(what: str, fn) -> tuple:
    """``fn()`` with every count at 0 first: (its result, K1..K4c launches,
    wall seconds); no plain attention may run."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    check_no_plain(what)
    return out, list(counts()), wall


def check_launches(what: str, got: list, k1: int, k4a: int, k2k3: int = 0) -> None:
    want = [k1, k2k3, k2k3, k4a, 0, 0]
    if got != want:
        raise AssertionError(f"{what}: launched K1..K4c {got}, expected {want}")


def phase_baselines(tmp: Path, sd_dir: Path) -> dict:
    """The four baseline generators (cli/generate_images_{uce,textinversion,
    textinversion_xl,customdiffusion}.py) at 512px, one case, one sample,
    BASELINE_STEPS steps (cut from 50; UCE's 5 samples and 7 scales cut to 1
    and -1, 0, 0.5, 2; the others' 5 samples to 1). UCE and TI-SD1 over the
    load phase's SD1.5 directory, TI-XL and Custom Diffusion XL on the SDXL
    name. UCE's scale-0 trajectory is run again with the original UNet's own
    weights (``sample_loop(merged=None)``): the final latents bit-equal."""
    out = {}
    csv_path = str(REPO / "prompts" / "prompts-person.csv")
    common = ["--prompts_path", csv_path, "--num_samples", "1", "--till_case", "0", "--ddim_steps",
              str(BASELINE_STEPS), "--device", "0"]
    g = torch.Generator().manual_seed(21)

    # UCE: the directory's UNet with every attn2 K/V tensor moved, stored bf16 like the base
    t0 = time.time()
    sd, _ = torch_convert.load_unet_state(str(sd_dir))
    edited = {k: ((v.float() + 0.02 * torch.randn(v.shape, generator=g)).to(v.dtype)
                  if "attn2" in k and (".to_k." in k or ".to_v." in k) else v) for k, v in sd.items()}
    uce_file = tmp / "uce_sd15.safetensors"
    save_file(edited, str(uce_file))
    n_edited = sum(not torch.equal(edited[k], sd[k]) for k in sd)
    del sd, edited
    write_s = time.time() - t0
    calls, real = [], gen_uce.sample_loop

    def recording(*a, **k):
        final = real(*a, **k)
        calls.append((a, k, final))
        return final

    scales = [-1.0, 0.0, 0.5, 2.0]
    gen_uce.sample_loop = recording
    try:
        _, launches, wall = counted("baseline_uce", lambda: gen_uce.main(
            ["--model_name", str(uce_file), "--save_path", str(tmp / "uce"), "--base", str(sd_dir),
             "--scales=" + ",".join(map(str, scales)), *common]))
    finally:
        gen_uce.sample_loop = real
    a, k, final0 = calls[scales.index(0.0)]
    n_interpolated = len(a[1])
    before = counts()
    original = real(a[0], None, *a[2:], **k)  # scale 0 again, with the original UNet's own weights
    extra = [x - y for x, y in zip(counts(), before)]
    del calls, a, k
    uce_file.unlink()
    k1, k4a = per_sampler_call(UNetConfig.sd15(), BASELINE_STEPS, decode=False)
    check_launches("baseline_uce", launches, len(scales) * k1, len(scales) * (k4a + 1))
    out["baseline_uce"] = [x + y for x, y in zip(launches, extra)]
    root = tmp / "uce" / "uce_sd15.safetensors"
    folders = sorted(p.name for p in root.iterdir())
    imgs = {f: decode_png((root / f / "0_0.png").read_bytes()) for f in ("-1", "0", "half", "2")}
    row = dict(phase="baselines", cli="generate_images_uce", model=f"{SD15} (the load phase's directory)",
               image_size=512, steps=BASELINE_STEPS, scheduler="lms", scales=scales, edited_tensors=n_edited,
               interpolated_tensors=n_interpolated, folders=folders, edit_write_seconds=write_s, wall_seconds=wall,
               scale0_bit_equal_to_original=bool(torch.equal(final0, original)),
               gap_scale_minus1_to_2=image_gap(imgs["-1"], imgs["2"]), launches_k1_to_k4c=launches)
    emit(row)
    if (folders != ["-1", "0", "2", "all", "half"] or not row["scale0_bit_equal_to_original"]
            or n_interpolated != n_edited or row["gap_scale_minus1_to_2"]["max_abs"] == 0
            or any(im.shape != (512, 512, 3) for im in imgs.values())):
        raise AssertionError(f"baselines: UCE {row}")

    # Textual Inversion, SD1.5 (the directory's BPE tokenizer) and SDXL (the weightless towers' hash tokenizer)
    save_file({"<sks>": torch.randn((768,), generator=g) * 0.02}, str(tmp / "learned_embeds.safetensors"))
    save_file({"clip_l": torch.randn((768,), generator=g) * 0.02, "clip_g": torch.randn((1280,), generator=g) * 0.02},
              str(tmp / "learned_embeds_xl.safetensors"))
    k1_xl, k4a_xl = per_sampler_call(UNetConfig.sdxl(), BASELINE_STEPS)
    runs = [("baseline_ti_sd1", gen_ti, ["--model_name", str(sd_dir), "--token", "<sks>", "--embedding_path",
                                         str(tmp / "learned_embeds.safetensors")], sd_dir.name, (k1, k4a + 1)),
            ("baseline_ti_xl", gen_ti_xl, ["--model_name", SDXL, "--token", "<sks>", "--embedding_path",
                                           str(tmp / "learned_embeds_xl.safetensors")], Path(SDXL).name,
             (k1_xl, k4a_xl))]

    # Custom Diffusion XL: one plain and one compressed (rank 4) attn2 K/V entry, one token for both towers
    with torch.device("meta"):
        shapes = {n: tuple(p.shape) for n, p in UNet2DConditionModel(UNetConfig.sdxl()).named_parameters()}
    kv = sorted(n for n in shapes if "attn2" in n and (".to_k." in n or ".to_v." in n))
    (tmp / "cd").mkdir()
    torch.save({"unet": {kv[0]: torch.randn(shapes[kv[0]], generator=g) * 0.02,
                         kv[1]: {"u": torch.randn((shapes[kv[1]][0], 4), generator=g) * 0.05,
                                 "v": torch.randn((4, shapes[kv[1]][1]), generator=g) * 0.05}},
                "modifier_token": {"<new1>": [torch.randn((768,), generator=g) * 0.02,
                                              torch.randn((1280,), generator=g) * 0.02]}}, tmp / "cd" / "delta.bin")
    runs.append(("baseline_cd_xl", gen_cd, ["--model_name", str(tmp / "cd" / "delta.bin"), "--token", "<new1>",
                                            "--family", "xl", "--base", SDXL], "delta.bin", (k1_xl, k4a_xl)))
    for what, cli, argv, folder, (w_k1, w_k4a) in runs:
        save = tmp / what
        _, launches, wall = counted(what, lambda: cli.main([*argv, "--save_path", str(save), *common]))
        check_launches(what, launches, w_k1, w_k4a)
        files = sorted(str(p.relative_to(save)) for p in save.rglob("*.png"))
        img = decode_png((save / folder / "0_0.png").read_bytes())
        emit(dict(phase="baselines", cli=cli.__name__.rsplit(".", 1)[-1], image_size=512, steps=BASELINE_STEPS,
                  files=files, wall_seconds=wall, launches_k1_to_k4c=launches, image_mean=float(img.mean())))
        if files != [f"{folder}/0_0.png"] or img.shape != (512, 512, 3):
            raise AssertionError(f"baselines: {what} wrote {files}")
        out[what] = launches
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_acceptance(tmp: Path) -> list:
    """cli/acceptance --skip_train on sweep_xl's slider over the SDXL name: a
    3-scale sweep (-2, 0, 2) at 512px and ACCEPTANCE_STEPS DDIM steps (cut
    from 50), one case (prompts-person.csv's first), then both scorers with
    the scorers phase's seeded weights, on the card. acceptance.json: JAX's
    keys, finite curves, lpips_identity exactly 0.0."""
    save = tmp / "acceptance"
    argv = ["--prompts_path", str(one_case_csv(tmp / "acceptance_prompts.csv")), "--save_path", str(save),
            "--base", SDXL, "--skip_train", "--model_name", str(tmp / "sweep_xl_noxattn_rank4_alpha1.safetensors"),
            "--ddim_steps", str(ACCEPTANCE_STEPS), "--scales=-2,0,2", "--clip_prompt", "a photo of a person",
            "--clip_model", str(tmp / "clip_vit_b32"), "--alexnet_weights", str(tmp / "lpips" / "alexnet.pth"),
            "--lpips_weights", str(tmp / "lpips" / "lpips_alex.pth"), "--device", "0"]
    _, launches, wall = counted("acceptance", lambda: acceptance.main(argv))
    report = json.loads((save / "acceptance.json").read_text())
    k1, k4a = per_sampler_call(UNetConfig.sdxl(), ACCEPTANCE_STEPS)
    emit(dict(phase="acceptance", model=SDXL, image_size=512, steps=ACCEPTANCE_STEPS, scales=[-2.0, 0.0, 2.0],
              report={k: v for k, v in report.items() if k not in ("slider", "sweep_dir")}, wall_seconds=wall,
              launches_k1_to_k4c=launches))
    check_launches("acceptance", launches, 3 * k1, 3 * k4a)
    curves = list(report["clip_curve"].values()) + list(report["lpips_curve"].values())
    if (report.get("lpips_identity") != 0.0 or len(report["clip_curve"]) != 3 or len(report["lpips_curve"]) != 2
            or not all(np.isfinite(curves))):
        raise AssertionError(f"acceptance: {report}")
    return launches


def phase_demos(tmp: Path) -> dict:
    """demos/demo_sdxl_turbo on the SDXL name with sweep_xl's slider (512px,
    TURBO_STEPS Euler-A steps, guidance 0: the cond-only rows, start_noise
    800, scales -2, 0, 2), then demos/demo_concept_sliders on it: fp32 ESD
    training through the programmatic API (CONCEPT_DEMO_STEPS steps at 512px,
    cut from 8 at 64px: K2/K3) and a 2-scale sweep (4 Euler-A steps, CFG)."""
    out = {}
    args = demo_turbo.build_parser().parse_args(
        ["--base", SDXL, "--slider", str(tmp / "sweep_xl_noxattn_rank4_alpha1.safetensors"), "--prompt",
         "a photo of a person", "--steps", str(TURBO_STEPS), "--out", str(tmp / "turbo")])
    images, launches, wall = counted("demo_turbo", lambda: demo_turbo.run(args))
    k1, k4a = per_sampler_call(UNetConfig.sdxl(), TURBO_STEPS)
    emit(dict(phase="demos", demo="demo_sdxl_turbo", model=SDXL, image_size=512, steps=TURBO_STEPS,
              guidance_scale=0.0, scales=sorted(images), wall_seconds=wall, launches_k1_to_k4c=launches,
              gap_scale_minus2_to_2=image_gap(images[-2.0], images[2.0])))
    check_launches("demo_turbo", launches, 3 * k1, 3 * k4a)
    if any(im.shape != (512, 512, 3) for im in images.values()) or np.array_equal(images[-2.0], images[2.0]):
        raise AssertionError("demo_turbo: the images are not three distinct 512px renders")
    out["demo_turbo"] = launches
    gc.collect()
    torch.cuda.empty_cache()

    args = demo_concept.build_parser().parse_args(
        ["--base", SDXL, "--steps", str(CONCEPT_DEMO_STEPS), "--resolution", "512", "--scales=-2,2", "--out",
         str(tmp / "concept_demo")])
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted("demo_concept", lambda: demo_concept.run(args))
    t_to = [row["timesteps_to"] for row in res["result"].metrics]
    train = per_step_launches(UNetConfig.sdxl(), sum(t + 2 for t in t_to), CONCEPT_DEMO_STEPS)
    k1, k4a = per_sampler_call(UNetConfig.sdxl(), demo_concept.SWEEP_STEPS)
    want = [train[0] + 2 * k1, train[1], train[2], 2 * k4a, 0, 0]
    losses = res["result"].losses
    emit(dict(phase="demos", demo="demo_concept_sliders", model=SDXL, precision="float32", image_size=512,
              train_steps=CONCEPT_DEMO_STEPS, timesteps_to=t_to, losses=losses, sweep_steps=demo_concept.SWEEP_STEPS,
              scales=sorted(res["images"]), wall_seconds=wall, launches_k1_to_k4c=launches, expected=want,
              max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30))
    if launches != want or len(losses) != CONCEPT_DEMO_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"demo_concept: launched {launches}, expected {want}; losses {losses}")
    out["demo_concept"] = launches
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_parity_dump(tmp: Path, sd_dir: Path) -> list:
    """eval/parity dump of the SD1.5 directory (fp32, the probes: one UNet
    forward and the text tower) on the card, then the same dump on the CPU,
    then compare at its default atol (5e-3 relative): seconds of each."""
    card, cpu = tmp / "parity_card.npz", tmp / "parity_cpu.npz"
    dump = ["dump", "--model_dir", str(sd_dir), "--family", "sd15"]
    _, launches, card_s = counted("parity_dump", lambda: parity.main([*dump, "--out", str(card), "--device", "0"]))
    t0 = time.time()
    parity.main([*dump, "--out", str(cpu), "--device", "cpu"])
    cpu_s = time.time() - t0
    ok = parity.compare(str(cpu), str(card))
    a, b = np.load(cpu), np.load(card)
    rel = {k: float(np.abs(a[k] - b[k]).max() / (np.abs(b[k]).max() + 1e-8)) for k in a.files}
    k1, k4a = per_sampler_call(UNetConfig.sd15(), 1, decode=False)
    emit(dict(phase="parity_dump", model=f"{SD15} (the load phase's directory)", precision="float32", ok=ok,
              max_rel_err_card_vs_cpu=rel, card_seconds=card_s, cpu_seconds=cpu_s, launches_k1_to_k4c=launches))
    check_launches("parity_dump", launches, k1, k4a)
    if not ok:
        raise AssertionError(f"parity_dump: the card's activations differ from the CPU's: {rel}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this smoke runs only on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    t0 = time.time()
    fa.build()
    libraries = {n: {k: v for k, v in info.items() if k != "ptxas"} for n, info in fa.build_info.items()}
    emit(dict(phase="build", seconds=time.time() - t0, libraries=libraries, kernels=ptxas_summary(fa.build_info),
              card=card, torch=torch.__version__, cuda=torch.version.cuda))

    gen = torch.Generator(device="cuda").manual_seed(0)
    t_image = time.time()
    phase_image_decode()
    image_eval_seconds = time.time() - t_image
    k1_rows = phase_kernel(gen)
    bwd_rows, k1_train_rows = phase_kernel_bwd(gen)
    kgrid_rows, kgrid_errors = phase_kernel_kgrid(gen)
    kgrid_bwd_rows, k4b_errors, k4c_errors = phase_kernel_kgrid_bwd(gen)
    k1_sd_errors, k4a_sd_errors = phase_kernel_sd_serve(gen)
    sd3_k1_rows, sd3_bwd_rows = phase_kernel_joint(gen)
    flux_k1_rows, flux_bwd_rows = phase_kernel_joint(gen, FLUX_K1_SHAPES, FLUX_K23_SHAPES)
    flux_k1_err, flux_k2_err, flux_k3_err = phase_kernel_flux_checks(gen)
    t_cascade = time.time()
    cascade_k1_rows, cascade_bwd_rows = phase_kernel_joint(gen, CASCADE_K1_SHAPES, CASCADE_K23_SHAPES)
    cascade_seconds = time.time() - t_cascade  # the Cascade phases' time: the kernel rows, the parity, the paths
    phase_parity()
    phase_train_parity()
    phase_sd_train_parity()
    phase_sd3_parity()
    phase_flux_parity()
    t_cascade = time.time()
    phase_cascade_parity()
    cascade_seconds += time.time() - t_cascade
    paths = {}  # each path's launches of K1..K4c, counted from 0 just before it
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        phase_imageslider_parity(tmp)
        # each serving and training phase sets every count to 0 first
        bf16_ref = {}  # the bf16 service's image of INT8_REQUEST, for serve_int8's gap

        def after_serve(svc):
            paths["serve_sliders"] = phase_serve_sliders(tmp, svc)
            bf16_ref["png"] = svc.generate(*INT8_REQUEST)

        paths["serve"] = served(tmp, "serve", lambda p: SliderService(
            SDXL, p, image_size=IMAGE_SIZE, steps=STEPS, device="cuda", batch_window_ms=50.0), UNetConfig.sdxl(), SDXL,
            after=after_serve)
        train_rows = {"train": phase_esd(tmp, "train", "config-xl.yaml")}
        torch.cuda.empty_cache()
        t_routes = time.time()
        train_rows["train_overlay_warmup"] = phase_esd(tmp, "train_overlay_warmup", "config-xl.yaml",
                                                       functools.partial(set_tpu, overlay_warmup=True),
                                                       iterations=ROUTE_ITERATIONS)
        torch.cuda.empty_cache()
        emit(dict(phase="warmup_routes", model=SDXL, **{
            name: {k: row[k] for k in ("student_overlay", "overlay_warmup", "iterations", "timesteps_to",
                                       "steps_per_sec_after_first", "unet_forwards_per_sec_after_first",
                                       "first_step_seconds")}
            for name, row in (("merged_warmup", train_rows["train"]),
                              ("overlay_warmup", train_rows["train_overlay_warmup"]))}))
        train_rows["train_merged"] = phase_esd(tmp, "train_merged", "config-xl.yaml",
                                               functools.partial(set_tpu, student_overlay=False),
                                               iterations=ROUTE_ITERATIONS)
        torch.cuda.empty_cache()
        phase_merged_call_cost()
        paths["imageslider"] = phase_image_pairs(tmp, "imageslider", "config-xl.yaml",
                                                 train_lora_scale.XL_RESOLUTION, seed=6, first_wh=(600, 400))
        torch.cuda.empty_cache()
        train_rows["sd_train"] = phase_esd(tmp, "sd_train", "config.yaml", profile=False)
        torch.cuda.empty_cache()
        train_rows["sd_dora_train"] = phase_esd(tmp, "sd_dora_train", "config.yaml", iterations=ROUTE_ITERATIONS,
                                                peft_type="dora", profile=False)
        torch.cuda.empty_cache()
        train_rows["sd2_train"] = phase_esd(tmp, "sd2_train", "config.yaml", sd21_config, iterations=2, profile=False)
        torch.cuda.empty_cache()
        paths.update({k: row["launches_k1_to_k4c"] for k, row in train_rows.items()})
        t_knobs = time.time()
        paths.update(phase_train_knobs(tmp))
        phase_knob_parity(tmp)
        paths.update(phase_sd_train_knobs(tmp))
        paths.update(phase_notrigger(tmp))
        emit(dict(phase="knob_phases", seconds=time.time() - t_knobs))
        paths["sd_imageslider"] = phase_image_pairs(tmp, "sd_imageslider", "config.yaml",
                                                    train_lora_scale.SD_RESOLUTION, seed=8)
        torch.cuda.empty_cache()
        paths["sd_imageslider_merged"] = phase_image_pairs(
            tmp, "sd_imageslider_merged", "config.yaml", train_lora_scale.SD_RESOLUTION, seed=8,
            yaml_edit=functools.partial(set_tpu, student_overlay=False), iterations=2,
            image_root=IMAGE_FIXTURES / "bank")
        torch.cuda.empty_cache()
        emit(dict(phase="route_phases", seconds=time.time() - t_routes))
        t_new = time.time()
        sd_dir = phase_load(tmp)
        paths["sd_serve"] = served(tmp, "sd_serve", lambda p: SD1SliderService(
            str(sd_dir), p, image_size=512, steps=SD1_STEPS, device="cuda", batch_window_ms=50.0), UNetConfig.sd15(),
            f"{SD15} (the load phase's directory)")
        paths["sd2_serve"] = served(tmp, "sd2_serve", lambda p: SD1SliderService(
            SD21, p, image_size=512, steps=SD2_STEPS, v2=True, v_pred=True, device="cuda"), UNetConfig.sd21(),
            SD21, pair=False, http=False, profile=False)
        paths["sweep_xl"] = phase_sweep_xl(tmp)
        paths["sweep_sd1"] = phase_sweep_sd1(tmp, sd_dir)
        emit(dict(phase="inference_paths", seconds=time.time() - t_new))
        t_image = time.time()
        phase_scorers(tmp)
        paths["edit"] = phase_edit(tmp, sd_dir)
        emit(dict(phase="image_eval_phases", seconds=time.time() - t_image + image_eval_seconds,
                  image_decode_seconds=image_eval_seconds))
        t_eval = time.time()
        paths.update(phase_baselines(tmp, sd_dir))
        paths["acceptance"] = phase_acceptance(tmp)
        paths.update(phase_demos(tmp))
        paths["parity_dump"] = phase_parity_dump(tmp, sd_dir)
        emit(dict(phase="eval_phases", seconds=time.time() - t_eval))
        t_export = time.time()
        paths["export"] = phase_export(tmp, sd_dir)
        emit(dict(phase="export_path", seconds=time.time() - t_export))
        t_int8 = time.time()
        phase_quant()
        paths.update(phase_train_int8(tmp))
        paths.update(phase_serve_int8(tmp, bf16_ref["png"]))
        paths["quantize_checkpoint"] = phase_quantize_checkpoint(tmp, sd_dir)
        emit(dict(phase="int8_phases", seconds=time.time() - t_int8))
        t_sd3 = time.time()
        sd3_dir = phase_sd3_load(tmp)
        paths["sd3_train"] = phase_sd3_train(tmp, sd3_dir)
        sd3_ref = {}
        paths["sd3_serve"] = phase_sd3_serve(tmp, sd3_dir, sd3_ref)
        paths["sd3_sweep"] = phase_sd3_sweep(tmp, sd3_dir, sd3_ref["slider"])
        paths.update(phase_sd3_int8(tmp, sd3_dir, sd3_ref))
        phase_sd3_export(tmp, sd3_dir, sd3_ref["slider"])
        phase_sd3_notrigger(tmp, sd3_dir)
        emit(dict(phase="sd3_phases", seconds=time.time() - t_sd3))
        shutil.rmtree(sd3_dir)
        t_flux = time.time()
        paths["flux_train"] = phase_flux_train(tmp)
        flux_ref = {}
        paths["flux_serve"] = phase_flux_serve(tmp, flux_ref)
        paths["flux_sweep"] = phase_flux_sweep(tmp, flux_ref["slider"])
        paths["flux_load"] = phase_flux_load(tmp, flux_ref)
        paths.update(phase_flux_int8(tmp, flux_ref))
        phase_flux_export(tmp, flux_ref["slider"], flux_ref["dir"])
        phase_flux_notrigger(tmp)
        emit(dict(phase="flux_phases", seconds=time.time() - t_flux))
        t_cascade = time.time()
        cascade_dir = phase_cascade_load(tmp)
        paths["cascade_train"] = phase_cascade_train(tmp, cascade_dir, profile=False)
        shutil.rmtree(cascade_dir)
        paths.update(phase_cascade_routes(tmp))
        emit(dict(phase="cascade_phases", seconds=time.time() - t_cascade + cascade_seconds,
                  kernel_and_parity_seconds=cascade_seconds))

    # the paths that run each kernel: every one launched it, and SD2.1 (head
    # dim 64 everywhere) launched no K4a/K4b/K4c in training and K4a only in
    # its decodes when serving
    inference = ("serve_sliders", "sd_serve", "sd2_serve", "sweep_xl", "sweep_sd1", "export", "notrigger_sweep",
                 "serve_int8_quantize_base", "serve_int8_w8a8", "quantize_checkpoint", "baseline_uce",
                 "baseline_ti_sd1", "baseline_ti_xl", "baseline_cd_xl", "acceptance", "demo_turbo", "parity_dump")
    # null-text inversion editing: SD1.5 in fp32, forward and backward (the embedding's gradient)
    edit = ("edit",)
    xl_train = ("train", "train_overlay_warmup", "train_merged", "imageslider", "knob_samples2",
                "knob_fuse_teacher_student", "knob_pipeline_warmup", "knob_share_warmup", "knob_dynamic_res_crops",
                "knob_lion", "knob_prodigy_restarts", "knob_1024_remat", "profile_dir", "int8_bf16_reference",
                "int8_quantize_base", "int8_w8a8_dual", "int8_both", "demo_concept")
    sd15_train = ("sd_train", "sd_dora_train", "sd_imageslider", "sd_imageslider_merged", "sd_knob_lion_step",
                  "sd_knob_sgd_linear_clip", "sd_knob_dadaptadam_samples2", "sd_int8_bf16_reference",
                  "sd_int8_quantize_base")
    # SD3: the MMDiT's joint attention is K1 (K2/K3 in training); its decodes K4a
    sd3_train = ("sd3_train", "sd3_int8_train")
    sd3_decode = ("sd3_serve", "sd3_sweep", "sd3_int8_serve")
    sd3_inference = sd3_decode + ("sd3_quantize_checkpoint",)
    # Flux: every attention is K1 (K2/K3 in training); only flux_load decodes (K4a)
    flux_train = ("flux_train", "flux_int8_train")
    flux_inference = ("flux_serve", "flux_sweep", "flux_load", "flux_int8_serve", "flux_quantize_checkpoint")
    # Stable Cascade: every attention of the prior is K1 (d 64), K2/K3 in training; no decode
    cascade_train = ("cascade_train", "cascade_wuerstchen", "cascade_dora", "cascade_w8a8", "cascade_overlay",
                     "cascade_samples2_share")
    runs_on = {
        "K1": ("serve",) + xl_train + sd15_train + ("sd2_train",) + inference + sd3_train + sd3_inference
              + flux_train + flux_inference + cascade_train + edit,
        "K2": xl_train + sd15_train + ("sd2_train",) + sd3_train + flux_train + cascade_train + edit,
        "K3": xl_train + sd15_train + ("sd2_train",) + sd3_train + flux_train + cascade_train + edit,
        "K4a": ("serve", "imageslider", "demo_concept") + sd15_train + inference + sd3_decode + ("flux_load",) + edit,
        "K4b": sd15_train + edit,
        "K4c": sd15_train + edit,
    }
    for i, name in enumerate(KERNEL_NAMES):
        if min(paths[p][i] for p in runs_on[name]) <= 0:
            raise AssertionError(f"{name} was not launched on every path that runs it: {paths}")
    if any(paths["sd2_train"][3:]):
        raise AssertionError(f"SD2.1 training launched K4a/K4b/K4c: {paths['sd2_train']}")
    if any(paths[p][4] or paths[p][5] or paths[p][3] for p in sd3_train + ("sd3_quantize_checkpoint",)):
        raise AssertionError(f"an SD3 path launched a k-grid kernel in the MMDiT: {paths}")
    if any(paths[p][3] or paths[p][4] or paths[p][5] for p in flux_train + flux_inference if p != "flux_load"):
        raise AssertionError(f"a Flux path launched a k-grid kernel in the transformer: {paths}")
    if any(paths[p][3] or paths[p][4] or paths[p][5] for p in cascade_train):
        raise AssertionError(f"a Stable Cascade path launched a k-grid kernel: {paths}")
    if any(paths[p][1] or paths[p][2] or paths[p][4] or paths[p][5]
           for p in inference + ("serve",) + sd3_inference + flux_inference):
        raise AssertionError(f"an inference path launched a backward kernel: {paths}")
    main_row = k1_rows[0]  # 4096x4096 self-attention: the largest share of K1's serving time
    bwd_main = bwd_rows[0]  # 1024x1024 self-attention, bf16: the largest share of K2/K3's time
    kgrid_main = kgrid_rows[0]  # the 1024px decode of one image: K4a's serving call
    kb_main = kgrid_bwd_rows[0]  # 256x256 self-attention, 8 heads, d 192, bf16: the ESD student's largest
    at_bwd = f"{bwd_main['shape']} rows=1 heads={bwd_main['heads']} d={bwd_main['head_dim']} bf16"
    at_kb = (f"{kb_main['shape']} rows={kb_main['rows']} heads={kb_main['heads']} "
             f"d={kb_main['head_dim']}→{kb_main['padded_head_dim']} bf16")

    def launches(name: str) -> dict:
        """The kernel's launches on the paths that run it, and their sum."""
        i = KERNEL_NAMES.index(name)
        every = {p: paths[p][i] for p in runs_on[name]}
        return dict(launches=sum(every.values()), launches_by_path=every)

    rows = [
        dict(
            name="flash_attention_fwd",
            route="cuda",
            source="sliders_conceptmod_tpu_torch/csrc/flash_attention_fwd.cu",
            replaces="sliders_conceptmod_tpu/ops/flash_attention.py:62",
            **launches("K1"),
            max_abs_err=max([r["max_abs_err"] for r in k1_rows + k1_train_rows + sd3_k1_rows + flux_k1_rows
                             + cascade_k1_rows] + k1_sd_errors + [flux_k1_err]),
            ms=main_row["kernel_ms"],
            device_ms=main_row["device_ms"],
            plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"],
            bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"],
            library_device_ms=main_row["library_device_ms"],
            host_us_per_call=next(r["host_us_per_call"] for r in k1_rows if "host_us_per_call" in r),
            tflops=main_row["tflops"],
            share_of_bound=main_row["share_of_bound"],
            over_library=main_row["over_library"],
            at=f"{main_row['shape']} rows={main_row['rows']} heads={main_row['heads']} d={main_row['head_dim']} bf16",
            sd3=[{k: r[k] for k in ("shape", "rows", "kernel_ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                                    "library_device_ms", "tflops", "share_of_bound", "over_library", "max_abs_err")}
                 for r in sd3_k1_rows],
            flux=[{k: r[k] for k in ("shape", "rows", "kernel_ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                                     "library_device_ms", "tflops", "share_of_bound", "over_library", "max_abs_err")}
                  for r in flux_k1_rows],
            cascade=[{k: r[k] for k in ("shape", "rows", "sq", "sk", "kernel_ms", "device_ms", "plain_ms", "bound_ms",
                                        "library_ms", "library_device_ms", "tflops", "share_of_bound", "over_library",
                                        "max_abs_err")}
                     for r in cascade_k1_rows],
        ),
        dict(
            name="flash_attention_bwd_dq",
            route="cuda",
            source="sliders_conceptmod_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="sliders_conceptmod_tpu/ops/flash_attention.py:107",
            **launches("K2"),
            max_abs_err=max([r["max_abs_err"]["dq"] for r in bwd_rows + sd3_bwd_rows + flux_bwd_rows + cascade_bwd_rows]
                            + [flux_k2_err]),
            ms=bwd_main["k2_ms"],
            device_ms=bwd_main["k2_device_ms"],
            plain_ms=bwd_main["k2_plain_ms"],
            bound_ms=bwd_main["k2_bound_ms"],
            bound_by=bwd_main["k2_bound_by"],
            library_ms=bwd_main["library_ms"],
            library="SDPA backward (dQ, dK, dV together)",
            host_us_per_call=bwd_main["k2_host_us_per_call"],
            splits=bwd_main["k2_splits"],
            tflops=bwd_main["k2_tflops"],
            share_of_bound=bwd_main["k2_share_of_bound"],
            over_library=bwd_main["k2_over_library"],
            at=at_bwd,
            sd3=[{k: r[k] for k in ("shape", "rows", "k2_splits", "k2_ms", "k2_device_ms", "k2_plain_ms", "k2_bound_ms",
                                    "library_ms", "k2_tflops", "k2_share_of_bound", "k2_over_library")}
                 for r in sd3_bwd_rows],
            flux=[{k: r[k] for k in ("shape", "rows", "k2_splits", "k2_ms", "k2_device_ms", "k2_plain_ms",
                                     "k2_bound_ms", "library_ms", "k2_tflops", "k2_share_of_bound", "k2_over_library")}
                  for r in flux_bwd_rows],
            cascade=[{k: r[k] for k in ("shape", "rows", "sq", "sk", "k2_splits", "k2_ms", "k2_device_ms",
                                        "k2_plain_ms", "k2_bound_ms", "library_ms", "k2_tflops",
                                        "k2_share_of_bound", "k2_over_library", "max_abs_err")}
                     for r in cascade_bwd_rows],
        ),
        dict(
            name="flash_attention_bwd_dkv",
            route="cuda",
            source="sliders_conceptmod_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces="sliders_conceptmod_tpu/ops/flash_attention.py:139",
            **launches("K3"),
            max_abs_err=max([max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"])
                             for r in bwd_rows + sd3_bwd_rows + flux_bwd_rows + cascade_bwd_rows] + [flux_k3_err]),
            ms=bwd_main["k3_ms"],
            device_ms=bwd_main["k3_device_ms"],
            plain_ms=bwd_main["k3_plain_ms"],
            bound_ms=bwd_main["k3_bound_ms"],
            bound_by=bwd_main["k3_bound_by"],
            library_ms=bwd_main["library_ms"],
            library="SDPA backward (dQ, dK, dV together)",
            splits=bwd_main["k3_splits"],
            tflops=bwd_main["k3_tflops"],
            share_of_bound=bwd_main["k3_share_of_bound"],
            over_library=bwd_main["k3_over_library"],
            at=at_bwd,
            sd3=[{k: r[k] for k in ("shape", "rows", "k3_splits", "k3_ms", "k3_device_ms", "k3_plain_ms", "k3_bound_ms",
                                    "library_ms", "k3_tflops", "k3_share_of_bound", "k3_over_library")}
                 for r in sd3_bwd_rows],
            flux=[{k: r[k] for k in ("shape", "rows", "k3_splits", "k3_ms", "k3_device_ms", "k3_plain_ms",
                                     "k3_bound_ms", "library_ms", "k3_tflops", "k3_share_of_bound", "k3_over_library")}
                  for r in flux_bwd_rows],
            cascade=[{k: r[k] for k in ("shape", "rows", "sq", "sk", "k3_splits", "k3_ms", "k3_device_ms",
                                        "k3_plain_ms", "k3_bound_ms", "library_ms", "k3_tflops",
                                        "k3_share_of_bound", "k3_over_library", "max_abs_err")}
                     for r in cascade_bwd_rows],
        ),
        dict(
            name="flash_attention_kgrid_fwd",
            route="cuda",
            source="sliders_conceptmod_tpu_torch/csrc/flash_attention_kgrid.cu",
            replaces="sliders_conceptmod_tpu/ops/flash_attention_kgrid.py:77",
            **launches("K4a"),
            max_abs_err=max(kgrid_errors + k4a_sd_errors),
            ms=kgrid_main["kernel_ms"],
            device_ms=kgrid_main["device_ms"],
            plain_ms=kgrid_main["plain_ms"],
            bound_ms=kgrid_main["bound_ms"],
            bound_by=kgrid_main["bound_by"],
            library_ms=kgrid_main["library_ms"],
            library_device_ms=kgrid_main["library_device_ms"],
            host_us_per_call=kgrid_main["host_us_per_call"],
            splits=kgrid_main["splits"],
            tflops=kgrid_main["tflops"],
            share_of_bound=kgrid_main["share_of_bound"],
            over_library=kgrid_main["over_library"],
            at=f"{kgrid_main['shape']} rows={kgrid_main['rows']} heads=1 d={kgrid_main['head_dim']} bf16",
        ),
        dict(
            name="flash_attention_kgrid_bwd_dq",
            route="cuda",
            source="sliders_conceptmod_tpu_torch/csrc/flash_attention_kgrid_bwd.cu",
            replaces="sliders_conceptmod_tpu/ops/flash_attention_kgrid.py:122",
            **launches("K4b"),
            max_abs_err=max(k4b_errors),
            ms=kb_main["k4b_ms"],
            device_ms=kb_main["k4b_device_ms"],
            plain_ms=kb_main["k4b_plain_ms"],
            bound_ms=kb_main["k4b_bound_ms"],
            bound_by=kb_main["k4b_bound_by"],
            library_ms=kb_main["library_ms"],
            library="SDPA backward (dQ, dK, dV together)",
            host_us_per_call=kb_main["k4b_host_us_per_call"],
            splits=kb_main["k4b_splits"],
            tflops=kb_main["k4b_tflops"],
            share_of_bound=kb_main["k4b_share_of_bound"],
            over_library=kb_main["k4b_over_library"],
            at=at_kb,
        ),
        dict(
            name="flash_attention_kgrid_bwd_dkv",
            route="cuda",
            source="sliders_conceptmod_tpu_torch/csrc/flash_attention_kgrid_bwd.cu",
            replaces="sliders_conceptmod_tpu/ops/flash_attention_kgrid.py:154",
            **launches("K4c"),
            max_abs_err=max(k4c_errors),
            ms=kb_main["k4c_ms"],
            device_ms=kb_main["k4c_device_ms"],
            plain_ms=kb_main["k4c_plain_ms"],
            bound_ms=kb_main["k4c_bound_ms"],
            bound_by=kb_main["k4c_bound_by"],
            library_ms=kb_main["library_ms"],
            library="SDPA backward (dQ, dK, dV together)",
            host_us_per_call=kb_main["k4c_host_us_per_call"],
            splits=kb_main["dkv_splits"],
            tflops=kb_main["k4c_tflops"],
            share_of_bound=kb_main["k4c_share_of_bound"],
            over_library=kb_main["k4c_over_library"],
            at=at_kb,
        ),
    ]
    emit({"kernels": rows})
    emit(dict(phase="smoke", seconds=time.time() - t0))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
