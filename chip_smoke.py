#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``aether_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its result; any failure raises and exits non-zero):
  1. the device and its name / power limit from nvidia-smi;
  2. builds the Hopper kernels from ``aether_tpu_torch/csrc`` (nvcc), logs
     each kernel's registers and spills, and K1's launch plan: cluster size,
     shared memory a CTA and ``cudaOccupancyMaxActiveClusters``;
  3. K1 (``qkv_prologue``, one HBM pass over thread-block clusters) against
     ``qkv_prologue_plain`` at the main-path shape: B=1, 15076 tokens padded
     to 15360, 48 heads, head_dim 64, bf16; int8 codes within 1 on at most
     1e-4 of them, v bit-exact, the stats within rtol 1e-5; timed, under
     0.5 ms (the two-pass form read 0.77);
  4. K2 (``flash_attention_prepacked``, the fixed-shift ``wgmma`` + TMA
     cell of ``csrc/fixed_cell.cuh``) against its plain version on K1's
     outputs, two launches bit-identical; then K1 at the CFG pair's batch 2
     against its plain version at phase 3's gates, timed, and K2 on its
     outputs, (96, 15360, 64), against its plain version at the same gates
     (max abs 1e-2, mean 1e-3), two launches bit-identical, timed beside one
     bf16 SDPA call at (2, 48, 15076, 64);
  5. builds ``AetherPipeline`` on the AetherV1 config with seeded random bf16
     weights on the GPU and a seeded (1, 226, 4096) prompt embedding;
  6. runs two 41-frame 480x720 reconstruction requests (4 steps, same input
     and seed) and checks shapes, finiteness, the RGB range, 168 launches of
     each kernel per request, and bit-identical outputs;
  7. K4 (``flash_attention``, online softmax) against
     ``flash_attention_plain`` at the training shape, B=1, 48 heads, 15076
     tokens, head_dim 64, in f32 (the 3xTF32 cell, max abs 1e-4) and in
     bf16 (the wgmma kernel, at ``bf16_gates``), with times and TFLOP/s, and
     each kernel alone on prepared operands beside its wrapper call;
  8. ``flash_attention_trainable`` (K4 forward, blockwise backward): value
     and gradients against autograd through ``attention_reference``;
  9. the fine-tuning path: a ``Trainer`` on the AetherV1 width at 16 blocks
     (f32 state does not fit 42 on one card), remat, ``flash_train``
     attention, two steps (``TRAIN_STEPS``, a cut) on the batches
     ``latent_batches`` yields at its
     defaults (native prefetch) over phase 21's precomputed 41x480x720
     files; checks finite loss and gradient norm, 2 x 16 K4 launches a
     step, the batch shapes, moved parameters, an EMA apart from them and
     the peak memory, and logs the seconds each step waited for its batch;
 10. K3 (``flash_attention_fixed_max``, K2's cell) against its plain version
     at the CFG pair's shape, B=2, 48 heads, 15076 tokens, head_dim 64, bf16,
     with int8 and with bf16 QK^T, two launches bit-identical, and the
     kernel alone on the operands its wrapper prepares (its output equal to
     the wrapper's); K3 unnormalized with a score bound on a
     sequence-parallel stripe (Sq < Skv, ``kv_valid``); K6
     (``flash_attention_pv8``, the wgmma kernel) against its plain version at
     the CFG shape, and K6 alone on prepared operands;
 11. one prediction request on the phase-5 pipeline (built again from its
     seeds) at ``AETHER_ATTN_FUSED=0``: the task defaults (guidance 3,
     dynamic CFG) but 2 of the default 50 steps (``FUSED0_STEPS``, a cut
     to fit the run's time), a seeded image and (41, 6, 60, 90)
     raymap; checks shapes, finiteness, the RGB range and 42 x 2 K3
     launches with no K1/K2/K6 launch;
 12. two planning requests (image, goal, raymap; same seed) at
     ``AETHER_ATTN_PV8=1``, cut to 2 steps to fit the run's time; checks
     42 x 2 K6 launches each and bit-identical outputs;
 12b. one prediction request at the default attention settings (K1 + K2 at
     the CFG pair's batch 2), cut to 2 steps (``DEFAULT_PREDICTION_STEPS``);
     checks 42 x 2
     launches of each of K1 and K2, none of K3 or K6, and K5 at its count.
Phases of the long-video slice, between 4 and 5 and after 6:
 4b. K5 (``groupnorm_moments``) against ``groupnorm_moments_plain`` at the
     480p decode stage (2, 128, 9, 256, 720), the latent stage (2, 512, 5,
     32, 90) and the untiled 480x720 encode's first stage (1, 128, 9, 480,
     720; phase 21), NCTHW bf16 (and channels-last, the layout cuDNN hands some
     decoder norms): m1 and m2 within 1e-5 of max |m2|, two launches
     bit-identical, times;
 6.  also K5's exact launch count per request (every VAE GroupNorm);
 6b. geometry on the card: a seeded smooth 41-pose trajectory through
     ``camera_pose_to_raymap`` and back through ``raymap_to_poses``, within
     1e-4;
 6c. the long-video path: a seeded 65-frame 480x720 clip through
     ``run_windowed_reconstruction`` (two windows, starts 0 and 24), serially
     and with ``batch_windows=2`` (``batch_reconstruct``), the two held
     together; ``blend_and_merge_window_results`` on the card; PLY and GLB
     export (the demo's ``save_geometry``) parsed back; exact K1/K2/K5 launch
     counts, seconds and peak memory.
Phases of the tuning-variant slice:
 13. K7 (``flash_v2``: 1024x1024 with K rows and K^T, and with every block
     masked), K8 (``flash_mh``, hper 4 and 1) and K9 (``flash_x`` in its four
     modes at 1024x1024, and padfix at 1024x256, whose 284 pad columns span
     two kv blocks) against their plain versions at (1, 48, 15076, 64) bf16,
     at the bf16 gates of ``bf16_gates`` (max abs two ulps of the output's
     scale, mean abs 2**-9 of its mean magnitude), exact launch counts, times
     through the wrapper and of the kernel alone on the operands the wrapper
     prepares, and one bf16 SDPA call in the same phase; every case at
     1024x1024 within 1.5x of phase 7's K4 bf16 wrapper call (they share its
     wgmma + TMA cell); a padfix without its correction must fall outside
     those gates; then the
     three bench entry points (``aether_tpu_torch.bench.flash_variants``,
     ``.flash_multihead``, ``.flash_bisect``) once each at that shape: every
     printed line parses, ``FAILED`` only at ``v2 2048x1024`` (a pad of 1308
     >= block_k), every maxdiff against the K4 baseline within four bf16
     ulps of the compared output's scale (and padfix 2048x512 without its
     correction outside it), and each kernel's launches equal to its
     configurations times its calls per configuration;
 14. beside phases 3 and 4, the float (``AETHER_ATTN_QK8=0``) K1 and K2 at
     the main-path shape: K1's bf16 q and k within one bf16 ulp on at most
     1e-4 of the elements, v bit-exact, the stats within 1e-5, timed, under
     0.5 ms; K2 at the
     gates of ``bf16_gates``, two launches bit-identical; after phase 6, one
     41x480x720 reconstruction
     request at ``AETHER_ATTN_QK8=0``: shapes, finite values, the RGB range,
     168 launches of each of K1 and K2, stage times and peak memory.
 14b. after phase 14's request, one 41x480x720 reconstruction request at
     ``AETHER_ATTN_FIXED_MAX=0`` (the DiT's attention through K4 bf16):
     shapes, finite values, the RGB range, exactly 168 K4 launches, no K1 or
     K2 launch, K5 at its count; stage times and peak memory.
Phases of the weight-format slice, after 6c:
 15. the w8a8 products of a block at the main path's shapes (qkv (15360 x
     3072) @ (3072 x 9216), o, w1, w2 at 15076 rows): ``int8_mm``
     (``torch._int_mm``) exact against its plain version, timed alone, as the
     whole w8a8 ``QuantLinear`` (quantize, product, epilogue), as an fp8
     weight-only ``QuantLinear`` and as a bf16 ``F.linear``, with the
     product's bound;
 16. quality at full width: one DiT forward at timestep 500 in bf16 and from
     the same weights quantized (``quantize_dit``): fp8 weight-only
     mean-abs relative error < 0.10, int8 weight-only < 0.05, int8 w8a8
     norm relative error < 0.2 (the JAX tests' bars), cosines printed;
 17. two 41x480x720 reconstruction requests with the DiT built directly
     as int8 codes (``init_quantized_dit``) and int8 activations
     (``act_quant``, ``bench.py``'s default), and two with fp8 codes
     weight-only: each pair bit-identical, 168 K1 and K2 launches, K5 at its
     count, 672 int8 products with int8 activations (none for fp8), stage
     times, peak memory and the DiT's resident bytes; the demo's
     ``--random-init aetherv1-int8`` / ``-fp8`` build the same DiT bit for
     bit;
 18. the int8 pipeline through ``save_checkpoint`` into a temporary
     directory and back through the demo's ``build_pipeline`` (``--checkpoint``): one
     request, bit-identical to the first int8 request.
Phases of the server and benchmark slice, after 6c, on the phase-5 pipeline:
 19. the web server (``aether_tpu_torch.apps.serve``): ``JobRunner`` and a
     ``ThreadingHTTPServer`` on 127.0.0.1 through ``make_handler``; a seeded
     65x480x720 reconstruction job (41-frame windows at stride 24: two) and a
     5-step prediction job (10 before phase 30; seeded image,
     ``action_raymap("forward_right")``,
     guidance at its default, the 4-step post-reconstruction), submitted
     with the params ``_fields_to_params`` returns and polled over HTTP until
     ``done``. The card's machine has no PIL or imageio, so the upload
     decoders hand ``_fields_to_params`` the seeded arrays, and
     ``viz.save_video`` writes the frames it receives as .npy (both said on a
     log line); all else runs as served. The runner gets the pipeline on a
     bare ``cuda``, the device ``--device cuda`` names. Gates: the server's
     default ``--device`` resolves to cuda:0, as does the runner's device;
     the stages in the JAX order
     (``vae_encode``, ``denoise``, ``vae_decode``; ``dispatch@`` /
     ``resolve@`` for the windows) and a ``denoise N%`` stage seen while the
     prediction runs; every stage begun on the worker thread with the
     pipeline's device current; ``GET /``, ``/api/raymaps`` (the
     ``NAMED_ACTIONS``) and ``/api/stats`` (two jobs done, the stages
     counted); every artifact downloaded over HTTP, the PLY and GLB parsed
     back with points; exact K1/K2/K5 launches a job; the served prediction's
     rgb bit-identical to a direct ``pipe(task="prediction")`` call's,
     clipped as ``save_output`` clips it; each job's wall and stage seconds;
 20. the benchmark drivers: ``video_depth.process_with_sliding_window`` at
     its defaults (41-frame windows at stride 8, 480x720 tiles, overlap
     60/90) over a seeded 49x480x960 clip (two windows x two tiles: four
     calls), serially and with ``batch_calls=2`` (two ``batch_reconstruct``
     calls): exact calls and K1/K2/K5 launches, (49, 480, 960) finite, rgb in
     [0, 1], batched against serial at the long-video phase's gates;
     ``depth_evaluation(align="scale")`` against 2.5x the prediction: Abs
     Rel <= 1e-6; LAD2's Adam loop on the card against the CPU within 1e-3
     relative; ``rel_pose.process_video_with_sliding_window`` over a seeded
     73x480x720 clip (stride 32: two windows): exact calls and launches,
     (73, 4, 4) poses with rotations orthonormal within 1e-4, finite positive
     focals, ATE <= 1e-6 against a Sim(3) copy of the trajectory; the seconds
     of each sequence and of each pipeline call.
Phase of the training-data slice, after 20, on the phase-5 pipeline:
 21. ``train.data.precompute_latents`` (the untiled full-width bf16 encode)
     of three seeded 41x480x720 clips into a temporary directory: (a) RGB,
     disparity and phase 6b's trajectory with its intrinsics, (b) RGB only,
     (c) RGB, poses and a seeded (226, 4096) ``text_embeds``. Gates: each
     file has the JAX keys, ``clean_latents`` (11, 56, 60, 90) f16 and
     finite, zero channels where a modality is absent; K5 launches exactly
     the encoder's GroupNorms x 5 chunks x 4 encodes; the same seed twice
     gives identical arrays; clip (a)'s channels 0-15 equal a direct
     ``_encode_pixels(tiling=False)`` call with the same draw and its
     channels 32-55 ``pack_raymap(camera_pose_to_raymap(...))``, both cast to
     f16, bit for bit. Logs each clip's encode and write seconds and the
     peak memory. Then ``runtime.load_npz`` equals ``np.load`` on each file,
     and ``latent_batches`` at its defaults gives the six batches (two
     epochs) of ``native_prefetch=False`` bit for bit. Phase 9 trains on
     these files.
Phase of the parallel slice, after 21, on the phase-5 pipeline
(``parallel_phase``):
 22. (a) a process group of one rank through NCCL in this process,
     ``parallel.make_mesh()``, and phase 6's request through an
     ``AetherPipeline`` built over the mesh (the phase-5 DiT and VAE), full
     width and depth: bit-identical to phase 6's request 0, 168 K1 and K2
     launches and K5 at its count; (b) two ranks spawned
     (``parallel.launch.spawn``) on cuda:0 over gloo (NCCL refuses two ranks
     on one card; gloo has all-reduce for CUDA tensors but no send/recv, so
     the ring's transport is tested on the CPU only), each holding half of
     the seeded AetherV1-width DiT cut to 2 blocks (``tp = 2``: 24 heads a
     rank), one forward of the blocks on the 15076-token window through K1 +
     K2, held against the one-process forward of the same blocks at the
     gates of ``bf16_gates``, exactly 2 K1 and 2 K2 launches a rank; rank 0
     alone then checks K1 and K2 at 24 heads against their plain versions
     (phase 3's and phase 4's gates) and times them; (c) ``ring_attention_stripes``
     (the ring's K3 steps and f32 merge, no process group) over the sp = 4
     stripes of a seeded (1, 48, 15076, 64) bf16 window padded to 4 x 3840
     rows (284 pad rows corrected exactly), int8 and bf16 QK^T, against one
     normalized K3 call over the sequence at K3's gates (max abs 1e-2, mean
     1e-3), 16 K3 launches each, both timed. Two ranks sharing one card show
     no tp speed-up, and none is claimed.
Phase of the parallel-training slice, after 9 (``parallel_train_phase``), at
the AetherV1 width cut to 2 blocks (a depth cut), seeded synthetic
41x480x720 batches (15076 tokens), remat, ``flash_train`` (K4 f32 forward):
 23. (a) a process group of one rank through NCCL, ``make_pp_mesh(1, 1)`` and
     the Trainer at ``pp_microbatches=2``, batch 2, two steps, against the
     same Trainer without a mesh in this run: losses within rtol 2e-4 / atol
     2e-5, every parameter within rtol 5e-4 / atol 5e-5 (``tests/test_fsdp.py``'s
     bars), the parameters moved, K4 f32 launches exact (a step: 2 blocks x
     the forward and remat's recompute, x 2 microbatches under pp); (b) two
     ranks spawned on cuda:0 over gloo, the Trainer at tp = 2 (24 heads a
     rank), one step at batch 1 against one process: the loss, each rank's
     piece of the fused qkv's, ``attn.o``'s and the time embedding's
     gradients within 1e-5 of their largest magnitude, 4 K4 launches a rank;
     rank 0 alone then checks K4 f32 at 24 heads against its plain version
     and times it; (c) the same two ranks, the Trainer at dp = 2 with FSDP,
     one step at batch 2 (a row a rank) against (a)'s first step without a
     mesh: the loss, the step's global gradient norm (rtol 1e-4: a dp sum in
     place of the mean reads twice it), ``blocks.0.mlp.w1.weight`` gathered
     after the step, each rank's resident parameter bytes 0.45-0.55 of the
     model's. Each run's
     seconds a step and peak memory are logged; one card shows no speed-up.
Phases of the serving slice (the wires, ``defer_host``, the server over a
mesh). Every pipeline here runs the default wires (``compact_transfer``
automatic: on for CUDA, u8 RGB and fp16 disparity) unless a phase names
others; no earlier phase holds a pipeline's output to a float reference finer
than the wire's rounding (the script says so on phase 24's first line).
 24. after 22, on the phase-5 pipeline, 41x480x720 (168/168/660 K1/K2/K5
     launches a request, counted after ``resolve``): (a) phase 6's request 0
     (compact) against ``compact_transfer=False``: RGB within 0.5/255 + 1e-6,
     disparity within 2e-3 or half an fp16 ulp of the value, raymap
     bit-identical; (b) ``wire_rgb="yuv420"`` + ``wire_disparity="u8"``
     against the f32 wires: the RGB equal bit for bit to the codec's round
     trip of the f32 RGB (packed on the card, unpacked on the host), luma
     q99 < 0.01, 2x2-block means q99 < 0.03, mean abs < 0.05 (JAX's maxima,
     0.08 and 0.1 on 17x64x96, are logged: at 480x720 with random weights
     they fall where the codec clips out-of-gamut colours); the u8
     disparity's codes within one of round(sqrt(d) * 255), or 0 where the
     pre-square value was negative (clipped, as JAX's codec does), within
     2.5/255 where d <= 1 and not clipped, and <= 1; raymap within 1e-5;
     and ``wire_input="yuv420"``: the
     codec on a smooth seeded clip (mean < 0.01, max < 0.08, gray frames
     within 2.5/255) and the request's RGB within 0.12 mean abs of the u8
     upload's; (c) a deferred call: an event recorded when it returns is
     still pending, its return and resolve seconds, the synchronizing calls
     ``set_sync_debug_mode("warn")`` names over its dispatch, its outputs
     bit-identical to phase 6's request 0; (d) the window driver over an
     undeferred pipeline on phase 6c's clip, serially and at
     ``batch_windows=2``: bit-identical to 6c's deferred runs. Prints each
     wire's bytes to the host and each call's seconds;
 25. after 24 (the phase-5 pipeline freed): the server over a mesh of two
     ranks spawned on cuda:0 over gloo (``serve_mesh_rank``), the AetherV1
     width cut to 2 blocks (depth only) with the full VAE; rank 0 serves HTTP
     through ``apps.serve.serve`` and a ``parallel.jobs.JobChannel``, the
     parent posts a job, polls ``/api/status`` and sends rank 0 SIGTERM:
     (a) dp = 2, the seeded 65-frame two-window reconstruction job (one
     ``batch_reconstruct`` chunk); (b) tp = 2, a 4-step prediction job with
     the 4-step post-reconstruction (K1 + K2 at 24 heads); (c) both jobs
     again from one process (``JobRunner``) on the same weights: exported
     rgb, disparity and poses within the long-video gates (mean abs <= 1e-2,
     max <= 0.25 of max(1, |ref|)); (d) each rank's K1/K2/K5 launches (dp:
     8/8/660, tp: 16/16/1088), both ranks exiting 0 after the stop message,
     and the two ranks' peaks under 80 GB.
Phase of the CogVideoX-1.5 slice, after 25 (``cogvideox15_phase`` and
``head_dim_phase``):
 26. (a) the CogVideoX-1.5 DiT at full width: ``DiTConfig.aetherv1()`` with
     ``patch_size_t=2`` and ``ofs_embed_dim=512``, seeded random bf16 weights,
     one forward on a seeded (1, 12, 96, 60, 90) latent with the slice RoPE
     tables of 480x720 at 12 latent frames (8100 video + 226 text tokens):
     42 K1 and 42 K2 launches at the default attention settings; ``ofs``
     None bit-identical to zeros, ``ofs=2`` moving the output by more than
     1e-3 of its mean magnitude; against the same forward through the plain
     attention route (``attn_impl="xla"``): mean-abs and norm relative error
     < 0.05 (phase 16's tightest bar); the same weights as int8 codes with
     int8 activations against bf16 at phase 16's w8a8 bar (norm relative <
     0.2), 4 x 42 int8 products; seconds and peak memory of each forward.
     (b) K1 + K2 at the head dims other than 64 (``csrc/attn_prologue.cu``'s
     cluster kernel there, counted on ``qkv_prologue_hd``, and the
     ``fixed_cell<D>`` instances of ``csrc/flash_prepacked.cu``): one
     17x64x96 reconstruction request of
     ``PipelineConfig.tiny()`` (head_dim 16) on the card at the default
     attention settings against the same request on the CPU (the same
     weights and ``TorchNoise`` draws, bf16, f32 wires), and one forward of
     the tiny DiT at head_dim 32 and at 112 against the CPU, at the
     long-video gates (mean abs <= 1e-2, max <= 0.25 of max(1, |ref|)), with
     exact launches of the head-dim kernels (8, 2, 2) and none of the
     head_dim-64 ones; then K1 and K2 at 48 heads x 15076 tokens (padded to
     15360) at head_dim 16, 32, 48, 80, 96 and 112, int8 and float, against their plain
     versions at phase 3's, 4's and 14's accuracy gates, two launches
     bit-identical, timed beside one bf16 SDPA call at the same shape and
     against the bound (K1 also replayed from a CUDA graph, its time on the
     card without the wrapper's host time).
Phase of the head-dim slice, after 13 (``head_dims_all_phase``):
 27. K3, K4 and K6 at the head dims other than 64 and K3 in f32
     (``csrc/flash_fixed_max.cu``, ``flash_pv8.cu`` and, for K4 bf16,
     ``flash_online_bf16.cu``, each templated over the head dim; the
     3xTF32 cell's ``flash_fixed_max_hd.cu`` and ``flash_online.cu``): (c)
     one tiny 17x64x96 reconstruction request
     (head_dim 16, 4 steps) on the card against the CPU at the long-video
     gates at FUSED=0 with QK8=1 and QK8=0 (K3 hd), PV8=1 (K6 hd),
     FIXED_MAX=0 (K4 bf16 hd) and at FUSED=0 in an f32 pipeline (K3 f32), 8
     launches of the setting's kernel and none of any other attention
     kernel, and the tiny DiT at head_dim 32 and 112 (K3 f32 also 64) at the
     same settings, 2 launches a forward; (d) the tiny DiT at head_dim 128 at
     the default settings (K4 bf16 "vpu", no K1/K2); (b) the trainer CLI's
     ``--synthetic --tiny --steps 2`` as a subprocess (exit 0), then the same
     two steps in this process on the card and on the CPU from one init and
     one noise stream, losses within phase 23's rtol 2e-4 / atol 2e-5, 8 K4
     f32 hd launches, and (d) one such step at head_dim 32, 112 and 128; (e)
     the sp = 4 ring over a (1, 48, 15076, 16) window against one K3 hd call
     (int8 and bf16 QK^T, 16 launches each); (a) each kernel at 48 heads x
     15076 tokens, batch 1, at head_dim 16, 32 and 112 (K3, K6 and K4 bf16
     also 48, 80 and 96, K4 also 128, K3 f32 also 64) against its plain
     version at the bars of its head_dim-64 counterpart here (K4 f32 at 128
     at max 3e-6 / mean 1e-7, the level of the other head dims since its P V
     left the tensor-core accumulator), two launches
     bit-identical, timed beside the bound and one SDPA call of the same shape
     and dtype, each kernel also alone on the operands its wrapper prepares
     (the f32 kernels' split for the 3xTF32 cell); an f32 kernel's bound
     counts its products as three TF32 products each.
Phase of the padded head dims, after 27 (``padded_dims_phase``):
 28. Every head dim below 128 (K4 up to 128) runs the kernels' instance of
     the next width up (16 to 128 in steps of 16) on operands with zero
     columns past the head dim; 128 is a new width (``fixed_cell<128>``,
     ``flash_pv8<128>``, ``tf32x3_cell<128, kFixed>``, ``attn_prologue<128>``).
     (c) the tiny DiT (4 heads, 2 blocks) at head_dim 24, 72 and 120, one
     batch-1 forward on the card against the CPU at the long-video gates, at
     the defaults (K1 + K2 hd), FUSED=0 with QK8=1 and QK8=0 (K3 hd),
     PV8=1 (K6 hd), FIXED_MAX=0 (K4 bf16 hd), and in f32 at FUSED=0 (K3
     f32) and FIXED_MAX=0 (K4 f32 hd), 2 launches a forward and none of any
     other attention kernel; its RoPE tables are cut to the head dim (the
     table builder gives head_dim + 2 columns there, which the unfused route
     cannot take, in JAX as here; K1 reads the first head_dim columns); the
     sp = 4 ring over a (1, 48, 15076, 24) window against one K3 hd call; (b)
     at (1, 48, 2048, D) K1 + K2 at D 8 and 24 and K3 (int8 and bf16
     QK^T), K4 (bf16 and f32) and K6 through ``flash_attention`` at D 8, 17,
     24 and 127 against their plain versions; (a) at 48 heads x 15076
     tokens and D 72 and 120, K1 and K2 (int8 and float), K3 (int8, bf16,
     f32, f32 with int8 QK^T), K4 (bf16, f32) and K6 against their plain
     versions (bf16 outputs at ``bf16_gates``, f32 at 1e-4; (b) the same),
     two launches bit-identical, timed beside
     one SDPA call of the same dtype and shape and the bound at the true head
     dim, each instance's registers and spill from the build's ptxas report.
Phase of K4 above head_dim 128, after 28 (``wide_dims_phase``):
 29. K4 runs every head dim 129-256 on the instances 160, 192, 224 and 256
     (a head dim between them on the next one's, zero-padded): bf16 on
     ``online_cell<D>`` with 64-row kv tiles, f32 on
     ``csrc/flash_online_wide.cu`` (a pair of CTAs a 128-row q tile, the head
     dim split in 32-column units, 32-row kv tiles through K and V rings of
     2 slots each; 29a logs the plan beside the registers). (d) K4 bf16 and
     f32 at (1, 48, 15076, D), D 64, 72, 160 and 256, on seeded inputs: the
     outputs' digests equal their pins (commit dbe6a4d's; f32 at 160 and 256
     the CTA pair's): the instances keep their bits; (c) the tiny
     trainer's two steps at head_dim 160 and 256 on the card against the CPU
     (losses within phase 23's rtol 2e-4 / atol 2e-5, exactly 8 K4 f32 hd
     launches each, finite loss and gradient norm, the parameters moved),
     and the tiny DiT at 144, 192 and 224 in bf16 and f32 at the defaults
     against the CPU at the long-video gates, 2 launches of the dtype's K4
     hd counter and no other attention kernel's; (b) one 41x480x720
     reconstruction request (4 steps) on the AetherV1 width regrouped as 12
     heads x 256: exactly 168 K4 bf16 hd launches, no K1, K2, K3 or K6
     launch, K5 at its count, finite outputs of the request's shapes, RGB in
     [0, 1], its seconds, stage times and peak memory; (a) K4 bf16 and f32
     at 48 heads x 15076 tokens and D 144, 160, 192, 200, 224 and 256
     against their plain versions (bf16 at ``bf16_gates``, f32 at max 3e-6 /
     mean 1e-7), two launches bit-identical, timed through the wrapper and
     alone (all but 200, whose timing was cut to fit phase 30), beside the
     bound at the true D, the plain version's one call and one SDPA call of
     the same shape and dtype (its flash or memory-efficient backend; "none"
     where neither takes it), with each instance's registers and spill.
Phase of K4 above head_dim 256, after 29 (``above_dims_phase``):
 30. K4 runs every head dim above 256 on one kernel a dtype that reads the
     width (the head dim rounded up to a multiple of 64, zero-padded) at run
     time: ``csrc/flash_online_wide_bf16.cu`` and ``flash_online_wide.cu``
     (a thread-block cluster a q tile splits the head dim in slices of at
     most 256 columns in bf16 and 128 in f32, sums S once through
     distributed shared memory, and each CTA stores its slice's output
     columns; 30a logs the cluster size beside the registers). (c) the tiny
     trainer's
     two steps at head_dim 320 and 512 on the card against the CPU (phase
     29c's gates, exactly 8 K4 f32 hd launches each), and the tiny DiT at
     288 and 384 in bf16 and f32 against the CPU at the long-video gates, 2
     launches of the dtype's K4 hd counter; (b) one 41x480x720
     reconstruction request (4 steps) on the AetherV1 width regrouped as 6
     heads x 512: exactly 168 K4 bf16 hd launches and no other attention
     kernel's, K5 at its count, ``check_request``'s gates, its seconds and
     peak memory; (d) K4 bf16 and f32 at (1, 4, 2048, 1024) against their
     plain versions (bf16 at ``bf16_gates``, f32 at max 3e-6 / mean 1e-7);
     (a) K4 bf16 and f32 at 48 heads x 15076 tokens and D 272, 320 and 512
     against their plain versions at phase 29a's gates, two launches
     bit-identical, and at 320 and 512 timed through the wrapper and alone
     beside the bound at the true D, the plain version's one call and one
     SDPA call (or "none"), with each kernel's registers and spill. (e), the
     digests of the instances up to 256 against the parent's, is phase
     29d.
At the end, beside the bounds: K2 (int8, float, batch 2) and K3 alone (int8
and bf16 QK^T) each within 1.25x of the SDPA call at its shape, and K6 within
1.5x of K3 with int8 QK^T.
The line before the last is a JSON object with each kernel's launches on its
path, error against its plain version, times, the bound (the least time the
card could take: the largest of bytes over 3.35 TB/s, operations over the
peak of their type, and for attention one exp2 a score over the SFU's 16 a
clock an SM at the card's maximum SM clock) and the time of one PyTorch call
computing the same function where there is one; the last line is the JSON
status line. There is no CPU path: without CUDA the script raises.
"""

import contextlib
import dataclasses
import gc
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEQ, TEXT, HEADS, HEAD_DIM = 15076, 226, 48, 64
FRAMES, HEIGHT, WIDTH, STEPS = 41, 480, 720, 4
# the fine-tuning steps (phase 9): 3 cut to 2 to fit phase 29 in the run's
# time (PERF.md §7's first cut)
TRAIN_LAYERS, TRAIN_STEPS = 16, 2
PREDICTION_STEPS = 50  # the task default
# the served prediction job of phase 19 (and the direct call it is held to):
# 10 steps cut to 5 to fit phase 30 in the run's time (PERF.md §7)
SERVED_PREDICTION_STEPS = 5
# the prediction at the default attention settings (phase 12b), the two
# planning requests at AETHER_ATTN_PV8=1 (phase 12) and the prediction at
# AETHER_ATTN_FUSED=0 (phase 11): depth cuts of the task default to keep the
# run inside its time limit (10 before phase 29, 5 before phase 30, 2 since;
# PERF.md §7). Two steps still take the solver's second-order update.
DEFAULT_PREDICTION_STEPS = PLANNING_PAIR_STEPS = FUSED0_STEPS = 2
LONG_FRAMES, STRIDE = 65, 24  # two 41-frame windows, starts 0 and 24
# H100 SXM at 700 W (NVIDIA's data sheet): memory rate, dense peaks by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}
# exp2 results a clock on one SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0); main() multiplies by the
# SM count and the maximum SM clock
SFU_PER_CLOCK_PER_SM = 16
SFU_PER_S = None
# 480p decode stage, latent stage, the untiled 480x720 encode's first stage
K5_SHAPES = ((2, 128, 9, 256, 720), (2, 512, 5, 32, 90), (1, 128, 9, 480, 720))
K1_MS_GATE = 0.5  # K1 at batch 1, int8 and float; the two-pass form read 0.77 ms
TP_BLOCKS, TP_RANKS, SP_STRIPES = 2, 2, 4  # phase 22 (b) and (c)
PAR_TRAIN_BLOCKS, PAR_TRAIN_STEPS = 2, 2  # phase 23: a depth cut; (a)'s steps


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_kernel_name(mangled: str) -> str:
    """``<file>.cu <namespace>::<function><template arguments>`` from a mangled
    kernel name: ..._<n>_<file>_cu_<hash> (the source's anonymous namespace),
    then length-prefixed names, then the mangled template arguments."""
    m = re.search(r"_\d+_(\w+?)_cu_[0-9a-f]{8}", mangled)
    if not m:
        return mangled[:72]
    rest, names = mangled[m.end():], []
    while (n := re.match(r"\d+", rest)):
        names.append(rest[n.end():n.end() + int(n.group())])
        rest = rest[n.end() + int(n.group()):]
    args = rest.split("EEv")[0] + "E" if rest.startswith("I") else ""
    return f"{m.group(1)}.cu {'::'.join(names)}{args}"


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def compare(name, out, ref, max_bar, mean_bar):
    """Max and mean abs error of a kernel's output against its plain version."""
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"{name}: {out.shape} {out.dtype} vs {ref.shape} {ref.dtype}")
    check(bool(torch.isfinite(out).all()), f"{name} output not finite")
    err = (out.float() - ref.float()).abs()
    err_max, err_mean = err.max().item(), err.mean().item()
    log(f"{name}: max abs err {err_max:.3e}, mean abs err {err_mean:.3e} "
        f"(gates {max_bar:g} / {mean_bar:g})")
    check(err_max <= max_bar and err_mean <= mean_bar,
          f"{name} disagrees with its plain version")
    return err_max


def k1_int8_gates(name, got, ref):
    """Phase 3's gates on K1's int8 outputs against its plain version: codes
    within 1 on at most 1e-4 of them and inside [-127, 127], v bit-exact with
    its pad rows zero, the stats within rtol 1e-5. Returns the largest code
    difference."""
    check(got[7] == ref[7], f"{name} s_pad {got[7]} / {ref[7]}")
    worst = 0
    for part, a, b in (("q8", got[0], ref[0]), ("k8", got[1], ref[1])):
        check(a.dtype == torch.int8 and a.shape == b.shape, f"{name} {part} {a.dtype} {a.shape}")
        diff = (a.int() - b.int()).abs()
        frac = (diff > 0).float().mean().item()
        worst = max(worst, int(diff.max().item()))
        log(f"{name} {part}: max code diff {int(diff.max().item())}, "
            f"differing fraction {frac:.3e}, codes in [{a.min().item()}, {a.max().item()}]")
        check(diff.max().item() <= 1 and frac <= 1e-4, f"{name} {part} codes disagree")
        check(a.min().item() >= -127, f"{name} {part} has a code -128")
    check(torch.equal(got[2], ref[2]), f"{name} v is not bit-exact")
    check(bool((got[2].view(-1, got[7], got[2].shape[-1])[:, SEQ:] == 0).all()),
          f"{name} v pad rows not zero")
    for part, a, b in zip(("qsc", "qn", "ksc", "kn"), got[3:7], ref[3:7]):
        rel = ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
        log(f"{name} {part}: shape {tuple(a.shape)} max rel err {rel:.3e}")
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    return worst


def bf16_gates(ref):
    """(max, mean) abs-error gates for a bf16 result against ``ref``: two
    bf16 ulps of its scale, 2 * 2**(floor(log2 max|ref|) - 7), and 2**-9 of
    its mean magnitude (a quarter of bf16's relative step of 2**-7)."""
    ref = ref.float().abs()
    top = ref.max().clamp_min(torch.finfo(torch.float32).tiny).item()
    return 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7), ref.mean().item() * 2.0 ** -9


def relative_errors(out, ref):
    """(mean-abs relative, norm relative, cosine) of ``out`` against ``ref``."""
    out, ref = out.float(), ref.float()
    return (((out - ref).abs().mean() / ref.abs().mean()).item(),
            ((out - ref).norm() / ref.norm()).item(),
            (torch.sum(out * ref) / (out.norm() * ref.norm())).item())


def padfix_uncorrected(q, k, v, seq_pad):
    """What ``flash_x(mode="padfix")`` gives without its correction: attention
    over k and v zero-padded to ``seq_pad`` rows, unmasked, so that the pad
    keys score 0 and add their mass to the denominator."""
    pad = (0, 0, 0, seq_pad - q.shape[2])
    return torch.nn.functional.scaled_dot_product_attention(
        q, torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad))


def bound(nbytes, ops, exp2=0.0):
    """(ms, what bounds it): the largest of ``nbytes`` over the memory rate,
    the operations ``ops`` ({type: count}) over their peaks, and ``exp2``
    evaluations over the SFU's rate (``SFU_PER_S``)."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()),
             "sfu": exp2 / SFU_PER_S}
    by = max(terms, key=terms.get)
    return (1e3 * terms[by], by)


def attention_exp2(b):
    """exp2 evaluations of one attention call over b x 48 heads x 15076
    tokens: one a score."""
    return float(b) * HEADS * SEQ * SEQ


def attention_ops(b, s, kinds, hd=HEAD_DIM):
    """{type: ops} of attention over b x 48 heads x s valid tokens x hd:
    QK^T and PV (``kinds``, one each), 2 * s^2 * hd multiply-adds each a
    head. The kind "tf32x3" is an f32 product as the f32 kernels make it
    (csrc/tf32x3_cell.cuh): three TF32 products."""
    per = 2.0 * b * HEADS * s * s * hd
    ops = {}
    for kind in kinds:
        n, kind = (3, "tf32") if kind == "tf32x3" else (1, kind)
        ops[kind] = ops.get(kind, 0.0) + n * per
    return ops


def sdpa_ms(dev, gen, b, dtype, hd=HEAD_DIM):
    """Time of one ``F.scaled_dot_product_attention`` over (b, 48, 15076, hd)
    in ``dtype`` (the library yardstick; the port never calls it). The math
    backend, which would hold the 48 x 15076^2 score matrix, is excluded."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (torch.randn((b, HEADS, SEQ, hd), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 5)
    del q, k, v
    torch.cuda.empty_cache()
    return ms


def sdpa_errors(q, k, v, ref):
    """(max, mean) abs error of one f32 ``scaled_dot_product_attention`` call
    (the library yardstick, sdpa_ms's backends: in f32 the memory-efficient
    kernel, itself 3xTF32) against the plain f32 attention ``ref``: the
    accuracy an f32 kernel of the port is read beside."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        err = (torch.nn.functional.scaled_dot_product_attention(q, k, v) - ref).abs()
    return err.max().item(), err.mean().item()


def time_pair(name, kernel, plain, flops):
    ms, plain_ms = cuda_time_ms(kernel, 5), cuda_time_ms(plain, 2)
    log(f"{name} time: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
        f"plain {plain_ms:.4f} ms ({flops / plain_ms / 1e9:.1f} TFLOP/s)")
    return ms, plain_ms


def k4_phase(dev, gen, dtype):
    """K4 against its plain version at B=1, 48 heads, 15076 tokens, head_dim
    64. Gates: f32 max abs 1e-4; bf16 ``bf16_gates``. Returns (max abs
    error, kernel ms, plain ms, kernel-alone ms): the kernel is also timed
    alone on the operands its wrapper prepares (f32: split for the 3xTF32
    cell), so the wrapper's own passes show apart."""
    from aether_tpu_torch.ops.flash_attention import (
        _online_bf16_launch,
        _online_f32_launch,
        _online_fold,
        _online_kv,
        _online_operands,
        _tf32_operands,
        flash_attention,
        flash_attention_plain,
    )

    name = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    shape = (1, HEADS, SEQ, HEAD_DIM)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))

    def kernel():
        return flash_attention(q, k, v)

    def plain():
        return flash_attention_plain(q, k, v)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(out.shape == shape, f"K4 {name} {out.shape}")
    bars = (1e-4, 1e-4) if dtype == torch.float32 else bf16_gates(ref)
    err = compare(f"K4 {name}", out, ref, *bars)
    if dtype == torch.float32:
        log("K4 f32: SDPA f32 against the same plain version: max abs err %.3e, mean %.3e"
            % sdpa_errors(q, k, v, ref))
    again = kernel()
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"K4 {name}: two launches differ")
    flops = 4.0 * HEADS * SEQ * SEQ * HEAD_DIM
    ms, plain_ms = time_pair(f"K4 {name}", kernel, plain, flops)
    if dtype == torch.bfloat16:
        kh, vh, kv_len = _online_kv(k, v, None)
        qh, kh, vh = (t.reshape(HEADS, SEQ, HEAD_DIM).contiguous() for t in (q, kh, vh))
        buf = torch.empty_like(qh)
        alone_ms = cuda_time_ms(lambda: _online_bf16_launch(
            qh, kh, vh, buf, kv_len, True, _online_fold(None, HEAD_DIM)), 5)
    else:
        qf, kf, vf, kv_len = _online_operands(q, k, v, None, None)
        split = _tf32_operands(*(t.reshape(HEADS, SEQ, HEAD_DIM) for t in (qf, kf, vf)))
        buf = torch.empty((HEADS, SEQ, HEAD_DIM), device=dev)
        alone_ms = cuda_time_ms(lambda: _online_f32_launch(split, buf, kv_len), 5)
        del split, qf, kf, vf
    torch.cuda.synchronize()
    check(torch.equal(buf.reshape(shape), out), f"K4 {name} alone differs from its wrapper")
    log(f"K4 {name} kernel alone: {alone_ms:.4f} ms ({flops / alone_ms / 1e9:.1f} TFLOP/s); "
        f"the wrapper's passes {ms - alone_ms:.4f} ms")
    return err, ms, plain_ms, alone_ms


def trainable_phase(dev, gen):
    """K4 forward + blockwise backward against autograd through the plain
    attention at 4 heads x 2048 tokens, f32: value within 1e-4, gradients
    within 1e-4 of their largest magnitude."""
    from aether_tpu_torch.ops.chunked_attention import flash_attention_trainable
    from aether_tpu_torch.ops.flash_attention import attention_reference

    shape = (1, 4, 2048, HEAD_DIM)
    q, k, v, w = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
    results = []
    for fn in (flash_attention_trainable, attention_reference):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        (out * w).sum().backward()
        results.append((out.detach(), [t.grad for t in leaves]))
    torch.cuda.synchronize()
    (out, grads), (ref, ref_grads) = results
    err = (out - ref).abs().max().item()
    rel = [((g - r).abs().max() / r.abs().max()).item() for g, r in zip(grads, ref_grads)]
    log(f"flash_attention_trainable: value max abs err {err:.3e}; dq/dk/dv max err "
        f"/ max |grad| {rel[0]:.3e} / {rel[1]:.3e} / {rel[2]:.3e}")
    check(err <= 1e-4 and max(rel) <= 1e-4,
          "flash_attention_trainable disagrees with plain autograd")


def train_phase(dev, latent_dir) -> int:
    """``TRAIN_STEPS`` steps of the AetherV1-width DiT at 16 blocks on the
    batches that ``latent_batches`` yields at its defaults (native prefetch,
    batch 1) over the precompute phase's 41x480x720 files. Returns K4's
    launches in the run."""
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.ops.flash_attention import flash_attention
    from aether_tpu_torch.train.data import latent_batches
    from aether_tpu_torch.train.trainer import TrainConfig, Trainer

    dit_cfg = dataclasses.replace(DiTConfig.aetherv1(), num_layers=TRAIN_LAYERS)
    # warmup 1: the first update has lr 0 (optax's schedule), the next ones 1e-5
    tcfg = TrainConfig(learning_rate=1e-5, warmup_steps=1, total_steps=100,
                       remat=True, attn_impl="flash_train", log_every=1)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer = Trainer(dit_cfg, tcfg, device=dev, seed=0)
    model = trainer.state.model
    n_params = sum(p.numel() for p in model.parameters())
    snap = {n: p.detach().flatten()[:4096].clone() for n, p in model.named_parameters()}
    f_lat, h_lat, w_lat = (FRAMES - 1) // 4 + 1, HEIGHT // 8, WIDTH // 8
    tokens = TEXT + f_lat * (h_lat // 2) * (w_lat // 2)
    check(tokens == SEQ, f"training tokens {tokens} != {SEQ}")
    loader = latent_batches(latent_dir, dit_cfg)
    waits, shapes = [], []

    def timed_batches():
        """``loader``, with the seconds each ``next`` waited."""
        while True:
            t_wait = time.perf_counter()
            batch = next(loader)
            waits.append(time.perf_counter() - t_wait)
            shapes.append({key: val.shape for key, val in batch.items()})
            yield batch

    batches = timed_batches()
    torch.cuda.synchronize()
    log(f"train: DiT {TRAIN_LAYERS} blocks x {dit_cfg.hidden_size}, {n_params / 1e9:.3f}B "
        f"f32 params, batches from latent_batches over {latent_dir} (native prefetch); "
        f"set-up {time.perf_counter() - t0:.3f} s")

    flash_attention.launches = 0
    for step in range(TRAIN_STEPS):
        before = flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.fit(batches, steps=1)[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = flash_attention.launches - before
        opt = trainer.state.optimizer
        norm = float(opt.grad_norm)
        log(f"train step {step + 1}: {dt:.3f} s ({tokens / dt:.1f} tokens/s), loss "
            f"{loss:.6f}, grad norm {norm:.6f}, lr {opt.schedule(opt.count - 1):.3e}, "
            f"K4 launches {n}, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        log(f"train step {step + 1}: waited {waits[-1]:.4f} s in next(batches) of its "
            f"{dt:.3f} s; batch {shapes[-1]}")
        check(len(waits) == step + 1, "a step did not take one batch")
        check(shapes[-1]["clean_latents"] == (1, f_lat, 56, h_lat, w_lat)
              and shapes[-1]["condition_latents"] == (1, f_lat, 40, h_lat, w_lat)
              and shapes[-1]["text_embeds"] == (1, TEXT, dit_cfg.text_embed_dim),
              f"batch shapes {shapes[-1]}")
        check(np.isfinite(loss) and np.isfinite(norm), "non-finite loss or grad norm")
        check(n == 2 * TRAIN_LAYERS, f"expected {2 * TRAIN_LAYERS} K4 launches a step")
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    moved = sum(int(not torch.equal(p.detach().flatten()[:4096], snap[n]))
                for n, p in model.named_parameters())
    ema = trainer.state.ema_params
    apart = sum(int(not torch.equal(ema[n], p.detach())) for n, p in model.named_parameters())
    n_tensors = len(snap)
    log(f"train: parameters moved in {moved}/{n_tensors} tensors, EMA apart in "
        f"{apart}/{n_tensors}; peak memory {peak / 2**30:.2f} GiB of "
        f"{total / 2**30:.2f} GiB")
    check(moved >= 0.9 * n_tensors, "parameters did not move")
    check(apart >= 0.9 * n_tensors, "EMA equals the parameters")
    check(peak < total, "peak memory above the card's memory")
    loader.close()  # joins the prefetch threads
    del trainer, model, ema, snap, opt, batches
    gc.collect()  # the trainer's state sits in reference cycles
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev)
    log(f"train: {left / 2**30:.2f} GiB still allocated after clean-up")
    check(left < 2**30, "the training phase left its state on the card")
    return launches


def make_prompt(cfg, dev):
    """The seeded (1, 226, 4096) f32 prompt embedding of every pipeline here."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    return torch.randn((1, cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim),
                       generator=gen, device=dev)


def make_pipeline(cfg, dev, codes=None):
    """``AetherPipeline`` on the AetherV1 config: seeded random bf16 DiT
    (seed 0) and VAE (seed 1) on the GPU and a seeded (1, 226, 4096) prompt
    embedding; the same weights every time it is built. With ``codes``
    (torch.int8 or torch.float8_e4m3fn) the DiT is built directly in that
    quantized layout (``init_quantized_dit``, seed 0), int8 with int8
    activations (``bench.py``'s default)."""
    from aether_tpu_torch.models import init_dit, init_quantized_dit, init_vae
    from aether_tpu_torch.pipeline import AetherPipeline

    if codes is None:
        dit = init_dit(cfg.dit, device=dev, dtype=torch.bfloat16, seed=0)
    else:
        dit = init_quantized_dit(cfg.dit, codes, device=dev, seed=0)
    vae = init_vae(cfg.vae, device=dev, dtype=torch.bfloat16, seed=1)
    return AetherPipeline(cfg, dit, vae, make_prompt(cfg, dev), device=dev,
                          compute_dtype=torch.bfloat16, act_quant=codes == torch.int8)


def check_request(res, frames, name) -> None:
    check(res.rgb.shape == (frames, HEIGHT, WIDTH, 3), f"{name} rgb {res.rgb.shape}")
    check(res.disparity.shape == (frames, HEIGHT, WIDTH), f"{name} disp {res.disparity.shape}")
    check(res.raymap.shape == (frames, 6, HEIGHT // 8, WIDTH // 8),
          f"{name} raymap {res.raymap.shape}")
    for field in ("rgb", "disparity", "raymap"):
        check(bool(np.isfinite(getattr(res, field)).all()), f"{name} {field} not finite")
    check(res.rgb.min() >= 0.0 and res.rgb.max() <= 1.0, f"{name} rgb outside [0, 1]")
    log(f"  rgb mean {res.rgb.mean():.6f}, disparity mean {res.disparity.mean():.6f}, "
        f"raymap std {res.raymap.std():.6f}")


def k5_phase(dev, gen):
    """K5 against its plain version at the two main-path shapes, NCTHW bf16.
    Gate: m1 and m2 within 1e-5 of the plain version's, relative to max |m2|
    (f32 sums of up to 1.7 M elements in another order); two launches
    bit-identical. Returns, for the 480p decode shape, (max abs error, kernel
    ms, plain ms, bound ms, bound by)."""
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments, groupnorm_moments_plain

    results = []
    for shape in K5_SHAPES:
        x = (3.0 + 2.0 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
        c0 = x[:, :, 0, 0, 0].float()
        got, again = groupnorm_moments(x, c0), groupnorm_moments(x, c0)
        ref = groupnorm_moments_plain(x, c0)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        scale = ref[1].abs().max().item()
        check(got[0].shape == ref[0].shape == shape[:2], f"K5 {shape}: {got[0].shape}")
        check(err <= 1e-5 * scale, f"K5 {shape} disagrees with its plain version")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K5 {shape}: two launches differ")
        ms = cuda_time_ms(lambda: groupnorm_moments(x, c0), 20)
        plain_ms = cuda_time_ms(lambda: groupnorm_moments_plain(x, c0), 5)
        b, c = shape[:2]
        # one read of x, c0 and two [B, C] outputs; 4 f32 ops an element
        bound_ms, bound_by = bound(x.numel() * x.element_size() + 3 * b * c * 4,
                                   {"f32": 4.0 * x.numel()})
        log(f"K5 {shape} bf16: max abs err {err:.3e} (max |m2| {scale:.3e}, gate 1e-5 "
            f"relative), repeats bit-identical; kernel {ms:.4f} ms "
            f"({x.numel() * 2 / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        results.append((err, ms, plain_ms, bound_ms, bound_by))
        # the decoder also hands its norms channels-last tensors (cuDNN's
        # output layout): the same check and time on that layout
        xc = x.to(memory_format=torch.channels_last_3d)
        got, again = groupnorm_moments(xc, c0), groupnorm_moments(xc, c0)
        torch.cuda.synchronize()
        err_cl = max((a - b).abs().max().item() for a, b in zip(got, ref))
        check(err_cl <= 1e-5 * scale and all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K5 {shape} channels-last disagrees with its plain version or itself")
        log(f"K5 {shape} bf16 channels-last: max abs err {err_cl:.3e}, repeats "
            f"bit-identical; kernel {cuda_time_ms(lambda: groupnorm_moments(xc, c0), 20):.4f} ms")
        del x, xc, c0, got, again, ref
        torch.cuda.empty_cache()
    return results[0]


def expected_k5(pipe, frames, images=None, windows=1):
    """K5 launches of one request: every GroupNorm of the encoder once per
    encode chunk and tile, of the decoder once per decode chunk and tile, and
    both once per window (``batch_reconstruct`` encodes and decodes window by
    window). ``images``: the one-frame encodes of prediction (1) or planning
    (2)."""
    from aether_tpu_torch.models.vae import GroupNorm
    from aether_tpu_torch.pipeline.aether import _chunk_bounds, _tile_spans

    enc = sum(isinstance(m, GroupNorm) for m in pipe.vae.encoder.modules())
    dec = sum(isinstance(m, GroupNorm) for m in pipe.vae.decoder.modules())
    tiles = len(_tile_spans(HEIGHT // 8, 32, 4)) * len(_tile_spans(WIDTH // 8, 90, 6))
    enc_chunks = len(list(_chunk_bounds(frames, 8))) if images is None else images
    dec_chunks = len(list(_chunk_bounds((frames - 1) // 4 + 1, 2)))
    return tiles * windows * (enc * enc_chunks + dec * dec_chunks)


def smooth_trajectory():
    """A seeded smooth 41-pose c2w trajectory and its intrinsics, float64
    numpy (FRAMES, 4, 4) and (FRAMES, 3, 3). The principal point sits at the
    mean of the raymap codec's sample positions (half a pixel before the frame
    centre), where the mean ray is the optical axis."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(21)
    t = np.linspace(0.0, 1.0, FRAMES)[:, None]
    poses = np.tile(np.eye(4), (FRAMES, 1, 1))
    rotvec = t * rng.normal(size=3) * 0.5 + 0.05 * np.sin(6.0 * t) * rng.normal(size=3)
    poses[:, :3, :3] = Rotation.from_rotvec(rotvec).as_matrix()
    poses[:, :3, 3] = t * rng.normal(size=3) * 2.0 + 0.1 * np.cos(4.0 * t)
    k = np.zeros((FRAMES, 3, 3))
    k[:, 0, 0] = k[:, 1, 1] = 500.0
    k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = WIDTH / 2 - 0.5, HEIGHT / 2 - 0.5, 1.0
    return poses, k


def geometry_phase(dev):
    """``smooth_trajectory`` -> ``camera_pose_to_raymap`` -> ``raymap_to_poses``
    on the card; the poses come back within 1e-4."""
    from aether_tpu_torch.geometry import camera_pose_to_raymap, raymap_to_poses

    poses, k = smooth_trajectory()
    pose_t = torch.from_numpy(poses).float().to(dev)
    raymap = camera_pose_to_raymap(pose_t, torch.from_numpy(k).float().to(dev),
                                   height=HEIGHT, width=WIDTH)
    rec, fov_x, fov_y = raymap_to_poses(raymap, ray_o_scale_inv=0.1)
    torch.cuda.synchronize()
    check(raymap.is_cuda and rec.is_cuda, "geometry did not run on the card")
    check(tuple(raymap.shape) == (FRAMES, 6, HEIGHT // 8, WIDTH // 8),
          f"raymap {tuple(raymap.shape)}")
    err = (rec[:, :3, :4] - pose_t[:, :3, :4]).abs().max().item()
    log(f"geometry on the card: {FRAMES} poses -> raymap {tuple(raymap.shape)} -> poses, "
        f"max abs err {err:.3e} (gate 1e-4); fov_x {fov_x.mean().item():.6f}, "
        f"fov_y {fov_y.mean().item():.6f}")
    check(err <= 1e-4, "camera_pose_to_raymap -> raymap_to_poses does not round-trip")


def parse_ply_count(path):
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii")
    n = int(next(ln for ln in header.splitlines()
                 if ln.startswith("element vertex")).split()[-1])
    body = np.frombuffer(data[end:], dtype=np.dtype(
        [("xyz", "<f4", 3), ("rgb", "u1", 3)]), count=n)
    check(np.isfinite(body["xyz"]).all(), f"{path}: non-finite points")
    return n


def parse_glb_points(path):
    with open(path, "rb") as f:
        data = f.read()
    magic, version, total = struct.unpack_from("<III", data, 0)
    check(magic == 0x46546C67 and version == 2 and total == len(data), f"{path}: header")
    json_len, json_type = struct.unpack_from("<II", data, 12)
    check(json_type == 0x4E4F534A, f"{path}: JSON chunk")
    gltf = json.loads(data[20:20 + json_len])
    prim = next(pr for mesh in gltf["meshes"] for pr in mesh["primitives"]
                if pr.get("mode") == 0)
    return gltf["accessors"][prim["attributes"]["POSITION"]]["count"]


def long_video_phase(pipe, dev):
    """The long-video path on the AetherV1 pipeline: a seeded 65-frame clip in
    two 41-frame windows, serially and batched, the blend, the export.
    Returns K5's launches in the two runs, the clip and the two runs'
    window outputs ({1: serial, 2: batched}; phase 24 holds them to the
    driver's undeferred runs)."""
    from aether_tpu_torch.apps.demo import save_geometry
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue
    from aether_tpu_torch.ops.flash_attention import flash_attention_prepacked
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments
    from aether_tpu_torch.pipeline.windowing import (
        blend_and_merge_window_results,
        run_windowed_reconstruction,
    )

    kernels = (qkv_prologue, flash_attention_prepacked, groupnorm_moments)
    video = np.random.default_rng(13).integers(0, 256, (LONG_FRAMES, HEIGHT, WIDTH, 3),
                                               dtype=np.uint8)
    n_layers = pipe.config.dit.num_layers
    runs, k5_launches = {}, 0
    for batch_windows in (1, 2):
        for fn in kernels:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        results, starts, n = run_windowed_reconstruction(
            pipe, video, height=HEIGHT, width=WIDTH, num_frames=FRAMES, fps=12,
            num_inference_steps=STEPS, stride=STRIDE, seed=42, batch_windows=batch_windows)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [fn.launches for fn in kernels]
        name = "serial" if batch_windows == 1 else "batched (batch_reconstruct, B=2)"
        stages = "; ".join(", ".join(f"{k} {v:.3f} s" for k, v in r.stage_seconds.items())
                           for r in (results if batch_windows == 1 else results[:1]))
        log(f"long video, {name}: {len(starts)} windows at {starts}, {wall:.3f} s "
            f"({stages}); K1/K2/K5 launches {'/'.join(map(str, counts))}; peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        check(starts == [0, STRIDE] and n == FRAMES, f"windows {starts} of {n} frames")
        # the batch runs the DiT once at batch 2, the serial path once a window;
        # both run the VAE window by window
        dit_calls = n_layers * STEPS * (2 if batch_windows == 1 else 1)
        k5 = expected_k5(pipe, FRAMES, windows=2)
        check(counts == [dit_calls, dit_calls, k5],
              f"expected K1/K2/K5 launches {dit_calls}/{dit_calls}/{k5}")
        for i, res in enumerate(results):
            check_request(res, FRAMES, f"window {i} ({name})")
        runs[batch_windows] = results
        k5_launches += counts[2]

    # batch vs serial: the same draws and the same VAE calls; only the batch-2
    # DiT's rounding can differ (bf16)
    for i in range(2):
        diffs = {f: np.abs(getattr(runs[1][i], f) - getattr(runs[2][i], f))
                 for f in ("rgb", "disparity", "raymap")}
        log(f"window {i}, batched vs serial: " + ", ".join(
            f"{f} max {d.max():.3e} mean {d.mean():.3e}" for f, d in diffs.items()))
        for f, d in diffs.items():
            top = max(1.0, float(np.abs(getattr(runs[1][i], f)).max()))
            check(d.mean() <= 1e-2 * top and d.max() <= 0.25 * top,
                  f"window {i} {f}: batched and serial disagree")

    t0 = time.perf_counter()
    rgb, disparity, poses, pointmaps = blend_and_merge_window_results(
        runs[1], [0, STRIDE], HEIGHT, WIDTH, device=dev)
    blend_s = time.perf_counter() - t0
    check(rgb.shape == (LONG_FRAMES, HEIGHT, WIDTH, 3), f"blend rgb {rgb.shape}")
    check(disparity.shape == (LONG_FRAMES, HEIGHT, WIDTH), f"blend disp {disparity.shape}")
    check(poses.shape == (LONG_FRAMES, 4, 4), f"blend poses {poses.shape}")
    check(pointmaps.shape == (LONG_FRAMES, HEIGHT, WIDTH, 3), f"pointmaps {pointmaps.shape}")
    for name, arr in (("rgb", rgb), ("disparity", disparity), ("poses", poses),
                      ("pointmaps", pointmaps)):
        check(bool(np.isfinite(arr).all()), f"blend {name} not finite")
    rot = poses[:, :3, :3]
    ortho = np.abs(np.einsum("tij,tik->tjk", rot, rot) - np.eye(3)).max()
    check(ortho <= 1e-4, f"blended rotations not orthonormal ({ortho:.3e})")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        written = save_geometry(os.path.join(tmp, "long"), rgb, disparity, poses, pointmaps)
        export_s = time.perf_counter() - t0
        n_ply = parse_ply_count(written["ply"])
        n_glb = [parse_glb_points(p) for p in written["glb"]]
        saved = np.loadtxt(written["poses"])
        check(saved.shape == (LONG_FRAMES, 16) and np.isfinite(saved).all(), "poses file")
        check(n_ply > 0 and len(n_glb) == -(-LONG_FRAMES // 10) and min(n_glb) > 0,
              f"export: PLY {n_ply} points, GLB {n_glb}")
    log(f"long video blend: {blend_s:.3f} s, rotations orthonormal within {ortho:.1e}; "
        f"export: {export_s:.3f} s, PLY {n_ply} points, {len(n_glb)} GLB scenes "
        f"({min(n_glb)}-{max(n_glb)} points), poses file {saved.shape}")
    return k5_launches, video, runs


PRECOMPUTE_SEED = 5


def precompute_phase(pipe, dev, latent_dir):
    """The training data path on the phase-5 pipeline's full-width bf16 VAE:
    three seeded 41x480x720 clips through ``precompute_latents`` (untiled
    encode) into ``latent_dir``; then the native loader on those files.
    Returns K5's launches in the precompute."""
    from aether_tpu_torch import runtime
    from aether_tpu_torch.geometry import camera_pose_to_raymap
    from aether_tpu_torch.models.vae import GroupNorm
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments
    from aether_tpu_torch.pipeline.aether import _chunk_bounds, _encode_pixels, pack_raymap
    from aether_tpu_torch.train.data import RGB, LatentNoise, latent_batches, precompute_latents
    from aether_tpu_torch.utils.preprocess import preprocess_video
    from aether_tpu_torch.utils.profiling import add_stage_listener, remove_stage_listener

    rng = np.random.default_rng(17)
    poses, k = smooth_trajectory()
    rgb = [rng.uniform(0, 1, (FRAMES, HEIGHT, WIDTH, 3)).astype(np.float32) for _ in range(3)]
    clips = [
        {"name": "a_rgb_disparity_poses", "rgb": rgb[0], "poses": poses, "intrinsics": k,
         "disparity": rng.uniform(0, 1, (FRAMES, HEIGHT, WIDTH)).astype(np.float32)},
        {"name": "b_rgb", "rgb": rgb[1]},
        {"name": "c_rgb_poses_text", "rgb": rgb[2], "poses": poses, "intrinsics": k,
         "text_embeds": rng.standard_normal(
             (TEXT, pipe.config.dit.text_embed_dim)).astype(np.float32)},
    ]
    encodes = (2, 1, 1)  # clip (a) encodes RGB and disparity
    enc_norms = sum(isinstance(m, GroupNorm) for m in pipe.vae.encoder.modules())
    chunks = len(list(_chunk_bounds(FRAMES, 8)))
    f_lat, h_lat, w_lat = (FRAMES - 1) // 4 + 1, HEIGHT // 8, WIDTH // 8
    stages = []

    def listen(name, event, seconds):
        if event == "end" and name.startswith("precompute_"):
            stages.append((name, seconds))

    add_stage_listener(listen)
    try:
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        groupnorm_moments.launches = 0
        t0 = time.perf_counter()
        paths = precompute_latents(pipe, clips, latent_dir, seed=PRECOMPUTE_SEED)
        wall = time.perf_counter() - t0
        launches = groupnorm_moments.launches
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        remove_stage_listener(listen)
    enc_s = [sec for name, sec in stages if name == "precompute_encode"]
    write_s = [sec for name, sec in stages if name == "precompute_write"]
    check(len(enc_s) == len(write_s) == 3, f"precompute stages {stages}")
    for clip, n_enc, e, w_s, path in zip(clips, encodes, enc_s, write_s, paths):
        log(f"precompute {clip['name']}: {n_enc} untiled encode(s) {e:.3f} s, "
            f"savez_compressed {w_s:.3f} s, file {os.path.getsize(path) / 2**20:.2f} MiB")
    log(f"precompute: 3 clips in {wall:.3f} s; peak memory {peak / 2**30:.2f} GiB with "
        f"{base / 2**30:.2f} GiB resident before it (the untiled encode's own "
        f"{(peak - base) / 2**30:.2f} GiB); K5 launches {launches}")
    want = enc_norms * chunks * sum(encodes)
    check(launches == want, f"expected {want} K5 launches ({enc_norms} GroupNorms x {chunks} "
          f"chunks x {sum(encodes)} encodes)")

    keys = {"clean_latents", "num_frames", "height", "width", "fps", "text_embeds"}
    files = {}
    for clip, path in zip(clips, paths):
        with np.load(path) as z:
            files[clip["name"]] = {key: z[key] for key in z.files}
        got = files[clip["name"]]
        clean = got["clean_latents"]
        check(set(got) == keys, f"{path}: keys {sorted(got)}")
        check(clean.dtype == np.float16 and clean.shape == (f_lat, 56, h_lat, w_lat),
              f"{path}: clean_latents {clean.dtype} {clean.shape}")
        check(bool(np.isfinite(clean).all()), f"{path}: clean_latents not finite")
        check((int(got["num_frames"]), int(got["height"]), int(got["width"]), int(got["fps"]))
              == (FRAMES, HEIGHT, WIDTH, 12), f"{path}: sizes")
        text = clip.get("text_embeds")
        check(got["text_embeds"].dtype == np.float16 and got["text_embeds"].shape
              == ((0,) if text is None else text.shape), f"{path}: text_embeds")
        check(bool((clean[:, 16:32] == 0).all()) == (clip.get("disparity") is None)
              and bool((clean[:, 32:] == 0).all()) == (clip.get("poses") is None),
              f"{path}: absent modalities are not the zero channels")
        log(f"  {clip['name']}: clean_latents {clean.shape} f16, |rgb| max "
            f"{np.abs(clean[:, :16].astype(np.float32)).max():.4f}, |disparity| max "
            f"{np.abs(clean[:, 16:32].astype(np.float32)).max():.4f}, |camera| max "
            f"{np.abs(clean[:, 32:].astype(np.float32)).max():.4f}")

    # the same seed twice: identical files
    with tempfile.TemporaryDirectory() as again_dir:
        again = precompute_latents(pipe, clips[:1], again_dir, seed=PRECOMPUTE_SEED)[0]
        with np.load(again) as z:
            same = all(np.array_equal(z[key], files[clips[0]["name"]][key]) for key in keys)
    check(same, "the same seed gave another file")
    # clip (a) by hand: the untiled encode with the same draw, and the raymap
    a_clean = files[clips[0]["name"]]["clean_latents"]
    with torch.no_grad():
        frames = torch.from_numpy(preprocess_video(rgb[0], HEIGHT, WIDTH)).to(dev).to(
            pipe.compute_dtype)
        noise = LatentNoise(PRECOMPUTE_SEED, dev)
        direct = _encode_pixels(pipe.config, pipe.compute_dtype, pipe.vae, frames,
                                lambda shape: noise.posterior(0, RGB, shape), tiling=False)
        raymap = camera_pose_to_raymap(torch.from_numpy(poses).float().to(dev),
                                       torch.from_numpy(k).float().to(dev),
                                       height=HEIGHT, width=WIDTH, vae_downsample=8)
        camera = pack_raymap(raymap[None].to(pipe.compute_dtype))
    direct16 = direct.float().cpu().numpy()[0].astype(np.float16)
    camera16 = camera.float().cpu().numpy()[0].astype(np.float16)
    del frames, direct, raymap, camera
    check(np.array_equal(a_clean[:, :16], direct16),
          "clip (a) RGB channels differ from a direct untiled _encode_pixels call")
    check(np.array_equal(a_clean[:, 32:], camera16),
          "clip (a) camera channels differ from pack_raymap(camera_pose_to_raymap(...))")
    log("precompute: the same seed twice gives identical files; clip (a)'s RGB channels "
        "equal a direct untiled _encode_pixels call, its camera channels the packed "
        "raymap, bit for bit")

    # the loader on those files
    t0 = time.perf_counter()
    for clip, path in zip(clips, paths):
        native = runtime.load_npz(path)
        ref = files[clip["name"]]
        check(set(native) == set(ref) and all(
            native[key].dtype == ref[key].dtype and np.array_equal(native[key], ref[key])
            for key in ref), f"runtime.load_npz differs from np.load on {path}")
    load_s = time.perf_counter() - t0
    cfg = pipe.config.dit
    native_it = latent_batches(latent_dir, cfg)
    plain_it = latent_batches(latent_dir, cfg, native_prefetch=False)
    t0 = time.perf_counter()
    for i in range(6):  # batch 1 over three files: two epochs
        a, b = next(native_it), next(plain_it)
        check(set(a) == set(b) and all(np.array_equal(a[key], b[key]) for key in a),
              f"native and np.load batch {i} differ")
        check(a["clean_latents"].shape == (1, f_lat, 56, h_lat, w_lat),
              f"batch {i}: clean_latents {a['clean_latents'].shape}")
    native_it.close()
    log(f"loader: runtime.load_npz equals np.load on the 3 files ({load_s:.3f} s); "
        f"latent_batches at its defaults (native prefetch) gives the 6 batches of "
        f"native_prefetch=False bit for bit ({time.perf_counter() - t0:.3f} s for both)")
    return launches


def http_get(url, timeout=120):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def wait_job(base, job_id, limit_s=600):
    """Poll ``GET /api/status/ID`` until the job is done or failed; returns
    (status, wall seconds from the first poll, every stage label seen)."""
    t0, seen = time.perf_counter(), set()
    while time.perf_counter() - t0 < limit_s:
        status = json.loads(http_get(f"{base}/api/status/{job_id}"))
        stage = (status.get("progress") or {}).get("stage")
        if stage:
            seen.add(stage)
        if status["status"] in ("done", "error"):
            return status, time.perf_counter() - t0, seen
        time.sleep(0.1)
    raise AssertionError(f"job {job_id} did not finish in {limit_s} s")


def serve_phase(pipe, dev):
    """The web server (``apps/serve.py``) over the phase-5 pipeline: a
    ``JobRunner`` and a ``ThreadingHTTPServer`` on 127.0.0.1 through
    ``make_handler``, as ``main`` builds them; a 65-frame reconstruction job
    (two windows) and a ``SERVED_PREDICTION_STEPS``-step prediction job with
    the post-reconstruction,
    polled over HTTP. The card's machine has no PIL or imageio: the uploads'
    decoding (``_decode_video`` / ``_decode_image``) hands
    ``_fields_to_params`` seeded arrays, and ``viz.save_video`` writes the
    frames it receives as .npy; everything else runs as served. Returns the
    K1/K2/K5 launches of the two jobs."""
    import threading
    from http.server import ThreadingHTTPServer

    import aether_tpu_torch.viz as viz
    from aether_tpu_torch.apps import serve
    from aether_tpu_torch.apps.actions import NAMED_ACTIONS, action_raymap
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue
    from aether_tpu_torch.ops.flash_attention import flash_attention_prepacked
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments
    from aether_tpu_torch.utils.profiling import add_stage_listener, remove_stage_listener

    kernels = (qkv_prologue, flash_attention_prepacked, groupnorm_moments)
    n_layers = pipe.config.dit.num_layers
    rng = np.random.default_rng(17)
    uploads = {"clip.mp4": rng.integers(0, 256, (LONG_FRAMES, HEIGHT, WIDTH, 3),
                                        dtype=np.uint8).astype(np.float32) / 255.0,
               "image.png": rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)}
    received = {}

    def frames_to_npy(path, frames, fps=12):
        path = os.path.splitext(str(path))[0] + ".npy"
        frames = np.asarray(frames)
        np.save(path, frames)
        received[os.path.basename(path)] = frames
        return path

    # where the worker thread launches: (thread, current CUDA device) at
    # every stage's beginning
    where = []

    def on_stage(name, event, value):
        if event == "begin":
            where.append((threading.get_ident(), torch.cuda.current_device()))

    originals = (serve._decode_video, serve._decode_image, viz.save_video)
    log("serve: the card's machine has no PIL or imageio: uploads are not decoded "
        "(_fields_to_params gets seeded arrays in their place) and viz.save_video "
        "writes the frames it receives as .npy for this phase")
    serve._decode_video = lambda field: uploads[field["filename"]]
    serve._decode_image = lambda field: uploads[field["filename"]]
    viz.save_video = frames_to_npy
    # the device as serve.main resolves it from its default --device cuda;
    # the runner gets the pipeline with the bare torch.device("cuda") (no
    # index), the case in which the worker must find the device itself
    from aether_tpu_torch.apps.demo import resolve_device

    default = serve.parse_args(["--random-init", "aetherv1"]).device
    check(default == "cuda" and resolve_device(default) == dev,
          f"serve's default --device {default!r} resolves to "
          f"{resolve_device(default)}, not {dev}")
    pipe.device = torch.device(default)
    add_stage_listener(on_stage)
    tmp = tempfile.TemporaryDirectory()
    runner = serve.JobRunner(pipe, os.path.join(tmp.name, "served"))
    check(runner.device == dev, f"the runner's device {runner.device}, not {dev}")
    log(f"serve: --device {default!r} resolves to {resolve_device(default)}; the "
        f"runner is given the pipeline on {pipe.device!r} and launches on {runner.device}")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(runner, None))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    form = {"num_frames": str(FRAMES), "fps": "12", "height": str(HEIGHT),
            "width": str(WIDTH), "seed": "42"}
    jobs = {
        "reconstruction": dict(form, task="reconstruction", stride=str(STRIDE),
                               video={"filename": "clip.mp4", "data": b""}),
        "prediction": dict(form, task="prediction", raymap="forward_right",
                           steps=str(SERVED_PREDICTION_STEPS),
                           image={"filename": "image.png", "data": b""}),
    }
    k5_window = expected_k5(pipe, FRAMES)
    expected = {
        # two windows of 4 steps; each window encodes and decodes once
        "reconstruction": [2 * n_layers * STEPS] * 2 + [2 * k5_window],
        # the CFG pair at batch 2 (one launch a block and step), then the
        # 4-step post-reconstruction of the generated clip
        "prediction": [n_layers * (SERVED_PREDICTION_STEPS + STEPS)] * 2
        + [expected_k5(pipe, FRAMES, images=1) + k5_window],
    }
    window = ["vae_encode", "denoise", "vae_decode"]
    stage_order = {
        "reconstruction": window + [f"dispatch@0"] + window
        + [f"dispatch@{STRIDE}", "resolve@0", f"resolve@{STRIDE}"],
        "prediction": window * 2,
    }
    launches = [0, 0, 0]
    try:
        html = http_get(base + "/").decode()
        check("showGLB" in html and "api/submit" in html, "GET / does not serve the UI")
        check(json.loads(http_get(base + "/api/raymaps")) == sorted(NAMED_ACTIONS),
              "GET /api/raymaps does not list NAMED_ACTIONS")
        for name, fields in jobs.items():
            params = serve._fields_to_params(fields, None)
            for fn in kernels:
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            status, wall, seen = wait_job(base, runner.submit(params))
            counts = [fn.launches for fn in kernels]
            check(status["status"] == "done", f"{name} job: {status.get('error')}")
            done = status["progress"]["stages_done"]
            log(f"served {name} job: {wall:.3f} s from submit to done over HTTP; stages "
                + ", ".join(f"{d['stage']} {d['seconds']:.3f} s" for d in done)
                + f"; K1/K2/K5 launches {'/'.join(map(str, counts))}; peak memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; stage labels "
                f"seen while polling: {sorted(seen)}")
            check([d["stage"] for d in done] == stage_order[name],
                  f"{name} job stages {[d['stage'] for d in done]}")
            check(counts == expected[name],
                  f"{name} job: expected K1/K2/K5 launches {expected[name]}")
            launches = [a + b for a, b in zip(launches, counts)]
            if name == "prediction":
                check(any(s.startswith("denoise ") and s.endswith("%") for s in seen),
                      "no 'denoise N%' progress stage was seen while the prediction ran")
            with tempfile.TemporaryDirectory() as got:
                sizes, ply, glb = {}, [], []
                for url in status["artifacts"]:
                    data = http_get(base + url)
                    path = os.path.join(got, os.path.basename(url))
                    with open(path, "wb") as f:
                        f.write(data)
                    sizes[os.path.basename(url)] = len(data)
                    if url.endswith(".ply"):
                        ply.append(parse_ply_count(path))
                    elif url.endswith(".glb"):
                        glb.append(parse_glb_points(path))
                    elif url.endswith("_poses.txt"):
                        poses = np.loadtxt(path)
                        frames = LONG_FRAMES if name == "reconstruction" else FRAMES
                        check(poses.shape == (frames, 16) and np.isfinite(poses).all(),
                              f"{name} poses file {poses.shape}")
                check(len(ply) == 1 and ply[0] > 0, f"{name} PLY points {ply}")
                check(glb and min(glb) > 0, f"{name} GLB points {glb}")
                check(all(n > 0 for n in sizes.values()), f"{name} empty artifact")
                log(f"served {name} job: {len(sizes)} artifacts downloaded over HTTP "
                    f"({sum(sizes.values()) / 2**20:.1f} MiB), PLY {ply[0]} points, "
                    f"{len(glb)} GLB scenes ({min(glb)}-{max(glb)} points)")
        stats = json.loads(http_get(base + "/api/stats"))
        check(stats["jobs"] == {"done": 2} and stats["queue_depth"] == 0,
              f"GET /api/stats jobs {stats['jobs']}")
        check(all(stats["stages"][s]["count"] >= 4 for s in window),
              f"GET /api/stats stages {sorted(stats['stages'])}")
        log("GET /api/stats: " + ", ".join(
            f"{s} x{stats['stages'][s]['count']} mean {stats['stages'][s]['mean_s']:.3f} s"
            for s in window))
    finally:
        httpd.shutdown()
        httpd.server_close()
        runner.close(timeout=60)  # the worker lets go of the pipeline
        pipe.device = dev
        remove_stage_listener(on_stage)
        serve._decode_video, serve._decode_image, viz.save_video = originals
    check(not runner._thread.is_alive(), "the server's worker did not stop")
    check(where and {w[0] for w in where} == {runner._thread.ident}
          and {w[1] for w in where} == {dev.index or 0},
          f"the pipeline did not run on the worker thread on cuda:{dev.index or 0}: "
          f"{set(where)}")
    log(f"serve: {len(where)} stages ran on the worker thread, current device "
        f"cuda:{where[0][1]}")

    # the server adds nothing: the served prediction's rgb, as the writer
    # received it, is a direct call's with the same arguments, clipped as
    # save_output clips it
    direct = pipe(task="prediction", image=uploads["image.png"],
                  raymap=action_raymap("forward_right", num_frames=FRAMES, height=HEIGHT,
                                       width=WIDTH),
                  height=HEIGHT, width=WIDTH, num_frames=FRAMES, fps=12,
                  num_inference_steps=SERVED_PREDICTION_STEPS, guidance_scale=None,
                  use_dynamic_cfg=True, seed=42)
    served = received["prediction_upload_rgb.npy"]
    check(np.array_equal(served, np.clip(direct.rgb, 0, 1)),
          "the served prediction's rgb differs from a direct call's")
    log("serve: the served prediction's rgb is bit-identical to a direct pipe(task="
        "'prediction') call's")
    tmp.cleanup()
    return launches


class TimedPipeline:
    """Counts and times (host clock, ended by a synchronize) the pipeline
    calls of an evaluation driver."""

    def __init__(self, pipe):
        self.pipe, self.config, self.device, self.seconds = pipe, pipe.config, pipe.device, []

    def _timed(self, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out

    def __call__(self, **kw):
        return self._timed(self.pipe, **kw)

    def batch_reconstruct(self, *args, **kw):
        return self._timed(self.pipe.batch_reconstruct, *args, **kw)


def eval_phase(pipe, dev):
    """The two benchmark drivers over the phase-5 pipeline on seeded clips:
    ``video_depth.process_with_sliding_window`` at its defaults over
    49x480x960 (two temporal windows x two spatial tiles), serially and with
    ``batch_calls=2``, scored by ``depth_evaluation``;
    ``rel_pose.process_video_with_sliding_window`` over 73x480x720 (two
    windows), scored by ``eval_metrics``; LAD2 on the card against the CPU.
    Returns the K1/K2/K5 launches of the serial video-depth run."""
    from aether_tpu_torch.eval import depth_metrics, pose_metrics
    from aether_tpu_torch.eval.rel_pose import process_video_with_sliding_window
    from aether_tpu_torch.eval.video_depth import process_with_sliding_window
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue
    from aether_tpu_torch.ops.flash_attention import flash_attention_prepacked
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments

    kernels = (qkv_prologue, flash_attention_prepacked, groupnorm_moments)
    n_layers = pipe.config.dit.num_layers
    k5_window = expected_k5(pipe, FRAMES)
    rng = np.random.default_rng(19)
    clip = rng.integers(0, 256, (49, HEIGHT, 960, 3), dtype=np.uint8) / 255.0

    runs = {}
    for batch_calls in (1, 2):
        timed = TimedPipeline(pipe)
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        rgb, disp = process_with_sliding_window(timed, clip, batch_calls=batch_calls)
        wall = time.perf_counter() - t0
        counts = [fn.launches for fn in kernels]
        name = "serial" if batch_calls == 1 else "batch_calls=2"
        log(f"video depth, {name}: 49x480x960 in {wall:.3f} s, {len(timed.seconds)} "
            f"pipeline calls (" + ", ".join(f"{s:.3f}" for s in timed.seconds)
            + f" s); K1/K2/K5 launches {'/'.join(map(str, counts))}")
        # 2 temporal windows x 2 tiles; batched, the DiT runs the pairs at batch 2
        calls = 4 if batch_calls == 1 else 2
        dit = n_layers * STEPS * calls
        check(len(timed.seconds) == calls and counts == [dit, dit, 4 * k5_window],
              f"video depth {name}: {len(timed.seconds)} calls, expected K1/K2/K5 "
              f"{dit}/{dit}/{4 * k5_window}")
        check(rgb.shape == (49, HEIGHT, 960, 3) and disp.shape == (49, HEIGHT, 960),
              f"video depth {name}: {rgb.shape} {disp.shape}")
        check(bool(np.isfinite(rgb).all() and np.isfinite(disp).all()),
              f"video depth {name} not finite")
        check(rgb.min() >= 0.0 and rgb.max() <= 1.0, f"video depth {name}: rgb outside [0, 1]")
        runs[batch_calls] = (rgb, disp, counts)
    # batched against serial: the same draws and VAE calls, only the batch-2
    # DiT's rounding differs; the long-video phase's gates
    for field, a, b in (("rgb", runs[1][0], runs[2][0]), ("disparity", runs[1][1], runs[2][1])):
        d = np.abs(a - b)
        top = max(1.0, float(np.abs(a).max()))
        log(f"video depth, batched vs serial {field}: max {d.max():.3e} mean {d.mean():.3e}")
        check(d.mean() <= 1e-2 * top and d.max() <= 0.25 * top,
              f"video depth {field}: batched and serial disagree")

    # the benchmark's scoring: a GT that is a known scale of the prediction
    # aligns back to it (Weiszfeld scale, run_sequences' depth clamp)
    depth = np.clip(1.0 / np.clip(runs[1][1], 1e-8, None), 0, 1e2)
    t0 = time.perf_counter()
    metrics, *_ = depth_metrics.depth_evaluation(depth, 2.5 * depth, max_depth=None,
                                                 align="scale")
    log(f"video depth scored against 2.5x itself (align scale): Abs Rel "
        f"{metrics['Abs Rel']:.3e} (bar 1e-6), delta<1.25 {metrics['δ < 1.25']:.6f}, "
        f"{metrics['valid_pixels']} pixels, {time.perf_counter() - t0:.3f} s")
    check(metrics["Abs Rel"] <= 1e-6 and metrics["valid_pixels"] == depth.size,
          "video depth: the scale alignment does not recover a known scale")

    # LAD2 (Adam) on the card against the CPU on one frame's pixels
    pred = depth[0].reshape(-1)
    gt = 1.7 * pred + 0.3 + np.random.default_rng(23).normal(0.0, 0.05, pred.size)
    s_init = float(np.median(gt) / np.median(pred))
    lad2 = []
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        lad2.append(depth_metrics._lad2_device(
            torch.tensor(pred, dtype=torch.float32, device=where),
            torch.tensor(gt, dtype=torch.float32, device=where), s_init))
        log(f"LAD2 on {where}: s {lad2[-1][0]:.6f}, t {lad2[-1][1]:.6f} from s_init "
            f"{s_init:.6f}, {time.perf_counter() - t0:.3f} s")
    (s_gpu, t_gpu), (s_cpu, t_cpu) = lad2
    check(abs(s_gpu - s_cpu) <= 1e-3 * abs(s_cpu) and abs(t_gpu - t_cpu) <= 1e-3 * max(
        1.0, abs(t_cpu)), "LAD2 on the card disagrees with the CPU (bar 1e-3 relative)")

    # relative pose: 73 frames in two windows (starts 0 and 32)
    video = rng.integers(0, 256, (73, HEIGHT, WIDTH, 3), dtype=np.uint8) / 255.0
    timed = TimedPipeline(pipe)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    res = process_video_with_sliding_window(timed, video)
    wall = time.perf_counter() - t0
    counts = [fn.launches for fn in kernels]
    log(f"relative pose: 73x480x720 in {wall:.3f} s, {len(timed.seconds)} pipeline calls ("
        + ", ".join(f"{s:.3f}" for s in timed.seconds)
        + f" s); K1/K2/K5 launches {'/'.join(map(str, counts))}")
    dit = n_layers * STEPS * 2
    check(len(timed.seconds) == 2 and counts == [dit, dit, 2 * k5_window],
          f"relative pose: expected 2 calls and K1/K2/K5 {dit}/{dit}/{2 * k5_window}")
    poses, focals = res["poses"], res["focals"]
    check(poses.shape == (73, 4, 4) and focals.shape == (73,), f"poses {poses.shape}")
    rot = poses[:, :3, :3]
    ortho = np.abs(np.einsum("tij,tik->tjk", rot, rot) - np.eye(3)).max()
    check(ortho <= 1e-4, f"relative pose: rotations not orthonormal ({ortho:.3e})")
    check(bool(np.isfinite(poses).all() and np.isfinite(focals).all() and (focals > 0).all()),
          "relative pose: poses or focals not finite, or a focal not positive")
    # a Sim(3) transform of the trajectory scores ATE 0 against it
    from scipy.spatial.transform import Rotation

    r = Rotation.from_euler("xyz", [20.0, -35.0, 50.0], degrees=True).as_matrix()
    moved = poses.copy()
    moved[:, :3, 3] = 2.5 * poses[:, :3, 3] @ r.T + np.array([1.0, -2.0, 0.5])
    moved[:, :3, :3] = r @ poses[:, :3, :3]
    with tempfile.TemporaryDirectory() as tmp:
        ate, rpe_t, rpe_r = pose_metrics.eval_metrics(
            pose_metrics.poses_to_traj(moved), pose_metrics.poses_to_traj(poses), seq="smoke",
            filename=os.path.join(tmp, "eval_metric.txt"))
    spread = np.ptp(poses[:, :3, 3], axis=0)
    log(f"relative pose: rotations orthonormal within {ortho:.1e}, focals "
        f"{focals.min():.3f}-{focals.max():.3f}, trajectory extent {np.round(spread, 6)}; "
        f"against a Sim(3) copy ATE {ate:.3e} (bar 1e-6), RPE trans {rpe_t:.3e}, RPE rot "
        f"{rpe_r:.3e} deg")
    check(ate <= 1e-6, "relative pose: ATE against a Sim(3) copy of the trajectory")
    return runs[1][2]


def fixed_max_phase(dev, gen):
    """K3 (int8 and bf16 QK^T) and K6 against their plain versions at the CFG
    pair's shape, B=2 x 48 heads x 15076 tokens x 64, bf16, and K3's
    unnormalized ring-merge mode on a quarter-sequence q stripe against the
    padded full K/V. Gates: max abs 1e-2 and mean 1e-3, as K2; K6 computes
    its plain version's function up to exp2f's last bit, so its mean error
    is held to 1e-4. Each is launched twice on the same inputs (the same
    bits), and K3 and K6 are also timed alone on the operands their wrappers
    prepare. Returns {name: (max abs error, kernel ms, plain ms)} and
    {"K3 int8 alone", "K3 bf16 alone", "K6 alone"}: ms."""
    from aether_tpu_torch.ops.flash_attention import (
        _fixed_max_launch,
        _fixed_max_operands,
        _pv8_launch,
        _pv8_operands,
        flash_attention_fixed_max,
        flash_attention_fixed_max_plain,
        flash_attention_pv8,
        flash_attention_pv8_plain,
    )

    shape = (2, HEADS, SEQ, HEAD_DIM)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    flops = 4.0 * 2 * HEADS * SEQ * SEQ * HEAD_DIM
    results = {}
    for qk_int8 in (True, False):
        name = f"K3 {'int8' if qk_int8 else 'bf16'} QK^T"

        def kernel(qk_int8=qk_int8):
            return flash_attention_fixed_max(q, k, v, qk_int8=qk_int8)

        def plain(qk_int8=qk_int8):
            return flash_attention_fixed_max_plain(q, k, v, qk_int8=qk_int8)

        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = compare(name, out, ref, 1e-2, 1e-3)
        check(torch.equal(out, kernel()), f"{name}: two launches differ")
        results[name] = (err, *time_pair(name, kernel, plain, flops))
        # the kernel alone on the operands its wrapper prepares (norms, fold,
        # group quantization; unpadded)
        ops = _fixed_max_operands(q, k, v, sm_scale=None, kv_valid=None, heads_per_cell=4,
                                  noshift=False, qk_int8=qk_int8, pv_int8=False,
                                  score_bound=None, unnormalized=False)
        buf = torch.empty((2 * HEADS, SEQ, HEAD_DIM), dtype=q.dtype, device=dev)
        alone_ms = cuda_time_ms(lambda: _fixed_max_launch(ops, buf, None), 5)
        torch.cuda.synchronize()
        check(torch.equal(buf.view(shape), out), f"{name}: the kernel alone differs")
        log(f"{name} kernel alone: {alone_ms:.4f} ms ({flops / alone_ms / 1e9:.1f} TFLOP/s); "
            f"the wrapper's passes {results[name][1] - alone_ms:.4f} ms")
        results[f"K3 {'int8' if qk_int8 else 'bf16'} alone"] = alone_ms
        del out, ref, ops, buf

    out, ref = flash_attention_pv8(q, k, v), flash_attention_pv8_plain(q, k, v)
    torch.cuda.synchronize()
    err = compare("K6", out, ref, 1e-2, 1e-4)
    check(torch.equal(out, flash_attention_pv8(q, k, v)), "K6: two launches differ")
    results["K6"] = (err, *time_pair("K6", lambda: flash_attention_pv8(q, k, v),
                                     lambda: flash_attention_pv8_plain(q, k, v), flops))
    # K6 alone on the operands its wrapper prepares (quantized, padded, v8
    # transposed and permuted): the wrapper's passes show apart
    qp, kp, vt, ops, span = _pv8_operands(q, k, v, sm_scale=None, kv_valid=None,
                                          block_k=1024, heads_per_cell=4)
    buf = torch.empty((2 * HEADS, qp.shape[1], HEAD_DIM), dtype=q.dtype, device=dev)
    alone_ms = cuda_time_ms(lambda: _pv8_launch(qp, kp, vt, ops, span, buf), 5)
    torch.cuda.synchronize()
    check(torch.equal(buf[:, :SEQ].reshape(shape), out), "K6 alone differs from its wrapper")
    log(f"K6 kernel alone: {alone_ms:.4f} ms (span {span}); the wrapper's passes "
        f"{results['K6'][1] - alone_ms:.4f} ms")
    results["K6 alone"] = alone_ms
    del qp, kp, vt, ops, buf

    # a sequence-parallel stripe: 4 shards of 64-row multiples, the 15076
    # tokens padded to 15104 (stripes of 3776)
    stripe = -(-SEQ // (4 * 64)) * 64
    kv_pad = 4 * stripe
    qs = q[:1, :, :stripe].contiguous()
    kp, vp = (torch.nn.functional.pad(t[:1], (0, 0, 0, kv_pad - SEQ)) for t in (k, v))
    bound = 1.0 + (qs.float().norm(dim=-1).max() * kp.float().norm(dim=-1).max()
                   * HEAD_DIM ** -0.5 * 1.4426950408889634)
    kw = dict(kv_valid=SEQ, score_bound=bound, unnormalized=True)
    (o, l), (ro, rl) = (flash_attention_fixed_max(qs, kp, vp, **kw),
                        flash_attention_fixed_max_plain(qs, kp, vp, **kw))
    torch.cuda.synchronize()
    check(l.shape == rl.shape == (1, HEADS, stripe, 1), f"K3 unnormalized l {l.shape}")
    l_rel = ((l - rl).abs() / rl.abs()).max().item()
    scale = ro.float().abs().max().item()
    compare("K3 unnormalized o / max|o|", o.float() / scale, ro.float() / scale, 1e-2, 1e-3)
    log(f"K3 unnormalized l: max rel err {l_rel:.3e} (gate 1e-4)")
    check(l_rel <= 1e-4, "K3 unnormalized l disagrees with its plain version")
    check(all(torch.equal(a, b) for a, b in zip(
        (o, l), flash_attention_fixed_max(qs, kp, vp, **kw))),
        "K3 unnormalized: two launches differ")
    del q, k, v, out, ref, qs, kp, vp, o, l, ro, rl
    torch.cuda.empty_cache()
    return results


def cfg_phases(cfg, dev):
    """One prediction request through K3 (the task defaults, cut to
    ``FUSED0_STEPS`` steps), two ``PLANNING_PAIR_STEPS``-step planning
    requests through K6, and one prediction request at the default attention
    settings (K1 + K2 at the CFG pair's batch 2) cut to
    ``DEFAULT_PREDICTION_STEPS`` steps, on the
    AetherV1 pipeline. Returns the launches of K3 and K6 in their runs."""
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue
    from aether_tpu_torch.ops.flash_attention import (
        flash_attention_fixed_max,
        flash_attention_prepacked,
        flash_attention_pv8,
    )
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments

    kernels = (qkv_prologue, flash_attention_prepacked, flash_attention_fixed_max,
               flash_attention_pv8, groupnorm_moments)
    check(dict(cfg.default_num_inference_steps)["prediction"] == PREDICTION_STEPS
          and dict(cfg.default_guidance_scale)["prediction"] == 3.0
          and dict(cfg.default_use_dynamic_cfg)["prediction"],
          "prediction defaults are not 50 steps, guidance 3, dynamic CFG")
    t0 = time.perf_counter()
    pipe = make_pipeline(cfg, dev)
    torch.cuda.synchronize()
    log(f"pipeline built again from its seeds in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(11)
    image, goal = (rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8) for _ in range(2))
    raymap = rng.standard_normal((FRAMES, 6, HEIGHT // 8, WIDTH // 8)).astype(np.float32)
    n_layers = cfg.dit.num_layers

    def drive(name, **kw):
        for fn in kernels:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = pipe(image=image, raymap=raymap, height=HEIGHT, width=WIDTH,
                   num_frames=FRAMES, fps=12, seed=42, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [fn.launches for fn in kernels]
        stages = ", ".join(f"{k} {v:.3f} s" for k, v in res.stage_seconds.items())
        log(f"{name}: {wall:.3f} s ({stages}); K1/K2/K3/K6/K5 launches "
            f"{'/'.join(map(str, counts))}; peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        check_request(res, FRAMES, name)
        return res, counts

    saved = {n: os.environ.get(n) for n in ("AETHER_ATTN_FUSED", "AETHER_ATTN_PV8")}
    try:
        os.environ["AETHER_ATTN_FUSED"] = "0"
        _, counts = drive(f"prediction request ({FUSED0_STEPS} of the default "
                          f"{PREDICTION_STEPS} steps)", task="prediction",
                          num_inference_steps=FUSED0_STEPS)
        k5 = expected_k5(pipe, FRAMES, images=1)
        check(counts == [0, 0, n_layers * FUSED0_STEPS, 0, k5],
              f"expected {n_layers * FUSED0_STEPS} K3 and {k5} K5 launches, no other")
        k3_launches = counts[2]

        os.environ["AETHER_ATTN_PV8"] = "1"
        outs, k6_launches = [], 0
        for req in range(2):
            res, counts = drive(f"planning request {req}", task="planning", goal=goal,
                                num_inference_steps=PLANNING_PAIR_STEPS)
            k5 = expected_k5(pipe, FRAMES, images=2)
            check(counts == [0, 0, 0, n_layers * PLANNING_PAIR_STEPS, k5],
                  f"expected {n_layers * PLANNING_PAIR_STEPS} K6 and {k5} K5 launches, "
                  "no other")
            k6_launches += counts[3]
            outs.append(res)
        for name in ("rgb", "disparity", "raymap"):
            check(np.array_equal(getattr(outs[0], name), getattr(outs[1], name)),
                  f"planning outputs differ: {name}")
        log("planning requests 0 and 1: bit-identical outputs")

        # the default path of the heaviest request: fused K1 + K2 at batch 2
        for n in saved:
            os.environ.pop(n, None)
        _, counts = drive("prediction request at the default attention settings",
                          task="prediction", num_inference_steps=DEFAULT_PREDICTION_STEPS)
        k5 = expected_k5(pipe, FRAMES, images=1)
        n = n_layers * DEFAULT_PREDICTION_STEPS
        check(counts == [n, n, 0, 0, k5],
              f"expected {n} K1 and K2 and {k5} K5 launches, no K3 or K6, at the defaults")
    finally:
        for n, value in saved.items():
            if value is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = value
    del pipe, outs
    torch.cuda.empty_cache()
    return k3_launches, k6_launches


def bf16_ulps(a, b):
    """|a - b| in bf16 ulps of the larger magnitude, 2**(floor(log2 x) - 7);
    0 where the two are equal."""
    a, b = a.float(), b.float()
    top = torch.maximum(a.abs(), b.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return torch.where(a == b, torch.zeros_like(a), (a - b).abs() / ulp)


def k1_float_gates(name, got, ref):
    """Phase 14's gates on K1's float (QK8=0) outputs against its plain
    version: bf16 q and k within one bf16 ulp on at most 1e-4 of the
    elements, v bit-exact, the stats within rtol 1e-5. Returns the largest
    abs difference of q and k."""
    check(got[7] == ref[7], f"{name} s_pad {got[7]} / {ref[7]}")
    err = 0.0
    for part, a, b in (("q", got[0], ref[0]), ("k", got[1], ref[1])):
        check(a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape,
              f"{name} {part} {a.dtype} {a.shape}")
        ulps = bf16_ulps(a, b)
        frac = (ulps > 0).float().mean().item()
        err = max(err, (a.float() - b.float()).abs().max().item())
        log(f"{name} {part}: max {ulps.max().item():.3f} bf16 ulps, differing "
            f"fraction {frac:.3e} (gates 1 ulp, 1e-4)")
        check(ulps.max().item() <= 1 and frac <= 1e-4, f"{name} {part} disagrees")
    check(torch.equal(got[2], ref[2]), f"{name} v is not bit-exact")
    for part, a, b in zip(("qsc", "qn", "ksc", "kn"), got[3:7], ref[3:7]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0, msg=f"{name} {part}")
    return err


def float_k1_k2_phase(k1_args, kw):
    """The float (QK8=0) K1 and K2 against their plain versions at the
    main-path shape. Gates: K1's bf16 q and k within one bf16 ulp on at most
    1e-4 of the elements, v bit-exact, the stats within rtol 1e-5; K2 at
    ``bf16_gates``. Returns {name: (max abs error, kernel ms, plain
    ms)} for "K1 float" and "K2 float"."""
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue, qkv_prologue_plain
    from aether_tpu_torch.ops.flash_attention import (
        flash_attention_prepacked,
        flash_attention_prepacked_plain,
    )

    def k1():
        return qkv_prologue(*k1_args, quantize=False, **kw)

    def k1_plain():
        return qkv_prologue_plain(*k1_args, quantize=False, **kw)

    got, ref = k1(), k1_plain()
    torch.cuda.synchronize()
    k1_err = k1_float_gates("K1 float", got, ref)
    results = {"K1 float": (k1_err, cuda_time_ms(k1, 20), cuda_time_ms(k1_plain, 3))}
    log(f"K1 float time: kernel {results['K1 float'][1]:.4f} ms, plain "
        f"{results['K1 float'][2]:.4f} ms")
    check(results["K1 float"][1] < K1_MS_GATE,
          f"float K1 {results['K1 float'][1]:.4f} ms, not under {K1_MS_GATE} ms")

    q, k, v, qsc, qn, ksc, kn, _ = got
    kw2 = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=SEQ)
    out = flash_attention_prepacked(q, k, v, **kw2)
    out_ref = flash_attention_prepacked_plain(q, k, v, **kw2)
    torch.cuda.synchronize()
    err = compare("K2 float (bf16 QK^T)", out, out_ref, *bf16_gates(out_ref))
    check(torch.equal(out, flash_attention_prepacked(q, k, v, **kw2)),
          "K2 float: two launches differ")
    flops = 4.0 * HEADS * q.shape[1] * q.shape[1] * HEAD_DIM
    results["K2 float"] = (err, *time_pair(
        "K2 float", lambda: flash_attention_prepacked(q, k, v, **kw2),
        lambda: flash_attention_prepacked_plain(q, k, v, **kw2), flops))
    del got, ref, out, out_ref, q, k, v
    torch.cuda.empty_cache()
    return results


def float_request_phase(pipe, video, dev):
    """One reconstruction request at ``AETHER_ATTN_QK8=0`` (the float K1 and
    K2). Returns (K1 launches, K2 launches) of the request."""
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue
    from aether_tpu_torch.ops.flash_attention import flash_attention_prepacked

    saved = os.environ.get("AETHER_ATTN_QK8")
    os.environ["AETHER_ATTN_QK8"] = "0"
    try:
        qkv_prologue.launches = flash_attention_prepacked.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = pipe(task="reconstruction", video=video, height=HEIGHT, width=WIDTH,
                   num_frames=FRAMES, num_inference_steps=STEPS, fps=12, seed=42)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = (qkv_prologue.launches, flash_attention_prepacked.launches)
    finally:
        if saved is None:
            os.environ.pop("AETHER_ATTN_QK8", None)
        else:
            os.environ["AETHER_ATTN_QK8"] = saved
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in res.stage_seconds.items())
    log(f"request at AETHER_ATTN_QK8=0: {wall:.3f} s ({stages}); K1 launches {counts[0]}, "
        f"K2 launches {counts[1]}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    n = pipe.config.dit.num_layers * STEPS
    check(counts == (n, n), f"expected {n} launches of each of K1 and K2 at QK8=0")
    check_request(res, FRAMES, "request at AETHER_ATTN_QK8=0")
    return counts


def online_request_phase(pipe, video, dev):
    """One reconstruction request at ``AETHER_ATTN_FIXED_MAX=0``: the DiT's
    attention through K4 bf16, none through K1 or K2. Returns K4's launches
    in the request."""
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue
    from aether_tpu_torch.ops.flash_attention import flash_attention, flash_attention_prepacked
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments

    kernels = (qkv_prologue, flash_attention_prepacked, flash_attention, groupnorm_moments)
    saved = os.environ.get("AETHER_ATTN_FIXED_MAX")
    os.environ["AETHER_ATTN_FIXED_MAX"] = "0"
    try:
        for fn in kernels:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = pipe(task="reconstruction", video=video, height=HEIGHT, width=WIDTH,
                   num_frames=FRAMES, num_inference_steps=STEPS, fps=12, seed=42)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [fn.launches for fn in kernels]
    finally:
        if saved is None:
            os.environ.pop("AETHER_ATTN_FIXED_MAX", None)
        else:
            os.environ["AETHER_ATTN_FIXED_MAX"] = saved
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in res.stage_seconds.items())
    log(f"request at AETHER_ATTN_FIXED_MAX=0: {wall:.3f} s ({stages}); K1/K2/K4/K5 "
        f"launches {'/'.join(map(str, counts))}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    n = pipe.config.dit.num_layers * STEPS
    k5 = expected_k5(pipe, FRAMES)
    check(counts == [0, 0, n, k5],
          f"expected {n} K4 and {k5} K5 launches, no K1 or K2, at FIXED_MAX=0")
    check_request(res, FRAMES, "request at AETHER_ATTN_FIXED_MAX=0")
    return counts[2]

# the a8 products of one block at the main path's shapes: (name, rows, in, out);
# the fused qkv runs over the 15360 padded joint rows, o over the 15076 valid
# ones, the MLP over the 15076 joint tokens
W8A8_SHAPES = (("qkv", 15360, 3072, 9216), ("o", SEQ, 3072, 3072),
               ("w1", SEQ, 3072, 12288), ("w2", SEQ, 12288, 3072))


@torch.no_grad()
def w8a8_phase(dev, gen):
    """The w8a8 products at the main path's shapes: ``int8_mm``
    (``torch._int_mm``) against its plain version (exact int32 sums) on the
    activation codes of a seeded bf16 x; then, with CUDA events, the product
    alone, the whole w8a8 ``QuantLinear`` (quantize, product, epilogue), the
    fp8 weight-only ``QuantLinear`` and a bf16 ``F.linear`` at the same shape,
    and the product's bound (int8 operations over the int8 peak against its
    bytes). Returns {name: (product ms, w8a8 linear ms, fp8 linear ms, bf16
    ms, bound)}."""
    from aether_tpu_torch.models.dit import QuantLinear, int8_mm, int8_mm_plain
    from aether_tpu_torch.models.dit import quantize_activations

    results = {}
    for name, m, k, n in W8A8_SHAPES:
        x = torch.randn((1, m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((n, k), generator=gen, device=dev) * k ** -0.5)
        b = torch.randn((n,), generator=gen, device=dev).to(torch.bfloat16) * 0.02
        s = w.abs().amax(dim=1) / 127.0
        q8 = torch.round(w / s[:, None]).to(torch.int8)
        s8 = w.abs().amax(dim=1) / 448.0
        f8 = (w / s8[:, None]).to(torch.float8_e4m3fn)
        wb = w.to(torch.bfloat16)
        del w
        xq, _ = quantize_activations(x)
        xq = xq.reshape(m, k)
        before = int8_mm.launches
        got = int8_mm(xq, q8.t())
        ref = int8_mm_plain(xq, q8.t())
        torch.cuda.synchronize()
        check(int8_mm.launches == before + 1, f"w8a8 {name}: int8_mm did not launch")
        check(got.dtype == torch.int32 and torch.equal(got, ref),
              f"w8a8 {name}: torch._int_mm differs from the exact int32 sums")
        lin8, linf8 = QuantLinear(q8, s, b), QuantLinear(f8, s8, b)
        prod_ms = cuda_time_ms(lambda: int8_mm(xq, q8.t()), 10)
        a8_ms = cuda_time_ms(lambda: lin8(x, a8=True), 10)
        fp8_ms = cuda_time_ms(lambda: linf8(x), 10)
        bf16_ms = cuda_time_ms(lambda: torch.nn.functional.linear(x, wb, b), 10)
        ops = 2.0 * m * k * n
        bnd = bound(m * k + n * k + 4 * m * n, {"int8": ops})
        log(f"w8a8 {name} ({m} x {k}) @ ({k} x {n}): _int_mm exact; product {prod_ms:.4f} ms "
            f"({ops / prod_ms / 1e9:.1f} TOP/s, {bnd[0] / prod_ms:.1%} of its {bnd[0]:.4f} ms "
            f"{bnd[1]} bound), w8a8 linear {a8_ms:.4f} ms (quantize + epilogue "
            f"{a8_ms - prod_ms:.4f}), fp8 weight-only linear {fp8_ms:.4f} ms, bf16 F.linear "
            f"{bf16_ms:.4f} ms ({ops / bf16_ms / 1e9:.1f} TFLOP/s)")
        results[name] = (prod_ms, a8_ms, fp8_ms, bf16_ms, bnd)
        del x, b, s, q8, s8, f8, wb, xq, got, ref, lin8, linf8
        torch.cuda.empty_cache()
    return results


@torch.no_grad()
def quality_phase(cfg, dev):
    """One DiT forward at timestep 500 on seeded 41x480x720 latents in bf16,
    then in each weight format from the same bf16 weights (``quantize_dit`` of
    ``init_dit`` seed 0, the phase-5 DiT): fp8 weight-only, int8 weight-only
    and int8 w8a8. Gates, the JAX tests' bars: fp8 mean-abs relative error
    < 0.10 (tests/test_models.py:213), int8 weight-only < 0.05 (:238), int8
    w8a8 norm relative error < 0.2 (:446). Returns {format: (mean-abs rel,
    norm rel, cosine)}."""
    from aether_tpu_torch.models import init_dit, quantize_dit
    from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings

    f_lat, h_lat, w_lat = (FRAMES - 1) // 4 + 1, HEIGHT // 8, WIDTH // 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    hidden = torch.randn((1, f_lat, cfg.dit.in_channels, h_lat, w_lat), generator=gen,
                         device=dev).to(torch.bfloat16)
    text = make_prompt(cfg, dev).to(torch.bfloat16)
    t = torch.tensor([500], device=dev)
    cos, sin = prepare_rotary_positional_embeddings(
        cfg.dit, HEIGHT, WIDTH, f_lat, vae_scale_factor_spatial=8, base_fps=12, fps=12)
    rope = (torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev))

    def forward(dit, act_quant=False):
        out = dit(hidden, text, t, *rope, act_quant=act_quant).float()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), "quality: non-finite DiT output")
        return out

    results = {}

    def against_bf16(name, out):
        mean_rel, norm_rel, cosine = relative_errors(out, ref)
        log(f"quality at full width, {name} against bf16: mean-abs relative error "
            f"{mean_rel:.6f}, norm relative error {norm_rel:.6f}, cosine {cosine:.6f}")
        results[name] = (mean_rel, norm_rel, cosine)

    dit = init_dit(cfg.dit, device=dev, dtype=torch.bfloat16, seed=0)
    ref = forward(dit)
    quantize_dit(dit, torch.int8)  # in place: the bf16 weights go as their codes come
    against_bf16("int8 weight-only", forward(dit))
    against_bf16("int8 w8a8", forward(dit, act_quant=True))
    del dit
    gc.collect()
    torch.cuda.empty_cache()
    dit = quantize_dit(init_dit(cfg.dit, device=dev, dtype=torch.bfloat16, seed=0),
                       torch.float8_e4m3fn)
    against_bf16("fp8 weight-only", forward(dit))
    check(results["fp8 weight-only"][0] < 0.10, "fp8 weight-only over the 0.10 mean-abs bar")
    check(results["int8 weight-only"][0] < 0.05, "int8 weight-only over the 0.05 mean-abs bar")
    check(results["int8 w8a8"][1] < 0.2, "int8 w8a8 over the 0.2 norm bar")
    del dit, ref, hidden, text
    gc.collect()
    torch.cuda.empty_cache()
    return results


def quantized_request(pipe, video, dev, name):
    """One 41x480x720 reconstruction request on a quantized pipeline: shapes,
    finite values, the RGB range, 168 K1 and K2 launches, K5 at its count,
    and 4 x 42 x 4 = 672 int8 products with int8 activations (qkv, o, w1, w2
    of every block and step), none without them. Returns (result, seconds,
    peak GiB)."""
    from aether_tpu_torch.models.dit import int8_mm
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue
    from aether_tpu_torch.ops.flash_attention import flash_attention_prepacked
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments

    counted = (qkv_prologue, flash_attention_prepacked, groupnorm_moments, int8_mm)
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = pipe(task="reconstruction", video=video, height=HEIGHT, width=WIDTH,
               num_frames=FRAMES, num_inference_steps=STEPS, fps=12, seed=42)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    counts = [fn.launches for fn in counted]
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in res.stage_seconds.items())
    log(f"{name}: {wall:.3f} s ({stages}); K1/K2/K5/int8 product launches "
        f"{'/'.join(map(str, counts))}; peak memory {peak:.2f} GiB")
    n = pipe.config.dit.num_layers * STEPS
    a8 = 4 * n if pipe.act_quant else 0
    check(counts == [n, n, expected_k5(pipe, FRAMES), a8],
          f"{name}: expected {n} K1 and K2, {expected_k5(pipe, FRAMES)} K5 and {a8} int8 "
          "product launches")
    check_request(res, FRAMES, name)
    return res, wall, peak


def same_outputs(a, b, what):
    for field in ("rgb", "disparity", "raymap"):
        check(np.array_equal(getattr(a, field), getattr(b, field)), f"{what}: {field} differs")
    log(f"{what}: bit-identical outputs")


def quantized_requests_phase(cfg, video, dev):
    """The deployment weight formats end to end: two int8 w8a8 requests
    (bit-identical), the int8 pipeline saved with ``save_checkpoint`` and
    built again through the demo's ``build_pipeline`` (``--checkpoint``; one request,
    bit-identical to the first), then two fp8 weight-only requests
    (bit-identical). Returns {name: (seconds, peak GiB, DiT GiB)}."""
    from aether_tpu_torch.apps import demo
    from aether_tpu_torch.io.weights import save_checkpoint

    times = {}
    for label, codes in (("int8 w8a8", torch.int8), ("fp8 weight-only", torch.float8_e4m3fn)):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        pipe = make_pipeline(cfg, dev, codes)
        torch.cuda.synchronize()
        dit_bytes = sum(t.numel() * t.element_size()
                        for t in list(pipe.dit.parameters()) + list(pipe.dit.buffers()))
        log(f"{label} pipeline: built in {time.perf_counter() - t0:.3f} s, DiT "
            f"{dit_bytes / 2**30:.3f} GiB resident (codes, scales, biases, norms), "
            f"{(torch.cuda.memory_allocated(dev) - base) / 2**30:.3f} GiB with the VAE and "
            f"prompt, act_quant {pipe.act_quant}")
        outs = []
        for req in range(2):
            res, wall, peak = quantized_request(pipe, video, dev, f"{label} request {req}")
            outs.append(res)
        same_outputs(outs[0], outs[1], f"{label} requests 0 and 1")
        times[label] = (wall, peak, dit_bytes / 2**30)
        # the demo's --random-init builds the same DiT on the card
        init = "aetherv1-" + ("int8" if codes == torch.int8 else "fp8")
        demo_pipe, _ = demo.build_pipeline(demo.parse_args(
            ["--task", "reconstruction", "--random-init", init, "--device", str(dev)]))
        want = pipe.dit.state_dict()
        got = demo_pipe.dit.state_dict()
        check(demo_pipe.act_quant == pipe.act_quant and set(got) == set(want) and all(
            got[k].dtype == want[k].dtype and torch.equal(got[k].view(torch.uint8),
                                                          want[k].view(torch.uint8))
            for k in want), f"--random-init {init} does not build this DiT")
        log(f"--random-init {init}: the demo builds the same DiT on the card, "
            f"act_quant {demo_pipe.act_quant}")
        del demo_pipe, want, got
        if codes == torch.int8:
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                save_checkpoint(tmp, pipe.dit.state_dict(), pipe.vae.state_dict(),
                                pipe.empty_prompt_embeds[0].float().cpu().numpy())
                save_s = time.perf_counter() - t0
                del pipe
                gc.collect()
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                args = demo.parse_args(["--task", "reconstruction", "--checkpoint", tmp,
                                        "--config", "aetherv1", "--device", str(dev)])
                pipe, _ = demo.build_pipeline(args)
                torch.cuda.synchronize()
                log(f"checkpoint round trip: saved in {save_s:.3f} s "
                    f"({sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp)) / 2**30:.3f}"
                    f" GiB), built through the demo's build_pipeline (--checkpoint) in "
                    f"{time.perf_counter() - t0:.3f} s, act_quant {pipe.act_quant}")
                res, wall, peak = quantized_request(pipe, video, dev,
                                                    "int8 request from the checkpoint")
            same_outputs(outs[0], res, "the checkpoint's request and int8 request 0")
            times["int8 from the checkpoint"] = (wall, peak, dit_bytes / 2**30)
        del pipe, outs, res
    gc.collect()
    torch.cuda.empty_cache()
    return times


def variants_phase(dev, gen):
    """K7, K8 and K9 against their plain versions at (1, 48, 15076, 64)
    bf16, one launch a call, at ``bf16_gates``; a padfix without its
    correction must fail them. Each case is timed through its wrapper and,
    on the operands the wrapper prepares, its kernel alone; one bf16
    ``scaled_dot_product_attention`` call at the same shape is timed in the
    same phase. Returns ({kernel: (max abs error over its cases, kernel ms,
    plain ms)}, {case: (wrapper ms, alone ms, at 1024x1024)}, SDPA ms); the
    kernel ms are those of the wrapper's defaults at 1024x1024 (K8 at hper
    4)."""
    from aether_tpu_torch.ops.flash_variants import (
        _kernel_launch,
        _kernel_operands,
        _mh_args,
        _v2_args,
        _v2_seq_pad,
        _x_args,
        flash_mh,
        flash_mh_plain,
        flash_v2,
        flash_v2_plain,
        flash_x,
        flash_x_plain,
    )

    shape = (1, HEADS, SEQ, HEAD_DIM)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    blocks = dict(block_q=1024, block_k=1024)
    v2 = ("K7", flash_v2, flash_v2_plain, _v2_args)
    mh = ("K8", flash_mh, flash_mh_plain, _mh_args)
    fx = ("K9", flash_x, flash_x_plain, _x_args)
    cases = [(*v2, blocks), (*v2, dict(blocks, kt=True)),
             (*v2, dict(blocks, mask_last_only=False)),
             (*mh, dict(blocks, hper=4)), (*mh, dict(blocks, hper=1))]
    cases += [(*fx, dict(blocks, mode=m)) for m in ("fold", "fold2", "padfix", "padfix_exp")]
    cases.append((*fx, dict(block_q=1024, block_k=256, mode="padfix")))
    flops = 4.0 * HEADS * SEQ * SEQ * HEAD_DIM
    results, times = {}, {}
    for kname, fn, plain, args_of, kw in cases:
        name = f"{kname} {fn.__name__}({', '.join(f'{a}={b}' for a, b in kw.items())})"
        before = fn.launches
        out, ref = fn(q, k, v, **kw), plain(q, k, v, **kw)
        torch.cuda.synchronize()
        check(fn.launches == before + 1, f"{name}: {fn.launches - before} launches, not 1")
        bars = bf16_gates(ref)
        err = compare(name, out, ref, *bars)
        if kw.get("mode") == "padfix":
            # the gates must see a padfix that leaves out its correction
            bad = (padfix_uncorrected(q, k, v, _v2_seq_pad(SEQ, kw["block_q"], kw["block_k"]))
                   .float() - ref.float()).abs()
            log(f"{name} without its correction: max abs err {bad.max().item():.3e}, "
                f"mean abs err {bad.mean().item():.3e}")
            check(bad.max().item() > bars[0] or bad.mean().item() > bars[1],
                  f"{name}: the gates cannot tell a padfix without its correction")
            del bad
        ms, plain_ms = time_pair(name, lambda: fn(q, k, v, **kw),
                                 lambda: plain(q, k, v, **kw), flops)
        # the kernel alone on the operands its wrapper prepares
        args = args_of(q, **kw)
        ops = _kernel_operands(q, k, v, args)
        buf = torch.empty_like(ops[0])
        alone_ms = cuda_time_ms(lambda: _kernel_launch(*ops, buf, args), 5)
        torch.cuda.synchronize()
        check(torch.equal(buf.view(shape), out), f"{name}: the kernel alone differs")
        log(f"{name} kernel alone: {alone_ms:.4f} ms ({flops / alone_ms / 1e9:.1f} TFLOP/s); "
            f"the wrapper's passes {ms - alone_ms:.4f} ms")
        times[name] = (ms, alone_ms, kw["block_q"] == kw["block_k"] == 1024)
        if kname in results:
            results[kname] = (max(results[kname][0], err), *results[kname][1:])
        else:
            results[kname] = (err, ms, plain_ms)
        del out, ref, ops, buf
    del q, k, v
    torch.cuda.empty_cache()
    sdpa = sdpa_ms(dev, gen, 1, torch.bfloat16)
    log(f"phase 13 scaled_dot_product_attention bf16 (1, 48, 15076, 64): {sdpa:.4f} ms; "
        + "; ".join(f"{n} {ms / sdpa:.3f}x (alone {a / sdpa:.3f}x)"
                    for n, (ms, a, _) in times.items()))
    return results, times, sdpa


def bench_phase():
    """The three bench entry points once each at full shape; every maxdiff
    within four bf16 ulps of the scale of the part of the K4 baseline it
    reads (twice ``bf16_gates``' max: two kernels, each with its own
    rounding). Returns the launches of K7, K8 and K9 in their runs."""
    from aether_tpu_torch.bench import flash_bisect, flash_multihead, flash_variants
    from aether_tpu_torch.bench._harness import LINE, make_qkv, max_diff
    from aether_tpu_torch.ops.flash_attention import flash_attention
    from aether_tpu_torch.ops.flash_variants import _v2_seq_pad, flash_mh, flash_v2, flash_x

    # the benches' own inputs and baseline, for the scale of what maxdiff reads
    q, k, v = make_qkv(torch.device("cuda", 0))
    base = flash_attention(q, k, v, block_q=1024, block_k=1024)
    bars = {m: 2 * bf16_gates(m.compared(base))[0]
            for m in (flash_variants, flash_multihead, flash_bisect)}
    # the gate must see padfix at the sweep's largest pad without its correction
    bad = max_diff(flash_bisect.compared(padfix_uncorrected(q, k, v, _v2_seq_pad(SEQ, 2048, 512))),
                   flash_bisect.compared(base).float())
    log(f"padfix 2048x512 without its correction: maxdiff {bad:.3e} against the K4 "
        f"baseline (gate {bars[flash_bisect]:.3e})")
    check(bad > bars[flash_bisect], "the bench gate cannot tell a padfix without its correction")
    del q, k, v, base

    iters = 5
    launches = {}
    # (kernel, module, wrapper, configuration-line prefix, calls a configuration,
    #  lines that must fail)
    runs = (("K7", flash_variants, flash_v2, "v2 ", 2 + iters, {"v2 2048x1024 kt=0"}),
            ("K8", flash_multihead, flash_mh, "mh ", 1 + iters, set()),
            ("K9", flash_bisect, flash_x, "", 1 + iters, set()))
    for kname, module, fn, prefix, calls, must_fail in runs:
        fn.launches = 0
        t0 = time.perf_counter()
        lines = module.main(["--iters", str(iters)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[kname] = fn.launches
        parsed = [LINE.match(line) for line in lines]
        check(all(parsed), f"{module.__name__}: unparsed lines "
              f"{[ln for ln, m in zip(lines, parsed) if not m]}")
        failed = {m["name"] for m in parsed if m["exc"]}
        check(failed == must_fail, f"{module.__name__}: FAILED {failed}, expected {must_fail}")
        configs = [m for m in parsed[1:] if m["name"].startswith(prefix) and not m["exc"]
                   and "library" not in m["name"]]
        check(launches[kname] == len(configs) * calls,
              f"{module.__name__}: {launches[kname]} launches, expected "
              f"{len(configs)} x {calls}")
        worst = max(float(m["err"]) for m in parsed if m["err"] is not None)
        check(worst <= bars[module], f"{module.__name__}: maxdiff {worst:.3e} against the "
              f"K4 baseline, gate {bars[module]:.3e}")
        log(f"bench {module.__name__}: {len(lines)} lines parsed, {len(configs)} "
            f"configurations, {kname} launches {launches[kname]}, worst maxdiff "
            f"{worst:.3e} (gate {bars[module]:.3e}), {wall:.3f} s")
    return launches


def tp_inputs(dev):
    """Phase 22 (b)'s seeded AetherV1-width DiT cut to 2 blocks (48 heads x
    64, depth cut, not width) and its inputs on ``dev``: the 15076-token
    window's video (14850) and text (226) tokens, a time embedding, and the
    joint RoPE tables (identity over the text)."""
    from aether_tpu_torch.config import PipelineConfig
    from aether_tpu_torch.models import init_dit
    from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings

    cfg = dataclasses.replace(PipelineConfig.aetherv1().dit, num_layers=TP_BLOCKS)
    model = init_dit(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    d = cfg.hidden_size
    video, text = (torch.randn((1, n, d), generator=gen, device=dev).to(torch.bfloat16)
                   for n in (SEQ - TEXT, TEXT))
    temb = torch.randn((1, cfg.time_embed_dim), generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = prepare_rotary_positional_embeddings(
        cfg, HEIGHT, WIDTH, (FRAMES - 1) // 4 + 1, vae_scale_factor_spatial=8, base_fps=12,
        fps=12)
    rc = torch.cat([torch.ones(TEXT, HEAD_DIM), torch.from_numpy(cos)]).to(dev)
    rs = torch.cat([torch.zeros(TEXT, HEAD_DIM), torch.from_numpy(sin)]).to(dev)
    return model, (video, text, temb, rc, rs)


def blocks_forward(model, video, text, temb, rc, rs):
    """The model's blocks on the fused path (K1 + K2, int8 QK^T)."""
    opts = dict(fixed_max=True, qk_int8=True, pv_int8=False)
    with torch.no_grad():
        for block in model.blocks:
            video, text = block(video, text, temb, rc, rs, "fused", opts)
    return video, text


def tp_rank():
    """Phase 22 (b) on one of two ranks that share cuda:0 over gloo: the
    2-block DiT split at tp = 2 (24 heads a rank), one forward of its blocks
    (timed with both ranks running, after a warm-up), the K1 / K2 launches of
    that forward, one gloo all-reduce of an f32 block output timed alone,
    and on rank 0 alone (rank 1 waiting) K1 and K2 at 24 heads against their
    plain versions, timed."""
    import torch.distributed as dist

    from aether_tpu_torch.ops.attn_prologue import qkv_prologue, qkv_prologue_plain
    from aether_tpu_torch.ops.flash_attention import (
        flash_attention_prepacked,
        flash_attention_prepacked_plain,
    )
    from aether_tpu_torch.parallel import make_mesh, shard_params

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                            f"{os.environ['MASTER_PORT']}", rank=rank, world_size=TP_RANKS)
    torch.backends.cuda.matmul.allow_tf32 = False
    model, inputs = tp_inputs(dev)
    mesh = make_mesh(dp=1, tp=TP_RANKS)
    shard_params(model, mesh)
    blocks_forward(model, *inputs)  # warm-up
    dist.barrier()
    qkv_prologue.launches = flash_attention_prepacked.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    video, text = blocks_forward(model, *inputs)
    torch.cuda.synchronize()
    out = dict(forward_s=time.perf_counter() - t0, k1=qkv_prologue.launches,
               k2=flash_attention_prepacked.launches, video=video.cpu(), text=text.cpu(),
               heads=model.blocks[0].attn.qkv.weight.shape[0] // 3 // HEAD_DIM)
    partial = torch.randn((1, SEQ, model.cfg.hidden_size), device=dev)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(partial)
    torch.cuda.synchronize()
    out["all_reduce_s"] = time.perf_counter() - t0
    dist.barrier()
    if rank == 0:
        heads = out["heads"]
        d = heads * HEAD_DIM
        gen = torch.Generator(device=dev)
        gen.manual_seed(1234)
        y = torch.randn((1, 15360, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
        y[:, SEQ:] = 0
        norms = [1.0 + 0.1 * torch.randn(HEAD_DIM, generator=gen, device=dev),
                 0.1 * torch.randn(HEAD_DIM, generator=gen, device=dev),
                 1.0 + 0.1 * torch.randn(HEAD_DIM, generator=gen, device=dev),
                 0.1 * torch.randn(HEAD_DIM, generator=gen, device=dev)]
        args = (y[..., :d], y[..., d:2 * d], y[..., 2 * d:], *norms, *inputs[3:])
        kw = dict(num_heads=heads, head_dim=HEAD_DIM, eps=model.cfg.qk_norm_eps, s_valid=SEQ)
        got = qkv_prologue(*args, **kw)
        out["k1_err"] = k1_int8_gates(f"K1 at {heads} heads", got, qkv_prologue_plain(*args, **kw))
        out["k1_ms"] = cuda_time_ms(lambda: qkv_prologue(*args, **kw), 20)
        q8, k8, v, qsc, qn, ksc, kn, _ = got
        kw2 = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=SEQ)
        o = flash_attention_prepacked(q8, k8, v, **kw2)
        out["k2_err"] = compare(f"K2 at {heads} heads", o,
                                flash_attention_prepacked_plain(q8, k8, v, **kw2), 1e-2, 1e-3)
        out["k2_ms"] = cuda_time_ms(lambda: flash_attention_prepacked(q8, k8, v, **kw2), 5)
    dist.barrier()
    dist.destroy_process_group()
    return out


def parallel_phase(pipe, cfg, dev, video, first, k5_per_request):
    """Phase 22, the parallel layer on the one card. (a) a process group of
    one rank through NCCL, ``make_mesh()`` and the phase-6 request through
    the pipeline built over it at full width and depth: bit-identical to
    phase 6's, launches as phase 6 counts them. (b) two spawned ranks sharing
    the card over gloo, the 2-block AetherV1-width DiT at tp = 2
    (:func:`tp_rank`), against the one-process forward of the same blocks at
    the gates of ``bf16_gates``, with exactly 2 K1 and 2 K2 launches a rank.
    (c) the ring's step and merge (``ring_attention_stripes``) over the sp = 4
    stripes of a seeded (1, 48, 15076, 64) bf16 window, padded to 4 x 3840
    rows so that the exact pad correction is taken, against one normalized
    K3 call over the whole sequence at K3's gates, int8 and bf16 QK^T, both
    timed. Returns (launches of each kernel, (a)'s request seconds, (b)'s
    launches and times, (c)'s {name: (K3 launches, error, ring ms, K3 ms)})."""
    import torch.distributed as dist

    from aether_tpu_torch.ops.attn_prologue import qkv_prologue
    from aether_tpu_torch.ops.flash_attention import (
        flash_attention_fixed_max,
        flash_attention_prepacked,
        ring_attention_stripes,
    )
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments
    from aether_tpu_torch.parallel import make_mesh
    from aether_tpu_torch.parallel.launch import free_port, spawn
    from aether_tpu_torch.pipeline import AetherPipeline

    # (a) world size 1 through NCCL
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh()
        sharded = AetherPipeline(cfg, pipe.dit, pipe.vae, pipe.empty_prompt_embeds, device=dev,
                                 compute_dtype=torch.bfloat16, mesh=mesh)
        log(f"phase 22a: backend {dist.get_backend()}, mesh {mesh.mesh_dim_names} "
            f"{tuple(mesh.shape)}, set up in {time.perf_counter() - t0:.3f} s")
        qkv_prologue.launches = flash_attention_prepacked.launches = 0
        groupnorm_moments.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sharded(task="reconstruction", video=video, height=HEIGHT, width=WIDTH,
                      num_frames=FRAMES, num_inference_steps=STEPS, fps=12, seed=42)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": qkv_prologue.launches, "K2": flash_attention_prepacked.launches,
                    "K5": groupnorm_moments.launches}
    finally:
        pipe.dit.mesh = None  # the phase-5 pipeline runs without a mesh again
        dist.destroy_process_group()
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in res.stage_seconds.items())
    log(f"phase 22a request through the mesh at world size 1: {wall:.3f} s ({stages}); "
        f"launches {launches}")
    check(launches == {"K1": cfg.dit.num_layers * STEPS, "K2": cfg.dit.num_layers * STEPS,
                       "K5": k5_per_request}, "phase 22a launches differ from phase 6's")
    for name in ("rgb", "disparity", "raymap"):
        check(np.array_equal(getattr(res, name), getattr(first, name)),
              f"phase 22a {name} is not bit-identical to phase 6's request")
    log("phase 22a: bit-identical to phase 6's request 0")
    del res, sharded

    # (b) tp = 2 at full width: two ranks sharing the card over gloo
    model, inputs = tp_inputs(dev)
    torch.cuda.synchronize()
    ref_video, ref_text = blocks_forward(model, *inputs)
    t0 = time.perf_counter()
    ref_video, ref_text = blocks_forward(model, *inputs)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    del model, inputs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:tp_rank", TP_RANKS, {}, timeout=300,
                  extra_path=[os.path.dirname(os.path.abspath(__file__))])
    log(f"phase 22b: {TP_RANKS} ranks over gloo on cuda:0, {time.perf_counter() - t0:.3f} s "
        f"with their start-up")
    for rank, got in enumerate(ranks):
        check(got["heads"] == HEADS // TP_RANKS, f"rank {rank} holds {got['heads']} heads")
        check(got["k1"] == got["k2"] == TP_BLOCKS,
              f"rank {rank}: {got['k1']} K1 and {got['k2']} K2 launches, not {TP_BLOCKS}")
        for name, out, ref in (("video", got["video"], ref_video), ("text", got["text"], ref_text)):
            compare(f"phase 22b rank {rank} {name} at tp = {TP_RANKS}", out.to(dev), ref,
                    *bf16_gates(ref))
        log(f"phase 22b rank {rank}: {TP_BLOCKS}-block forward {got['forward_s'] * 1e3:.3f} ms "
            f"(both ranks on the card at once), one gloo all-reduce of a (1, {SEQ}, 3072) f32 "
            f"block output {got['all_reduce_s'] * 1e3:.3f} ms; the one-process forward "
            f"{one_s * 1e3:.3f} ms")
    log(f"phase 22b K1 at {HEADS // TP_RANKS} heads {ranks[0]['k1_ms']:.4f} ms (max code "
        f"diff {ranks[0]['k1_err']}), K2 {ranks[0]['k2_ms']:.4f} ms (max abs err "
        f"{ranks[0]['k2_err']:.3e}); rank 0 alone on the card, rank 1 waiting")
    tp = {"K1": sum(got["k1"] for got in ranks), "K2": sum(got["k2"] for got in ranks),
          "forward_s": [got["forward_s"] for got in ranks], "one_s": one_s,
          "k1_ms": ranks[0]["k1_ms"], "k2_ms": ranks[0]["k2_ms"]}
    del ref_video, ref_text, ranks

    # (c) the ring's arithmetic over the sp = 4 stripes of the real window
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    q, k, v = (torch.randn((1, HEADS, SEQ, HEAD_DIM), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    seq_pad = -(-SEQ // (SP_STRIPES * 128)) * SP_STRIPES * 128
    rows = seq_pad // SP_STRIPES
    stripes = [[torch.nn.functional.pad(t, (0, 0, 0, seq_pad - SEQ))[:, :, i * rows:(i + 1) * rows]
                .contiguous() for i in range(SP_STRIPES)] for t in (q, k, v)]
    ring = {}
    for qk_int8 in (True, False):
        name = f"ring sp={SP_STRIPES} {'int8' if qk_int8 else 'bf16'} QK^T"

        def run(qk_int8=qk_int8):
            return ring_attention_stripes(*stripes, n_pad=seq_pad - SEQ, qk_int8=qk_int8)

        ref = flash_attention_fixed_max(q, k, v, qk_int8=qk_int8)
        flash_attention_fixed_max.launches = 0
        out = torch.cat(run(), dim=2)[:, :, :SEQ]
        n = flash_attention_fixed_max.launches
        check(n == SP_STRIPES ** 2, f"{name}: {n} K3 launches, not {SP_STRIPES ** 2}")
        err = compare(f"{name} against one K3 call", out, ref, 1e-2, 1e-3)
        ms = cuda_time_ms(run, 3)
        k3 = cuda_time_ms(lambda: flash_attention_fixed_max(q, k, v, qk_int8=qk_int8), 3)
        log(f"{name}: {ms:.4f} ms for {n} K3 steps and the merge (stripes of {rows} rows, "
            f"{seq_pad - SEQ} pad rows corrected), one K3 call {k3:.4f} ms: {ms / k3:.3f}x")
        ring[name] = (n, err, ms, k3)
        del ref, out
    del q, k, v, stripes
    torch.cuda.empty_cache()
    return {"K1": launches["K1"] + tp["K1"], "K2": launches["K2"] + tp["K2"],
            "K5": launches["K5"], "K3": sum(r[0] for r in ring.values())}, wall, tp, ring


def par_train_inputs(batch):
    """Phase 23's DiT config (the AetherV1 width, 48 heads x 64, cut to
    ``PAR_TRAIN_BLOCKS`` blocks), its TrainConfig (remat, ``flash_train``;
    lr 1e-3 from the first update, so that one step moves the weights past
    the tolerance) and one seeded synthetic 41x480x720 batch (15076 tokens)
    of ``batch`` rows."""
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.train.trainer import TrainConfig, synthetic_batches

    cfg = dataclasses.replace(DiTConfig.aetherv1(), num_layers=PAR_TRAIN_BLOCKS)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=100, remat=True,
                       attn_impl="flash_train", log_every=1)
    f_lat, h_lat, w_lat = (FRAMES - 1) // 4 + 1, HEIGHT // 8, WIDTH // 8
    host = next(synthetic_batches(cfg, batch_size=batch, f_lat=f_lat, h_lat=h_lat,
                                  w_lat=w_lat, seed=23))
    return cfg, tcfg, host


def train_steps(trainer, host, steps):
    """``steps`` Trainer steps, each on ``host``: (losses, seconds a step)."""
    losses, secs = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += trainer.fit(iter([host]), steps=1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return losses, secs


def gloo_rank(world):
    """Join a gloo group of ``world`` ranks sharing cuda:0 (NCCL refuses two
    ranks on one card); returns (device, rank)."""
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.init()  # before the peak-memory counters are reset
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                            f"{os.environ['MASTER_PORT']}", rank=rank, world_size=world)
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev, rank


# phase 23 (b): unsharded name -> this rank's parameter: a column split (its
# heads' rows of the fused qkv), a row split (its columns of attn.o) and a
# leaf whole on every rank (the time embedding)
TP_GRADS = {"blocks.0.attn.qkv.weight": "blocks.0.attn.qkv.weight",
            "blocks.0.attn.o.weight": "blocks.0.attn.o.inner.weight",
            "time_embed.w1.weight": "time_embed.w1.weight"}
FSDP_WEIGHT = "blocks.0.mlp.w1.weight"  # phase 23 (c)'s updated weight


def gloo_train_rank():
    """Phase 23 (b) and (c) on one of two ranks sharing cuda:0 over gloo:
    {"tp": :func:`tp_train_part`, "fsdp": :func:`fsdp_train_part`}."""
    import torch.distributed as dist

    dev, rank = gloo_rank(2)
    out = {"tp": tp_train_part(dev, rank)}
    gc.collect()
    torch.cuda.empty_cache()
    out["fsdp"] = fsdp_train_part(dev)
    dist.barrier()
    dist.destroy_process_group()
    return out


def tp_train_part(dev, rank):
    """Phase 23 (b): the 2-block AetherV1-width Trainer at tp = 2 (24 heads
    a rank), one step on the batch-1 input; the loss, the step's seconds and
    K4 f32 launches, the gradients of ``TP_GRADS`` (after the clip), the peak
    memory; then rank 0 alone (rank 1 waiting) K4 f32 at 24 heads against
    its plain version, timed."""
    import torch.distributed as dist

    from aether_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from aether_tpu_torch.parallel import make_mesh
    from aether_tpu_torch.train.trainer import Trainer

    cfg, tcfg, host = par_train_inputs(1)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(cfg, tcfg, device=dev, seed=0,
                      mesh=make_mesh(dp=1, tp=TP_RANKS, device_type="cuda"))
    named = dict(trainer.state.model.named_parameters())
    dist.barrier()
    flash_attention.launches = 0
    losses, secs = train_steps(trainer, host, 1)
    out = dict(loss=losses[0], step_s=secs[0], k4=flash_attention.launches,
               peak=torch.cuda.max_memory_allocated(dev),
               heads=named["blocks.0.attn.qkv.weight"].shape[0] // 3 // HEAD_DIM,
               grads={n: named[local].grad.detach().cpu() for n, local in TP_GRADS.items()})
    del trainer, named
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(1234)
        shape = (1, HEADS // TP_RANKS, SEQ, HEAD_DIM)
        q, k, v = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
        out["k4_err"] = compare(f"K4 f32 at {shape[1]} heads", flash_attention(q, k, v),
                                flash_attention_plain(q, k, v), 1e-4, 1e-4)
        out["k4_ms"] = cuda_time_ms(lambda: flash_attention(q, k, v), 3)
        out["k4_plain_ms"] = cuda_time_ms(lambda: flash_attention_plain(q, k, v), 1)
        del q, k, v
    dist.barrier()
    return out


def fsdp_train_part(dev):
    """Phase 23 (c): the 2-block AetherV1-width Trainer at dp = 2 with FSDP,
    one step on the batch-2 input (a row a rank); the loss, the clip's
    global gradient norm, the step's seconds and K4 f32 launches, the peak
    memory, this rank's resident parameter bytes, and on rank 0
    ``FSDP_WEIGHT`` gathered after the step."""
    import torch.distributed as dist

    from aether_tpu_torch.ops.flash_attention import flash_attention
    from aether_tpu_torch.parallel import make_mesh
    from aether_tpu_torch.parallel.mesh import local_view
    from aether_tpu_torch.train.trainer import Trainer

    cfg, tcfg, host = par_train_inputs(2)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(cfg, tcfg, device=dev, seed=0, fsdp=True,
                      mesh=make_mesh(dp=2, tp=1, device_type="cuda"))
    model = trainer.state.model
    resident = sum(local_view(p).numel() * p.element_size() for p in model.parameters())
    dist.barrier()
    flash_attention.launches = 0
    losses, secs = train_steps(trainer, host, 1)
    named = dict(model.named_parameters())
    weight = trainer.layout.gather(lambda n: named[n] if n == FSDP_WEIGHT else None)
    return dict(loss=losses[0], step_s=secs[0], k4=flash_attention.launches,
                grad_norm=float(trainer.state.optimizer.grad_norm),
                peak=torch.cuda.max_memory_allocated(dev), resident=resident,
                weight=weight.get(FSDP_WEIGHT))


def close(name, got, want, rtol, atol):
    """|got - want| <= atol + rtol |want| everywhere (numpy's allclose);
    returns the largest absolute difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    check(bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want))),
          f"{name}: max abs diff {err:.3e} beyond rtol {rtol} / atol {atol}")
    return err


def parallel_train_phase(dev):
    """Phase 23, the parallel trainer on the one card, at the AetherV1 width
    cut to 2 blocks (remat, ``flash_train``: K4 f32 forward). (a) a process
    group of one rank through NCCL and ``make_pp_mesh(1, 1)``: the Trainer at
    ``pp_microbatches=2``, batch 2, two steps, against the same Trainer
    without a mesh in this run (losses rtol 2e-4 / atol 2e-5, every
    parameter rtol 5e-4 / atol 5e-5: ``tests/test_fsdp.py:102-109``), K4
    launches exact (a step: 2 blocks x the forward and remat's recompute, x 2
    microbatches under pp). (b) :func:`tp_train_part` on two ranks against
    one process at batch 1: the loss (rtol 2e-4 / atol 2e-5) and each rank's
    piece of three gradients within 1e-5 of the reference's largest
    magnitude (f32 sums in another order), 4 K4 launches a rank. (c)
    :func:`fsdp_train_part` on the same two ranks (one spawn,
    :func:`gloo_train_rank`) against (a)'s one-process first
    step at batch 2: the loss, the clip's global gradient norm (rtol 1e-4),
    ``FSDP_WEIGHT`` after the step (rtol 5e-4 / atol 5e-5), each rank's
    resident parameter bytes 0.45-0.55 of the whole model's. Returns the K4
    f32 launches of its Trainer runs."""
    import torch.distributed as dist

    from aether_tpu_torch.ops.flash_attention import flash_attention
    from aether_tpu_torch.parallel.launch import free_port, spawn
    from aether_tpu_torch.parallel.mesh import _qkv_rows
    from aether_tpu_torch.parallel.pipeline import make_pp_mesh
    from aether_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    launches = 0

    def counted_run(trainer, host, steps, name):
        nonlocal launches
        flash_attention.launches = 0
        losses, secs = train_steps(trainer, host, steps)
        n = flash_attention.launches
        launches += n
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"phase 23{name}: " + ", ".join(f"{t:.3f}" for t in secs) + f" s a step "
            f"(batch {host['clean_latents'].shape[0]}), losses "
            + ", ".join(f"{x:.6f}" for x in losses) + f", K4 f32 launches {n}; peak memory "
            f"{peak:.2f} GiB")
        return losses, n

    # (a) pp at world size 1 through NCCL, against no mesh
    cfg, tcfg, host = par_train_inputs(2)
    per_step = 2 * PAR_TRAIN_BLOCKS  # a block's forward and its recompute
    torch.cuda.reset_peak_memory_stats(dev)
    ref = Trainer(cfg, tcfg, device=dev, seed=0)
    init = {n: p.detach().cpu().clone() for n, p in ref.state.model.named_parameters()}
    ref_losses, n = counted_run(ref, host, 1, "a no mesh step 1")
    check(n == per_step, f"phase 23a: {n} K4 launches, not {per_step}")
    first = (ref_losses[0], ref.state.model.get_parameter(FSDP_WEIGHT).detach().cpu().clone(),
             float(ref.state.optimizer.grad_norm))
    more, n = counted_run(ref, host, PAR_TRAIN_STEPS - 1, "a no mesh")
    ref_losses += more
    check(n == per_step * (PAR_TRAIN_STEPS - 1), "phase 23a: K4 launches of the second step")
    ref_params = {n: p.detach().cpu().clone() for n, p in ref.state.model.named_parameters()}
    full_bytes = sum(p.numel() * p.element_size() for p in ref.state.model.parameters())
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_pp_mesh(1, 1)
        torch.cuda.reset_peak_memory_stats(dev)
        pp = Trainer(cfg, tcfg, device=dev, seed=0, mesh=mesh, pp_microbatches=2)
        pp_losses, n = counted_run(pp, host, PAR_TRAIN_STEPS, "a pp mesh")
        check(n == 2 * per_step * PAR_TRAIN_STEPS,
              f"phase 23a: {n} K4 launches under pp, not {2 * per_step * PAR_TRAIN_STEPS}")
        state = pp.gathered_state()
        del pp
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    loss_err = close("phase 23a losses, pp against no mesh", pp_losses, ref_losses, 2e-4, 2e-5)
    param_err = max(close(f"phase 23a {name}", state["params"][name], want, 5e-4, 5e-5)
                    for name, want in ref_params.items())
    moved = sum(int(not torch.equal(ref_params[n], init[n])) for n in init)
    check(moved >= 0.9 * len(init), f"phase 23a: only {moved}/{len(init)} tensors moved")
    log(f"phase 23a: backend nccl, mesh ('dp', 'pp') (1, 1), {PAR_TRAIN_STEPS} steps at "
        f"pp_microbatches 2 against no mesh: losses max abs diff {loss_err:.3e}, every "
        f"parameter max abs diff {param_err:.3e}; {moved}/{len(init)} tensors moved")
    w0 = init[FSDP_WEIGHT]
    del state, init

    # (b) tp = 2 over gloo, against one process at batch 1
    cfg, tcfg, host1 = par_train_inputs(1)
    torch.cuda.reset_peak_memory_stats(dev)
    one = Trainer(cfg, tcfg, device=dev, seed=0)
    (one_loss,), n = counted_run(one, host1, 1, "b one process")
    check(n == per_step, f"phase 23b: {n} K4 launches in one process, not {per_step}")
    named = dict(one.state.model.named_parameters())
    want = {name: named[name].grad.detach().cpu().clone() for name in TP_GRADS}
    del one, named
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    both = spawn("chip_smoke:gloo_train_rank", TP_RANKS, {}, timeout=600,
                 extra_path=[os.path.dirname(os.path.abspath(__file__))])
    log(f"phase 23b-c: {TP_RANKS} ranks over gloo on cuda:0, {time.perf_counter() - t0:.3f} s "
        f"with their start-up (gloo all-gathers and reduce-scatters CUDA tensors in this "
        f"torch {torch.__version__})")
    ranks = [got["tp"] for got in both]
    d = cfg.hidden_size
    for rank, got in enumerate(ranks):
        check(got["heads"] == HEADS // TP_RANKS, f"phase 23b rank {rank}: {got['heads']} heads")
        check(got["k4"] == per_step, f"phase 23b rank {rank}: {got['k4']} K4 launches")
        launches += got["k4"]
        close(f"phase 23b rank {rank} loss", [got["loss"]], [one_loss], 2e-4, 2e-5)
        pieces = {"blocks.0.attn.qkv.weight": (_qkv_rows(3 * d, rank, TP_RANKS),),
                  "blocks.0.attn.o.weight": (slice(None), slice(rank * d // TP_RANKS,
                                                               (rank + 1) * d // TP_RANKS)),
                  "time_embed.w1.weight": ()}
        errs = []
        for name, index in pieces.items():
            ref_g = want[name][index]
            err = (got["grads"][name] - ref_g).abs().max().item() / ref_g.abs().max().item()
            check(err <= 1e-5, f"phase 23b rank {rank} {name}: gradient error {err:.3e} of "
                  f"its largest magnitude")
            errs.append(f"{name} {err:.3e}")
        log(f"phase 23b rank {rank}: one step {got['step_s']:.3f} s (both ranks on the card "
            f"at once), loss {got['loss']:.6f} against {one_loss:.6f}, gradient error / max "
            f"|grad|: " + ", ".join(errs) + f"; K4 f32 launches {got['k4']}; peak memory "
            f"{got['peak'] / 2**30:.2f} GiB")
    log(f"phase 23b K4 f32 at {HEADS // TP_RANKS} heads (1, {HEADS // TP_RANKS}, {SEQ}, "
        f"{HEAD_DIM}): {ranks[0]['k4_ms']:.4f} ms, plain {ranks[0]['k4_plain_ms']:.4f} ms, max "
        f"abs err {ranks[0]['k4_err']:.3e}; rank 0 alone on the card, rank 1 waiting")
    del ranks, want

    # (c) dp = 2 with FSDP over gloo, against (a)'s first step in one process
    ranks = [got["fsdp"] for got in both]
    del both
    per_row = 2 * PAR_TRAIN_BLOCKS
    for rank, got in enumerate(ranks):
        check(got["k4"] == per_row, f"phase 23c rank {rank}: {got['k4']} K4 launches")
        launches += got["k4"]
        close(f"phase 23c rank {rank} loss", [got["loss"]], [first[0]], 2e-4, 2e-5)
        norm_err = close(f"phase 23c rank {rank} global gradient norm", [got["grad_norm"]],
                         [first[2]], 1e-4, 0.0)
        share = got["resident"] / full_bytes
        check(0.45 <= share <= 0.55, f"phase 23c rank {rank}: resident share {share:.4f}")
        log(f"phase 23c rank {rank}: one step {got['step_s']:.3f} s (both ranks on the card at "
            f"once), loss {got['loss']:.6f} against {first[0]:.6f} in one process, global "
            f"gradient norm {got['grad_norm']:.6f} against {first[2]:.6f} (abs diff "
            f"{norm_err:.3e}); resident "
            f"parameters {got['resident'] / 2**30:.3f} GiB of {full_bytes / 2**30:.3f} GiB "
            f"({share:.4f}); K4 f32 launches {got['k4']}; peak memory "
            f"{got['peak'] / 2**30:.2f} GiB")
    err = close(f"phase 23c {FSDP_WEIGHT} after the step", ranks[0]["weight"], first[1], 5e-4,
                5e-5)
    step = float((first[1] - w0).abs().max())
    check(step > 10 * 5e-5, f"phase 23c: {FSDP_WEIGHT} moved {step:.3e}, within the tolerance")
    log(f"phase 23c: {FSDP_WEIGHT} gathered after the step, max abs diff {err:.3e} from one "
        f"process (the step moved it {step:.3e})")
    del ranks
    log(f"phase 23: {time.perf_counter() - t_phase:.3f} s, K4 f32 launches of its Trainer "
        f"runs {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 24: the device->host wires and defer_host at full size
# ---------------------------------------------------------------------------

def wire_bytes(frames=FRAMES):
    """Bytes one request moves to the host in each wire, from its shapes."""
    px = frames * HEIGHT * WIDTH
    return {"rgb": {"f32": 12 * px, "u8": 3 * px, "yuv420": 3 * px // 2},
            "disparity": {"f32": 4 * px, "fp16": 2 * px, "u8": px},
            "raymap": {"f32": frames * 6 * (HEIGHT // 8) * (WIDTH // 8) * 4}}


def rewired(pipe, **wires):
    """The phase-5 pipeline's DiT and VAE behind other wires."""
    from aether_tpu_torch.pipeline import AetherPipeline

    return AetherPipeline(pipe.config, pipe.dit, pipe.vae, pipe.empty_prompt_embeds,
                          device=pipe.device, compute_dtype=pipe.compute_dtype,
                          act_quant=pipe.act_quant, **wires)


def counted_request(pipe, video, k5_per_request, name):
    """One 41x480x720 reconstruction request (4 steps, seed 42): its output,
    its host seconds (ended by a synchronize) and its K1/K2/K5 launches,
    checked to be 168/168/``k5_per_request``."""
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue
    from aether_tpu_torch.ops.flash_attention import flash_attention_prepacked
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments

    kernels = (qkv_prologue, flash_attention_prepacked, groupnorm_moments)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe(task="reconstruction", video=video, height=HEIGHT, width=WIDTH,
               num_frames=FRAMES, num_inference_steps=STEPS, fps=12, seed=42)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = [fn.launches for fn in kernels]
    want = [pipe.config.dit.num_layers * STEPS] * 2 + [k5_per_request]
    check(counts == want, f"{name}: K1/K2/K5 launches {counts}, not {want}")
    check_request(res, FRAMES, name)
    return res, wall, counts


class Undeferred:
    """A pipeline whose calls resolve before they return: the window
    driver's undeferred run (``defer_host`` asked, an already-resolved
    output handed back)."""

    def __init__(self, pipe):
        self.pipe, self.config, self.device = pipe, pipe.config, pipe.device

    def _run(self, fn, kw):
        from aether_tpu_torch.pipeline import DeferredOutput

        asked = kw.pop("defer_host", False)
        out = fn(**kw)
        return DeferredOutput(lambda: out) if asked else out

    def __call__(self, **kw):
        return self._run(self.pipe, kw)

    def batch_reconstruct(self, videos, **kw):
        return self._run(lambda **k: self.pipe.batch_reconstruct(videos, **k), kw)


def wire_phase(pipe, dev, video, first, k5_per_request, long_clip, long_runs):
    """Phase 24 on the phase-5 pipeline at 41x480x720 (K1 + K2 + K5). (a) the
    default compact request (phase 6's request 0) against
    ``compact_transfer=False``: RGB within 0.5/255 + 1e-6, disparity within
    2e-3 or half an fp16 ulp of the value (where it exceeds 4.096, fp16's
    own rounding), raymap bit-identical (JAX tests/test_pipeline.py:393-421);
    (b) ``wire_rgb="yuv420"`` + ``wire_disparity="u8"`` against the f32
    wires: the yuv420 RGB equal to its codec's round trip of the f32 RGB,
    JAX's quantile and mean bars (:346-375), the u8 disparity's codes within
    one of round(sqrt(d) * 255) or 0 (a negative pre-square value clipped)
    and JAX's 2.5/255 (:322-345) where not clipped; ``wire_input="yuv420"``
    on a smooth clip at the bars of :280-321 (the codec at full size, then
    the request);
    (c) a deferred call: an event recorded when it returns is still pending,
    its dispatch under ``set_sync_debug_mode("warn")``, its resolved outputs
    bit-identical to phase 6's request 0; (d) the 65-frame clip through the
    window driver on an undeferred pipeline, serially and at
    ``batch_windows=2``: bit-identical to phase 6c's deferred runs. Returns
    ({name: seconds}, the phase's K1/K2/K5 launches)."""
    import warnings

    from aether_tpu_torch.pipeline.aether import (
        _rgb_to_yuv420_wire,
        _rgb_u8_to_yuv420_host,
        _u8_to_unit,
        _upload,
        _yuv420_to_unit,
        _yuv420_wire_to_rgb,
    )
    from aether_tpu_torch.pipeline.windowing import run_windowed_reconstruction

    wb = wire_bytes()
    log("phase 24 bytes to the host a request (41x480x720): " + "; ".join(
        f"{out} " + ", ".join(f"{w} {n / 1e6:.1f} MB" for w, n in wires.items())
        for out, wires in wb.items()))
    log(f"phase 24: every pipeline of this script runs the default wires unless named "
        f"(compact_transfer=None: on for CUDA, u8 RGB and fp16 disparity, "
        f"{(wb['rgb']['u8'] + wb['disparity']['fp16'] + wb['raymap']['f32']) / 1e6:.1f} MB a "
        f"request against {sum(w['f32'] for w in wb.values()) / 1e6:.1f} MB in f32); no "
        f"earlier phase holds a pipeline's output to a float reference finer than the "
        f"wire's rounding (they compare compact outputs with compact outputs, or at gates "
        f">= 1e-2), so none is built with compact_transfer=False")
    secs, launches = {}, [0, 0, 0]

    def request(name, p, clip, what):
        res, secs[name], counts = counted_request(p, clip, k5_per_request, what)
        launches[:] = [a + b for a, b in zip(launches, counts)]
        return res

    # (a) the compact default against the f32 wires
    exact = request("f32 wires", rewired(pipe, compact_transfer=False), video,
                    "phase 24a f32 wires")
    rgb_err = np.abs(first.rgb - exact.rgb).max()
    disp_err = np.abs(first.disparity - exact.disparity)
    disp_bar = np.maximum(2e-3, 2.0 ** -11 * np.abs(exact.disparity))
    log(f"phase 24a compact (u8 rgb, fp16 disparity) against f32 wires: rgb max "
        f"{rgb_err:.3e} (bar {0.5 / 255 + 1e-6:.3e}), disparity max {disp_err.max():.3e} "
        f"(values up to {np.abs(exact.disparity).max():.3f}; bar 2e-3 or half an fp16 ulp), "
        f"raymap {'bit-identical' if np.array_equal(first.raymap, exact.raymap) else 'DIFFERS'}")
    check(rgb_err <= 0.5 / 255 + 1e-6, "phase 24a: compact rgb outside 0.5/255")
    check(bool((disp_err <= disp_bar).all()), "phase 24a: fp16 disparity outside its bar")
    check(np.array_equal(first.raymap, exact.raymap), "phase 24a: raymap differs")
    check(first.rgb.dtype == first.disparity.dtype == np.float32, "phase 24a: host dtypes")

    # (b) the lossy wires against the f32 wires
    lossy = request("yuv420 rgb + u8 disparity", rewired(
        pipe, compact_transfer=True, wire_rgb="yuv420", wire_disparity="u8"), video,
        "phase 24b lossy wires")

    def luma(x):
        return x @ np.array([0.299, 0.587, 0.114], np.float32)

    def blocks(x):
        return x.reshape(FRAMES, HEIGHT // 2, 2, WIDTH // 2, 2, 3).mean((2, 4))

    lerr = np.abs(luma(lossy.rgb) - luma(exact.rgb))
    berr = np.abs(blocks(lossy.rgb) - blocks(exact.rgb))
    mean_rgb = np.abs(lossy.rgb - exact.rgb).mean()
    # the wire is its codec: the f32 request's rgb packed on the card and
    # unpacked on the host gives the yuv420 request's rgb bit for bit (both
    # requests decode the same frames)
    codec_rgb = _yuv420_wire_to_rgb(*(t.cpu().numpy() for t in _rgb_to_yuv420_wire(
        torch.from_numpy(exact.rgb).to(dev)))).astype(np.float32)
    # the u8 disparity wire carries the pre-square value s in [0, 1] (JAX
    # :352-365): its codes are round(s * 255) of |s| = sqrt(d), or 0 where
    # s < 0 (clipped); JAX's bar (2.5/255 where d <= 1) holds where it is not
    codes = np.round(np.sqrt(lossy.disparity) * 255.0)
    want = np.round(np.clip(np.sqrt(exact.disparity), 0.0, 1.0) * 255.0)
    gamut = exact.disparity <= 1.0
    clipped = (codes == 0) & (want > 1)
    derr = np.abs(lossy.disparity - exact.disparity)[gamut & ~clipped]
    log(f"phase 24b yuv420 rgb: luma err q99 {np.quantile(lerr, 0.99):.3e} max {lerr.max():.3e}, "
        f"2x2-block err q99 {np.quantile(berr, 0.99):.3e} max {berr.max():.3e}, mean abs "
        f"{mean_rgb:.3e} (JAX's bars on 17x64x96: q99 0.01 / 0.03, max 0.08 / 0.1, mean "
        f"0.05; the maxima fall where the codec clips out-of-gamut colours: the wire equals "
        f"its codec's round trip of the f32 rgb "
        f"{'bit for bit' if np.array_equal(lossy.rgb, codec_rgb) else 'NOT'}); u8 disparity: "
        f"{gamut.mean():.4f} of it <= 1, {clipped.mean():.4e} of it clipped from a negative "
        f"pre-square value, the rest within {derr.max() if derr.size else 0.0:.3e} (bar "
        f"2.5/255), codes within one of round(sqrt(d) * 255) elsewhere; largest value "
        f"{lossy.disparity.max():.4f}; raymap "
        f"{'bit-identical' if np.array_equal(lossy.raymap, exact.raymap) else 'DIFFERS'}")
    check(np.array_equal(lossy.rgb, codec_rgb), "phase 24b: the yuv420 wire is not its codec")
    check(np.quantile(lerr, 0.99) < 0.01, "phase 24b: luma q99")
    check(np.quantile(berr, 0.99) < 0.03, "phase 24b: chroma blocks q99")
    check(mean_rgb < 0.05, "phase 24b: yuv420 rgb mean error")
    check(bool((clipped | (np.abs(codes - want) <= 1)).all()), "phase 24b: u8 disparity codes")
    check(not derr.size or derr.max() < 2.5 / 255, "phase 24b: u8 disparity")
    check(bool((lossy.disparity <= 1.0 + 1e-6).all()), "phase 24b: u8 disparity above 1")
    check(np.allclose(lossy.raymap, exact.raymap, atol=1e-5), "phase 24b: raymap")
    del lossy, exact, codec_rgb

    # the input wire: the codec at full size, then a request on a smooth clip
    rng = np.random.default_rng(24)
    base = rng.uniform(0, 1, (FRAMES, HEIGHT // 8, WIDTH // 8, 3))
    smooth = np.round(np.repeat(np.repeat(base, 8, 1), 8, 2) * 255).astype(np.uint8)
    unit = _yuv420_to_unit(*(_upload(p, dev) for p in _rgb_u8_to_yuv420_host(smooth)),
                           torch.float32)
    plain = _u8_to_unit(smooth, torch.float32, dev)
    diff = (unit - plain).abs()
    gray = np.repeat(rng.integers(0, 256, (FRAMES, HEIGHT, WIDTH, 1), dtype=np.uint8), 3, -1)
    gray_err = (_yuv420_to_unit(*(_upload(p, dev) for p in _rgb_u8_to_yuv420_host(gray)),
                                torch.float32) - _u8_to_unit(gray, torch.float32, dev)).abs()
    codec = (diff.mean().item(), diff.max().item(), gray_err.max().item())
    del unit, plain, diff, gray_err
    log(f"phase 24b input wire at 41x480x720 on the card: smooth clip mean {codec[0]:.3e} "
        f"max {codec[1]:.3e} (bars 0.01 / 0.08), gray max {codec[2]:.3e} (bar 2.5/255)")
    check(codec[0] < 0.01 and codec[1] < 0.08 and codec[2] < 2.5 / 255, "phase 24b: codec")
    ref = request("smooth clip, u8 input", pipe, smooth, "phase 24b u8 input")
    got = request("smooth clip, yuv420 input", rewired(pipe, wire_input="yuv420"), smooth,
                  "phase 24b yuv420 input")
    input_err = np.abs(got.rgb - ref.rgb).mean()
    log(f"phase 24b yuv420 input: rgb mean abs {input_err:.3e} from the u8 upload (bar 0.12)")
    check(input_err < 0.12, "phase 24b: yuv420 input moved the output too far")
    del ref, got

    # (c) a deferred call returns while its work runs
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue
    from aether_tpu_torch.ops.flash_attention import flash_attention_prepacked
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments

    kernels = (qkv_prologue, flash_attention_prepacked, groupnorm_moments)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            deferred = pipe(task="reconstruction", video=video, height=HEIGHT, width=WIDTH,
                            num_frames=FRAMES, num_inference_steps=STEPS, fps=12, seed=42,
                            defer_host=True)
            returned = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    marker = torch.cuda.Event()
    marker.record()
    pending = not marker.query()
    out = deferred.resolve()
    resolved = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = [fn.launches for fn in kernels]
    # the mode's own notice that it is a prototype is not a synchronizing call
    syncs = sorted({str(w.message).splitlines()[0][:160] for w in caught
                    if "prototype feature" not in str(w.message)})
    secs["deferred call returned"], secs["deferred call resolved"] = returned, resolved
    log(f"phase 24c deferred call: returned after {returned:.3f} s with its work still "
        f"running (an event recorded then: {'pending' if pending else 'COMPLETE'}), resolved "
        f"after {resolved:.3f} s (the undeferred request: {secs['f32 wires']:.3f} s in f32 "
        f"wires); enqueue stage seconds " + ", ".join(
            f"{k} {v:.3f}" for k, v in out.stage_seconds.items())
        + f"; K1/K2/K5 launches after resolve {'/'.join(map(str, counts))}; "
        f"set_sync_debug_mode('warn') over the dispatch named {len(syncs)} synchronizing "
        f"call(s)" + (": " + " | ".join(syncs) if syncs else ""))
    check(pending, "phase 24c: the deferred call returned after its work had ended")
    check(counts == [pipe.config.dit.num_layers * STEPS] * 2 + [k5_per_request],
          f"phase 24c: launches {counts}")
    launches[:] = [a + b for a, b in zip(launches, counts)]
    check(deferred.resolve() is out, "phase 24c: resolve() is not idempotent")
    for name in ("rgb", "disparity", "raymap"):
        check(np.array_equal(getattr(out, name), getattr(first, name)),
              f"phase 24c: the deferred {name} differs from phase 6's request 0")
    log("phase 24c: the deferred call's outputs are bit-identical to phase 6's request 0")

    # (d) the window driver, deferred (phase 6c) against undeferred
    for batch_windows in (1, 2):
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        results, starts, _ = run_windowed_reconstruction(
            Undeferred(pipe), long_clip, height=HEIGHT, width=WIDTH, num_frames=FRAMES,
            fps=12, num_inference_steps=STEPS, stride=STRIDE, seed=42,
            batch_windows=batch_windows)
        torch.cuda.synchronize()
        name = "serial" if batch_windows == 1 else "batch_windows=2"
        secs[f"65-frame clip undeferred, {name}"] = time.perf_counter() - t0
        check(starts == [0, STRIDE] and len(results) == 2, f"phase 24d windows {starts}")
        launches[:] = [a + fn.launches for a, fn in zip(launches, kernels)]
        for i, (a, b) in enumerate(zip(results, long_runs[batch_windows])):
            for field in ("rgb", "disparity", "raymap"):
                check(np.array_equal(getattr(a, field), getattr(b, field)),
                      f"phase 24d {name} window {i} {field}: deferred and undeferred differ")
        log(f"phase 24d 65-frame clip, {name}: the deferred driver's two windows (phase 6c) "
            f"bit-identical to its undeferred run "
            f"({secs[f'65-frame clip undeferred, {name}']:.3f} s)")
    log("phase 24 seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    return secs, launches


# ---------------------------------------------------------------------------
# phase 25: the server over a mesh of two ranks sharing the card
# ---------------------------------------------------------------------------

# phase 25: a depth cut; the prediction job's steps. Neither is cut further:
# at 1 block (c)'s tp poses gate failed, at 2 steps its rgb gate; that is the
# random-weight job amplifying rounding, not a fault of tp (ROADMAP Queue 3,
# aether_tpu_torch/bench/tp_departure.py)
SERVE_BLOCKS, SERVE_STEPS = 2, 4
# (c)'s sensitivity control: the RMS of the tp = 2 DiT's departure from one
# process at each of the tp job's 8 DiT calls (4 CFG steps, then the 4-step
# post-reconstruction), each call on the same inputs, as
# aether_tpu_torch/bench/tp_departure.py measured it at 2 blocks x 4 steps
# (NVIDIA H100 80GB HBM3, 700.00 W)
TP_DEPARTURE_RMS = (8.664e-4, 8.642e-4, 8.838e-4, 8.779e-4, 4.778e-4, 4.755e-4, 4.899e-4,
                    4.919e-4)


def serve_uploads():
    """Phase 25's seeded uploads by file name (the card's machine cannot
    decode files: no PIL or imageio)."""
    rng = np.random.default_rng(25)
    return {"clip.mp4": rng.integers(0, 256, (LONG_FRAMES, HEIGHT, WIDTH, 3),
                                     dtype=np.uint8).astype(np.float32) / 255.0,
            "image.png": rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)}


SERVE_JOBS = {
    "dp": dict(task="reconstruction", num_frames=str(FRAMES), fps="12", height=str(HEIGHT),
               width=str(WIDTH), seed="42", stride=str(STRIDE)),
    "tp": dict(task="prediction", num_frames=str(FRAMES), fps="12", height=str(HEIGHT),
               width=str(WIDTH), seed="42", raymap="forward_right", steps=str(SERVE_STEPS)),
}
SERVE_FILES = {"dp": ("video", "clip.mp4"), "tp": ("image", "image.png")}


def serve_pipeline(dev, mesh=None):
    """The AetherV1 width cut to ``SERVE_BLOCKS`` DiT blocks (depth only;
    seed 0) with the full VAE (seed 1), bf16, the default wires."""
    from aether_tpu_torch.config import PipelineConfig
    from aether_tpu_torch.models import init_dit, init_vae
    from aether_tpu_torch.pipeline import AetherPipeline

    cfg = PipelineConfig.aetherv1()
    cfg = dataclasses.replace(cfg, dit=dataclasses.replace(cfg.dit, num_layers=SERVE_BLOCKS))
    dit = init_dit(cfg.dit, device=dev, dtype=torch.bfloat16, seed=0)
    vae = init_vae(cfg.vae, device=dev, dtype=torch.bfloat16, seed=1)
    return AetherPipeline(cfg, dit, vae, make_prompt(cfg, dev), device=dev,
                          compute_dtype=torch.bfloat16, mesh=mesh)


def serve_patches():
    """What the card's machine lacks, replaced in this process: the upload
    decoders hand ``_fields_to_params`` the seeded arrays, ``viz.save_video``
    writes .npy, and ``demo.save_output`` also saves the rgb and disparity it
    exports (``<job dir>/export_rgb.npy``, ``export_disparity.npy``).
    Returns a function that puts the originals back."""
    import aether_tpu_torch.viz as viz
    from aether_tpu_torch.apps import demo, serve

    originals = (serve._decode_video, serve._decode_image, viz.save_video, demo.save_output)
    uploads = serve_uploads()
    serve._decode_video = lambda field: uploads[field["filename"]]
    serve._decode_image = lambda field: uploads[field["filename"]]

    def frames_to_npy(path, frames, fps=12):
        path = os.path.splitext(str(path))[0] + ".npy"
        np.save(path, np.asarray(frames))
        return path

    def save_output(rgb, disparity, args, **kw):
        np.save(os.path.join(args.output_dir, "export_rgb.npy"), np.asarray(rgb))
        np.save(os.path.join(args.output_dir, "export_disparity.npy"), np.asarray(disparity))
        return originals[3](rgb, disparity, args, **kw)

    viz.save_video, demo.save_output = frames_to_npy, save_output

    def restore():
        serve._decode_video, serve._decode_image, viz.save_video, demo.save_output = originals

    return restore


def serve_mesh_rank(mode, out_dir):
    """Phase 25 on one of two ranks sharing cuda:0 over gloo: the
    ``SERVE_BLOCKS``-block pipeline over a ('dp', 'tp') mesh of dp = 2 or
    tp = 2, served through ``apps.serve.serve`` with a job channel; rank 0
    writes its HTTP port to ``<out_dir>/port`` and serves until SIGTERM.
    Returns the rank's K1/K2/K5 launches, jobs and peak memory."""
    from aether_tpu_torch.apps import serve
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue
    from aether_tpu_torch.ops.flash_attention import flash_attention_prepacked
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments
    from aether_tpu_torch.parallel import make_mesh
    from aether_tpu_torch.parallel.jobs import JobChannel

    dev, rank = gloo_rank(2)
    axes = dict(dp=2, tp=1) if mode == "dp" else dict(dp=1, tp=2)
    pipe = serve_pipeline(dev, make_mesh(**axes, device_type="cuda"))
    serve_patches()
    channel = JobChannel()
    kernels = (qkv_prologue, flash_attention_prepacked, groupnorm_moments)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def on_listen(server, runner):
        with open(os.path.join(out_dir, "port.tmp"), "w") as f:
            f.write(str(server.server_address[1]))
        os.replace(os.path.join(out_dir, "port.tmp"), os.path.join(out_dir, "port"))

    serve.serve(pipe, out_dir, port=0, channel=channel, on_listen=on_listen)
    return dict(rank=rank, launches=[fn.launches for fn in kernels], jobs=channel.jobs,
                peak=torch.cuda.max_memory_allocated(dev),
                reserved=torch.cuda.max_memory_reserved(dev),
                heads=pipe.dit.blocks[0].attn.qkv.weight.shape[0] // 3 // HEAD_DIM)


def post_job(base, fields, file_field):
    """POST one job over HTTP; the upload's bytes are a placeholder (its
    name picks the seeded array)."""
    import urllib.request

    boundary, body = "chipsmoke25", []
    for name, value in fields.items():
        body.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"'
                    f"\r\n\r\n{value}\r\n".encode())
    name, filename = file_field
    body.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                f'filename="{filename}"\r\nContent-Type: application/octet-stream'
                f"\r\n\r\n0\r\n--{boundary}--\r\n".encode())
    req = urllib.request.Request(
        base + "/api/submit", data=b"".join(body),
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["job_id"]


def exported(job_dir, status, frames):
    """(rgb, disparity, poses) a served job exported."""
    poses = next(a for a in status["artifacts"] if a.endswith("_poses.txt"))
    poses = np.loadtxt(os.path.join(os.path.dirname(job_dir), poses[len("/outputs/"):]))
    out = (np.load(os.path.join(job_dir, "export_rgb.npy")),
           np.load(os.path.join(job_dir, "export_disparity.npy")), poses)
    check(out[0].shape == (frames, HEIGHT, WIDTH, 3) and out[2].shape == (frames, 16),
          f"exported shapes {out[0].shape} / {out[2].shape}")
    return out


def serve_mesh_phase(dev):
    """Phase 25: (a) a dp = 2 server (two ranks over gloo sharing cuda:0)
    answers the seeded 65-frame two-window reconstruction job, one
    ``batch_reconstruct`` chunk; (b) a tp = 2 server (24 heads a rank)
    answers a ``SERVE_STEPS``-step prediction job with the 4-step
    post-reconstruction; the parent submits each job over HTTP, polls
    ``/api/status``, then sends rank 0 SIGTERM and both ranks must exit 0.
    (c) both jobs served again by one process (``JobRunner``, no mesh) on
    the same weights: the exported rgb, disparity and poses within the
    long-video phase's gates (mean abs <= 1e-2 and max <= 0.25 of
    max(1, max |one process|)); beside them, logged, the sensitivity
    control: the tp job in one process again with the DiT's output at each
    call perturbed by seeded noise of ``TP_DEPARTURE_RMS``, its exports
    against the unperturbed ones (how far the random-weight job carries a
    departure the size of tp's; no gate); (d) each rank's K1/K2/K5 launches, the
    follower's equal to the leader's, and the two ranks' peaks under 80 GB.
    Returns rank 0's K1/K2/K5 launches of the served jobs and the phase's
    numbers."""
    import signal

    from aether_tpu_torch.apps import serve
    from aether_tpu_torch.parallel.launch import start

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory(prefix="aether_serve_mesh_")
    one_pipe = serve_pipeline(dev)  # the one-process reference, and the K5 counts
    k5_window = expected_k5(one_pipe, FRAMES)
    want = {  # per rank and job
        # one batch_reconstruct chunk: each rank's DiT row (batch 1), its
        # window's encode and two of the four decode streams
        "dp": [SERVE_BLOCKS * STEPS] * 2 + [k5_window],
        # the CFG pair at H/2 heads, then the 4-step post-reconstruction
        "tp": [SERVE_BLOCKS * (SERVE_STEPS + STEPS)] * 2
        + [expected_k5(one_pipe, FRAMES, images=1) + k5_window],
    }
    served, numbers, launches = {}, {}, [0, 0, 0]
    for mode in ("dp", "tp"):
        out_dir = os.path.join(tmp.name, mode)
        os.makedirs(out_dir)
        t0 = time.perf_counter()
        # two processes share the card's 80 GB: expandable segments keep each
        # caching allocator's reserve close to what it allocates
        ranks = start("chip_smoke:serve_mesh_rank", 2, dict(mode=mode, out_dir=out_dir),
                      extra_path=[here],
                      env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
        port_file = os.path.join(out_dir, "port")
        while not os.path.exists(port_file):
            if any(p.poll() is not None for p in ranks.procs) or time.perf_counter() - t0 > 300:
                ranks.procs[0].send_signal(signal.SIGTERM)
                ranks.join(timeout=60)  # raises with the ranks' output
                raise AssertionError(f"phase 25 {mode}: rank 0 did not listen")
            time.sleep(0.5)
        with open(port_file) as f:
            base = f"http://127.0.0.1:{f.read().strip()}"
        up = time.perf_counter() - t0
        try:
            status, wall, _ = wait_job(base, post_job(base, SERVE_JOBS[mode],
                                                      SERVE_FILES[mode]))
        except Exception as exc:
            ranks.procs[0].send_signal(signal.SIGTERM)
            try:
                ranks.join(timeout=180)
            except RuntimeError as ranks_failed:  # the ranks' own account
                raise AssertionError(f"phase 25 {mode}: {exc!r}\n{ranks_failed}") from exc
            raise
        ranks.procs[0].send_signal(signal.SIGTERM)
        results = ranks.join(timeout=180)  # raises unless both ranks exit 0
        check(status["status"] == "done", f"phase 25 {mode} job: {status.get('error')}")
        frames = LONG_FRAMES if mode == "dp" else FRAMES
        served[mode] = exported(os.path.join(out_dir, status["artifacts"][0].split("/")[2]),
                                status, frames)
        peaks = [r["peak"] for r in results]
        numbers[mode] = dict(up_s=up, job_s=wall, peaks_gib=[p / 2**30 for p in peaks])
        log(f"phase 25{'a' if mode == 'dp' else 'b'} {mode} = 2 server: ranks listening after "
            f"{up:.3f} s, the job {wall:.3f} s from submit to done over HTTP; stages "
            + ", ".join(f"{d['stage']} {d['seconds']:.3f} s"
                        for d in status["progress"]["stages_done"])
            + "; per rank (K1/K2/K5 launches, jobs, heads, peak / reserved GiB): " + "; ".join(
                f"rank {r['rank']} {'/'.join(map(str, r['launches']))}, {r['jobs']}, "
                f"{r['heads']}, {r['peak'] / 2**30:.2f} / {r['reserved'] / 2**30:.2f}"
                for r in results)
            + f"; peaks sum {sum(peaks) / 1e9:.2f} GB; both ranks exited 0 after SIGTERM "
            f"to rank 0 (the stop message)")
        heads = HEADS if mode == "dp" else HEADS // 2
        for r in results:
            check(r["launches"] == want[mode] and r["heads"] == heads and r["jobs"] == 1,
                  f"phase 25 {mode} rank {r['rank']}: launches {r['launches']}, heads "
                  f"{r['heads']}, jobs {r['jobs']}; want {want[mode]}, {heads}, 1")
        check(sum(peaks) < 80e9, f"phase 25 {mode}: the ranks' peaks sum to "
              f"{sum(peaks) / 1e9:.2f} GB")
        launches = [a + b for a, b in zip(launches, results[0]["launches"])]

    # (c) the same jobs from one process on the same weights
    from aether_tpu_torch.bench.tp_departure import gate, run_job

    restore = serve_patches()
    exports, job_params = {}, {}
    runner = serve.JobRunner(one_pipe, os.path.join(tmp.name, "one"))
    try:
        for mode in ("dp", "tp"):
            name, filename = SERVE_FILES[mode]
            params = serve._fields_to_params(
                dict(SERVE_JOBS[mode], **{name: {"filename": filename, "data": b"0"}}), None)
            t0 = time.perf_counter()
            job_id = runner.submit(params)
            while runner.status(job_id)["status"] not in ("done", "error"):
                time.sleep(0.1)
            status = runner.status(job_id)
            check(status["status"] == "done", f"phase 25c {mode} job: {status.get('error')}")
            one = exported(os.path.join(runner.output_dir, job_id), status,
                           LONG_FRAMES if mode == "dp" else FRAMES)
            exports[mode], job_params[mode] = one, params
            numbers[mode]["one_process_s"] = time.perf_counter() - t0
            diffs = []
            for field, got, ref in zip(("rgb", "disparity", "poses"), served[mode], one):
                d = np.abs(got - ref)
                top = max(1.0, float(np.abs(ref).max()))
                diffs.append(f"{field} max {d.max():.3e} mean {d.mean():.3e}"
                             + (" (bit-identical)" if not d.any() else ""))
                check(d.mean() <= 1e-2 * top and d.max() <= 0.25 * top,
                      f"phase 25c {mode} {field}: the mesh server and one process disagree "
                      f"(max {d.max():.3e}, mean {d.mean():.3e}, max |ref| {top:.3g})")
            log(f"phase 25c {mode} = 2 server against one process "
                f"({numbers[mode]['one_process_s']:.3f} s there): " + ", ".join(diffs))
        t0 = time.perf_counter()
        _, control = run_job(one_pipe, job_params["tp"], dev, perturb=TP_DEPARTURE_RMS)
        log(f"phase 25c control ({time.perf_counter() - t0:.3f} s): the tp job in one process "
            "with the DiT's output perturbed by the tp departure's RMS at each call, against "
            "the unperturbed job: " + ", ".join(
                f"{field} max {mx:.3e} mean {mean:.3e} ({'within' if ok else 'outside'} the "
                f"gates of max |ref| {top:.3g})"
                for field, (mx, mean, top, ok) in gate(control, exports["tp"]).items()))
    finally:
        runner.close(timeout=120)
        restore()
        del one_pipe
        tmp.cleanup()
    return launches, numbers


# ---------------------------------------------------------------------------
# phase 26: the CogVideoX-1.5 DiT at full width; K1 + K2 below head_dim 64
# ---------------------------------------------------------------------------

# (a) latent frames of the 1.5 clip (6 token frames at patch_size_t 2: 8100
# video tokens + 226 text at 480x720) and its ofs embedding width
COG15_FRAMES, COG15_OFS = 12, 512
# (a) the 1.5 forward through K1 + K2 against the same forward through the
# plain attention route (``attn_impl="xla"``): mean-abs and norm relative
# error, the tightest bar of the script's full-width DiT comparisons (phase
# 16's int8 weight-only); w8a8 against bf16 at phase 16's w8a8 bar
COG15_PLAIN_BAR, COG15_W8A8_NORM_BAR = 0.05, 0.2
# (a) ofs = 2 must move the output's mean magnitude by more than this share
COG15_OFS_MOVES = 1e-3
# (b) the tiny request and the DiT forwards on the card against the CPU at
# the long-video gates (mean abs <= 1e-2, max <= 0.25 of max(1, |ref|)) at
# HD_DIMS; K1 + K2 at the main path's 48 heads x 15076 tokens at
# PREPACKED_HD_DIMS
HD_DIMS = (16, 32, 112)
PREPACKED_HD_DIMS = (16, 32, 48, 80, 96, 112)
TINY_FRAMES, TINY_HEIGHT, TINY_WIDTH = 17, 64, 96


def cogvideox15_phase(cfg, dev):
    """Phase 26 (a): the CogVideoX-1.5 DiT, ``DiTConfig.aetherv1()`` with
    ``patch_size_t=2`` and ``ofs_embed_dim=512`` (42 blocks, 48 heads x 64),
    seeded random bf16 weights (``init_dit`` seed 0), one forward at timestep
    500 on a seeded (1, 12, 96, 60, 90) bf16 latent, the phase's seeded
    prompt and the slice RoPE tables of 480x720 at 12 latent frames: 8100
    video + 226 text tokens. At the default attention settings (K1 + K2, 42
    launches each, none of the head-dim kernels); ``ofs`` None bit-identical
    to explicit zeros, ``ofs=2`` moving the output; against the same forward
    through the plain attention route at ``COG15_PLAIN_BAR``; then the same
    weights as int8 codes with int8 activations (``quantize_dit``, w8a8: 42
    K1/K2 launches, 4 x 42 int8 products) against bf16 at phase 16's w8a8
    bar. Logs each forward's seconds and peak memory; returns {name: value}."""
    from aether_tpu_torch.models import init_dit, quantize_dit
    from aether_tpu_torch.models.dit import int8_mm
    from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings
    from aether_tpu_torch.ops.attn_prologue import qkv_prologue, qkv_prologue_hd
    from aether_tpu_torch.ops.flash_attention import (
        flash_attention_prepacked,
        flash_attention_prepacked_hd,
    )

    cfg15 = dataclasses.replace(cfg.dit, patch_size_t=2, ofs_embed_dim=COG15_OFS)
    h_lat, w_lat = HEIGHT // 8, WIDTH // 8
    video_tokens = COG15_FRAMES // 2 * (h_lat // 2) * (w_lat // 2)
    t0 = time.perf_counter()
    dit = init_dit(cfg15, device=dev, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in dit.parameters())
    log(f"phase 26a: CogVideoX-1.5 DiT (patch_size_t 2, ofs_embed_dim {COG15_OFS}) "
        f"{n_params / 1e9:.4f}B bf16 params, built in {time.perf_counter() - t0:.3f} s; "
        f"proj {tuple(dit.proj.weight.shape)}, proj_out {tuple(dit.proj_out.weight.shape)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    hidden = torch.randn((1, COG15_FRAMES, cfg15.in_channels, h_lat, w_lat), generator=gen,
                         device=dev).to(torch.bfloat16)
    text = make_prompt(cfg, dev).to(torch.bfloat16)
    t = torch.tensor([500], device=dev)
    cos, sin = prepare_rotary_positional_embeddings(
        cfg15, HEIGHT, WIDTH, COG15_FRAMES, vae_scale_factor_spatial=8, base_fps=12, fps=12)
    check(cos.shape == (video_tokens, cfg15.head_dim), f"slice RoPE tables {cos.shape}")
    rope = (torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev))
    counted = (qkv_prologue, flash_attention_prepacked, qkv_prologue_hd,
               flash_attention_prepacked_hd, int8_mm)
    n = cfg15.num_layers
    numbers = {}

    def forward(name, launches, **kw):
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = dit(hidden, text, t, *rope, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = [fn.launches for fn in counted]
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        log(f"phase 26a {name}: {secs:.3f} s, {video_tokens + TEXT} tokens; K1/K2/K1 hd/K2 "
            f"hd/int8 product launches {'/'.join(map(str, counts))}; peak memory {peak:.2f} GiB")
        check(out.shape == (1, COG15_FRAMES, cfg15.out_channels, h_lat, w_lat),
              f"phase 26a {name}: output {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"phase 26a {name}: non-finite output")
        check(counts == launches, f"phase 26a {name}: launches {counts}, not {launches}")
        numbers[f"{name} s"], numbers[f"{name} peak GiB"] = secs, peak
        return out

    fused = [n, n, 0, 0, 0]
    ref = forward("forward (K1 + K2, ofs None)", fused)
    zeros = forward("forward, ofs zeros", fused, ofs=torch.zeros(1, device=dev))
    check(torch.equal(ref, zeros), "phase 26a: ofs None is not bit-identical to zeros")
    moved = forward("forward, ofs 2", fused, ofs=torch.full((1,), 2.0, device=dev))
    share = ((moved.float() - ref.float()).abs().mean() / ref.float().abs().mean()).item()
    log(f"phase 26a: ofs None bit-identical to zeros; ofs 2 moves the output by {share:.4e} "
        f"of its mean magnitude (gate > {COG15_OFS_MOVES:g})")
    check(share > COG15_OFS_MOVES, "phase 26a: ofs 2 does not move the output")
    del zeros, moved
    plain = forward("forward, plain attention route", [0, 0, 0, 0, 0], attn_impl="xla")
    mean_rel, norm_rel, cosine = relative_errors(ref, plain)
    log(f"phase 26a K1 + K2 against the plain attention route: mean-abs relative error "
        f"{mean_rel:.6f}, norm relative error {norm_rel:.6f}, cosine {cosine:.6f} (gates "
        f"{COG15_PLAIN_BAR:g} / {COG15_PLAIN_BAR:g})")
    check(mean_rel < COG15_PLAIN_BAR and norm_rel < COG15_PLAIN_BAR,
          "phase 26a: the K1 + K2 forward is outside its bars of the plain route")
    numbers.update({"plain mean rel": mean_rel, "plain norm rel": norm_rel,
                    "plain cosine": cosine})
    del plain
    torch.cuda.empty_cache()
    quantize_dit(dit, torch.int8)  # in place: the bf16 weights go as their codes come
    w8a8 = forward("forward, int8 w8a8", [n, n, 0, 0, 4 * n], act_quant=True)
    mean_rel, norm_rel, cosine = relative_errors(w8a8, ref)
    log(f"phase 26a int8 w8a8 against bf16: mean-abs relative error {mean_rel:.6f}, norm "
        f"relative error {norm_rel:.6f}, cosine {cosine:.6f} (gate norm "
        f"{COG15_W8A8_NORM_BAR:g})")
    check(norm_rel < COG15_W8A8_NORM_BAR, "phase 26a: int8 w8a8 over the 0.2 norm bar")
    numbers.update({"w8a8 mean rel": mean_rel, "w8a8 norm rel": norm_rel,
                    "w8a8 cosine": cosine})
    del dit, ref, w8a8, hidden, text, rope
    gc.collect()
    torch.cuda.empty_cache()
    return numbers


class HostDrawnNoise:
    """The pipeline's ``TorchNoise`` draws made on the CPU (seeded there) and
    moved to ``device``: a CPU and a CUDA pipeline see the same noise."""

    def __init__(self, seed, device):
        from aether_tpu_torch.pipeline.aether import TorchNoise

        self.source, self.device = TorchNoise(seed, "cpu"), torch.device(device)

    def posterior(self, shape):
        return self.source.posterior(shape).to(self.device)

    def goal(self, shape):
        return self.source.goal(shape).to(self.device)

    def initial(self, shape):
        return self.source.initial(shape).to(self.device)

    def sde(self, step, shape):
        return self.source.sde(step, shape).to(self.device)


def cross_device_gates(name, got, ref):
    """The long-video gates of a card result against the CPU's: mean abs
    <= 1e-2, max <= 0.25 of max(1, max |ref|). Returns the max abs error."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    check(got.shape == ref.shape, f"{name}: {got.shape} against {ref.shape}")
    check(bool(np.isfinite(got).all()), f"{name}: non-finite values on the card")
    err = np.abs(got - ref)
    top = 0.25 * max(1.0, float(np.abs(ref).max()))
    log(f"{name}, the card against the CPU: mean abs {err.mean():.3e}, max abs "
        f"{err.max():.3e} (gates 1e-2 / {top:.3g})")
    check(err.mean() <= 1e-2 and err.max() <= top, f"{name}: the card departs from the CPU")
    return float(err.max())


def head_dim_phase(dev, gen):
    """Phase 26 (b): K1 + K2 below head_dim 64. (i) One reconstruction
    request of ``PipelineConfig.tiny()`` (head_dim 16, 4 heads, 2 blocks) on
    the card at the default attention settings, 17x64x96 and 4 steps, against
    the same request on the CPU (the same CPU-drawn weights and
    ``TorchNoise`` draws, bf16, f32 wires) at the long-video gates: 8
    launches of each head-dim kernel, none of the head_dim-64 ones, K5 at its
    count. (ii) The tiny DiT at head_dim 32 and 112 (4 heads, 2 blocks): one
    forward on the card against the CPU at the same gates, 2 launches each.
    (iii) K1 and K2 at 48 heads x 15076 tokens (padded to 15360) at each of
    ``PREPACKED_HD_DIMS``, int8 and float: phase 3's and phase 4's (and phase 14's)
    accuracy gates against the plain versions, two launches bit-identical,
    the times beside one bf16 SDPA call at (1, 48, 15076, head_dim) and the
    bound. Returns ({head_dim: (K1 launches, K2 launches)} of (i)-(ii),
    {(kernel, head_dim, branch): (max abs error, ms, plain ms, bound,
    SDPA ms)})."""
    from aether_tpu_torch.config import DiTConfig, PipelineConfig
    from aether_tpu_torch.models import init_dit, init_vae
    from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings
    from aether_tpu_torch.models.vae import GroupNorm
    from aether_tpu_torch.bench.time_prologue import graph_ms
    from aether_tpu_torch.ops.attn_prologue import (
        qkv_prologue,
        qkv_prologue_hd,
        qkv_prologue_plain,
    )
    from aether_tpu_torch.ops.flash_attention import (
        flash_attention_prepacked,
        flash_attention_prepacked_hd,
        flash_attention_prepacked_plain,
    )
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments
    from aether_tpu_torch.pipeline import AetherPipeline
    from aether_tpu_torch.pipeline.aether import TorchNoise, _chunk_bounds

    counted = (qkv_prologue_hd, flash_attention_prepacked_hd, qkv_prologue,
               flash_attention_prepacked, groupnorm_moments)
    path_launches = {}
    # (i) the tiny request
    tcfg = PipelineConfig.tiny()
    dit = init_dit(tcfg.dit, dtype=torch.bfloat16, seed=0)
    vae = init_vae(tcfg.vae, dtype=torch.bfloat16, seed=1)
    host_gen = torch.Generator()
    host_gen.manual_seed(2)
    text = torch.randn((1, tcfg.dit.max_text_seq_length, tcfg.dit.text_embed_dim),
                       generator=host_gen)
    video = np.random.default_rng(26).integers(
        0, 256, (TINY_FRAMES, TINY_HEIGHT, TINY_WIDTH, 3), dtype=np.uint8)
    kw = dict(task="reconstruction", video=video, height=TINY_HEIGHT, width=TINY_WIDTH,
              num_frames=TINY_FRAMES, num_inference_steps=4, fps=12)
    host = AetherPipeline(tcfg, dit, vae, text, device="cpu", compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    want = host(noise=TorchNoise(42, "cpu"), **kw)
    host_s = time.perf_counter() - t0
    card = AetherPipeline(tcfg, dit.to(dev), vae.to(dev), text.to(dev), device=dev,
                          compute_dtype=torch.bfloat16, compact_transfer=False)
    card(noise=HostDrawnNoise(42, dev), **kw)  # the first call builds cuDNN's plans
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    got = card(noise=HostDrawnNoise(42, dev), **kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = [fn.launches for fn in counted]
    enc = sum(isinstance(m, GroupNorm) for m in card.vae.encoder.modules())
    dec = sum(isinstance(m, GroupNorm) for m in card.vae.decoder.modules())
    k5 = (enc * len(list(_chunk_bounds(TINY_FRAMES, 8)))
          + dec * len(list(_chunk_bounds((TINY_FRAMES - 1) // 4 + 1, 2))))
    steps = tcfg.dit.num_layers * 4
    log(f"phase 26b tiny request (head_dim {tcfg.dit.head_dim}, {tcfg.dit.num_heads} heads) "
        f"{TINY_FRAMES}x{TINY_HEIGHT}x{TINY_WIDTH}: card {card_s:.3f} s, CPU {host_s:.3f} s; "
        f"K1 hd/K2 hd/K1/K2/K5 launches {'/'.join(map(str, counts))}")
    check(counts == [steps, steps, 0, 0, k5],
          f"phase 26b tiny request: launches {counts}, not {[steps, steps, 0, 0, k5]}")
    for field in ("rgb", "disparity", "raymap"):
        cross_device_gates(f"phase 26b tiny request {field}", getattr(got, field),
                           getattr(want, field))
    path_launches[tcfg.dit.head_dim] = tuple(counts[:2])
    del host, card, dit, vae, got, want

    # (ii) the tiny DiT at the other head dims, one forward on each side
    for hd in HD_DIMS:
        if hd == tcfg.dit.head_dim:
            continue
        dcfg = dataclasses.replace(DiTConfig.tiny(), head_dim=hd)
        model = init_dit(dcfg, dtype=torch.bfloat16, seed=0)
        h, w = dcfg.sample_height, dcfg.sample_width
        hidden = torch.randn((1, 3, dcfg.in_channels, h, w), generator=host_gen).bfloat16()
        prompt = torch.randn((1, dcfg.max_text_seq_length, dcfg.text_embed_dim),
                             generator=host_gen)
        cos, sin = prepare_rotary_positional_embeddings(dcfg, h * 8, w * 8, 3,
                                                        vae_scale_factor_spatial=8)
        args = (hidden, prompt, torch.tensor([500]), torch.from_numpy(cos),
                torch.from_numpy(sin))
        with torch.no_grad():
            want = model(*args)
            model.to(dev)
            for fn in counted:
                fn.launches = 0
            got = model(*(a.to(dev) for a in args))
            torch.cuda.synchronize()
        counts = [fn.launches for fn in counted]
        log(f"phase 26b tiny DiT at head_dim {hd}: K1 hd/K2 hd/K1/K2/K5 launches "
            f"{'/'.join(map(str, counts))}")
        check(counts == [dcfg.num_layers, dcfg.num_layers, 0, 0, 0],
              f"phase 26b tiny DiT at head_dim {hd}: launches {counts}")
        cross_device_gates(f"phase 26b tiny DiT at head_dim {hd}", got.float().cpu(),
                           want.float())
        path_launches[hd] = tuple(counts[:2])
        del model, got, want

    # (iii) K1 and K2 at the main path's shape
    results = {}
    s_pad = 15360
    for hd in PREPACKED_HD_DIMS:
        d = HEADS * hd
        y = torch.randn((1, s_pad, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
        y[:, SEQ:] = 0
        xs = (y[..., :d], y[..., d:2 * d], y[..., 2 * d:])
        norms = [1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev),
                 0.1 * torch.randn(hd, generator=gen, device=dev),
                 1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev),
                 0.1 * torch.randn(hd, generator=gen, device=dev)]
        ang = torch.randn((SEQ, hd // 2), generator=gen, device=dev)
        rope = (ang.cos().repeat_interleave(2, -1), ang.sin().repeat_interleave(2, -1))
        sdpa = sdpa_ms(dev, gen, 1, torch.bfloat16, hd)
        half = HEADS * s_pad * hd
        k1_in = SEQ * 3 * d * 2 + 2 * SEQ * hd * 4
        for quantize in (True, False):
            branch = "int8" if quantize else "float"
            pkw = dict(num_heads=HEADS, head_dim=hd, eps=1e-6, s_valid=SEQ,
                       quantize=quantize)

            def k1():
                return qkv_prologue(*xs, *norms, *rope, **pkw)

            def k1_plain():
                return qkv_prologue_plain(*xs, *norms, *rope, **pkw)

            before = qkv_prologue_hd.launches
            got, ref = k1(), k1_plain()
            torch.cuda.synchronize()
            check(qkv_prologue_hd.launches == before + 1, "K1 hd: not one launch a call")
            name = f"K1 {branch} at head_dim {hd}"
            if quantize:
                err = k1_int8_gates(name, got, ref)
            else:
                err = k1_float_gates(name, got, ref)
            check(all(torch.equal(a, b) for a, b in zip(got[:7], k1()[:7])),
                  f"{name}: two launches differ")
            ms, plain_ms = cuda_time_ms(k1, 20), cuda_time_ms(k1_plain, 3)
            # the same 20 calls replayed from a CUDA graph: the card's time
            # alone (at 16 the wrapper's host time sets the pace of the above)
            alone_ms = graph_ms(k1)
            out_bytes = (2 if quantize else 4) * half + 2 * half
            bnd = bound(k1_in + out_bytes, {"f32": 30.0 * 2 * SEQ * d})
            log(f"{name} time: kernel {ms:.4f} ms ({bnd[0] / ms:.1%} of its {bnd[0]:.4f} ms "
                f"{bnd[1]} bound), from a CUDA graph {alone_ms:.4f} ms "
                f"({bnd[0] / alone_ms:.1%}), plain {plain_ms:.4f} ms")
            results["K1", hd, branch] = (err, ms, plain_ms, bnd, None)

            q, k, v, qsc, qn, ksc, kn, _ = got
            fkw = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=SEQ)
            name = f"K2 {branch} at head_dim {hd}"

            def k2():
                return flash_attention_prepacked(q, k, v, **fkw)

            def k2_plain():
                return flash_attention_prepacked_plain(q, k, v, **fkw)

            before = flash_attention_prepacked_hd.launches
            out, out_ref = k2(), k2_plain()
            torch.cuda.synchronize()
            check(flash_attention_prepacked_hd.launches == before + 1,
                  "K2 hd: not one launch a call")
            bars = (1e-2, 1e-3) if quantize else bf16_gates(out_ref)
            err = compare(name, out, out_ref, *bars)
            check(torch.equal(out, k2()), f"{name}: two launches differ")
            ms, plain_ms = cuda_time_ms(k2, 5), cuda_time_ms(k2_plain, 2)
            kinds = ("int8", "bf16") if quantize else ("bf16", "bf16")
            bnd = bound((2 if quantize else 4) * half + 2 * 2 * half,
                        attention_ops(1, SEQ, kinds, hd), attention_exp2(1))
            flops = 4.0 * HEADS * SEQ * SEQ * hd
            log(f"{name} time: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                f"{bnd[0] / ms:.1%} of its {bnd[0]:.4f} ms {bnd[1]} bound), plain "
                f"{plain_ms:.4f} ms, SDPA bf16 (1, 48, 15076, {hd}) {sdpa:.4f} ms: "
                f"{ms / sdpa:.3f}x")
            results["K2", hd, branch] = (err, ms, plain_ms, bnd, sdpa)
            del got, ref, out, out_ref, q, k, v
        del y, xs
        torch.cuda.empty_cache()
    return path_launches, results


# ---------------------------------------------------------------------------
# phase 27: K3, K4 and K6 at every head dim and dtype the JAX wrapper takes
# ---------------------------------------------------------------------------

# (a) K3 (bf16 v) and K6 at every head dim of their wgmma kernels but 64;
# K4 bf16 also at 128, where the JAX wrapper forces "vpu"; K4 f32 at the
# head dims phase 27's paths run it at (PATH_ONLINE_HD_DIMS, also K4 bf16's
# on those paths); K3 in f32 also at 64
FIXED_HD_DIMS = (16, 32, 48, 80, 96, 112)
ONLINE_HD_DIMS = FIXED_HD_DIMS + (128,)
PATH_ONLINE_HD_DIMS = HD_DIMS + (128,)
F32_HD_DIMS = (16, 32, 64, 112)
# K4 f32 at 128 (max, mean abs error against its plain version): each kv
# tile's P V added on the FMA units, as at 16-112, reads their level; on the
# tensor-core accumulator it read 1.27e-5 / 1.14e-6
K4_F32_128_BARS = (3e-6, 1e-7)
# (b) the trainer CLI's documented tiny run; (b, d) phase 23's tolerance of
# one process against another on the losses
TRAIN_CLI = ("-m", "aether_tpu_torch.train.trainer", "--synthetic", "--tiny", "--steps", "2")
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5
# (c) the unfused attention settings of a tiny request: name -> (environment,
# compute dtype, the head-dim counter they launch, the head dims of (c)'s
# DiT forwards besides the request's 16)
UNFUSED_SETTINGS = {
    "FUSED=0 QK8=1": ({"AETHER_ATTN_FUSED": "0", "AETHER_ATTN_QK8": "1"}, torch.bfloat16,
                      "flash_attention_fixed_max_hd", (32, 112)),
    "FUSED=0 QK8=0": ({"AETHER_ATTN_FUSED": "0", "AETHER_ATTN_QK8": "0"}, torch.bfloat16,
                      "flash_attention_fixed_max_hd", (32, 112)),
    "PV8=1": ({"AETHER_ATTN_PV8": "1"}, torch.bfloat16, "flash_attention_pv8_hd", (32, 112)),
    "FIXED_MAX=0": ({"AETHER_ATTN_FIXED_MAX": "0"}, torch.bfloat16, "flash_attention_hd",
                    (32, 112)),
    "FUSED=0 in f32": ({"AETHER_ATTN_FUSED": "0"}, torch.float32,
                       "flash_attention_fixed_max_f32", (32, 64, 112)),
}
# (d) training steps at these head dims besides the CLI's 16 (K4 f32 hd)
TRAIN_HD_DIMS = (32, 112, 128)


@contextlib.contextmanager
def attention_env(values):
    """The ``AETHER_ATTN_*`` variables set to ``values`` inside the block and
    restored after; every other one unset (the defaults)."""
    names = ("AETHER_ATTN_FUSED", "AETHER_ATTN_QK8", "AETHER_ATTN_PV8", "AETHER_ATTN_FIXED_MAX")
    saved = {n: os.environ.pop(n, None) for n in names}
    os.environ.update(values)
    try:
        yield
    finally:
        for n, v in saved.items():
            os.environ.pop(n, None)
            if v is not None:
                os.environ[n] = v


def attention_counters():
    """{name: wrapper} of every attention kernel's launch counter."""
    from aether_tpu_torch.ops import attn_prologue as ap
    from aether_tpu_torch.ops import flash_attention as fa

    names = ("flash_attention_fixed_max_hd", "flash_attention_fixed_max_f32",
             "flash_attention_hd", "flash_attention_f32_hd", "flash_attention_pv8_hd",
             "flash_attention", "flash_attention_fixed_max", "flash_attention_pv8",
             "flash_attention_prepacked", "flash_attention_prepacked_hd")
    counters = {n: getattr(fa, n) for n in names}
    counters.update(qkv_prologue=ap.qkv_prologue, qkv_prologue_hd=ap.qkv_prologue_hd)
    return counters


def counted(fn, expect, what):
    """Run ``fn`` with every attention counter at 0; check that the counts
    are ``expect`` ({name: n}, every other 0) and return ``fn``'s result."""
    counters = attention_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {n: c.launches for n, c in counters.items() if c.launches}
    check(got == expect, f"{what}: launches {got}, not {expect}")
    return out


def hd_alone_ms(name, q, k, v, out):
    """K3 (``name`` "K3 int8", "K3 bf16" or "K3 f32" with f32 QK^T), K6, K4
    bf16 or K4 f32 alone on the operands its wrapper prepares (uncounted; the
    f32 kernels' split by ``_tf32_operands``): the CUDA-event ms of 5 calls,
    its output held bit for bit to the wrapper's ``out``."""
    from aether_tpu_torch.ops import flash_attention as fa

    b, h, s, hd = q.shape
    if name == "K4 f32":
        qf, kf, vf, kv_len = fa._online_operands(q, k, v, None, None)
        split = fa._tf32_operands(*(t.reshape(b * h, s, hd) for t in (qf, kf, vf)))
        buf = torch.empty((b * h, s, hd), device=q.device)
        ms = cuda_time_ms(lambda: fa._online_f32_launch(split, buf, kv_len), 5)
        got = buf.view(q.shape)
    elif name == "K3 f32":
        ops = fa._fixed_max_operands(q, k, v, sm_scale=None, kv_valid=None,
                                     heads_per_cell=4, noshift=False, qk_int8=False,
                                     pv_int8=False, score_bound=None, unnormalized=False)
        split = fa._tf32_operands(ops.q, ops.k, ops.v)
        buf = torch.empty((b * h, s, hd), device=q.device)
        ms = cuda_time_ms(lambda: fa._fixed_max_f32_launch(split, ops, buf, None), 5)
        got = buf.view(q.shape)
    elif name == "K4 bf16":
        qh, kh, vh = (t.reshape(b * h, s, hd).contiguous() for t in (q, k, v))
        buf = torch.empty_like(qh)
        fold = fa._online_fold(None, hd)
        ms = cuda_time_ms(lambda: fa._online_bf16_launch(qh, kh, vh, buf, s, hd < 128, fold), 5)
        got = buf.view(q.shape)
    elif name == "K6":
        qp, kp, vt, ops, span = fa._pv8_operands(q, k, v, sm_scale=None, kv_valid=None,
                                                 block_k=1024, heads_per_cell=4)
        buf = torch.empty((b * h, qp.shape[1], hd), dtype=q.dtype, device=q.device)
        ms = cuda_time_ms(lambda: fa._pv8_launch(qp, kp, vt, ops, span, buf), 5)
        got = buf[:, :s].reshape(q.shape)
    else:
        ops = fa._fixed_max_operands(q, k, v, sm_scale=None, kv_valid=None,
                                     heads_per_cell=4, noshift=False,
                                     qk_int8=name == "K3 int8", pv_int8=False,
                                     score_bound=None, unnormalized=False)
        buf = torch.empty((b * h, s, hd), dtype=q.dtype, device=q.device)
        ms = cuda_time_ms(lambda: fa._fixed_max_launch(ops, buf, None), 5)
        got = buf.view(q.shape)
    torch.cuda.synchronize()
    check(torch.equal(got, out), f"{name} alone at head_dim {hd} differs from its wrapper")
    return ms


def hd_kernels_phase(dev, gen):
    """Phase 27 (a): K3, K4 and K6 at the main path's 48 heads x 15076
    tokens, batch 1 (K3 with bf16 v and K6 at ``FIXED_HD_DIMS``, K4 bf16 at
    ``ONLINE_HD_DIMS``, K4 f32 at ``PATH_ONLINE_HD_DIMS``, K3 f32 at
    ``F32_HD_DIMS``), against their
    plain versions at the bars of their head_dim-64 counterparts in this
    script: K3 (int8 and bf16 QK^T) max 1e-2 / mean 1e-3, K6 1e-2 / 1e-4
    (phase 10), K4 and K3 in f32 1e-4 / 1e-4, K4 bf16 ``bf16_gates`` (phase
    7). One launch of the head-dim kernel a call, two launches
    bit-identical. The kernel's CUDA-event ms of 5 warm calls (K3, K6 and K4
    bf16 also alone, ``hd_alone_ms``), the plain version's of the one call compared
    (it runs for hundreds of ms; a second would add a minute to the phase),
    the bound and one SDPA call of the same shape and dtype. Returns {(name,
    head_dim): (max abs error, ms, plain ms, bound, SDPA ms)}."""
    from aether_tpu_torch.ops import flash_attention as fa

    def cases(hd):
        bf16 = (torch.bfloat16, 2)
        if hd in FIXED_HD_DIMS:
            yield ("K3 int8", bf16, "flash_attention_fixed_max_hd", ("int8", "bf16"),
                   lambda q, k, v: fa.flash_attention_fixed_max(q, k, v, qk_int8=True),
                   lambda q, k, v: fa.flash_attention_fixed_max_plain(q, k, v, qk_int8=True),
                   (1e-2, 1e-3))
            yield ("K3 bf16", bf16, "flash_attention_fixed_max_hd", ("bf16", "bf16"),
                   fa.flash_attention_fixed_max, fa.flash_attention_fixed_max_plain,
                   (1e-2, 1e-3))
            yield ("K6", bf16, "flash_attention_pv8_hd", ("int8", "int8"),
                   fa.flash_attention_pv8, fa.flash_attention_pv8_plain, (1e-2, 1e-4))
        if hd in F32_HD_DIMS:
            yield ("K3 f32", (torch.float32, 4), "flash_attention_fixed_max_f32",
                   ("tf32x3", "tf32x3"), fa.flash_attention_fixed_max,
                   fa.flash_attention_fixed_max_plain, (1e-4, 1e-4))
        if hd in PATH_ONLINE_HD_DIMS:
            yield ("K4 f32", (torch.float32, 4), "flash_attention_f32_hd", ("tf32x3", "tf32x3"),
                   fa.flash_attention, fa.flash_attention_plain,
                   K4_F32_128_BARS if hd == 128 else (1e-4, 1e-4))
        if hd in ONLINE_HD_DIMS:
            yield ("K4 bf16", bf16, "flash_attention_hd", ("bf16", "bf16"),
                   fa.flash_attention, fa.flash_attention_plain, None)

    results = {}
    for hd in sorted(set(FIXED_HD_DIMS + ONLINE_HD_DIMS + F32_HD_DIMS)):
        sdpa = {}
        for name, (dtype, size), counter, kinds, kernel, plain, bars in cases(hd):
            shape = (1, HEADS, SEQ, hd)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            what = f"phase 27a {name} at head_dim {hd}"
            out = counted(lambda: kernel(q, k, v), {counter: 1}, what)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            ref = plain(q, k, v)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            err = compare(what, out, ref, *(bars or bf16_gates(ref)))
            if name == "K4 f32":
                log(f"{what}: SDPA f32 against the same plain version: max abs err "
                    "%.3e, mean %.3e" % sdpa_errors(q, k, v, ref))
            check(torch.equal(out, kernel(q, k, v)), f"{what}: two launches differ")
            del ref
            ms = cuda_time_ms(lambda: kernel(q, k, v), 5)
            alone = ""
            if name in ("K3 int8", "K3 bf16", "K6", "K4 bf16", "K4 f32", "K3 f32"):
                alone_ms = hd_alone_ms(name, q, k, v, out)
                alone = f"; alone {alone_ms:.4f} ms, the wrapper's passes {ms - alone_ms:.4f} ms"
            del q, k, v, out
            if dtype not in sdpa:
                sdpa[dtype] = sdpa_ms(dev, gen, 1, dtype, hd)
            bnd = bound(4 * size * HEADS * SEQ * hd, attention_ops(1, SEQ, kinds, hd),
                        attention_exp2(1))
            flops = 4.0 * HEADS * SEQ * SEQ * hd
            log(f"{what} time: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                f"{bnd[0] / ms:.1%} of its {bnd[0]:.4f} ms {bnd[1]} bound), plain "
                f"{plain_ms:.4f} ms, SDPA {str(dtype)[6:]} (1, 48, 15076, {hd}) "
                f"{sdpa[dtype]:.4f} ms: {ms / sdpa[dtype]:.3f}x{alone}")
            results[name, hd] = (err, ms, plain_ms, bnd, sdpa[dtype])
            torch.cuda.empty_cache()
    return results


def tiny_train_run(device, cfg, tcfg, n, init):
    """``n`` steps of a ``Trainer`` on ``device`` from the state dict
    ``init`` over the CLI's synthetic batches, (t, eps) drawn on the CPU from
    seed 27. Returns (the losses, the trainer)."""
    from aether_tpu_torch.train.trainer import Trainer, synthetic_batches

    gen = torch.Generator()
    gen.manual_seed(27)

    def noise(shape):
        t = torch.randint(0, 1000, (shape[0],), generator=gen)
        return t, torch.randn(shape, generator=gen)

    trainer = Trainer(cfg, tcfg, device=device, init_params=init, noise=noise)
    return trainer.fit(synthetic_batches(cfg, batch_size=1), steps=n), trainer


def tiny_train_phase(dev):
    """Phase 27 (b) and the training half of (d). (b) the trainer CLI's
    documented tiny run (``TRAIN_CLI``: ``DiTConfig.tiny()``, head_dim 16,
    ``flash_train``: K4 f32 hd on the forward) as a subprocess on the card,
    which must exit 0; then the same two steps (the CLI's TrainConfig and
    synthetic batches) in this process on the card and on the CPU from one
    CPU-built init and one CPU-drawn (t, eps) stream, losses within phase
    23's rtol 2e-4 / atol 2e-5, the card's K4 f32 hd launches exact (2 a
    block a step: the forward and remat's recompute). (d) one step of the
    tiny DiT at each of ``TRAIN_HD_DIMS`` (128: "vpu") the same way. Returns
    ({head_dim: K4 f32 hd launches}, the CLI's seconds)."""
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.models import init_dit
    from aether_tpu_torch.train.trainer import TrainConfig

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *TRAIN_CLI], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-4:]
    log(f"phase 27b `python {' '.join(TRAIN_CLI)}`: exit {proc.returncode} in "
        f"{cli_s:.3f} s; its last lines: " + " | ".join(tail))
    check(proc.returncode == 0, f"phase 27b: the trainer CLI exited {proc.returncode}")

    def steps_on(device, cfg, tcfg, n, init):
        return tiny_train_run(device, cfg, tcfg, n, init)[0]

    launches = {}
    runs = [(16, 2, TrainConfig(learning_rate=1e-5, total_steps=2, warmup_steps=1,
                                log_every=1, attn_impl="flash_train"))]
    runs += [(hd, 1, TrainConfig(learning_rate=1e-5, total_steps=1, warmup_steps=1,
                                 log_every=1, attn_impl="flash_train"))
             for hd in TRAIN_HD_DIMS]
    for hd, n, tcfg in runs:
        cfg = dataclasses.replace(DiTConfig.tiny(), head_dim=hd)
        init = init_dit(cfg, dtype=torch.float32, seed=0).state_dict()
        t0 = time.perf_counter()
        want = steps_on("cpu", cfg, tcfg, n, init)
        cpu_s = time.perf_counter() - t0
        per = 2 * cfg.num_layers * n
        t0 = time.perf_counter()
        got = counted(lambda: steps_on(dev, cfg, tcfg, n, init),
                      {"flash_attention_f32_hd": per}, f"phase 27 training at head_dim {hd}")
        card_s = time.perf_counter() - t0
        err = close(f"phase 27 training losses at head_dim {hd}", got, want, LOSS_RTOL,
                    LOSS_ATOL)
        log(f"phase 27{'b' if hd == 16 else 'd'} {n} tiny training step(s) at head_dim {hd} "
            f"(K4 f32 hd{', vpu' if hd >= 128 else ''}): card losses "
            + ", ".join(f"{x:.6f}" for x in got) + ", CPU " + ", ".join(f"{x:.6f}" for x in want)
            + f" (max abs diff {err:.3e}, rtol {LOSS_RTOL} / atol {LOSS_ATOL}); {per} K4 f32 hd "
            f"launches; card {card_s:.3f} s, CPU {cpu_s:.3f} s")
        launches[hd] = per
    return launches, cli_s


def unfused_tiny_phase(dev):
    """Phase 27 (c) and the forward of (d). (c) one reconstruction request of
    ``PipelineConfig.tiny()`` (head_dim 16, 17x64x96, 4 steps) on the card
    against the same request on the CPU (the same CPU-built weights and
    CPU-drawn noise, f32 wires) at phase 26b's long-video gates, at each of
    ``UNFUSED_SETTINGS`` (the f32 one in an f32 pipeline), 8 launches of the
    setting's head-dim kernel (2 blocks x 4 steps) and none of any other
    attention kernel; then the tiny DiT (4 heads, 2 blocks) at the setting's
    other head dims, one forward on each side at the same gates, 2 launches.
    (d) the tiny DiT at head_dim 128 at the default settings: K4 bf16 "vpu"
    (2 launches), no K1/K2. Returns {(counter, head_dim): launches}."""
    import copy

    from aether_tpu_torch.config import DiTConfig, PipelineConfig
    from aether_tpu_torch.models import init_dit, init_vae
    from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings
    from aether_tpu_torch.pipeline import AetherPipeline
    from aether_tpu_torch.pipeline.aether import TorchNoise

    launches = {}
    tcfg = PipelineConfig.tiny()
    host_gen = torch.Generator()
    host_gen.manual_seed(27)
    text = torch.randn((1, tcfg.dit.max_text_seq_length, tcfg.dit.text_embed_dim),
                       generator=host_gen)
    video = np.random.default_rng(27).integers(
        0, 256, (TINY_FRAMES, TINY_HEIGHT, TINY_WIDTH, 3), dtype=np.uint8)
    kw = dict(task="reconstruction", video=video, height=TINY_HEIGHT, width=TINY_WIDTH,
              num_frames=TINY_FRAMES, num_inference_steps=4, fps=12)
    pipes = {}
    for dtype in (torch.bfloat16, torch.float32):
        dit = init_dit(tcfg.dit, dtype=dtype, seed=0)
        vae = init_vae(tcfg.vae, dtype=dtype, seed=1)
        pipes[dtype] = (
            AetherPipeline(tcfg, dit, vae, text, device="cpu", compute_dtype=dtype),
            AetherPipeline(tcfg, copy.deepcopy(dit), copy.deepcopy(vae), text.to(dev),
                           device=dev, compute_dtype=dtype, compact_transfer=False))
    steps = tcfg.dit.num_layers * 4

    def forward_pair(hd, dtype, what, expect):
        dcfg = dataclasses.replace(DiTConfig.tiny(), head_dim=hd)
        model = init_dit(dcfg, dtype=dtype, seed=0)
        h, w = dcfg.sample_height, dcfg.sample_width
        hidden = torch.randn((1, 3, dcfg.in_channels, h, w), generator=host_gen).to(dtype)
        prompt = torch.randn((1, dcfg.max_text_seq_length, dcfg.text_embed_dim),
                             generator=host_gen)
        cos, sin = prepare_rotary_positional_embeddings(dcfg, h * 8, w * 8, 3,
                                                        vae_scale_factor_spatial=8)
        args = (hidden, prompt, torch.tensor([500]), torch.from_numpy(cos),
                torch.from_numpy(sin))
        with torch.no_grad():
            want = model(*args)
            model.to(dev)
            got = counted(lambda: model(*(a.to(dev) for a in args)), expect, what)
        cross_device_gates(what, got.float().cpu(), want.float())

    t_first = None
    for name, (env, dtype, counter, dims) in UNFUSED_SETTINGS.items():
        host, card = pipes[dtype]
        with attention_env(env):
            t0 = time.perf_counter()
            want = host(noise=TorchNoise(42, "cpu"), **kw)
            host_s = time.perf_counter() - t0
            if t_first is None:  # the first card call builds cuDNN's plans
                t_first = card(noise=HostDrawnNoise(42, dev), **kw)
            hd = tcfg.dit.head_dim
            t0 = time.perf_counter()
            got = counted(lambda: card(noise=HostDrawnNoise(42, dev), **kw), {counter: steps},
                          f"phase 27c tiny request at {name}")
            card_s = time.perf_counter() - t0
            log(f"phase 27c tiny request (head_dim {hd}) at {name} ({str(dtype)[6:]}): "
                f"{steps} {counter} launches, no other attention kernel; card {card_s:.3f} s, "
                f"CPU {host_s:.3f} s")
            for field in ("rgb", "disparity", "raymap"):
                cross_device_gates(f"phase 27c tiny request at {name} {field}",
                                   getattr(got, field), getattr(want, field))
            launches[counter, hd] = launches.get((counter, hd), 0) + steps
            for other in dims:
                n = DiTConfig.tiny().num_layers
                forward_pair(other, dtype, f"phase 27c tiny DiT at head_dim {other}, {name}",
                             {counter: n})
                launches[counter, other] = launches.get((counter, other), 0) + n
    del pipes, t_first
    n = DiTConfig.tiny().num_layers
    with attention_env({}):
        forward_pair(128, torch.bfloat16,
                     "phase 27d tiny DiT at head_dim 128 (default settings)",
                     {"flash_attention_hd": n})
    launches["flash_attention_hd", 128] = n
    return launches


def ring_hd_phase(dev, hd=16, phase="27e"):
    """Phase 27 (e) (and 28c at head_dim 24): ``ring_attention_stripes`` over
    the sp = 4 stripes of a (1, 48, 15076, hd) window (padded to 15360)
    against one K3 hd call, as phase 22c at 64: int8 and bf16 QK^T, 16 K3 hd
    launches each, max abs 1e-2 / mean 1e-3. Returns ({name: (launches,
    error, ring ms, K3 ms)}, the K3 hd launches of the rings)."""
    from aether_tpu_torch.ops.flash_attention import (
        flash_attention_fixed_max,
        ring_attention_stripes,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    q, k, v = (torch.randn((1, HEADS, SEQ, hd), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    seq_pad = -(-SEQ // (SP_STRIPES * 128)) * SP_STRIPES * 128
    rows = seq_pad // SP_STRIPES
    stripes = [[torch.nn.functional.pad(t, (0, 0, 0, seq_pad - SEQ))[:, :, i * rows:(i + 1) * rows]
                .contiguous() for i in range(SP_STRIPES)] for t in (q, k, v)]
    ring, total = {}, 0
    for qk_int8 in (True, False):
        name = f"ring sp={SP_STRIPES} at head_dim {hd}, {'int8' if qk_int8 else 'bf16'} QK^T"

        def run(qk_int8=qk_int8):
            return ring_attention_stripes(*stripes, n_pad=seq_pad - SEQ, qk_int8=qk_int8)

        ref = flash_attention_fixed_max(q, k, v, qk_int8=qk_int8)
        out = counted(lambda: torch.cat(run(), dim=2)[:, :, :SEQ],
                      {"flash_attention_fixed_max_hd": SP_STRIPES ** 2}, f"phase {phase} {name}")
        total += SP_STRIPES ** 2
        err = compare(f"phase {phase} {name} against one K3 hd call", out, ref, 1e-2, 1e-3)
        ms = cuda_time_ms(run, 3)
        k3 = cuda_time_ms(lambda: flash_attention_fixed_max(q, k, v, qk_int8=qk_int8), 3)
        log(f"phase {phase} {name}: {ms:.4f} ms for {SP_STRIPES ** 2} K3 hd steps and the merge, "
            f"one K3 hd call {k3:.4f} ms: {ms / k3:.3f}x")
        ring[name] = (SP_STRIPES ** 2, err, ms, k3)
        del ref, out
    del q, k, v, stripes
    torch.cuda.empty_cache()
    return ring, total


def head_dims_all_phase(dev, gen):
    """Phase 27: (a) ``hd_kernels_phase``, (b, d) ``tiny_train_phase``, (c,
    d) ``unfused_tiny_phase``, (e) ``ring_hd_phase``. Returns ({(counter,
    head_dim): launches on the paths of (b)-(e)}, (a)'s results, seconds by
    part)."""
    secs = {}
    t0 = time.perf_counter()
    launches = unfused_tiny_phase(dev)
    secs["c, d forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train, secs["b CLI"] = tiny_train_phase(dev)
    secs["b, d training"] = time.perf_counter() - t0
    for hd, n in train.items():
        launches["flash_attention_f32_hd", hd] = launches.get(("flash_attention_f32_hd", hd),
                                                              0) + n
    t0 = time.perf_counter()
    ring, n = ring_hd_phase(dev)
    launches["flash_attention_fixed_max_hd", 16] += n
    secs["e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels = hd_kernels_phase(dev, gen)
    secs["a"] = time.perf_counter() - t0
    log("phase 27 seconds: " + ", ".join(f"({k}) {v:.3f}" for k, v in secs.items())
        + "; (e) " + "; ".join(f"{n} {ms:.4f} ms against K3 hd {k3:.4f} ms"
                                for n, (_, _, ms, k3) in ring.items()))
    return launches, kernels, secs


# ---------------------------------------------------------------------------
# phase 28: every head dim below 128 on the padded instances
# ---------------------------------------------------------------------------

# (a) the main path's shape at these head dims (instances 80 and 128)
PADDED_FULL_DIMS = (72, 120)
# (b) the small shape's sequence and head dims
PADDED_SMALL_SEQ = 2048
PADDED_SMALL_K1_DIMS = (8, 24)
PADDED_SMALL_DIMS = (8, 17, 24, 127)
# (c) the tiny DiT's head dims; the ring's
PADDED_TINY_DIMS = (24, 72, 120)
PADDED_RING_DIM = 24
# (c) setting -> (environment, compute dtype, the counters one forward
# launches, num_layers times each)
PADDED_SETTINGS = {
    "defaults": ({}, torch.bfloat16, ("qkv_prologue_hd", "flash_attention_prepacked_hd")),
    "FUSED=0 QK8=1": ({"AETHER_ATTN_FUSED": "0", "AETHER_ATTN_QK8": "1"}, torch.bfloat16,
                      ("flash_attention_fixed_max_hd",)),
    "FUSED=0 QK8=0": ({"AETHER_ATTN_FUSED": "0", "AETHER_ATTN_QK8": "0"}, torch.bfloat16,
                      ("flash_attention_fixed_max_hd",)),
    "PV8=1": ({"AETHER_ATTN_PV8": "1"}, torch.bfloat16, ("flash_attention_pv8_hd",)),
    "FIXED_MAX=0": ({"AETHER_ATTN_FIXED_MAX": "0"}, torch.bfloat16, ("flash_attention_hd",)),
    "FUSED=0 in f32": ({"AETHER_ATTN_FUSED": "0"}, torch.float32,
                       ("flash_attention_fixed_max_f32",)),
    "FIXED_MAX=0 in f32": ({"AETHER_ATTN_FIXED_MAX": "0"}, torch.float32,
                           ("flash_attention_f32_hd",)),
}


def ptxas_of(pattern):
    """'<registers> registers, <stores>/<loads> bytes spilled' of the first
    kernel instance in the build's ptxas report whose mangled name contains
    ``pattern``."""
    from aether_tpu_torch.ops import _build

    name, found = None, {}
    for line in _build.BUILD_LOG["ptxas"].splitlines():
        if "Compiling entry function" in line:
            if name is not None and pattern in name:
                break
            name, found = line.split("'")[1], {}
        elif name is not None and "Used" in line and "registers" in line:
            found["regs"] = re.search(r"Used (\d+) registers", line).group(1)
        elif name is not None and "spill stores" in line:
            found["spill"] = re.findall(r"(\d+) bytes spill", line)
    if name is None or pattern not in name or "regs" not in found:
        return f"{pattern}: not in the build report"
    return (f"{found['regs']} registers, {'/'.join(found.get('spill', ['?', '?']))} bytes "
            "spilled (stores/loads)")


def padded_kernels_phase(dev, gen):
    """Phase 28 (a): at 48 heads x 15076 tokens and each of
    ``PADDED_FULL_DIMS``, K1 and K2 (int8 and float; K1 over 15360 rows),
    K3 (int8, bf16, f32, f32 with int8 QK^T), K4 (bf16, f32) and K6 against
    their plain versions (bf16 outputs at ``bf16_gates`` of the reference,
    whose mean gate scales with it, so that a fold taken from the width
    fails each kernel on its own; f32 at max and mean 1e-4), one launch a call
    on the head-dim counter, two launches bit-identical; CUDA-event times
    (K1 also from a CUDA graph), the plain version's, one SDPA call of the
    same dtype and shape, the bound at the true head dim (so the padding's
    cost shows), and each instance's registers and spill. Returns {(name,
    head_dim): (max abs error, ms, plain ms, bound, SDPA ms)}."""
    from aether_tpu_torch.bench.time_prologue import graph_ms
    from aether_tpu_torch.ops import attn_prologue as ap
    from aether_tpu_torch.ops import flash_attention as fa

    results = {}
    s_pad = -(-SEQ // 1024) * 1024  # 15360, as _pick_pad_and_block pads it
    for hd in PADDED_FULL_DIMS:
        width = fa.head_dim_width(hd)
        d = HEADS * hd
        sdpa = {dt: sdpa_ms(dev, gen, 1, dt, hd) for dt in (torch.bfloat16, torch.float32)}
        # K1 and K2 on the fused projection, as the DiT's fused route
        y = torch.randn((1, s_pad, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
        y[:, SEQ:] = 0
        xs = (y[..., :d], y[..., d:2 * d], y[..., 2 * d:])
        norms = [1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev),
                 0.1 * torch.randn(hd, generator=gen, device=dev),
                 1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev),
                 0.1 * torch.randn(hd, generator=gen, device=dev)]
        ang = torch.randn((SEQ, hd // 2), generator=gen, device=dev)
        rope = (ang.cos().repeat_interleave(2, -1), ang.sin().repeat_interleave(2, -1))
        half = HEADS * s_pad * hd  # at the true head dim
        k1_in = SEQ * 3 * d * 2 + 2 * SEQ * hd * 4
        for quantize in (True, False):
            branch = "int8" if quantize else "float"
            pkw = dict(num_heads=HEADS, head_dim=hd, eps=1e-6, s_valid=SEQ, quantize=quantize)

            def k1():
                return ap.qkv_prologue(*xs, *norms, *rope, **pkw)

            name = f"phase 28a K1 {branch} at head_dim {hd}"
            got = counted(k1, {"qkv_prologue_hd": 1}, name)
            ref = ap.qkv_prologue_plain(*xs, *norms, *rope, **pkw)
            err = (k1_int8_gates if quantize else k1_float_gates)(name, got, ref)
            check(got[0].stride(1) == width and not got[0].as_strided(
                (*got[0].shape[:2], width), got[0].stride())[..., hd:].any(),
                  f"{name}: not written {width} wide with zero columns past {hd}")
            check(all(torch.equal(a, b) for a, b in zip(got[:7], k1()[:7])),
                  f"{name}: two launches differ")
            ms, plain_ms = cuda_time_ms(k1, 20), cuda_time_ms(
                lambda: ap.qkv_prologue_plain(*xs, *norms, *rope, **pkw), 2)
            alone = graph_ms(k1)
            bnd = bound(k1_in + (2 if quantize else 4) * half + 2 * half,
                        {"f32": 30.0 * 2 * SEQ * d})
            regs = ptxas_of(f"prologue_kernelILi{width}ELi{ap._CTA_ROWS[width]}"
                            f"ELb{int(quantize)}ELb1E")
            log(f"{name} time: kernel {ms:.4f} ms, from a CUDA graph {alone:.4f} ms "
                f"({bnd[0] / alone:.1%} of its {bnd[0]:.4f} ms {bnd[1]} bound at {hd}), plain "
                f"{plain_ms:.4f} ms; the <{width}> instance: {regs}")
            results[f"K1 {branch}", hd] = (err, alone, plain_ms, bnd, None)

            q, k, v, qsc, qn, ksc, kn, _ = got
            fkw = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=SEQ)
            name = f"phase 28a K2 {branch} at head_dim {hd}"

            def k2():
                return fa.flash_attention_prepacked(q, k, v, **fkw)

            out = counted(k2, {"flash_attention_prepacked_hd": 1}, name)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out_ref = fa.flash_attention_prepacked_plain(q, k, v, **fkw)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            err = compare(name, out, out_ref, *bf16_gates(out_ref))
            check(torch.equal(out, k2()), f"{name}: two launches differ")
            ms = cuda_time_ms(k2, 5)
            kinds = ("int8", "bf16") if quantize else ("bf16", "bf16")
            bnd = bound((2 if quantize else 4) * half + 2 * 2 * half,
                        attention_ops(1, SEQ, kinds, hd), attention_exp2(1))
            regs = ptxas_of(f"fixed_cell11cell_kernelILi{width}ELb{int(quantize)}ELb1E")
            log(f"{name} time: kernel {ms:.4f} ms ({bnd[0] / ms:.1%} of its {bnd[0]:.4f} ms "
                f"{bnd[1]} bound at {hd}), plain {plain_ms:.4f} ms, SDPA bf16 (1, 48, 15076, "
                f"{hd}) {sdpa[torch.bfloat16]:.4f} ms: {ms / sdpa[torch.bfloat16]:.3f}x; the "
                f"<{width}> instance: {regs}")
            results[f"K2 {branch}", hd] = (err, ms, plain_ms, bnd, sdpa[torch.bfloat16])
            del got, ref, out, out_ref, q, k, v
        del y, xs
        torch.cuda.empty_cache()

        # K3, K4 and K6 through their wrappers on (1, 48, 15076, hd)
        bf16, f32 = (torch.bfloat16, 2), (torch.float32, 4)
        cases = (
            ("K3 int8", bf16, "flash_attention_fixed_max_hd", ("int8", "bf16"),
             dict(fixed_max=True, qk_int8=True), None,
             f"fixed_cell11cell_kernelILi{width}ELb1ELb0E"),
            ("K3 bf16", bf16, "flash_attention_fixed_max_hd", ("bf16", "bf16"),
             dict(fixed_max=True), None, f"fixed_cell11cell_kernelILi{width}ELb0ELb0E"),
            ("K3 f32", f32, "flash_attention_fixed_max_f32", ("tf32x3", "tf32x3"),
             dict(fixed_max=True), (1e-4, 1e-4), f"tf32x3_cell11cell_kernelILi{width}ELb0ELi1E"),
            ("K3 f32 int8", f32, "flash_attention_fixed_max_f32", ("int8", "tf32x3"),
             dict(fixed_max=True, qk_int8=True), (1e-4, 1e-4),
             f"tf32x3_cell11cell_kernelILi{width}ELb1ELi1E"),
            ("K4 bf16", bf16, "flash_attention_hd", ("bf16", "bf16"), {}, None,
             f"online_cell11cell_kernelILi{width}E"),
            ("K4 f32", f32, "flash_attention_f32_hd", ("tf32x3", "tf32x3"), {}, (1e-4, 1e-4),
             f"tf32x3_cell11cell_kernelILi{width}ELb0ELi2E"),
            ("K6", bf16, "flash_attention_pv8_hd", ("int8", "int8"),
             dict(fixed_max=True, qk_int8=True, pv_int8=True), None,
             f"flash_pv8_kernelILi{width}E13__nv_bfloat16E"),
        )
        for name, (dtype, size), counter, kinds, opts, bars, pattern in cases:
            shape = (1, HEADS, SEQ, hd)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
            what = f"phase 28a {name} at head_dim {hd}"

            def kernel(q=q, k=k, v=v, opts=opts):
                return fa.flash_attention(q, k, v, **opts)

            if name.startswith("K3"):
                plain = fa.flash_attention_fixed_max_plain
                popts = dict(qk_int8=opts.get("qk_int8", False))
            elif name == "K6":
                plain, popts = fa.flash_attention_pv8_plain, {}
            else:
                plain, popts = fa.flash_attention_plain, {}
            out = counted(kernel, {counter: 1}, what)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            ref = plain(q, k, v, **popts)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            err = compare(what, out, ref, *(bars or bf16_gates(ref)))
            check(torch.equal(out, kernel()), f"{what}: two launches differ")
            del ref
            ms = cuda_time_ms(kernel, 5)
            del q, k, v, out
            bnd = bound(4 * size * HEADS * SEQ * hd, attention_ops(1, SEQ, kinds, hd),
                        attention_exp2(1))
            log(f"{what} time: kernel {ms:.4f} ms ({bnd[0] / ms:.1%} of its {bnd[0]:.4f} ms "
                f"{bnd[1]} bound at {hd}), plain {plain_ms:.4f} ms, SDPA {str(dtype)[6:]} (1, "
                f"48, 15076, {hd}) {sdpa[dtype]:.4f} ms: {ms / sdpa[dtype]:.3f}x; the "
                f"<{width}> instance: {ptxas_of(pattern)}")
            results[name, hd] = (err, ms, plain_ms, bnd, sdpa[dtype])
            torch.cuda.empty_cache()
    return results


def padded_small_phase(dev, gen):
    """Phase 28 (b): at (1, 48, ``PADDED_SMALL_SEQ``, D), K1 + K2 (int8) at
    each of ``PADDED_SMALL_K1_DIMS`` and, through ``flash_attention``, K3
    (int8 and bf16 QK^T), K4 (bf16 and f32) and K6 at each of
    ``PADDED_SMALL_DIMS``, against their plain versions at phase 28a's
    gates (K1's of phase 26b), one launch a call on the head-dim counter. Returns the number of
    cases."""
    from aether_tpu_torch.ops import attn_prologue as ap
    from aether_tpu_torch.ops import flash_attention as fa

    n, s = 0, PADDED_SMALL_SEQ
    for hd in PADDED_SMALL_K1_DIMS:
        d = HEADS * hd
        y = torch.randn((1, s, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
        xs = (y[..., :d], y[..., d:2 * d], y[..., 2 * d:])
        norms = [1.0 + 0.1 * torch.randn(hd, generator=gen, device=dev),
                 0.1 * torch.randn(hd, generator=gen, device=dev)] * 2
        ang = torch.randn((s, hd // 2), generator=gen, device=dev)
        rope = (ang.cos().repeat_interleave(2, -1), ang.sin().repeat_interleave(2, -1))
        pkw = dict(num_heads=HEADS, head_dim=hd, eps=1e-6, s_valid=s - 50)
        what = f"phase 28b K1 at (1, 48, {s}, {hd})"
        got = counted(lambda: ap.qkv_prologue(*xs, *norms, *rope, **pkw),
                      {"qkv_prologue_hd": 1}, what)
        k1_int8_gates(what, got, ap.qkv_prologue_plain(*xs, *norms, *rope, **pkw))
        q, k, v, qsc, qn, ksc, kn, _ = got
        fkw = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=s - 50)
        what = f"phase 28b K2 at (1, 48, {s}, {hd})"
        out = counted(lambda: fa.flash_attention_prepacked(q, k, v, **fkw),
                      {"flash_attention_prepacked_hd": 1}, what)
        ref = fa.flash_attention_prepacked_plain(q, k, v, **fkw)
        compare(what, out, ref, *bf16_gates(ref))
        n += 2
    for hd in PADDED_SMALL_DIMS:
        for name, dtype, opts, counter, plain, bars in (
                ("K3 int8", torch.bfloat16, dict(fixed_max=True, qk_int8=True),
                 "flash_attention_fixed_max_hd",
                 lambda q, k, v: fa.flash_attention_fixed_max_plain(q, k, v, qk_int8=True),
                 None),
                ("K3 bf16", torch.bfloat16, dict(fixed_max=True), "flash_attention_fixed_max_hd",
                 fa.flash_attention_fixed_max_plain, None),
                ("K4 bf16", torch.bfloat16, {}, "flash_attention_hd", fa.flash_attention_plain,
                 None),
                ("K4 f32", torch.float32, {}, "flash_attention_f32_hd", fa.flash_attention_plain,
                 (1e-4, 1e-4)),
                ("K6", torch.bfloat16, dict(fixed_max=True, qk_int8=True, pv_int8=True),
                 "flash_attention_pv8_hd", fa.flash_attention_pv8_plain, None)):
            q, k, v = (torch.randn((1, HEADS, s, hd), generator=gen, device=dev).to(dtype)
                       for _ in range(3))
            what = f"phase 28b {name} at (1, 48, {s}, {hd})"
            out = counted(lambda: fa.flash_attention(q, k, v, **opts), {counter: 1}, what)
            ref = plain(q, k, v)
            compare(what, out, ref, *(bars or bf16_gates(ref)))
            n += 1
    return n


def padded_tiny_phase(dev):
    """Phase 28 (c): the tiny DiT (4 heads, 2 blocks) at each of
    ``PADDED_TINY_DIMS``, one batch-1 forward on the card against the CPU (the
    same CPU-built weights and inputs) at the long-video gates under each of
    ``PADDED_SETTINGS``, 2 launches of each of the setting's counters and
    none of any other attention kernel; RoPE tables cut to the head dim.
    Then the sp = 4 ring at ``PADDED_RING_DIM``. Returns ({(counter,
    head_dim): launches}, the ring's {name: (launches, error, ring ms, K3
    ms)})."""
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.models import init_dit
    from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings

    launches = {}
    host_gen = torch.Generator()
    host_gen.manual_seed(28)
    for hd in PADDED_TINY_DIMS:
        dcfg = dataclasses.replace(DiTConfig.tiny(), head_dim=hd)
        h, w = dcfg.sample_height, dcfg.sample_width
        cos, sin = prepare_rotary_positional_embeddings(dcfg, h * 8, w * 8, 3,
                                                        vae_scale_factor_spatial=8)
        cos, sin = (torch.from_numpy(np.ascontiguousarray(t[:, :hd])) for t in (cos, sin))
        hidden = torch.randn((1, 3, dcfg.in_channels, h, w), generator=host_gen)
        prompt = torch.randn((1, dcfg.max_text_seq_length, dcfg.text_embed_dim),
                             generator=host_gen)
        models = {}
        for name, (env, dtype, counters) in PADDED_SETTINGS.items():
            if dtype not in models:
                models[dtype] = init_dit(dcfg, dtype=dtype, seed=0)
            model = models[dtype]
            args = (hidden.to(dtype), prompt, torch.tensor([500]), cos, sin)
            what = f"phase 28c tiny DiT at head_dim {hd}, {name}"
            with attention_env(env), torch.no_grad():
                want = model.cpu()(*args)
                model.to(dev)
                expect = {c: dcfg.num_layers for c in counters}
                got = counted(lambda: model(*(a.to(dev) for a in args)), expect, what)
            cross_device_gates(what, got.float().cpu(), want.float())
            for c in counters:
                launches[c, hd] = launches.get((c, hd), 0) + dcfg.num_layers
        del models
    ring, n = ring_hd_phase(dev, PADDED_RING_DIM, "28c")
    launches["flash_attention_fixed_max_hd", PADDED_RING_DIM] += n
    return launches, ring


def padded_dims_phase(dev, gen):
    """Phase 28: (c) ``padded_tiny_phase``, (b) ``padded_small_phase``, (a)
    ``padded_kernels_phase``. Returns ({(counter, head_dim): launches on (c)'s
    paths}, (a)'s results, seconds by part)."""
    secs = {}
    t0 = time.perf_counter()
    with attention_env({}):
        launches, ring = padded_tiny_phase(dev)
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = padded_small_phase(dev, gen)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels = padded_kernels_phase(dev, gen)
    secs["a"] = time.perf_counter() - t0
    log("phase 28 seconds: " + ", ".join(f"({k}) {v:.3f}" for k, v in secs.items())
        + f"; (b) {n} cases; (c) " + "; ".join(f"{name} {ms:.4f} ms against K3 hd {k3:.4f} ms"
                                               for name, (_, _, ms, k3) in ring.items()))
    return launches, kernels, secs


# ---------------------------------------------------------------------------
# phase 29: K4 above head_dim 128
# ---------------------------------------------------------------------------

# (a) K4 bf16 and f32 at the main path's 48 heads x 15076 tokens at these head
# dims: the instances 160, 192, 224 and 256, and 144 and 200 on padded
# operands; all timed but 200 (PERF.md §7's third cut: 144 stays, its line
# entry holds the tiny DiT's launches of <160>)
WIDE_DIMS = (144, 160, 192, 200, 224, 256)
WIDE_TIMED = (144, 160, 192, 224, 256)
# (b) the AetherV1 width (42 blocks x 3072) regrouped as 12 heads x 256
WIDE_HEADS, WIDE_HEAD_DIM = 12, 256
# (c) the tiny trainer at these head dims (K4 f32), and one forward of the
# tiny DiT in bf16 and in f32 at the defaults (K4 "vpu") at the others whose
# instances (b) and the trainer do not run (144 runs 160's)
WIDE_TRAIN_DIMS = (160, 256)
WIDE_TINY_DIMS = (144, 192, 224)
# (d) K4's outputs at (1, 48, 15076, D) for D 64, 72, 160 and 256 on seeded
# inputs (time_hd_cells.py k4_digests), as commit dbe6a4d gave them on the
# card before K4 took head dims above 256 (its outputs at 64 and 72 equal
# d21dc60's, before 129-256, on numpy-drawn inputs), but f32 at 160 and 256:
# the outputs of flash_online_wide.cu's CTA pair, which replaced
# split_kernel's summation order (held to the plain version at
# K4_F32_128_BARS on these inputs, the same in two card runs): the
# instances up to 256 keep their bits
PARENT_K4_DIGESTS = {"K4 bf16 hd64": "fa5f35e2445ac114", "K4 f32 hd64": "4c3690d8288a42e5",
                     "K4 bf16 hd72": "f6d7d564d463e7ca", "K4 f32 hd72": "f9c863ba3d087916",
                     "K4 bf16 hd160": "3b0dcb73ba43921d", "K4 f32 hd160": "2a2ef38a5377561f",
                     "K4 bf16 hd256": "d3d23aed9d83d8eb", "K4 f32 hd256": "7a6fab4405274968"}


def sdpa_or_none(q, k, v, iters):
    """The CUDA-event ms of one ``scaled_dot_product_attention`` call on (q,
    k, v), the mean of ``iters``, through its flash or memory-efficient
    backend (the library yardstick; the port never calls it), or None where
    neither takes the shape (the math backend would build 48 x 15076^2
    scores)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return cuda_time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), iters)
    except RuntimeError as e:
        reason = str(e).splitlines()[0][:120]
        log(f"  SDPA at {tuple(q.shape)} {str(q.dtype)[6:]}: none ({reason})")
        return None


def k4_dims_cases(dev, gen, label, dims, timed, patterns, plan=None):
    """K4 bf16 and f32 at 48 heads x 15076 tokens, batch 1, at each of
    ``dims``, through ``flash_attention`` against the plain version: bf16 at
    ``bf16_gates``, f32 at ``K4_F32_128_BARS`` (phase 27a's at 128: each
    tile's P V added on the FMA units); one launch a call on the head-dim
    counter, two launches bit-identical. At the head dims of ``timed``:
    CUDA-event ms of 3 calls (f32: 1) through the wrapper
    and of the kernel alone on the operands the wrapper prepares (padded to
    the width; f32: split), the plain version's one call, the bound at the
    true head dim, one SDPA call at the same shape and dtype (flash or
    memory-efficient backend, or none), and the kernel's registers and spill
    (``patterns(width)``: the ptxas name patterns of the bf16 and the f32
    kernel), beside ``plan(width, dtype)`` where given (the launch plan's
    note, such as the wide kernels' cluster size). Returns {(name,
    head_dim): (max abs error, ms, plain ms, bound, SDPA ms or None)}, ms
    None where untimed."""
    from aether_tpu_torch.ops import flash_attention as fa

    results = {}
    for hd in dims:
        width = fa.head_dim_width(hd)
        for (name, dtype, size, counter, kinds, bars), pattern in zip((
                ("K4 bf16", torch.bfloat16, 2, "flash_attention_hd", ("bf16", "bf16"), None),
                ("K4 f32", torch.float32, 4, "flash_attention_f32_hd", ("tf32x3", "tf32x3"),
                 K4_F32_128_BARS)), patterns(width)):
            shape = (1, HEADS, SEQ, hd)
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
            what = f"phase {label} {name} at head_dim {hd}"

            def kernel(q=q, k=k, v=v):
                return fa.flash_attention(q, k, v)

            out = counted(kernel, {counter: 1}, what)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            ref = fa.flash_attention_plain(q, k, v)
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            err = compare(what, out, ref, *(bars or bf16_gates(ref)))
            del ref
            check(torch.equal(out, kernel()), f"{what}: two launches differ")
            bnd = bound(4 * size * HEADS * SEQ * hd, attention_ops(1, SEQ, kinds, hd),
                        attention_exp2(1))
            regs = ptxas_of(pattern) + (f", {plan(width, dtype)}" if plan else "")
            if hd not in timed:
                log(f"{what} (one launch a call on {counter}): untimed; plain {plain_ms:.4f} "
                    f"ms; the <{width}> kernel: {regs}")
                results[name, hd] = (err, None, plain_ms, bnd, None)
                del q, k, v, out
                torch.cuda.empty_cache()
                continue
            # an f32 call runs 0.1-0.3 s up to 256, 0.5-1.3 s above (a
            # depth cut of 5 bf16 and 3 f32 calls to fit the run's time)
            iters = 3 if dtype == torch.bfloat16 else 1
            ms = cuda_time_ms(kernel, iters)
            qh, kh, vh, kv_len, fold = fa._online_kernel_operands(q, k, v, None, None)
            buf = torch.empty((HEADS, SEQ, width), dtype=dtype, device=dev)
            if dtype == torch.bfloat16:
                alone_ms = cuda_time_ms(
                    lambda: fa._online_bf16_launch(qh, kh, vh, buf, kv_len, False, fold), iters)
            else:
                split = fa._tf32_operands((qh * fold).to(qh.dtype), kh, vh)
                alone_ms = cuda_time_ms(lambda: fa._online_f32_launch(split, buf, kv_len), iters)
                del split
            torch.cuda.synchronize()
            check(torch.equal(buf[..., :hd].reshape(shape), out),
                  f"{what}: the kernel alone differs from its wrapper")
            del qh, kh, vh, buf, out
            lib = sdpa_or_none(q, k, v, iters)
            del q, k, v
            log(f"{what} (one launch a call on {counter}) time: kernel {ms:.4f} ms "
                f"({bnd[0] / ms:.1%} of its {bnd[0]:.4f} ms "
                f"{bnd[1]} bound at {hd}), alone {alone_ms:.4f} ms ({bnd[0] / alone_ms:.1%}; "
                f"the wrapper's passes {ms - alone_ms:.4f} ms), plain {plain_ms:.4f} ms, SDPA "
                f"{str(dtype)[6:]} (1, 48, 15076, {hd}) "
                + (f"{lib:.4f} ms: {ms / lib:.3f}x" if lib is not None else "none")
                + f"; the <{width}> kernel: {regs}")
            results[name, hd] = (err, ms, plain_ms, bnd, lib)
            torch.cuda.empty_cache()
    return results


def wide_plan_note(width, dtype):
    """Phase 29a's and 30a's launch plan of K4 at ``width``: bf16 up to 256
    on ``online_cell<D>``; f32 above 128 and bf16 above 256 the wide
    kernels' cluster (``_wide_plan``), with f32's kv tile and ring slots."""
    from aether_tpu_torch.ops import flash_attention as fa

    if dtype == torch.bfloat16 and width <= fa.ONLINE_CELL_TOP:
        return "one CTA a 128-row q tile, 64-row kv tiles"
    plan = fa._wide_plan(width, dtype)
    note = (f"cluster {plan.cluster} x {plan.groups} along y, slices "
            + " + ".join(str(c) for c in plan.score_cols))
    if dtype == torch.float32:
        note += (", 32-row kv tiles, "
                 + ("K and V rings of 2 slots each" if width <= fa.ONLINE_CELL_TOP
                    else "one ring of 2 slots"))
    return note


def wide_kernels_phase(dev, gen):
    """Phase 29 (a): :func:`k4_dims_cases` at ``WIDE_DIMS`` (timed at
    ``WIDE_TIMED``), bf16 on ``online_cell<D>`` (64-row kv tiles), f32 on
    ``flash_online_wide.cu``'s CTA pairs."""
    return k4_dims_cases(dev, gen, "29a", WIDE_DIMS, WIDE_TIMED, lambda width: (
        f"online_cell11cell_kernelILi{width}E", "wide_f3211wide_kernelILb0ELb1E"),
        wide_plan_note)


def wide_request_phase(dev, heads=WIDE_HEADS, head_dim=WIDE_HEAD_DIM, label="29b"):
    """Phase 29 (b), and 30 (b) at 6 x 512: one 41x480x720 reconstruction
    request (4 steps) through ``AetherPipeline.__call__`` on the AetherV1
    width regrouped as ``heads`` heads x ``head_dim`` (42 blocks x 3072,
    seeded random bf16 weights, phase 6's clip): the DiT's unfused route at
    head_dim >= 128, exactly 42 x 4 K4 bf16 launches on the head-dim counter
    and no other attention kernel's (K1, K2, K3, K6 none), K5 at its count,
    outputs of the request's shapes, finite, RGB in [0, 1]. Returns (K4 bf16
    hd launches, the request's seconds)."""
    from aether_tpu_torch.config import PipelineConfig
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments

    cfg = PipelineConfig.aetherv1()
    cfg = dataclasses.replace(cfg, dit=dataclasses.replace(
        cfg.dit, num_heads=heads, head_dim=head_dim))
    check(cfg.dit.hidden_size == HEADS * HEAD_DIM, f"hidden size {cfg.dit.hidden_size}")
    t0 = time.perf_counter()
    pipe = make_pipeline(cfg, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    video = np.random.default_rng(7).integers(0, 256, (FRAMES, HEIGHT, WIDTH, 3), dtype=np.uint8)
    n = cfg.dit.num_layers * STEPS
    k5 = expected_k5(pipe, FRAMES)
    groupnorm_moments.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = counted(lambda: pipe(task="reconstruction", video=video, height=HEIGHT, width=WIDTH,
                               num_frames=FRAMES, num_inference_steps=STEPS, fps=12, seed=42),
                  {"flash_attention_hd": n},
                  f"phase {label} reconstruction request at {heads} heads x {head_dim}")
    wall = time.perf_counter() - t0
    check(groupnorm_moments.launches == k5,
          f"phase {label}: {groupnorm_moments.launches} K5 launches, not {k5}")
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in res.stage_seconds.items())
    log(f"phase {label} reconstruction request, AetherV1 width as {heads} heads x "
        f"{head_dim} (pipeline built in {build_s:.3f} s): {wall:.3f} s ({stages}); "
        f"{n} K4 bf16 hd launches, no K1/K2/K3/K6, {k5} K5; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    check_request(res, FRAMES, f"phase {label} request")
    del pipe, res
    gc.collect()
    torch.cuda.empty_cache()
    return n, wall


def wide_tiny_phase(dev, train_dims=WIDE_TRAIN_DIMS, tiny_dims=WIDE_TINY_DIMS, label="29c"):
    """Phase 29 (c), and 30 (c) at its head dims: the tiny trainer
    (``DiTConfig.tiny()``, 2 blocks, ``flash_train``: K4 f32 hd on the
    forward) at each of ``train_dims``, two steps on the card and on the CPU
    from one init
    and one noise stream: losses within phase 23's rtol 2e-4 / atol 2e-5,
    exactly 2 x 2 x 2 K4 f32 hd launches (blocks x forward and remat's
    recompute x steps), finite loss and gradient norm, the parameters moved
    (the first update has lr 0); then one forward of the tiny DiT at each of
    ``tiny_dims`` in bf16 and in f32 at the defaults on the card against
    the CPU at the long-video gates, 2 launches of the dtype's K4 hd counter
    and no other attention kernel's. Returns {(counter, head_dim):
    launches}."""
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.models import init_dit
    from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings
    from aether_tpu_torch.train.trainer import TrainConfig

    launches = {}
    tcfg = TrainConfig(learning_rate=1e-5, total_steps=2, warmup_steps=1, log_every=1,
                       attn_impl="flash_train")
    for hd in train_dims:
        cfg = dataclasses.replace(DiTConfig.tiny(), head_dim=hd)
        init = init_dit(cfg, dtype=torch.float32, seed=0).state_dict()
        want, _ = tiny_train_run("cpu", cfg, tcfg, 2, init)
        per = 2 * cfg.num_layers * 2
        got, trainer = counted(lambda: tiny_train_run(dev, cfg, tcfg, 2, init),
                               {"flash_attention_f32_hd": per},
                               f"phase {label} training at head_dim {hd}")
        err = close(f"phase {label} training losses at head_dim {hd}", got, want, LOSS_RTOL,
                    LOSS_ATOL)
        norm = float(trainer.state.optimizer.grad_norm)
        moved = sum(int(not torch.equal(p.detach().cpu(), init[n]))
                    for n, p in trainer.state.model.named_parameters())
        n_tensors = len(list(trainer.state.model.parameters()))
        log(f"phase {label} two tiny training steps at head_dim {hd} (K4 f32 hd, vpu): card losses "
            + ", ".join(f"{x:.6f}" for x in got) + ", CPU " + ", ".join(f"{x:.6f}" for x in want)
            + f" (max abs diff {err:.3e}); grad norm {norm:.6f}; {per} K4 f32 hd launches; "
            f"parameters moved in {moved}/{n_tensors} tensors")
        check(all(np.isfinite(got)) and np.isfinite(norm), f"phase {label}: non-finite loss "
              "or gradient norm")
        check(moved >= 0.9 * n_tensors, f"phase {label} at head_dim {hd}: parameters did not "
              "move")
        launches["flash_attention_f32_hd", hd] = per
        del trainer
    host_gen = torch.Generator()
    host_gen.manual_seed(29)
    for hd in tiny_dims:
        dcfg = dataclasses.replace(DiTConfig.tiny(), head_dim=hd)
        h, w = dcfg.sample_height, dcfg.sample_width
        cos, sin = prepare_rotary_positional_embeddings(dcfg, h * 8, w * 8, 3,
                                                        vae_scale_factor_spatial=8)
        hidden = torch.randn((1, 3, dcfg.in_channels, h, w), generator=host_gen)
        prompt = torch.randn((1, dcfg.max_text_seq_length, dcfg.text_embed_dim),
                             generator=host_gen)
        for dtype, counter in ((torch.bfloat16, "flash_attention_hd"),
                               (torch.float32, "flash_attention_f32_hd")):
            model = init_dit(dcfg, dtype=dtype, seed=0)
            args = (hidden.to(dtype), prompt, torch.tensor([500]), torch.from_numpy(cos),
                    torch.from_numpy(sin))
            what = f"phase {label} tiny DiT at head_dim {hd}, {str(dtype)[6:]}"
            with attention_env({}), torch.no_grad():
                want = model(*args)
                model.to(dev)
                got = counted(lambda: model(*(a.to(dev) for a in args)),
                              {counter: dcfg.num_layers}, what)
            cross_device_gates(what, got.float().cpu(), want.float())
            launches[counter, hd] = dcfg.num_layers
            del model
    return launches


def wide_dims_phase(dev, gen):
    """Phase 29: (d) the instances up to 128 against the parent's digests,
    (c) ``wide_tiny_phase``, (b) ``wide_request_phase``, (a)
    ``wide_kernels_phase``. Returns ({(counter, head_dim): launches on the
    paths of (b) and (c)}, (a)'s results, seconds by part)."""
    from aether_tpu_torch.bench.time_hd_cells import k4_digests
    from aether_tpu_torch.ops import flash_attention as fa

    secs = {}
    t0 = time.perf_counter()
    got = k4_digests(fa, dev)
    log("phase 29d (and 30e) K4 at (1, 48, 15076, D), D 64, 72, 160 and 256, against "
        "the pins: " + ", ".join(
            f"{n} {d} ({'same' if d == PARENT_K4_DIGESTS[n] else 'DIFFERS'})"
            for n, d in got.items()))
    check(got == PARENT_K4_DIGESTS, "phase 29d: an instance up to 256 changed its bits")
    secs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = wide_tiny_phase(dev)
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n, _ = wide_request_phase(dev)
    launches["flash_attention_hd", WIDE_HEAD_DIM] = n
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels = wide_kernels_phase(dev, gen)
    secs["a"] = time.perf_counter() - t0
    log("phase 29 seconds: " + ", ".join(f"({k}) {v:.3f}" for k, v in secs.items()))
    return launches, kernels, secs


# ---------------------------------------------------------------------------
# phase 30: K4 above head_dim 256
# ---------------------------------------------------------------------------

# (a) K4 bf16 and f32 at the main path's 48 heads x 15076 tokens at these
# head dims: 320 and 512 at their own widths, 272 on 320's (padded); timed at
# 320 and 512 only (PERF.md §7's fourth cut)
ABOVE_DIMS, ABOVE_TIMED = (272, 320, 512), (320, 512)
# (b) the AetherV1 width (42 blocks x 3072) regrouped as 6 heads x 512
ABOVE_HEADS, ABOVE_HEAD_DIM = 6, 512
# (c) the tiny trainer at these head dims (K4 f32), and one forward of the
# tiny DiT in bf16 and in f32 at the others (on the widths 320 and 384)
ABOVE_TRAIN_DIMS, ABOVE_TINY_DIMS = (320, 512), (288, 384)
# (d) one case beyond 512: B, H, S, D
ABOVE_FAR = (1, 4, 2048, 1024)


def above_far_phase(dev, gen):
    """Phase 30 (d): K4 bf16 and f32 at ``ABOVE_FAR`` through
    ``flash_attention`` against the plain version (bf16 at ``bf16_gates``,
    f32 at ``K4_F32_128_BARS``), one launch a call on the dtype's head-dim
    counter. Returns {counter: launches}."""
    from aether_tpu_torch.ops import flash_attention as fa

    launches = {}
    for dtype, counter, bars in ((torch.bfloat16, "flash_attention_hd", None),
                                 (torch.float32, "flash_attention_f32_hd", K4_F32_128_BARS)):
        q, k, v = (torch.randn(ABOVE_FAR, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        what = f"phase 30d K4 {str(dtype)[6:]} at {ABOVE_FAR}"
        out = counted(lambda: fa.flash_attention(q, k, v), {counter: 1}, what)
        ref = fa.flash_attention_plain(q, k, v)
        compare(what, out, ref, *(bars or bf16_gates(ref)))
        launches[counter] = 1
    return launches


def above_dims_phase(dev, gen):
    """Phase 30: (c) ``wide_tiny_phase`` at ``ABOVE_TRAIN_DIMS`` /
    ``ABOVE_TINY_DIMS``, (b) ``wide_request_phase`` at 6 heads x 512, (d)
    :func:`above_far_phase`, (a) :func:`k4_dims_cases` at ``ABOVE_DIMS``
    (timed at ``ABOVE_TIMED``) on the wide kernels. (e), the digests of the
    instances up to 256, is phase 29d. Returns ({(counter, head_dim):
    launches on the paths of (b) and (c)}, (a)'s results, seconds by part)."""
    secs = {}
    t0 = time.perf_counter()
    launches = wide_tiny_phase(dev, ABOVE_TRAIN_DIMS, ABOVE_TINY_DIMS, "30c")
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n, _ = wide_request_phase(dev, ABOVE_HEADS, ABOVE_HEAD_DIM, "30b")
    launches["flash_attention_hd", ABOVE_HEAD_DIM] = n
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    above_far_phase(dev, gen)
    secs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels = k4_dims_cases(
        dev, gen, "30a", ABOVE_DIMS, ABOVE_TIMED,
        lambda width: ("wide_bf1611wide_kernelILb0E", "wide_f3211wide_kernelILb0ELb0E"),
        wide_plan_note)
    secs["a"] = time.perf_counter() - t0
    log("phase 30 seconds: " + ", ".join(f"({k}) {v:.3f}" for k, v in secs.items()))
    return launches, kernels, secs


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    started = time.perf_counter()
    from aether_tpu_torch.config import PipelineConfig
    from aether_tpu_torch.models.rope import prepare_rotary_positional_embeddings
    from aether_tpu_torch.ops import _build
    from aether_tpu_torch.ops.attn_prologue import (
        _launch_plan,
        prologue_occupancy,
        qkv_prologue,
        qkv_prologue_plain,
    )
    from aether_tpu_torch.ops.flash_attention import (
        flash_attention_prepacked,
        flash_attention_prepacked_plain,
    )
    from aether_tpu_torch.ops.groupnorm import groupnorm_moments

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(smi)  # the card's name and power limit, exactly as nvidia-smi gives them
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    global SFU_PER_S
    SFU_PER_S = SFU_PER_CLOCK_PER_SM * n_sm * max_sm_mhz * 1e6
    log(f"SFU exp2 rate for the bounds: {SFU_PER_CLOCK_PER_SM} x {n_sm} SMs x "
        f"{max_sm_mhz:.0f} MHz (clocks.max.sm) = {SFU_PER_S:.4e} per s")

    # ---- 2. build ----
    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.3f} s -> {_build.BUILD_LOG['path']}")
    kernel = "?"
    for line in _build.BUILD_LOG["ptxas"].splitlines():
        if "Compiling entry function" in line:
            kernel = ptxas_kernel_name(line.split("'")[1])
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {kernel}: {line.strip()}")
    for b, hd in ([(1, HEAD_DIM), (2, HEAD_DIM)]
                  + [(1, hd) for hd in PREPACKED_HD_DIMS + PADDED_FULL_DIMS]):
        plan = _launch_plan(b * HEADS, 15360, 1024, 4, hd)
        log(f"K1 launch plan at batch {b}, head_dim {hd}: grid {plan.grid}, clusters of "
            f"{plan.cluster} CTAs x {plan.rows} rows x {plan.hper} heads, {plan.smem_bytes} "
            f"bytes of shared memory a CTA; cudaOccupancyMaxActiveClusters int8 "
            f"{prologue_occupancy(plan, True)}, float {prologue_occupancy(plan, False)}")

    # ---- 3. K1 at the main-path shape ----
    cfg = PipelineConfig.aetherv1()
    d = HEADS * HEAD_DIM
    s_pad = 15360
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    y = torch.randn((1, s_pad, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
    y[:, SEQ:] = 0  # the DiT pads the joint stream with zero rows
    xq, xk, xv = y[..., :d], y[..., d:2 * d], y[..., 2 * d:]
    norms = [1.0 + 0.1 * torch.randn(HEAD_DIM, generator=gen, device=dev),
             0.1 * torch.randn(HEAD_DIM, generator=gen, device=dev),
             1.0 + 0.1 * torch.randn(HEAD_DIM, generator=gen, device=dev),
             0.1 * torch.randn(HEAD_DIM, generator=gen, device=dev)]
    f_lat = (FRAMES - 1) // 4 + 1
    cos, sin = prepare_rotary_positional_embeddings(
        cfg.dit, HEIGHT, WIDTH, f_lat, vae_scale_factor_spatial=8, base_fps=12, fps=12)
    rc = torch.cat([torch.ones(TEXT, HEAD_DIM), torch.from_numpy(cos)]).to(dev)
    rs = torch.cat([torch.zeros(TEXT, HEAD_DIM), torch.from_numpy(sin)]).to(dev)
    check(rc.shape[0] == SEQ, f"rope rows {rc.shape[0]} != {SEQ}")
    kw = dict(num_heads=HEADS, head_dim=HEAD_DIM, eps=cfg.dit.qk_norm_eps, s_valid=SEQ)

    def k1():
        return qkv_prologue(xq, xk, xv, *norms, rc, rs, **kw)

    def k1_plain():
        return qkv_prologue_plain(xq, xk, xv, *norms, rc, rs, **kw)

    got, ref = k1(), k1_plain()
    torch.cuda.synchronize()
    check(got[7] == ref[7] == s_pad, f"s_pad {got[7]} / {ref[7]}")
    k1_err = k1_int8_gates("K1", got, ref)
    check(all(torch.equal(a, b) for a, b in zip(got[:7], k1()[:7])),
          "K1: two launches differ")
    k1_ms = cuda_time_ms(k1, 20)
    k1_plain_ms = cuda_time_ms(k1_plain, 3)
    log(f"K1 time: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")
    check(k1_ms < K1_MS_GATE, f"K1 {k1_ms:.4f} ms, not under {K1_MS_GATE} ms")

    # ---- 4. K2 on K1's outputs ----
    q8, k8, v, qsc, qn, ksc, kn, _ = got
    kw2 = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=SEQ)

    def k2():
        return flash_attention_prepacked(q8, k8, v, **kw2)

    def k2_plain():
        return flash_attention_prepacked_plain(q8, k8, v, **kw2)

    out, out_ref = k2(), k2_plain()
    torch.cuda.synchronize()
    check(out.shape == out_ref.shape == (HEADS, s_pad, HEAD_DIM), f"K2 shape {out.shape}")
    err = (out.float() - out_ref.float()).abs()
    k2_max, k2_mean = err.max().item(), err.mean().item()
    log(f"K2: max abs err {k2_max:.3e}, mean abs err {k2_mean:.3e}")
    check(k2_max <= 1e-2 and k2_mean <= 1e-3, "K2 disagrees with its plain version")
    check(torch.equal(out, k2()), "K2: two launches differ")
    k2_ms = cuda_time_ms(k2, 5)
    k2_plain_ms = cuda_time_ms(k2_plain, 2)
    flops = 4.0 * HEADS * SEQ * SEQ * HEAD_DIM
    log(f"K2 time: kernel {k2_ms:.4f} ms ({flops / k2_ms / 1e9:.1f} TFLOP/s "
        f"of valid-token work), plain {k2_plain_ms:.4f} ms")
    del got, ref, out, out_ref, err, q8, k8, v

    # K2 at the CFG pair's batch 2 (prediction and planning at the defaults),
    # on a generator of its own so that later phases draw the inputs they did
    gen2 = torch.Generator(device=dev)
    gen2.manual_seed(1235)
    y2 = torch.cat([y, torch.randn(y.shape, generator=gen2, device=dev).to(torch.bfloat16)])
    y2[:, SEQ:] = 0
    x2 = (y2[..., :d], y2[..., d:2 * d], y2[..., 2 * d:])
    got = qkv_prologue(*x2, *norms, rc, rs, **kw)
    ref = qkv_prologue_plain(*x2, *norms, rc, rs, **kw)
    torch.cuda.synchronize()
    k1b_err = k1_int8_gates("K1 at batch 2", got, ref)
    k1b_ms = cuda_time_ms(lambda: qkv_prologue(*x2, *norms, rc, rs, **kw), 20)
    k1b_plain_ms = cuda_time_ms(lambda: qkv_prologue_plain(*x2, *norms, rc, rs, **kw), 2)
    log(f"K1 at batch 2 (2, 15360, 3 x 3072): kernel {k1b_ms:.4f} ms, plain "
        f"{k1b_plain_ms:.4f} ms, max code diff {k1b_err}")
    q8, k8, v, qsc, qn, ksc, kn, _ = got
    del ref
    kw2b = dict(qsc=qsc, ksc=ksc, qn=qn, kn=kn, s_valid=SEQ)
    out = flash_attention_prepacked(q8, k8, v, **kw2b)
    out_ref = flash_attention_prepacked_plain(q8, k8, v, **kw2b)
    torch.cuda.synchronize()
    check(out.shape == out_ref.shape == (2 * HEADS, s_pad, HEAD_DIM),
          f"K2 at batch 2 shape {out.shape}")
    err = (out.float() - out_ref.float()).abs()
    log(f"K2 at batch 2: max abs err {err.max().item():.3e}, mean abs err "
        f"{err.mean().item():.3e}")
    check(err.max().item() <= 1e-2 and err.mean().item() <= 1e-3,
          "K2 at batch 2 disagrees with its plain version")
    check(torch.equal(out, flash_attention_prepacked(q8, k8, v, **kw2b)),
          "K2 at batch 2: two launches differ")
    k2b_ms = cuda_time_ms(lambda: flash_attention_prepacked(q8, k8, v, **kw2b), 5)
    del y2, x2, got, out, out_ref, err, q8, k8, v
    torch.cuda.empty_cache()
    k2b_sdpa = sdpa_ms(dev, gen2, 2, torch.bfloat16)
    log(f"K2 at batch 2 (96, 15360, 64): {k2b_ms:.4f} ms ({2 * flops / k2b_ms / 1e9:.1f} "
        f"TFLOP/s), SDPA bf16 (2, 48, 15076, 64) {k2b_sdpa:.4f} ms: {k2b_ms / k2b_sdpa:.3f}x")

    # ---- 14. the float (AETHER_ATTN_QK8=0) K1 and K2 at the main-path shape ----
    floats = float_k1_k2_phase((xq, xk, xv, *norms, rc, rs), kw)
    del y, xq, xk, xv
    torch.cuda.empty_cache()

    # ---- 4b. K5 at the decode and latent stages ----
    k5_err, k5_ms, k5_plain_ms, k5_bound, k5_by = k5_phase(dev, gen)

    # ---- 5. the pipeline on the AetherV1 config ----
    t0 = time.perf_counter()
    pipe = make_pipeline(cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.dit.parameters())
    log(f"pipeline: AetherV1 DiT {n_params / 1e9:.3f}B params + VAE, bf16, "
        f"built in {time.perf_counter() - t0:.3f} s")

    # ---- 6. two reconstruction requests ----
    video = np.random.default_rng(7).integers(0, 256, (FRAMES, HEIGHT, WIDTH, 3),
                                              dtype=np.uint8)
    qkv_prologue.launches = 0
    flash_attention_prepacked.launches = 0
    groupnorm_moments.launches = 0
    k5_per_request = expected_k5(pipe, FRAMES)
    outs, walls = [], []
    for req in range(2):
        torch.cuda.reset_peak_memory_stats(dev)
        before = (qkv_prologue.launches, flash_attention_prepacked.launches,
                  groupnorm_moments.launches)
        t0 = time.perf_counter()
        res = pipe(task="reconstruction", video=video, height=HEIGHT, width=WIDTH,
                   num_frames=FRAMES, num_inference_steps=STEPS, fps=12, seed=42)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls.append(wall)
        k1_n = qkv_prologue.launches - before[0]
        k2_n = flash_attention_prepacked.launches - before[1]
        k5_n = groupnorm_moments.launches - before[2]
        stages = ", ".join(f"{k} {v:.3f} s" for k, v in res.stage_seconds.items())
        log(f"request {req}: {wall:.3f} s ({stages}); K1 launches {k1_n}, "
            f"K2 launches {k2_n}, K5 launches {k5_n}; peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        check(k1_n == k2_n == cfg.dit.num_layers * STEPS,
              f"expected {cfg.dit.num_layers * STEPS} launches of each kernel")
        check(k5_n == k5_per_request, f"expected {k5_per_request} K5 launches")
        check_request(res, FRAMES, f"request {req}")
        outs.append(res)
    for name in ("rgb", "disparity", "raymap"):
        check(np.array_equal(getattr(outs[0], name), getattr(outs[1], name)),
              f"request outputs differ: {name}")
    log("requests 0 and 1: bit-identical outputs")
    k1_launches = qkv_prologue.launches
    k2_launches = flash_attention_prepacked.launches
    first = outs[0]  # phase 22a holds its request to this one
    del res, outs

    # ---- 14. one request through the float K1 and K2 ----
    k1f_launches, k2f_launches = float_request_phase(pipe, video, dev)

    # ---- 14b. one request through K4 bf16 (AETHER_ATTN_FIXED_MAX=0) ----
    k4b_launches = online_request_phase(pipe, video, dev)

    # ---- 6b. geometry on the card ----
    geometry_phase(dev)

    # ---- 6c. the long-video path ----
    k5_launches, long_clip, long_runs = long_video_phase(pipe, dev)

    # ---- 19. the web server: a reconstruction and a prediction job ----
    serve_phase(pipe, dev)

    # ---- 20. the two benchmark drivers ----
    eval_phase(pipe, dev)

    # ---- 21. the training data path: precomputed latents, the native loader ----
    # the files stay until phase 9 has trained on them
    latents = tempfile.TemporaryDirectory(prefix="aether_latents_")
    k5_precompute = precompute_phase(pipe, dev, latents.name)

    # ---- 22. the parallel layer: NCCL at world size 1, tp = 2 over gloo, the ring ----
    par_launches, par_wall, par_tp, par_ring = parallel_phase(pipe, cfg, dev, video, first,
                                                              k5_per_request)
    log(f"phase 22 against phase 6 in this run: (a) the request through the world-size-1 "
        f"mesh {par_wall:.3f} s, phase 6's requests {walls[0]:.3f} / {walls[1]:.3f} s; (b) "
        f"the {TP_BLOCKS}-block forward at tp = {TP_RANKS} "
        + " / ".join(f"{t * 1e3:.3f}" for t in par_tp["forward_s"])
        + f" ms a rank (two ranks sharing the card), one process {par_tp['one_s'] * 1e3:.3f}"
        f" ms; (c) " + "; ".join(f"{n} {ms:.4f} ms against K3 {k3:.4f} ms"
                                  for n, (_, _, ms, k3) in par_ring.items()))

    # ---- 24. the wires and defer_host at full size ----
    wire_secs, wire_launches = wire_phase(pipe, dev, video, first, k5_per_request, long_clip,
                                          long_runs)
    del pipe, first, long_runs
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev)
    log(f"after phases 5-24: {left / 2**30:.2f} GiB still allocated")
    check(left < 2**30, "the phase-5 pipeline was not released (a server worker holds it?)")

    # ---- 25. the server over a dp = 2 and a tp = 2 mesh sharing the card ----
    t0 = time.perf_counter()
    serve_launches, serve_numbers = serve_mesh_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 25: {time.perf_counter() - t0:.3f} s (" + "; ".join(
        f"{mode} = 2: ranks up {n['up_s']:.3f} s, job {n['job_s']:.3f} s, one process "
        f"{n['one_process_s']:.3f} s, peaks " + " / ".join(f"{p:.2f}" for p in n["peaks_gib"])
        + " GiB" for mode, n in serve_numbers.items()) + "); phase 24's calls: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in wire_secs.items()))

    # ---- 26. the CogVideoX-1.5 DiT at full width; K1 + K2 below head_dim 64 ----
    t0 = time.perf_counter()
    cog15 = cogvideox15_phase(cfg, dev)
    hd_launches, hd_kernels = head_dim_phase(dev, gen)
    log(f"phase 26: {time.perf_counter() - t0:.3f} s; (a) " + ", ".join(
        f"{k} {v:.6g}" for k, v in cog15.items()) + "; (b) " + "; ".join(
        f"{kern} {branch} at head_dim {hd}: {ms:.4f} ms (bound {bnd[0]:.4f}, plain "
        f"{plain:.4f}" + (f", SDPA {lib:.4f})" if lib is not None else ")")
        for (kern, hd, branch), (_, ms, plain, bnd, lib) in hd_kernels.items()))

    # ---- 15. the w8a8 products at the main path's shapes ----
    w8a8 = w8a8_phase(dev, gen)

    # ---- 16. quality of the weight formats at full width ----
    quality = quality_phase(cfg, dev)

    # ---- 17-18. int8 w8a8 and fp8 requests, the checkpoint round trip ----
    quantized = quantized_requests_phase(cfg, video, dev)

    # ---- 7. K4 at the training shape ----
    k4 = {dtype: k4_phase(dev, gen, dtype) for dtype in (torch.float32, torch.bfloat16)}

    # ---- 8. flash_attention_trainable ----
    trainable_phase(dev, gen)

    # ---- 9. the fine-tuning path, on phase 21's files ----
    k4_launches = train_phase(dev, latents.name)
    latents.cleanup()

    # ---- 23. parallel training: pp through NCCL, tp = 2 and FSDP over gloo ----
    k4_launches += parallel_train_phase(dev)

    # ---- 10. K3 and K6 at the CFG pair's shape ----
    fixed = fixed_max_phase(dev, gen)

    # ---- 11, 12. prediction through K3, planning through K6 ----
    k3_launches, k6_launches = cfg_phases(cfg, dev)

    # ---- 13. K7-K9, then their bench entry points ----
    variants, variant_times, variants_sdpa = variants_phase(dev, gen)
    bench_launches = bench_phase()

    # ---- 27. K3, K4 and K6 at every head dim and dtype the JAX wrapper takes ----
    t0 = time.perf_counter()
    with attention_env({}):
        hd27_launches, hd27_kernels, _ = head_dims_all_phase(dev, gen)
    log(f"phase 27: {time.perf_counter() - t0:.3f} s; (a) " + "; ".join(
        f"{name} at head_dim {hd}: {ms:.4f} ms (bound {bnd[0]:.4f} {bnd[1]}, plain "
        f"{plain:.4f}, SDPA {lib:.4f})"
        for (name, hd), (_, ms, plain, bnd, lib) in hd27_kernels.items()))

    # ---- 28. every head dim below 128 on the padded instances ----
    t0 = time.perf_counter()
    hd28_launches, hd28_kernels, _ = padded_dims_phase(dev, gen)
    log(f"phase 28: {time.perf_counter() - t0:.3f} s; (a) " + "; ".join(
        f"{name} at head_dim {hd}: {ms:.4f} ms (bound {bnd[0]:.4f} {bnd[1]}, plain "
        f"{plain:.4f}" + (f", SDPA {lib:.4f})" if lib is not None else ")")
        for (name, hd), (_, ms, plain, bnd, lib) in hd28_kernels.items()))

    # ---- 29. K4 above head_dim 128 ----
    t0 = time.perf_counter()
    with attention_env({}):
        hd29_launches, hd29_kernels, _ = wide_dims_phase(dev, gen)
    log(f"phase 29: {time.perf_counter() - t0:.3f} s; (a) " + "; ".join(
        f"{name} at head_dim {hd}: {ms:.4f} ms (bound {bnd[0]:.4f} {bnd[1]}, plain "
        f"{plain:.4f}, SDPA " + (f"{lib:.4f})" if lib is not None else "none)")
        for (name, hd), (_, ms, plain, bnd, lib) in hd29_kernels.items() if ms is not None))

    # ---- 30. K4 above head_dim 256 ----
    t0 = time.perf_counter()
    with attention_env({}):
        hd30_launches, hd30_kernels, _ = above_dims_phase(dev, gen)
    log(f"phase 30: {time.perf_counter() - t0:.3f} s; (a) " + "; ".join(
        f"{name} at head_dim {hd}: {ms:.4f} ms (bound {bnd[0]:.4f} {bnd[1]}, plain "
        f"{plain:.4f}, SDPA " + (f"{lib:.4f})" if lib is not None else "none)")
        for (name, hd), (_, ms, plain, bnd, lib) in hd30_kernels.items() if ms is not None))

    # ---- bounds and library yardsticks ----
    k4_err, k4_ms, k4_plain_ms, _ = k4[torch.float32]
    k4b_err, k4b_ms, k4b_plain_ms, k4b_alone_ms = k4[torch.bfloat16]
    k3_err, k3_ms, k3_plain_ms = fixed["K3 int8 QK^T"]
    k6_err, k6_ms, k6_plain_ms = fixed["K6"]
    d, half = HEADS * HEAD_DIM, HEADS * s_pad * HEAD_DIM
    # K1: the valid rows of the fused bf16 projection and the f32 RoPE tables
    # read once (the kernel loads no row at or past s_valid); int8 q/k and
    # bf16 v written over all s_pad rows (the scales are small); ~30 f32 ops an
    # element of q and k
    k1_in = SEQ * 3 * d * 2
    rope_bytes = 2 * SEQ * HEAD_DIM * 4
    k1_bound = bound(k1_in + rope_bytes + 2 * half + 2 * half, {"f32": 30.0 * 2 * SEQ * d})
    # attention: q/k/v in, out written once; QK^T and PV over the valid
    # tokens; one exp2 a score (K6 evaluates it in its second sweep only)
    e1, e2 = attention_exp2(1), attention_exp2(2)
    k2_bound = bound(2 * half + 2 * 2 * half, attention_ops(1, SEQ, ("int8", "bf16")), e1)
    k3_bound = bound(2 * 4 * 2 * HEADS * SEQ * HEAD_DIM, attention_ops(2, SEQ, ("int8", "bf16")),
                     e2)
    k3_bf16_bound = bound(2 * 4 * 2 * HEADS * SEQ * HEAD_DIM,
                          attention_ops(2, SEQ, ("bf16", "bf16")), e2)
    # K4 f32: both products f32-accurate as three TF32 products each (the
    # 3xTF32 cell), the least the tensor cores take for them
    k4_bound = bound(4 * 4 * HEADS * SEQ * HEAD_DIM,
                     attention_ops(1, SEQ, ("tf32x3", "tf32x3")), e1)
    k4_bf16_bound = bound(4 * 2 * HEADS * SEQ * HEAD_DIM, attention_ops(1, SEQ, ("bf16", "bf16")),
                          e1)
    k6_bound = bound(2 * 4 * 2 * HEADS * SEQ * HEAD_DIM, attention_ops(2, SEQ, ("int8", "int8")),
                     e2)
    # the float K1 writes bf16 q/k; the float K2 reads them
    k1f_bound = bound(k1_in + rope_bytes + 3 * 2 * half, {"f32": 30.0 * 2 * SEQ * d})
    k2f_bound = bound(4 * 2 * half, attention_ops(1, SEQ, ("bf16", "bf16")), e1)
    # K7-K9: bf16 q, k, v read and out written once; bf16 QK^T and PV
    var_bound = bound(4 * 2 * HEADS * SEQ * HEAD_DIM, attention_ops(1, SEQ, ("bf16", "bf16")),
                      e1)
    lib = {"K2": sdpa_ms(dev, gen, 1, torch.bfloat16),
           "K4": sdpa_ms(dev, gen, 1, torch.float32),
           "K4 bf16": sdpa_ms(dev, gen, 1, torch.bfloat16),
           "K3/K6": sdpa_ms(dev, gen, 2, torch.bfloat16)}
    # K1 at the CFG pair's batch 2: twice the projection, the outputs and the
    # operations; the RoPE tables are shared
    k1b_bound = bound(2 * (k1_in + 2 * half + 2 * half) + rope_bytes,
                      {"f32": 2 * 30.0 * 2 * SEQ * d})
    log(f"K1 against its bound: int8 {k1_ms:.4f} ms ({k1_bound[0] / k1_ms:.1%} of "
        f"{k1_bound[0]:.4f}), float {floats['K1 float'][1]:.4f} ms "
        f"({k1f_bound[0] / floats['K1 float'][1]:.1%} of {k1f_bound[0]:.4f}), int8 at batch 2 "
        f"{k1b_ms:.4f} ms ({k1b_bound[0] / k1b_ms:.1%} of {k1b_bound[0]:.4f})")
    log(f"bounds (ms, by): K1 {k1_bound}, K2 {k2_bound}, K3 {k3_bound}, K3 bf16 QK^T "
        f"{k3_bf16_bound}, K4 f32 {k4_bound}, "
        f"K4 bf16 {k4_bf16_bound}, K5 {(k5_bound, k5_by)}, K6 {k6_bound}, K1 float "
        f"{k1f_bound}, K2 float {k2f_bound}, K7-K9 {var_bound}")
    log("weight formats: products (ms: int8 product, w8a8 linear, fp8 linear, bf16 "
        "F.linear) " + "; ".join(f"{n} {p:.4f} / {a:.4f} / {f:.4f} / {b:.4f}"
                                 for n, (p, a, f, b, _) in w8a8.items())
        + "; quality (mean-abs rel, norm rel, cosine) " + "; ".join(
            f"{n} {m:.6f} / {r:.6f} / {c:.6f}" for n, (m, r, c) in quality.items())
        + "; requests (s, peak GiB, DiT GiB) " + "; ".join(
            f"{n} {w:.3f} / {p:.2f} / {g:.3f}" for n, (w, p, g) in quantized.items()))
    log("scaled_dot_product_attention (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in lib.items())
        + f"; K4 bf16 kernel {k4b_ms:.4f} ms (alone {k4b_alone_ms:.4f}), K7 "
        f"{variants['K7'][1]:.4f} ms (phase 13's SDPA {variants_sdpa:.4f}); K6 {k6_ms:.4f} ms "
        f"(alone {fixed['K6 alone']:.4f}), K3 int8 QK^T {k3_ms:.4f} ms (alone "
        f"{fixed['K3 int8 alone']:.4f}), K3 bf16 QK^T {fixed['K3 bf16 QK^T'][1]:.4f} ms "
        f"(alone {fixed['K3 bf16 alone']:.4f}), K2 {k2_ms:.4f} ms, K2 float "
        f"{floats['K2 float'][1]:.4f} ms, K2 at batch 2 {k2b_ms:.4f} ms (SDPA at batch 2 "
        f"{k2b_sdpa:.4f})")
    # K7-K9 run on K4 bf16's cell: each case at 1024x1024 within 1.5x of it
    slow = {n: ms for n, (ms, _, full) in variant_times.items() if full and ms > 1.5 * k4b_ms}
    check(not slow, f"K7-K9 cases above 1.5x K4 bf16's {k4b_ms:.4f} ms: {slow}")
    # K2 and K3 run on the fixed-shift cell: each within 1.25x of SDPA at its
    # shape (a form without wgmma and TMA reads 1.35-2.1x)
    cell = {"K2": (k2_ms, lib["K2"]), "K2 float": (floats["K2 float"][1], lib["K2"]),
            "K2 at batch 2": (k2b_ms, k2b_sdpa),
            "K3 int8 alone": (fixed["K3 int8 alone"], lib["K3/K6"]),
            "K3 bf16 alone": (fixed["K3 bf16 alone"], lib["K3/K6"])}
    slow = {n: round(ms / ref, 3) for n, (ms, ref) in cell.items() if ms > 1.25 * ref}
    check(not slow, f"fixed-shift cell instances above 1.25x SDPA: {slow}")
    # K6 is K3's function with int8 P V; on the card it is not the faster one
    check(k6_ms < 1.5 * k3_ms, "K6 is not within 1.5x of K3 with int8 QK^T")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd, library_ms):
        return {"name": name, "route": "cuda", "source": f"aether_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    log(f"the whole run: {time.perf_counter() - started:.3f} s (the 1200-s limit)")
    print(json.dumps({"kernels": [
        entry("attn_prologue", "attn_prologue.cu", "aether_tpu/ops/attn_prologue.py:91",
              k1_launches + par_launches["K1"] + wire_launches[0] + serve_launches[0],
              k1_err, k1_ms, k1_plain_ms, k1_bound, None),
        entry("flash_prepacked", "flash_prepacked.cu",
              "aether_tpu/ops/flash_attention.py:812",
              k2_launches + par_launches["K2"] + wire_launches[1] + serve_launches[1], k2_max,
              k2_ms, k2_plain_ms, k2_bound, lib["K2"]),
        entry("flash_online", "flash_online.cu", "aether_tpu/ops/flash_attention.py:69",
              k4_launches, k4_err, k4_ms, k4_plain_ms, k4_bound, lib["K4"]),
        entry("flash_online_bf16", "flash_online_bf16.cu",
              "aether_tpu/ops/flash_attention.py:69", k4b_launches, k4b_err, k4b_ms,
              k4b_plain_ms, k4_bf16_bound, lib["K4 bf16"]),
        entry("flash_fixed_max", "flash_fixed_max.cu",
              "aether_tpu/ops/flash_attention.py:151", k3_launches + par_launches["K3"], k3_err,
              k3_ms, k3_plain_ms, k3_bound, lib["K3/K6"]),
        entry("flash_pv8", "flash_pv8.cu", "aether_tpu/ops/flash_attention.py:259",
              k6_launches, k6_err, k6_ms, k6_plain_ms, k6_bound, lib["K3/K6"]),
        entry("groupnorm_moments", "groupnorm_moments.cu", "aether_tpu/ops/groupnorm.py:30",
              k5_launches + k5_precompute + par_launches["K5"] + wire_launches[2]
              + serve_launches[2], k5_err, k5_ms, k5_plain_ms,
              (k5_bound, k5_by), None),
        entry("attn_prologue_float", "attn_prologue.cu", "aether_tpu/ops/attn_prologue.py:150",
              k1f_launches, *floats["K1 float"], k1f_bound, None),
        entry("flash_prepacked_float", "flash_prepacked.cu",
              "aether_tpu/ops/flash_attention.py:845", k2f_launches, *floats["K2 float"],
              k2f_bound, lib["K2"]),
        entry("flash_v2", "flash_variants.cu", "scripts/bench_flash_variants.py:48",
              bench_launches["K7"], *variants["K7"], var_bound, variants_sdpa),
        entry("flash_mh", "flash_variants.cu", "scripts/bench_flash_multihead.py:44",
              bench_launches["K8"], *variants["K8"], var_bound, variants_sdpa),
        entry("flash_x", "flash_variants.cu", "scripts/bench_flash_bisect.py:54",
              bench_launches["K9"], *variants["K9"], var_bound, variants_sdpa),
        *(entry(f"{name}_hd{hd}", source, replaces, hd_launches[hd][i],
                *hd_kernels[kern, hd, "int8"])
          for hd in HD_DIMS
          for i, (name, kern, source, replaces) in enumerate((
              ("attn_prologue", "K1", "attn_prologue.cu",
               "aether_tpu/ops/attn_prologue.py:91"),
              ("flash_prepacked", "K2", "flash_prepacked.cu",
               "aether_tpu/ops/flash_attention.py:812")))),
        *(entry(f"{name}{hd}", source, replaces, hd27_launches[counter, hd],
                *hd27_kernels[kern, hd])
          for name, kern, counter, source, replaces, dims in (
              ("flash_fixed_max_hd", "K3 int8", "flash_attention_fixed_max_hd",
               "flash_fixed_max.cu", "aether_tpu/ops/flash_attention.py:151", HD_DIMS),
              ("flash_fixed_max_f32_hd", "K3 f32", "flash_attention_fixed_max_f32",
               "flash_fixed_max_hd.cu", "aether_tpu/ops/flash_attention.py:151", F32_HD_DIMS),
              ("flash_online_hd", "K4 f32", "flash_attention_f32_hd", "flash_online.cu",
               "aether_tpu/ops/flash_attention.py:69", PATH_ONLINE_HD_DIMS),
              ("flash_online_bf16_hd", "K4 bf16", "flash_attention_hd", "flash_online_bf16.cu",
               "aether_tpu/ops/flash_attention.py:69", PATH_ONLINE_HD_DIMS),
              ("flash_pv8_hd", "K6", "flash_attention_pv8_hd", "flash_pv8.cu",
               "aether_tpu/ops/flash_attention.py:259", HD_DIMS))
          for hd in dims),
        *(entry(f"{name}{hd}", source, replaces, hd28_launches[counter, hd],
                *hd28_kernels[kern, hd])
          for hd in PADDED_FULL_DIMS
          for name, kern, counter, source, replaces in (
              ("attn_prologue_hd", "K1 int8", "qkv_prologue_hd", "attn_prologue.cu",
               "aether_tpu/ops/attn_prologue.py:91"),
              ("flash_prepacked_hd", "K2 int8", "flash_attention_prepacked_hd",
               "flash_prepacked.cu", "aether_tpu/ops/flash_attention.py:812"),
              ("flash_fixed_max_hd", "K3 int8", "flash_attention_fixed_max_hd",
               "flash_fixed_max.cu", "aether_tpu/ops/flash_attention.py:151"),
              ("flash_fixed_max_f32_hd", "K3 f32", "flash_attention_fixed_max_f32",
               "flash_fixed_max_hd.cu", "aether_tpu/ops/flash_attention.py:151"),
              ("flash_online_hd", "K4 f32", "flash_attention_f32_hd", "flash_online.cu",
               "aether_tpu/ops/flash_attention.py:69"),
              ("flash_online_bf16_hd", "K4 bf16", "flash_attention_hd", "flash_online_bf16.cu",
               "aether_tpu/ops/flash_attention.py:69"),
              ("flash_pv8_hd", "K6", "flash_attention_pv8_hd", "flash_pv8.cu",
               "aether_tpu/ops/flash_attention.py:259"))),
        *(entry(f"{name}{hd}", source, "aether_tpu/ops/flash_attention.py:69",
                hd29_launches[counter, hd], *hd29_kernels[kern, hd])
          for name, kern, counter, source in (
              ("flash_online_wide", "K4 f32", "flash_attention_f32_hd", "flash_online_wide.cu"),
              ("flash_online_bf16_hd", "K4 bf16", "flash_attention_hd", "flash_online_bf16.cu"))
          for hd in WIDE_DIMS if (counter, hd) in hd29_launches),
        *(entry(f"{name}{hd}", source, "aether_tpu/ops/flash_attention.py:69",
                hd30_launches[counter, hd], *hd30_kernels[kern, hd])
          for name, kern, counter, source in (
              ("flash_online_wide", "K4 f32", "flash_attention_f32_hd", "flash_online_wide.cu"),
              ("flash_online_wide_bf16", "K4 bf16", "flash_attention_hd",
               "flash_online_wide_bf16.cu"))
          for hd in ABOVE_TIMED if (counter, hd) in hd30_launches),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
