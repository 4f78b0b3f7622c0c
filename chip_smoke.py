"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises on failure:
1. versions and the card (`nvidia-smi` name and power limit);
2. build of the CUDA kernels from textualdegremoval_tpu_torch/csrc;
3. the whole-block kernels `tblock_fused` against their plain PyTorch
   version `tblock_ref` at every block shape of a 512 px restormer_deblur
   forward plus one ragged shape, WithBias and BiasFree, float32 (the
   csrc/tblock.cu pair) and bfloat16 (every call through the pipeline
   `tblock_pipeline`, two calls bitwise equal), with weights at a trained
   block's scale (both halves of the block add O(1) to the residual) and
   the median time of both (CUDA events), and in bf16 the forward's gram
   alone on csrc/wgrad.cu and as torch.matmul (the yardstick);
4. the full-width restormer_deblur network (seeded random weights) on the
   card against the same network on the CPU, whose blocks take the plain
   path, on a small input in float32 (no pipeline call);
5. the evaluation path: `restore_and_score` of the evaluation CLI on
   synthetic 512 x 512 (lq, hq, ref) triples in bfloat16 (f32 parameters),
   one warm-up and two timed, counting kernel launches (52 blocks per
   forward, each through the pipeline), peak memory and a profiled
   forward (device time by kernel, idle share);
6. the backward kernels `gdfn_half_bwd` and `attn_half_bwd` against plain
   autograd through the two halves of the block, on the same inputs, at
   every block shape of a 384 px, batch-8 training step plus the ragged
   shape, WithBias and BiasFree, float32 and bfloat16: dx and every
   parameter gradient, elementwise and in L2 against the plain gradient's
   norm, with both times (bf16 WithBias at the step's shapes, and float32
   WithBias at the noise widths: the rows the summary reads) and, in bf16
   WithBias, each row's device time
   split by kernel (`torch.profiler`: the LN passes, the stencils, the
   GEMM, pass 1 by its profiler range, wgrad, the glue), each weight-
   gradient product alone on csrc/wgrad.cu beside one torch.matmul(A^T,
   B) on the same operands (the yardstick) and its bound, and the time of
   the block's forward (the pipeline) and of its plain version at that
   shape; the same in float32 and bf16 at PromptIR's noise widths (C =
   704 / 320 / 160 with 4 heads: 176 / 80 / 40 channels a head; float32
   on csrc/tblock_attn_bwd.cu's 4 x 4 tiles at 704, csrc/tblock_bwd.cu's
   2 x 2 for B3); and bwd_mode 'remat' against 'save';
7. the training main path: the training CLI's step function with the
   options of options/train_restoration/restormer_motion_deblur.yml
   (AdamW 2e-4 / ref 1e-4, wd 1e-4, clip 0.01, cosine restarts, L1) and
   param_fix_iterations 2, on seeded synthetic 384 px batch-8 triples in
   bf16 with f32 parameters: a warm-up, two frozen and two released steps
   (each launching 52 forward blocks, all through the pipeline, 52 of
   each backward kernel), one step under bwd_mode 'remat' (52 more forward
   launches), the step timed
   against the same step through plain-autograd blocks in alternating
   turns, the peak memory and the idle share (`torch.profiler`) of each;
   and one f32 step at 128 px, batch 1, on the card against the same step
   on the CPU;
8. the whole-NAFBlock kernels `nafblock_fused` against their plain
   version `nafblock_ref` at every block shape of a 512 px nafnet_deblur
   forward, one ragged shape and the two largest shapes of a 384 px
   batch-8 training step, float32 (the csrc/nafblock.cu pair, its tiles
   and CTAs per SM printed) and bfloat16 (every call through the pipeline
   `naf_pipeline`, two calls bitwise equal, each row's device time split
   by kernel), with weights at a trained block's scale (beta, gamma and
   the SCA scale non-zero), and the median time of both and, in bf16, of
   the pair (CUDA events);
9. the NAFNetRefFusion evaluation path: the full-width nafnet_deblur network
   on the card against the same network on the CPU in float32 on a small
   input (no pipeline call), then `restore_and_score` on synthetic
   512 x 512 triples in bfloat16, one warm-up and two timed, 45 kernel
   launches per forward, each through the pipeline, and a profiled
   forward;
10. the NAFNetRefFusion training path: the training CLI's step function
   with the options of options/train_restoration/nafnet_motion_deblur.yml
   (PSNR loss) and param_fix_iterations 2, on seeded synthetic 384 px
   batch-8 triples in bf16: a warm-up, two frozen and two released steps
   (45 launches each, all through the pipeline; after the first released
   step every parameter has a finite gradient), phase 8's rows at every
   training block shape in bf16, and the step timed against the same step
   through plain blocks in alternating turns, with the peak memory of
   each;
11. the flash self-attention kernel `flash_attention` against its plain
   version `attention_ref` at the 512 px UNet's flash shape (2, 4096, 5, 64),
   at head_dim 128, at the shortest routed sequence and at a ragged one,
   float32 and bfloat16, with q and k scaled so that the logits have a
   standard deviation of 3 (peaked rows move the running max): elementwise
   and L2 bounds, two calls bitwise equal, the median time of the kernel,
   the plain version and `F.scaled_dot_product_attention` (the library
   yardstick, never called by the port), and in bf16 the device time of
   the kernel and of SDPA (runs behind a spin, `tools/_card.py`
   `time_ms`), the kernel's TFLOP/s as its bound counts the operations,
   the host's enqueue time of one call, and SDPA's backend kernel by name
   (`torch.profiler`);
12. pipeline A's towers at full SD 2.1 width (seeded random weights,
   `random_init`), float32 with cuDNN's TF32 off: the UNet at the 512 px
   latent through the kernel (5 launches) against the same weights with
   attn_impl='plain' on the card; the text tower with injected words, the
   vision tower, both mappers, the VAE decoder and a UNet at a 32 x 64
   latent (N = 2048, so the kernel runs) on the card against the CPU on
   small inputs;
13. the generation path: the generation CLI's `generate_one` on synthetic
   images at 512 px, 100 DDIM steps, guidance 5, in bf16 (f32 parameters;
   one warm-up and two timed) and in f32 (one timed), 500 kernel launches
   per image, the output (512, 512, 3) uint8 from finite values; the time
   of one DDIM step, a profiled step, and peak memory;
14. the flash backward kernels (`_backward_kernel`: dkv, then dq) against
   the plain backward `attention_bwd_ref` and against autograd through
   `attention_ref`, on the forward kernel's own o and lse, at the training
   shape (4, 4096, 5, 64), the CFG shape, head_dim 128, the shortest
   routed sequence and a ragged one, float32 and bfloat16, logits of
   standard deviation 3: dq, dk, dv elementwise and in L2, the lse against
   logsumexp, two calls bitwise equal, and the median time of the kernel
   pair, of the plain autograd backward and of SDPA's backward (the
   yardstick), and in bf16 the device time of the pair and of SDPA's
   backward, the pair's TFLOP/s as its bound counts the operations, the
   enqueue time of one pair, and SDPA's backend kernel by name;
15. pipeline A's training path: the I2T training CLI's step function
   (`train_i2t.build_towers` / `build_step`) at full SD 2.1 width on
   seeded random towers, 512 px numpy-made images, batch 4,
   --mixed_precision bf16, accumulation 4: a warm-up (every trainable
   parameter gets a finite non-zero gradient), 8 micro-steps with 5
   forward and 4 backward flash launches each (the first self-attention
   precedes every trainable parameter), the trainables moving only at
   micro-steps 4 and 8, the frozen towers bitwise unchanged; remat (10
   forward launches) bitwise equal to no remat; the micro-step timed
   against attn_impl='plain' in alternating turns (CUDA events) with the
   peak memory of each, and a profiled micro-step; one f32 micro-step at
   batch 1 through the kernels against plain (loss 1e-5 relative, each
   trainable gradient 1e-3 in L2); one TR-stage update, after which only
   the clean mapper has moved;
16. the whole-block kernels at PromptIR's noise-block widths, C = 704 /
   320 / 160 with 4 heads (176 / 80 / 40 channels per head) at the 512 px
   forward's sizes plus a ragged shape, against `tblock_ref` with phase
   3's weights, bounds, route checks and columns;
17. the cross-block chain (through `TBlockStage` with chain=True; in
   bfloat16 `chain_pipeline`, the block pipeline's kernels with
   csrc/bwd_gemm.cu's chain epilogue at each block boundary, in float32
   csrc/tblock_chain.cu) at every stage shape of a 512 px
   promptir_all_in_one forward plus a ragged batch-2 shape, WithBias and
   BiasFree, float32 and bfloat16: against the plain chain
   `tblock_chain_ref` and against the whole-block kernels run block by
   block, elementwise and in L2 over what the stage adds (phase 3's
   bounds times sqrt(n) for n blocks), two calls bitwise equal, the chain
   calls and boundary launches counted (in bf16 every boundary through the
   epilogue), the median time of the chain, of the blocks one by one and
   of the plain chain, and in bf16 csrc/tblock_chain.cu's route on the
   same stage beside (its error and time); and the gradient of
   `_TBlockChainFunction` at a 384 px batch-8 training shape (f32)
   against plain autograd;
18. the PromptIRRefFusion evaluation path: the full-width
   promptir_all_in_one network (seeded random weights, non-zero fusion
   gates) on the card against the CPU in float32 on a small input, block
   by block (55 block-kernel launches) and with every stage through the
   chain (11 block-kernel launches, 8 chain calls, 36 chain boundary
   launches); then `restore_and_score` on synthetic 512 x 512 triples in
   bfloat16 through both routes, one warm-up and two timed each, with
   those launch counts per forward (every block-kernel call through the
   pipeline, every chain boundary through the chain epilogue), images/s,
   the host's enqueue time of one forward, peak memory and a profiled
   forward;
19. the standalone GDFN `gdfn_fused` (in bfloat16 `gdfn_pipeline`, the
   block pipeline's two products and gate stencil; in float32
   csrc/gdfn.cu) against its plain version `gdfn_ref` at every GDFN shape
   of a 512 px restormer_deblur forward plus a ragged batch-2 shape,
   float32 and bfloat16, weights at a trained block's scale, elementwise
   and L2 bounds over the GDFN's output, two calls bitwise equal, the
   route counted, the median time of both and in bf16 of csrc/gdfn.cu on
   the same inputs beside; and its
   gradient (the kernel forward, the backward through `gdfn_ref`) at a
   384 px batch-8 shape against autograd through `gdfn_ref`;
20. the MDTA statistics kernels `mdta_stats` against `mdta_stats_ref`,
   and `mdta_attention` against the module path's `mdta_attention_nhwc`,
   at every attention shape of that forward, PromptIR's noise blocks (176
   / 80 / 40 channels per head) and a ragged shape, q and k strided chunks
   of one qkv tensor, float32 (csrc/mdta.cu) and bfloat16 (every call on
   the gram route `mdta_gram`: csrc/wgrad.cu's gram with its square sums,
   csrc/mdta_gram.cu's finish; csrc/mdta.cu timed and bounded beside it,
   and one torch.matmul of the gram on the same operands, the yardstick):
   bounds, two calls bitwise equal, the routes counted, times; and its
   refusal of a call that needs a gradient;
21. the module path as an evaluation route: the full-width
   restormer_deblur network with fused=False, gdfn_fused=True and
   mdta_pallas=True on the card against the CPU in float32, then
   `restore_and_score` on synthetic 512 x 512 triples in bfloat16 (one
   warm-up, two timed; 52 launches of each kernel per forward, every GDFN
   through the pipeline, and none of the whole-block kernel), images/s,
   peak memory, a profiled forward,
   and the module path without the two kernels (in bf16 every B7 call
   through `mdta_gram`);
22. the module path as a training route: the training CLI's step function
   with restormer_motion_deblur.yml's options, fused_kernels off and
   --gdfn_kernel, at 384 px in bf16 (batch 2: module blocks keep every
   activation for autograd, and batch 8 would not fit the card), 52 B6
   launches per step through the pipeline, timed against the same step with every GDFN op by
   op in alternating turns with the peak memory of each; the peak at
   batch 1 and 2 on both routes; one f32 step at 128 px on the card
   against the CPU;
23. the qkv-form probe kernels `qkv_current` (the 1x1 product, then the
   depthwise stencil) and `qkv_composed` (one K = 9C product) against
   their plain versions at the probe tool's four 512 px cases (C -> co
   48 -> 48, 48 -> 128, 96 -> 96, 96 -> 256) and five ragged shapes
   (batch 2, no 8 x 16 tile dividing H or W), float32
   (csrc/probe_qkv_form.cu) and bfloat16 (the TMA + wgmma kernels of
   csrc/probe_qkv_tma.cu, counted in `tma_launches`, where C and co are
   multiples of 8, current at C <= 256; probe_qkv_form.cu at the other
   widths), two calls bitwise equal, and in bf16 the time of each kernel,
   its plain version and one cuDNN conv of the same function beside the
   design model (`bench_qkv_form.reckon`);
24. the stencil probe kernel `stencil_loop` against `stencil_ref` for its
   four variants at the tool's shape (t = 8, W = 512, ch = 128, a bf16
   slab as the tool's) and a ragged one (W = 509: pixels past W in the
   last lane) after 1-4 iterations, and the time per step at the tool's
   shape and 3000 iterations, of the plain version and of one cuDNN
   depthwise conv step; then both probe tools run
   once, as `python -m` runs them, with the launches counted (the probe
   path: the probes are on no path of the model);
25. the network of options/train_restoration/promptir_all_in_one.yml at
   full width through the training CLI's step function at 384 px: bf16
   at batch 8 as phase 7 runs its step (55 blocks, every one through the
   pipeline; three timed steps, no plain turns, peak memory, idle share),
   float32 at
   batch 2 (csrc/tblock.cu, csrc/tblock_bwd.cu and csrc/tblock_attn_bwd.cu,
   176 channels a head in the noise block; two timed steps, peak memory),
   and one float32 step at 128 px on the card against the CPU;
26. restormer_gaussian_gray_denoise_blind.yml (bf16, batch 8) and
   restormer_defocus_dual_pixel_16bit.yml (its float32, batch 2) through
   cli/train_restoration.py's `main` on the card, full width, 384 px
   crops, two iterations over numpy-written PNG folders (the gray
   Gaussian-noise dataset, the 16-bit dual-pixel one), B1-B3 launches
   counted, the logger's lq|gt|pred|ref strip written;
27. the DINO reference-crop matcher at vit_base full width from a seeded
   random state dict in the reference layout (`load_dino`, strict): 8
   crops of 384 px against 480 x 480 refs (4 windows each) in float32,
   card against CPU on 2 of them (tokens, scores, the top-1 where the
   CPU's top-2 margin is clear), ms per step and peak memory;
28. DRSformerRefFusion (the drsformer_derain task: dim 48, blocks 4/6/6/8,
   heads 1/2/4/8, MEFC, nf 48; seeded random weights, non-zero fusion
   gates) on the card against the CPU in float32 at 128 px, then
   `restore_and_score` on synthetic 512 x 512 triples in bfloat16 and
   float32 (one warm-up, two timed; the forward's median ms, peak memory,
   in bf16 a profiled forward's device time and idle share), and one 512 px
   bfloat16 forward of the 200L/SPA variant (drsformer_derain_200l_spa,
   no MEFC);
29. the training CLI's step function with the options of
   drsformer_derain_rain200h.yml at 384 px, float32 (the YAML has no
   mixed_precision) and bfloat16, each at the largest batch of 8, 4, 2, 1
   whose step fits the card (batch 1's peak predicts the others', and a
   batch predicted past 1.25 times the card's memory is not tried; two
   timed steps, peak memory; a profiled float32 step);
30. SFNetRefFusion (sfnet_dehaze_indoor: num_res 16, base 32, nf 32, TLC
   pooling at base 246; random BN statistics) as phase 28, and one 512 px
   bfloat16 forward of sfnet_dehaze_outdoor (TLC base 210); the finest of
   the three outputs is scored;
31. the step of sfnet_dehaze_indoor.yml's options as phase 29, in which
   the BN running statistics move;
32. one float32 step at 128 px on the card against the CPU for each
   family (DRSformer at batch 1, SFNet at batch 2): the loss, every
   gradient, the update and SFNet's BN statistics.
   Phases 28-32 read every kernel counter of the port: none may move (no
   Pallas kernel lies on these paths; every op is plain torch, the
   convolutions cuDNN's), and the kernels line gives each kernel's count
   there as drsformer_sfnet_launches;
33. NAFNetDynamicFusion (DiffIR) at full width (width 64, enc 1/1/1/28,
   10 words: 1.78 B parameters, 1.72 B in the affine heads; seeded,
   float32, TF32 off): a 512 px forward with the embedding of seeded
   full-width towers (CLIP ViT-H/14 at 224 px, I2TMapper at 10 words),
   ms, peak memory, idle share, the embedding's ms an image, and the net
   on the card against the CPU at 128 px;
34. the DiffIR CLI (`train_diffir.main`) on the card over numpy-written
   PNGs, options synthesized as a dict: the frozen towers and phase 33's
   net at 256 px, the largest batch of 8, 4, 2, 1 that fits, three
   iterations through the DevicePrefetcher with the embedding and the step
   timed apart, peak memory, a profiled iteration (the checkpoint writes,
   29 GB of state at this width, recorded rather than made); then one f32
   step card vs CPU at the full widths, one block a level (C3's bounds);
   phases 33-34 read every kernel counter: none may move
   (diffir_launches in the kernels line);
35. the keyed archives: an LMDB (tests/lmdb_spec_writer.py) and a packed
   TFRecord of one seeded PNG folder, every Dataset_PairedImageWithRef
   item through each equal bit for bit to the disk backend's, the decoder
   that read the disk images named; then the training CLI's `main`, two
   iterations on each archive at nafnet_motion_deblur.yml's network
   (float32, 128 px crops, batch 8): 45 `nafblock_fused` launches a step
   (archive_launches in its row);
36. tiled restoration: `utils/tiled.py` `infer_tiled` of a seeded 1536 x
   2048 image with a 512 px reference through the full-width
   restormer_deblur network in bf16, tile 512, overlap 64: 20 tiles and
   1040 B1 launches, all through the pipeline (tiled_launches in its
   row); ms an image and a tile, peak memory beside one 512 px forward's;
   the tiled image on the kernel route against the same tiling on plain
   blocks (tblock_ref) on the card, the tiles within TILED_BF16_ATOL, the
   image within TILED_BF16_L2 and the blend within the largest tile's
   error; the C13 shape (480 x 1280: one row of 3 tiles), and the idle
   share read on it; the identity through the 1536 x 2048 blend;
   `measure_inference_speed` beside `time_ms`; `model_complexity` of the
   network at 512 px from the plain route (fake CPU tensors); the C13
   shape's tiled image under `trace`, whose file names B1's kernels;
37. FID and the metrics: an InceptionV3 with `seeded_init` weights, two
   seeded sets of 2080 images of 512 px made on the card batch by batch,
   float32 features (TF32 off) at batch 32, the card's against the CPU's
   on 4 images, extraction images/s, FID(a, a) about 0 with the host
   seconds of one `frechet_distance`, `calculate_fid_from_images(a, b)`;
   NIQE and the Y-channel PSNR / SSIM (crop_border 4) of phase 36's image
   passed as a card tensor; no kernel launched (fid_launches);
38. the distributed path: two ranks spawned (torch.multiprocessing)
   through the port's `init_distributed` on one card, so the backend rule
   picks gloo; each rank loads phase 2's kernels.  (a) The training CLI's
   step of restormer_motion_deblur.yml's network at full width, bf16, 384
   px, 4 of 8 seeded images a rank with the gradients averaged, against
   one process on all 8 (the loss, the norm, every parameter's gradient
   and the update, DIST_* bounds), 52 launches of B1/B2/B3 a rank, the
   step ms, the all-reduce's ms apart with its bytes, the peak a rank;
   two planted reduces (no division by the world; a stale copy) must
   fail the bounds.  (b) One FSDP step (the same step function on a
   parallel/fsdp.py sharded state) at the same setting against (a) and
   the single process, the bytes each rank holds
   against the replicated state's, the gather and reduce-scatter ms.  (c)
   FSDP of NAFNetDynamicFusion at DiffIR's full width, its deepest
   encoder cut to 4 blocks of 28 (f32, 256 px, 2 images a rank, the embeddings of the frozen full-width towers computed
   once in this process) against one process on all 4: the loss, the
   norm, each rank's slices of the gradients and of the updated
   parameters, DIST_* bounds; the peak a rank
   and the collectives' seconds.  (d) cli/train_restoration.py's `main`
   as two processes under the torch launcher's env on numpy-written
   PNGs, 2 iterations: one train.log of rank 0's lines, one net_g_2.pth
   (strict, equal to both ranks' parameters bit for bit), one strip, and
   a third process, `python -m`, resuming from it.  A rank that raises
   or does not finish in DIST_TIMEOUT fails the phase;
39. the whole-image forward split by rows over ranks (the evaluate CLI's
   --spatial_shard, parallel/spatial.py), two ranks spawned as phase
   38's on the one card over gloo: first B1's statistics row window
   (float32 `tblock_stats_rows`, the bf16 pipeline's
   `fwd_qkv_stencil_rows` and its gram on the view of the own rows)
   against plain sums over the same rows at one block shape a level of
   the sharded forward; (a) one process: the full-width restormer_deblur
   forward in bf16 on phase 36's 1536 x 2048 image with its 512 px
   reference (wall ms, device busy ms, peak, 52 B1 launches), the float32
   forward at 512 px, and the evaluate CLI unsharded on two seeded 515 x
   512 images; (b) each rank's 768 rows of (a)'s forward: 52 B1 launches
   a rank through the pipeline, the number, bytes and ms of its halo
   exchanges and statistic reductions (a traced forward), wall ms and
   peak, the image gathered on rank 0 against (a) (SPATIAL_BF16_*); (c)
   the float32 forward at 512 px sharded, against one process
   (SPATIAL_F32_*, csrc/tblock.cu's window on the card); (d) the CLI's
   `main` in the ranks with --spatial_shard 3 (refused: two ranks) and 2,
   scored on rank 0 alone, against the unsharded CLI (SPATIAL_CLI_*);
40. the same for nafnet_deblur and promptir_all_in_one, run by phase 39's
   function in the same two ranks: (e) first B5's SCA sums' row window
   (float32 `nafblock_sum_rows`, the bf16 pipeline's
   `naf_gate_stencil_rows`) against plain sums over the same rows, and
   B1's statistics window at PromptIR's noise widths (C = 704, 320, 160,
   4 heads) on the route `tblock_fused` takes there; (a) one process:
   each network's full-width bf16 forward of phase 39's image (wall ms,
   device busy ms, idle share, peak, 45 B5 launches through the pipeline
   or 55 B1), its float32 forward at 512 px and the unsharded CLI on
   phase 39's images; (b) each rank's 768 rows: the launches a rank (45
   B5, 55 B1, all through the pipelines), the exchanges and reductions
   with their bytes and ms, wall ms and peak, the gathered image against
   (a) under phase 39's bounds; (c) float32 at 512 px sharded
   (csrc/nafblock.cu's and csrc/tblock.cu's windows) against one process;
   (d) the CLI with --spatial_shard 2 against the unsharded CLI;
41. the same for DRSformer and SFNet, no kernel on their path, run by
   phase 39's function in the same two ranks, DRSformer at a trained
   scale (`trained_scale`), SFNet at PyTorch's init with its gates
   drawn: (a) one process: the full-width bf16 forwards of
   drsformer_derain and sfnet_dehaze_indoor on phase 39's image (wall
   ms, device busy ms, idle share, peak, no launch) and how far each
   moves under roundings alone (`_pool_noise`), and the float32 forwards
   at 512 px of both DRSformer tasks and sfnet_dehaze_indoor; (b) each
   rank's 768 rows: 0 launches of the port's kernels, the exchanges and
   reductions with their bytes and ms, wall ms and peak, every scale of
   the gathered output against (a) under phase 39's elementwise bound
   and in L2 within the larger of phase 39's bound and (a)'s own spread
   at batch 2 (the note above POOL_CLI_RUNS), DRSformer's masks against
   (a)'s (the flips counted and bounded) and its output with (a)'s masks
   replayed, read beside; (c) float32 at 512 px sharded against one
   process with (a)'s masks replayed, the free-running forward and its
   flips read beside (the note above POOL_FLIP_FRACTION); (d) the CLI with --spatial_shard 2 for all
   four tasks against one process on the same reflect-padded images
   (`reflect_padded_scores`; DRSformer's held in float32 and read in
   bf16, each with its flips).

The last line of stdout is {"ok": true, "device": {...}}; the line before
it is nvidia-smi's, and before that a JSON summary of each kernel.  Without
CUDA the script exits non-zero and prints no result.

    python3 chip_smoke.py --plant FAULT

builds a copy of the kernel sources with one fault planted, under a
temporary directory, runs the phase that should catch it in bfloat16 (phase
17: float32 and bfloat16; the NAFBlock pair's and csrc/gdfn.cu's: float32)
at a few shapes
and exits 0 only if its check catches the fault (the strength of the
phase's bound): o_uses_a, gate_tap_dropped and proj_residual_dropped
(phase 3, the bf16 pipeline:
o = v . A in place of v . A^T, the gate stencil without h1's centre tap,
x1 without its residual), dv_uses_a and dq_drops_diag (phase 6, the
attention half's per-head products),
gdfn_dd_kept_outside (phase 6, the GDFN half's gate gradient kept outside
the image), dgrad_wt_as_w (phase 6, the input-gradient product reading
W^T as W), wgrad_last_step_skipped, wgrad_a_kmajor and pass1_v_from_lin
(phase 6: the weight-gradient products skipping each split's last
64-pixel step, or reading A with its transpose bit off; pass 1's v taken
from lin, its stencil skipped), attn_f32_last_chunk_skipped (phase 6 in
float32: csrc/tblock_attn_bwd.cu's pass 1 skipping each third's last
channel chunk, so pass 2 reads q | k | v and lin that were never
written), sca_skipped and halo_kept (phase 8, the NAFBlock pair, run in
float32), naf_sca_unapplied, naf_sums_past_edge, naf_gate_pair_shifted
and naf_scale_dropped (phase 8, the bf16 NAFBlock pipeline: the gate
written without the SCA scale, the sums taking a ragged tile's pixels
past the image, the gate epilogue's halves paired a chunk apart, beta and
gamma dropped),
no_rescale and v_kmajor (phase 11, the flash kernel), no_di, dk_unscaled
and lse_log2 (phase 14, the flash backward and the forward's lse),
chain_ring_zeroed
(phase 17, the chain kernel's statistics without the tile's ring, caught
in f32), chain_ln_mean_dropped (phase 17, the chain epilogue's LayerNorm
without the row's mean subtracted, caught in bf16), gdfn_halo_kept (phase
19, csrc/gdfn.cu's hidden not zeroed outside the image, run in f32),
gdfn_gate_halves_swapped (phase 19, the bf16 pipeline's gate formed as
gelu(d2) d1), mdta_k_unnormed (phase 20, csrc/mdta.cu's finish
without k's norms, run in float32), mdta_gram_k_ssq_dropped (phase 20,
bf16: the gram kernel's square sums of k's boxes not taken, so the finish
divides by sqrt(1e-24)), x9_halo_kept (phase 23, the f32 composed form's X9 not
zeroed outside the image, run in float32), qkv_tma_tap_flipped and
qkv_tma_lin_ring_zeroed (phase 23, bf16: the composed form's x windows
shifted the wrong way along x, the current form's lin zeroed on the
tile's ring inside the image), stencil_reads_past_row (phase 24, the
stencil's pixels past W loaded from the next row, so the right x-shift at
a row's end reads them: caught at the ragged shape) and
stencil_warp_edge_zeroed (phase 24, a warp's last lane taking zero for
its right neighbour from the next warp), stats_window_ignored and
ssq_window_ignored (phase 39's window check: float32 pass A, and the bf16
pipeline's square sums, taking a sharded slab's halo rows too),
sum_window_ignored and gate_window_ignored (phase 40's window check: the
NAFBlock pair's pass A in float32, and the bf16 pipeline's SUM pass,
taking a sharded slab's halo rows into the SCA sums).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from textualdegremoval_tpu_torch.cli.evaluate import (
    TASK_TABLE, restore_and_score,
)
from textualdegremoval_tpu_torch.cli.generate_reference import (
    PROMPT_TEMPLATE, generate_one, random_init,
)
from textualdegremoval_tpu_torch.cli import train_i2t as train_cli
from textualdegremoval_tpu_torch.data import guidance as guidance_data
from textualdegremoval_tpu_torch.diffusion import pipeline
from textualdegremoval_tpu_torch.diffusion.pipeline import GuidanceModules
from textualdegremoval_tpu_torch.diffusion.tokenizer import tokenize_template
from textualdegremoval_tpu_torch.cli.train_restoration import resolve_network
from textualdegremoval_tpu_torch.losses import build_loss
from textualdegremoval_tpu_torch.models import define_network
from textualdegremoval_tpu_torch.models import layers
from textualdegremoval_tpu_torch.models.layers import (
    NAFBlock, TransformerBlock,
)
from textualdegremoval_tpu_torch.models.unet import UNet2DCondition
from textualdegremoval_tpu_torch.ops import _build
from textualdegremoval_tpu_torch.ops import flash_attn as fa
from textualdegremoval_tpu_torch.ops.attention import mdta_attention_nhwc
from textualdegremoval_tpu_torch.ops.pallas import gdfn as gd
from textualdegremoval_tpu_torch.ops.pallas import mdta as md
from textualdegremoval_tpu_torch.ops.pallas import nafblock as nb
from textualdegremoval_tpu_torch.ops.pallas import tblock as tb
from textualdegremoval_tpu_torch.ops.pallas import tblock_attn_bwd as ab
from textualdegremoval_tpu_torch.ops.pallas import tblock_bwd as gb
from textualdegremoval_tpu_torch.ops import probes as pr
from textualdegremoval_tpu_torch.tools import bench_block_bwd as block_bwd_tool
from textualdegremoval_tpu_torch.tools import bench_block_fwd as block_fwd_tool
from textualdegremoval_tpu_torch.tools import bench_flash as flash_tool
from textualdegremoval_tpu_torch.tools import bench_nafblock as naf_tool
from textualdegremoval_tpu_torch.tools import bench_qkv_form as qkv_tool
from textualdegremoval_tpu_torch.tools import bench_stencil as stencil_tool
from textualdegremoval_tpu_torch.tools._card import median_ms, time_ms
from textualdegremoval_tpu_torch.train.schedules import (
    build_schedule, warmup_wrap,
)
from textualdegremoval_tpu_torch.train.trainer import (
    build_optimizer, create_train_state, make_train_step,
)

# kernel vs plain: pass when |kernel - plain| <= atol + rtol * |plain| at
# every element and ||kernel - plain|| <= branch * ||plain - x|| (L2 over
# the output: the error against what the block adds to its input, so a
# fault in either half of the block cannot hide under the residual).
# float32: both sum in f32, in different orders.  bfloat16: the kernel
# rounds the GDFN gate once in f32 where the plain path rounds the dwconv
# output and the gelu product in bf16, a few bf16 ulps (2^-7 relative).
# On an H100 the shipped kernel's branch error was at most 1.5e-6 (f32)
# and 6.5e-3 (bf16); A^T in place of A in bf16 gave 5.5e-2 to 3.4e-1.
TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (1e-1, 5e-2)}
BRANCH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# whole network on the card (kernel) vs on the CPU (plain), float32
NET_ATOL = 2e-3

# (B, H, W, C, heads, blocks of that shape in one 512 px restormer_deblur
# forward), and a ragged shape with no block in the forward
SHAPES = block_fwd_tool.EVAL_SHAPES
TASK = "restormer_deblur"


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# the start of phase 3 (main sets it): log_held gives each phase group's
# end in seconds from there
T_START = time.perf_counter()


def log_held(after: str):
    """The device memory still allocated after a phase (a tensor that
    outlives its phase inflates every later phase's peak), and the
    seconds since phase 3 began."""
    gib = torch.cuda.memory_allocated() / 2 ** 30
    log(f"held after {after}: {gib:.2f} GiB; "
        f"{time.perf_counter() - T_START:.1f} s since phase 3 began")


def randomize_block(blk: TransformerBlock, gen: torch.Generator):
    """Weights at the scale of a trained block, so that both halves add O(1)
    to the residual: every conv weight ~ N(0, 1/fan_in), LN weights near 1
    and biases near 0, and temperatures ~ sqrt(C), since at random weights
    the normalised q.k correlations are O(C^-1/2) and a unit temperature
    leaves the softmax nearly uniform (then A and A^T give nearly the same
    o)."""
    c = blk.norm1.body.weight.shape[0]
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.endswith("temperature"):
                p.copy_(c ** 0.5 * (0.5 + torch.rand(p.shape, generator=gen)))
            elif p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=gen)
                        * p[0].numel() ** -0.5)
            else:
                p.copy_((1.0 if name.endswith("weight") else 0.0)
                        + 0.1 * torch.randn(p.shape, generator=gen))


def kernel_vs_plain(gen: torch.Generator, timed: bool = True,
                    shapes=SHAPES, dtypes=(torch.float32, torch.bfloat16)):
    """Phases 3 and 16.  Returns the bf16 WithBias rows at the main-path
    shapes as (blocks per forward, max_abs, kernel ms, plain ms, gram ms,
    gram library ms): the last two the forward's gram alone on
    csrc/wgrad.cu and one torch.matmul on the same operands (the
    yardstick); untimed, the ms are NaN.  Every bf16 call must run the pipeline
    (`tblock_pipeline`, the route rule of tblock.py at these widths) and
    two calls must be bitwise equal; float32 runs csrc/tblock.cu's pair,
    whose tiles (pass A's, pass B's) are logged."""
    log("kernel vs plain: |k-p| <= atol + rtol*|p| and ||k-p|| <= branch * "
        f"||p-x||; f32 atol/rtol/branch {TOL[torch.float32]}/"
        f"{BRANCH_TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]}/"
        f"{BRANCH_TOL[torch.bfloat16]}")
    log(f"{'B,H,W,C,heads':>22} {'LN':>8} {'dtype':>8} {'max_abs':>10} "
        f"{'max_rel':>10} {'tol_use':>8} {'branch':>10} {'kernel_ms':>10} "
        f"{'plain_ms':>10}  route")
    main_rows = []
    failures = []
    for b, h, w, c, heads, nblk in shapes:
        for ln_type in ("WithBias", "BiasFree"):
            blk = TransformerBlock(c, heads, ln_type=ln_type)
            randomize_block(blk, gen)
            x32 = torch.randn(b, h, w, c, generator=gen)
            for dtype in dtypes:
                blk_d = blk.to(device="cuda", dtype=dtype)
                x = x32.to(device="cuda", dtype=dtype)
                params = blk_d.block_params()
                pipeline = dtype == torch.bfloat16
                with torch.inference_mode():
                    calls = tb.tblock_pipeline.launches
                    got_d = blk_d(x)
                    routed = tb.tblock_pipeline.launches - calls == pipeline
                    same = not pipeline or torch.equal(got_d, blk_d(x))
                    got = got_d.float()
                    want = tb.tblock_ref(x, params, heads, ln_type).float()
                    torch.cuda.synchronize()
                    atol, rtol = TOL[dtype]
                    diff = (got - want).abs()
                    max_abs = diff.max().item()
                    max_rel = max_abs / max(want.abs().max().item(), 1e-30)
                    tol_use = (diff / (atol + rtol * want.abs())).max().item()
                    added = (want - x.float()).norm().clamp_min(1e-30)
                    branch = (diff.norm() / added).item()
                    finite = bool(torch.isfinite(got).all())
                    k_ms = p_ms = g_ms = g_lib = float("nan")
                    if timed:
                        k_ms = median_ms(lambda: blk_d(x))
                        p_ms = median_ms(
                            lambda: tb.tblock_ref(x, params, heads, ln_type))
                    if timed and pipeline and ln_type == "WithBias":
                        with block_bwd_tool.captured_wgrad() as calls:
                            blk_d(x)
                        (gram,) = block_bwd_tool.product_rows(
                            calls, ("gram",), torch.device("cuda"))
                        g_ms, g_lib = gram["ms"], gram["library_ms"]
                        del calls
                name = str(dtype).split(".")[-1]
                route = ("pipeline" if pipeline else
                         tb._block_tiles(_build.load_library(), x, heads)[:2])
                log(f"{f'{b},{h},{w},{c},{heads}':>22} {ln_type:>8} {name:>8} "
                    f"{max_abs:10.3e} {max_rel:10.3e} {tol_use:8.3f} "
                    f"{branch:10.3e} {k_ms:10.4f} {p_ms:10.4f}  {route}"
                    f"{'' if routed else '  NOT ROUTED AS RULED'}"
                    f"{'' if same else '  NOT REPEATABLE'}")
                if not finite or tol_use > 1.0 or branch > BRANCH_TOL[dtype] \
                        or not routed or not same:
                    failures.append((b, h, w, c, heads, ln_type, name))
                if dtype == torch.bfloat16 and ln_type == "WithBias" and nblk:
                    main_rows.append((nblk, max_abs, k_ms, p_ms, g_ms,
                                      g_lib))
                del got, got_d, want
            blk.cpu().float()
    if failures:
        raise RuntimeError(f"kernel disagrees with plain at {failures}")
    return main_rows


def build_network(seed: int, dtype, device, task=TASK,
                  extra=None) -> torch.nn.Module:
    """A task's network at full width with seeded random weights (`extra`:
    network options over the task's); the zero-initialised fusion gates
    and residual scales and the unit temperatures are set to non-zero
    random values so every block's output reaches the result."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = define_network(dict(TASK_TABLE[task], **(extra or {})),
                               dtype=dtype)
    return gate_and_temperatures(model, seed).to(device)


def gate_and_temperatures(model, seed):
    """Non-zero fusion gates and NAFBlock residual scales (beta, gamma),
    and non-unit temperatures, drawn from a seed, so that every block's
    output reaches the result."""
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("alpha", "beta", "gamma")):
                p.copy_(0.25 + 0.5 * torch.rand(p.shape, generator=gen))
            elif name.endswith("temperature"):
                p.copy_(0.5 + torch.rand(p.shape, generator=gen))
    return model


def set_chain(model, on: bool):
    """Route every Restormer stage of `model` through the cross-block chain
    (on) or block by block (off): the `chain` option of its stages."""
    for m in model.modules():
        if isinstance(m, layers.TBlockStage):
            m.chain = on
    return model


def _reset_chain_counts():
    tb.tblock_chain_fused.calls = tb.tblock_chain_fused.launches = 0


def _chain_counts():
    return tb.tblock_chain_fused.calls, tb.tblock_chain_fused.launches


def network_vs_cpu(seed: int, task=TASK, kernel=tb.tblock_fused,
                   routes=((52, None),), extra=None, more=()):
    """Phases 4, 9, 18 and 21: the task's network (with the network
    options `extra`) on the card vs on the CPU (plain), float32, through
    each route (blocks, chain): `blocks` launches of the forward kernel
    `kernel`, `n` launches of each other (kernel, n) of `more` and, with
    chain = (calls, launches), that many chain calls and chain kernel
    launches, every stage routed through the chain."""
    model_cpu = build_network(seed, torch.float32, "cpu", task, extra)
    model_gpu = copy.deepcopy(model_cpu).to("cuda")
    rng = np.random.default_rng(seed + 2)
    lq = rng.random((1, 128, 128, 3), dtype=np.float32)
    ref = rng.random((1, 128, 128, 3), dtype=np.float32)
    with torch.inference_mode():
        want = model_cpu(torch.from_numpy(lq), torch.from_numpy(ref))
    for blocks, chain in routes:
        set_chain(model_gpu, chain is not None)
        for k in (kernel, *(k for k, _ in more)):
            k.launches = 0
        _reset_chain_counts()
        with torch.inference_mode():
            got = model_gpu(torch.from_numpy(lq).cuda(),
                            torch.from_numpy(ref).cuda()).cpu()
        err = (got - want).abs().max().item()
        route = "" if chain is None else (
            f", chain calls/launches {_chain_counts()}")
        others = "".join(f", {k.__name__} {k.launches}" for k, _ in more)
        log(f"{task} f32 128x128, card ({kernel.launches} kernel launches"
            f"{others}{route}) vs CPU (plain): max_abs {err:.3e} (atol "
            f"{NET_ATOL}), max|out| {want.abs().max().item():.3f}")
        if not torch.isfinite(got).all() or err > NET_ATOL \
                or kernel.launches != blocks \
                or any(k.launches != n for k, n in more) \
                or _chain_counts() != (chain or (0, 0)):
            raise RuntimeError(f"{task} on the card disagrees with the "
                               f"CPU: {err}, {kernel.launches} launches, "
                               f"chain {_chain_counts()}")


def synthetic_triple(rng, size=512):
    """A smooth image, its noisy version and a shifted reference, HWC f32."""
    low = rng.random((size // 16, size // 16, 3)).astype(np.float32)
    hq = np.kron(low, np.ones((16, 16, 1), np.float32))
    hq = np.clip(hq + 0.05 * rng.standard_normal(hq.shape), 0, 1).astype(
        np.float32)
    lq = np.clip(hq + rng.standard_normal(hq.shape) * 15 / 255, 0, 1).astype(
        np.float32)
    ref = np.ascontiguousarray(np.roll(hq, (7, -5), axis=(0, 1)))
    return lq, hq, ref


def main_path(seed: int, task=TASK, kernel=tb.tblock_fused, blocks=52,
              chain=None, extra=None, more=(), enqueue=False):
    """Phases 5, 9, 18 and 21, the evaluation path of `task` (with the
    network options `extra`), whose every forward launches its forward
    kernel `kernel` `blocks` times and each other (kernel, n) of `more` n
    times and, with `chain` = (calls, launches) per forward, makes that
    many chain calls and chain kernel launches, every stage routed through
    the chain.  Returns (the launches of `kernel`, forward ms, the chain
    calls and launches, the launches of each kernel of `more`), and with
    `enqueue` the host's time to enqueue one forward (ms, the median of
    single forwards, the card synchronised between them)."""
    model = set_chain(
        build_network(seed, torch.bfloat16, "cuda", task, extra),
        chain is not None)
    rng = np.random.default_rng(seed + 3)
    triples = [synthetic_triple(rng) for _ in range(2)]
    for k in (kernel, *(k for k, _ in more)):
        k.launches = 0
    _reset_chain_counts()
    forwards = 0
    _, psnr, ssim = restore_and_score(model, *triples[0])
    forwards += 1
    log(f"{task} warm-up psnr {psnr:.4f} ssim {ssim:.4f}")
    for i, (lq, hq, ref) in enumerate(triples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred, psnr, ssim = restore_and_score(model, lq, hq, ref)
        ms = (time.perf_counter() - t0) * 1e3
        forwards += 1
        if pred.shape != hq.shape or not np.isfinite(pred).all() \
                or not np.isfinite(psnr) or not np.isfinite(ssim):
            raise RuntimeError(f"{task} image {i}: bad output {pred.shape}")
        log(f"{task} image {i}: {ms:.1f} ms (restore + score), psnr "
            f"{psnr:.4f} ssim {ssim:.4f}")
    launches, chain_counts = kernel.launches, _chain_counts()
    others = tuple(k.launches for k, _ in more)
    log(f"{task}: {kernel.__name__} launches {launches} over {forwards} "
        f"forwards; chain calls/launches {chain_counts}" + "".join(
            f"; {k.__name__} launches {k.launches}" for k, _ in more))
    want = tuple(forwards * n for n in chain or (0, 0))
    if launches != blocks * forwards or chain_counts != want \
            or others != tuple(forwards * n for _, n in more):
        raise RuntimeError(f"expected {blocks * forwards} kernel launches, "
                           f"chain calls/launches {want} and "
                           f"{[forwards * n for _, n in more]}, got "
                           f"{launches}, {chain_counts}, {others}")

    lq, _, ref = triples[0]
    args = [torch.from_numpy(a)[None].to("cuda", torch.bfloat16)
            for a in (lq, ref)]
    torch.cuda.reset_peak_memory_stats()
    route = "" if chain is None else " (chain)"
    if extra:
        route += f" ({', '.join(f'{k}={v}' for k, v in extra.items())})"
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: model(*args), reps=3)
        log(f"{task}{route} forward 512x512 bf16: {fwd_ms:.2f} ms "
            f"({1e3 / fwd_ms:.3f} images/s), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        enqueue_ms = None
        if enqueue:
            enqueue_ms = flash_tool.enqueue_us(lambda: model(*args), 5) / 1e3
            log(f"{task}{route} forward: host enqueue {enqueue_ms:.2f} ms")
        profile_device(lambda: model(*args), f"{task}{route} forward")
    del model
    torch.cuda.empty_cache()
    if enqueue:
        return launches, fwd_ms, chain_counts, others, enqueue_ms
    return launches, fwd_ms, chain_counts, others


# ---------------------------------------------------------------------------
# Phase 6: backward kernels against plain autograd
# ---------------------------------------------------------------------------

# (B, H, W, C, heads, blocks of that shape in one 384 px batch-8 step of
# restormer_motion_deblur), and a ragged shape with no block in the step
TRAIN_SHAPES = block_bwd_tool.TRAIN_SHAPES
# PromptIR's noise-block widths in training (C = 704 / 320 / 160, 4 heads:
# 176 / 80 / 40 channels a head), both types; float32 takes 704 on a 4 x 4
# tile in both passes of csrc/tblock_attn_bwd.cu
NOISE_TRAIN_SHAPES = [(2, 64, 64, 704, 4, 0), (2, 96, 96, 320, 4, 0),
                      (2, 128, 128, 160, 4, 0)]
# gradient, kernel vs plain autograd on the same inputs: pass when
# ||k - p|| <= GRAD_L2 ||p|| and |k - p| <= a max|p| + r |p| elementwise.
# f32: sum order only (measured at most 8.5e-6, temperatures 8.5e-5).
# bf16: the kernel rounds where the TPU kernel does (hid, dd, dlin, the
# scratch operands), the plain path after every op; 2e-2 is about three
# times the largest reading of the shipped kernels at every training shape
# (6.9e-3) and below both planted faults' (0.098 and 0.33 at their
# weakest).  The temperature gradient is a sum of cph^2 terms dz * ghat
# that cancel (each softmax row of dz sums to zero), so the bf16 noise of
# dA shows in it magnified: its own bound, 1e-1 in bf16, about four times
# its largest reading (2.35e-2).
GRAD_L2 = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
GRAD_L2_TEMPERATURE = {torch.float32: 1e-3, torch.bfloat16: 1e-1}
GRAD_ELEM = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (1e-1, 1e-1)}
# fault -> (source, text, replacement, the phase that must catch it)
FAULTS = {
    # the bf16 forward's o = v . A in place of v . A^T (A read MN-major:
    # the transpose bit of its product set)
    "o_uses_a": ("bwd_gemm.cu", "run_gemm(vv, av, cph, 0, g, B, stream)",
                 "run_gemm(vv, av, cph, 1, g, B, stream)", 3),
    # the bf16 forward's gate stencil without h1's centre tap
    "gate_tap_dropped": (
        "fwd_stencil.cu", "d1 += w1[r][c] * t1[r * 3 + c];",
        "d1 += (r * 3 + c == 4 ? 0.f : w1[r][c]) * t1[r * 3 + c];", 3),
    # the bf16 forward's x1 = rnd(o . Wproj): the attention half's
    # residual dropped
    "proj_residual_dropped": ("bwd_gemm.cu", "residual_gemm(o, wproj, x, x1,",
                              "residual_gemm(o, wproj, nullptr, x1,", 3),
    # dv = do . A^T in place of do . A in pass 2 of the attention half (A
    # read K-major: the transpose bit of its product cleared)
    "dv_uses_a": ("bwd_gemm.cu", "head_product(dos, C, attn, 1,",
                  "head_product(dos, C, attn, 0,", 6),
    # the norm-backward diagonal term q Dq dropped from dq
    "dq_drops_diag": ("bwd_gemm.cu", "m, 0, qkv, 0, dqd,",
                      "m, 0, nullptr, 0, dqd,", 6),
    # the weight-gradient products (and the forward's gram) skip the last
    # 64-pixel step of each split of the pixel axis
    "wgrad_last_step_skipped": (
        "wgrad.cu", "const int nk = k1 > k0 ? k1 - k0 : 0;",
        "const int nk = k1 > k0 ? k1 - k0 - 1 : 0;", 6),
    # the weight-gradient products read A with its transpose bit off: the
    # MN-major tile (rows of pixels) taken as K-major
    "wgrad_a_kmajor": ("wgrad.cu", "wgmma_ss<BN, 1, 1>(",
                       "wgmma_ss<BN, 1, 0>(", 6),
    # bf16 pass 1's v taken from lin (its depthwise stencil skipped) in the
    # q | k | v stencil that pass 1 runs without square sums
    "pass1_v_from_lin": (
        "fwd_stencil.cu", "const float v = rnd<__nv_bfloat16>(a);",
        "const float v = ssq == nullptr && col >= 2 * C ? at(1, px + 1) "
        ": rnd<__nv_bfloat16>(a);", 6),
    # the GDFN half's dd kept at pixels outside the image: the gate
    # gradient there taken from the nearest pixel of the image instead of
    # the zeros that TMA fills in
    "gdfn_dd_kept_outside": (
        "bwd_stencil.cu", "const float g = dg[q * kHC + j], ga",
        "const float g = dg[((min(max(oy - 1 + qy, 0), H - 1) - oy + 1) * "
        "kW1 + min(max(ox - 1 + qx, 0), W - 1) - ox + 1) * kHC + j], ga", 6),
    # the input-gradient product reads W^T as W (its B operand K-major
    # instead of MN-major): dz = dhid . W1 and dy = dlin . Wqkv
    "dgrad_wt_as_w": ("bwd_gemm.cu", "b_view(w, K, N), K, 1,",
                      "b_view(w, K, N), K, 0,", 6),
    # the pair's gate not multiplied by the SCA scale s in pass B (the
    # pair serves float32, so phase 8 runs it in float32)
    "sca_skipped": ("nafblock.cu",
                    "gate_at<T>(hab, rw, p / tw, p % tw, j, j0, taps, dwb, "
                    "cpad) * sv)",
                    "gate_at<T>(hab, rw, p / tw, p % tw, j, j0, taps, dwb, "
                    "cpad))", 8),
    # the pair's conv1 output (bias included) kept outside the image: the
    # dwconv's zero padding lost, in both passes (float32)
    "halo_kept": ("nafblock.cu", "from_f<T>(in ? rnd<T>(a) + bias : 0.f)",
                  "from_f<T>(rnd<T>(a) + bias)", 8),
    # the bf16 pipeline's APPLY pass writes the gate without the SCA scale
    "naf_sca_unapplied": ("naf_stencil.cu",
                          "from_f<__nv_bfloat16>(g * sv);",
                          "from_f<__nv_bfloat16>(g);", 8),
    # the SUM pass adds the gate of a ragged tile's body pixels past H and
    # W (zeros of h there, so g = rnd(dwb_a) rnd(dwb_b)) into the sums
    "naf_sums_past_edge": ("naf_stencil.cu",
                           "} else if (in && counted) {\n"
                           "            sum += g;",
                           "} else {\n            sum += g;", 8),
    # the gate epilogue pairs a chunk's first half with the next chunk's
    # second half (64 product columns on, in the 128-column tile)
    "naf_gate_pair_shifted": ("bwd_gemm.cu", "acc[4 * (j + 4) + 2 * h + c]",
                              "acc[4 * ((j + 12) % (BN / 8)) + 2 * h + c]",
                              8),
    # the bias-scale-residual epilogue drops its scale: beta and gamma
    "naf_scale_dropped": ("bwd_gemm.cu",
                          "a * (n < g.N ? g.scale[n] : 0.f)", "a", 8),
    # the flash kernel's accumulator not rescaled by exp(m_old - m_new)
    # when a row's running max grows (bf16 path)
    "no_rescale": ("flash_attn.cu",
                   "acc[4 * j] *= al0; acc[4 * j + 1] *= al0;\n"
                   "      acc[4 * j + 2] *= al1; acc[4 * j + 3] *= al1;", "",
                   11),
    # V read K-major by the P V product (the transpose bit cleared): the
    # wgmma descriptor's likeliest silent fault (bf16 forward)
    "v_kmajor": ("flash_attn.cu", "wgmma_rs<D, 1>(acc, pa,",
                 "wgmma_rs<D, 0>(acc, pa,", 11),
    # the flash backward's dS = P (dP - di) without di (dkv kernel, bf16)
    "no_di": ("flash_attn_bwd.cu", "dpt[e] = p * (dpt[e] - dl);",
              "dpt[e] = p * dpt[e];", 14),
    # dK not multiplied by the softmax scale (bf16)
    "dk_unscaled": ("flash_attn_bwd.cu",
                    "store_rows<D>(dk + off, dka, r0, N, H, scale);",
                    "store_rows<D>(dk + off, dka, r0, N, H, 1.f);", 14),
    # the forward's lse left in log2 units (bf16): every recomputed P is
    # off by a factor
    "lse_log2": ("flash_attn.cu",
                 "if (r0 < N) lb[r0] = (m0 * scale_log2 + log2f(l0)) * kLn2;",
                 "if (r0 < N) lb[r0] = m0 * scale_log2 + log2f(l0);", 14),
    # the chain kernel takes block i+1's statistics with the tile's 1-pixel
    # ring of block i's output zeroed, as if it lay outside the image: the
    # q/k stencils at the tile's edges lose their neighbours
    "chain_ring_zeroed": (
        "tblock_chain.cu", "if (gy < 0 || gy >= H || gx < 0 || gx >= W) {",
        "if (gy < oy || gy >= oy + th || gy >= H || gx < ox || "
        "gx >= ox + tw || gx >= W) {", 17),
    # the chain epilogue's LayerNorm without the row's mean subtracted
    # (the variance then E[x^2]): block i+1 reads an uncentred y (bf16)
    "chain_ln_mean_dropped": ("bwd_gemm.cu",
                              "const float mean = s[h] / g.N;",
                              "const float mean = 0.f;", 17),
    # the GDFN's hidden kept on the halo outside the image (the 1x1 of x's
    # clamped edge pixels) instead of zeroed: the depthwise conv's zero
    # padding lost (csrc/gdfn.cu, which serves float32, so phase 19 runs
    # it in float32; the whole-block kernels share the body but only phase
    # 19 runs)
    "gdfn_halo_kept": (
        "tblock_fwd.cuh", "gy >= 0 && gy < H && gx >= 0 && gx < W ? a : 0.f",
        "a", 19),
    # the bf16 GDFN pipeline's gate stencil (the block pipeline's too)
    # forms gelu(d2) d1 in place of gelu(d1) d2: the halves swapped
    "gdfn_gate_halves_swapped": ("fwd_stencil.cu", "gelu_erf(d1) * d2",
                                 "gelu_erf(d2) * d1", 19),
    # k's square sums dropped from the finish: the attention logits lose
    # their division by |k_d| (csrc/mdta.cu, which serves float32, so phase
    # 20 runs it in float32)
    "mdta_k_unnormed": ("mdta.cu", "rk[d] = 1.f / sqrtf(fmaxf(s, 1e-24f));",
                        "rk[d] = 1.f;", 20),
    # the bf16 gram route's square sums of k's boxes never taken: k's sums
    # stay 0 and the finish divides its logits by sqrt(1e-24)
    "mdta_gram_k_ssq_dropped": (
        "wgrad.cu",
        "          box_square_sums(st + L::kA + (wg + i * kWG) * kBox, warp, "
        "lane,\n                          sb[i]);",
        "          continue;", 20),
    # the composed form's X9 keeps x's clamped edge pixels outside the
    # image instead of zeros: the stencil's zero padding lost
    # (csrc/probe_qkv_form.cu, which serves float32, so phase 23 runs it in
    # float32)
    "x9_halo_kept": ("probe_qkv_form.cu", "in ? v : V{}", "v", 23),
    # the bf16 composed form loads each tap's x window shifted the wrong
    # way along x: (1 - dx) in place of (dx - 1)
    "qkv_tma_tap_flipped": ("probe_qkv_tma.cu", "ox + tap % 3 - 1,",
                            "ox - tap % 3 + 1,", 23),
    # the bf16 current form's lin zeroed on the tile's 1-pixel ring inside
    # the image as well as outside: the stencil at the tile's edges loses
    # its neighbours
    "qkv_tma_lin_ring_zeroed": (
        "probe_qkv_tma.cu",
        "bf16_pair(acc[m][4 * jn + 2 * h], acc[m][4 * jn + 2 * h + 1]);",
        "(q / kW1 % (kH1 - 1) && q % kW1 % (kW1 - 1)\n"
        "                     ? bf16_pair(acc[m][4 * jn + 2 * h],\n"
        "                                 acc[m][4 * jn + 2 * h + 1])\n"
        "                     : 0u);", 23),
    # the f32 variants' pixels past W loaded from the next row (its first
    # pixels) in place of zeros: the right x-shift at the row's end reads
    # past it (the ragged shape of phase 24, where the last lane holds
    # pixels past W)
    "stencil_reads_past_row": (
        "probe_stencil.cu", "r < t + 2 && x0 + j < W\n",
        "r < t + 2 && (size_t)r * W + x0 + j < (size_t)(t + 2) * W\n", 24),
    # float32 pass 1 skips each third's last channel chunk: the scratch
    # q | k | v and lin that pass 2 reads there are never written
    "attn_f32_last_chunk_skipped": (
        "tblock_attn_bwd.cu", "for (int n0 = 0; n0 < C; n0 += kVC) {",
        "for (int n0 = 0; n0 + kVC < C; n0 += kVC) {", 6),
    # a warp's last lane takes zero for its right neighbour, the next
    # warp's first pixel (f32 variants): the stencil loses it at every
    # warp edge inside the row
    "stencil_warp_edge_zeroed": (
        "probe_stencil.cu",
        "if (lane == 31) rr = eb[((warp + 2) * 2) * R + r];",
        "if (lane == 31) rr = 0.f;", 24),
    # the statistics row window ignored: float32 pass A (csrc/tblock.cu,
    # its body in tblock_fwd.cuh) and the bf16 pipeline's square sums
    # (csrc/fwd_stencil.cu) take a sharded slab's halo rows too
    "stats_window_ignored": (
        "tblock_fwd.cuh",
        "const bool in = oy + py >= lo && oy + py < hi && ox + px < W;",
        "const bool in = oy + py < H && ox + px < W;", 39),
    "ssq_window_ignored": (
        "fwd_stencil.cu", "if (gy >= row_lo && gy < row_hi) sq += v * v;",
        "sq += v * v;", 39),
    # the SCA sums' row window ignored: the pair's pass A (csrc/nafblock.cu,
    # float32) and the bf16 pipeline's SUM pass (csrc/naf_stencil.cu) take
    # a sharded slab's halo rows too
    "sum_window_ignored": (
        "nafblock.cu",
        "const bool in = oy + py >= row_lo && oy + py < row_hi && ox + px "
        "< W;",
        "const bool in = oy + py < H && ox + px < W;", 40),
    "gate_window_ignored": (
        "naf_stencil.cu", "const bool counted = gy >= row_lo && gy < row_hi;",
        "const bool counted = true;", 40),
}


def grad_l2_bound(name: str, dtype) -> float:
    return (GRAD_L2_TEMPERATURE if name == "temperature" else GRAD_L2)[dtype]


def _grad_row(name, got, want, dtype):
    """(max_abs, elementwise tolerance use, L2 error / ||plain||, ok)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    a, r = GRAD_ELEM[dtype]
    use = (diff / (a * w.abs().max() + r * w.abs()).clamp_min(1e-30)).max()
    l2 = diff.norm() / w.norm().clamp_min(1e-30)
    ok = bool(torch.isfinite(g).all()) and float(use) <= 1.0 \
        and float(l2) <= grad_l2_bound(name, dtype)
    return diff.max().item(), float(use), float(l2), ok


# the CUDA kernels of the two backward rows by group, as phase 6 splits
# their device time (`bench_block_bwd.KERNEL_GROUPS`: "pass 1" also every
# kernel inside the bf16 pass 1's profiler range)
BWD_KERNEL_GROUPS = block_bwd_tool.KERNEL_GROUPS
# the CUDA kernels of the bf16 NAFBlock pipeline, as phases 8 and 10 split
# a row's device time (the rest is torch's: none on this route)
NAF_KERNEL_GROUPS = (
    ("LN rows", ("ln_rows_",)),
    ("GEMMs", ("bwd_gemm_kernel",)),
    ("gate stencil", ("naf_gate_kernel",)),
    ("SCA glue", ("naf_sca_kernel",)),
)


def split_by_group(fn, what: str, reps: int = 3,
                   kernel_groups=BWD_KERNEL_GROUPS) -> None:
    """Print the device ms of one call of fn by group of CUDA kernels
    (`kernel_groups`: (name, parts of the kernels' names)), the mean of
    `reps` calls in one `torch.profiler` window, beside the call's
    device time (`time_ms`: calls back to back behind a spin): the trace of
    a single call has come back short of some kernels, so a split whose
    total falls below 90% of the device time is marked incomplete."""
    dev_ms = time_ms(fn, torch.device("cuda"), reps, 1)
    groups = block_bwd_tool.device_groups(fn, reps, kernel_groups)
    total = sum(groups.values())
    note = "" if total >= 0.9 * dev_ms else " (incomplete trace)"
    log(f"    {what} device ms: " + ", ".join(
        f"{n} {ms:.3f}" for n, ms in groups.items() if ms > 0)
        + f"; total {total:.3f} of {dev_ms:.3f} timed{note}")


def _step_rows(dtype, ln_type, nblk):
    return dtype == torch.bfloat16 and ln_type == "WithBias" and nblk > 0


def backward_vs_plain(gen, shapes=TRAIN_SHAPES, dtypes=None, timed=True,
                      keep=_step_rows, split=True):
    """Phase 6.  Returns the rows for which keep(dtype, ln_type, blocks)
    holds (by default the bf16 WithBias rows at the training shapes) as
    (blocks per step, max L2, gdfn max_abs, attn max_abs, gdfn ms, attn ms,
    gdfn plain ms, attn plain ms, forward ms, forward plain ms, shape,
    gdfn wgrad ms, gdfn wgrad library ms, attn wgrad ms, attn wgrad
    library ms), and raises after printing if any row fails.  The forward
    (x1 and the statistics the halves start from) is the kernels' own, the
    bf16 pipeline at these widths, and is timed beside them.  Timed, it
    times the rows it returns (every row is checked), and it also splits each bf16 WithBias row's device time by kernel
    (`split_by_group`) and times each half's weight-gradient products
    alone on csrc/wgrad.cu and as one torch.matmul(A^T, B) each on the
    same operands (the yardstick, never called by the port); split=False
    leaves both out."""
    dtypes = dtypes or (torch.float32, torch.bfloat16)
    log(f"backward kernels vs plain autograd: ||k-p|| <= l2 ||p|| and "
        f"|k-p| <= a max|p| + r |p|; f32 l2 {GRAD_L2[torch.float32]} a/r "
        f"{GRAD_ELEM[torch.float32]}, bf16 l2 {GRAD_L2[torch.bfloat16]} "
        f"(temperature {GRAD_L2_TEMPERATURE[torch.bfloat16]}) a/r "
        f"{GRAD_ELEM[torch.bfloat16]}; per gradient max_abs/use/l2")
    rows, failures = [], []
    for b, h, w, c, heads, nblk in shapes:
        for ln_type in ("WithBias", "BiasFree"):
            blk = TransformerBlock(c, heads, ln_type=ln_type)
            randomize_block(blk, gen)
            blk = blk.cuda()
            p = {k: v.detach() for k, v in blk.block_params().items()}
            x32 = torch.randn(b, h, w, c, generator=gen)
            g32 = torch.randn(b, h, w, c, generator=gen)
            for dtype in dtypes:
                x, g = x32.to("cuda", dtype), g32.to("cuda", dtype)
                kw = tb.prepare_tblock_weights(p, dtype, ln_type)
                with torch.no_grad():
                    _, x1, stats = tb._forward_kernel(x, kw, heads, ln_type,
                                                      want_x1=True)
                dx1, gg = gb.gdfn_half_bwd(x1, g, p, ln_type, kw)
                dx, ga = ab.attn_half_bwd(x, dx1, p, heads, ln_type, stats,
                                          kw)
                pdx1, pgg = gb.gdfn_half_bwd_ref(x1, g, p, ln_type)
                pdx, pga = ab.attn_half_bwd_ref(x, dx1, p, heads, ln_type)
                torch.cuda.synchronize()
                got = {"dx1": dx1, **gg, "dx": dx, **ga}
                want = {"dx1": pdx1, **pgg, "dx": pdx, **pga}
                stats_row = {k: _grad_row(k, got[k], want[k], dtype)
                             for k in want}
                del got, want, pdx1, pgg, pdx, pga
                kept = keep(dtype, ln_type, nblk)
                t = [float("nan")] * 6
                if timed and kept:
                    t = [median_ms(lambda: gb.gdfn_half_bwd(
                             x1, g, p, ln_type, kw), reps=3),
                         median_ms(lambda: ab.attn_half_bwd(
                             x, dx1, p, heads, ln_type, stats, kw), reps=3),
                         median_ms(lambda: gb.gdfn_half_bwd_ref(
                             x1, g, p, ln_type), reps=3),
                         median_ms(lambda: ab.attn_half_bwd_ref(
                             x, dx1, p, heads, ln_type), reps=3)]
                    with torch.no_grad():  # the step's forward of the block
                        t += [median_ms(lambda: tb._forward_kernel(
                                  x, kw, heads, ln_type), reps=3),
                              median_ms(lambda: tb.tblock_ref(
                                  x, p, heads, ln_type), reps=3)]
                name = str(dtype).split(".")[-1]
                worst = max(v[2] for v in stats_row.values())
                # the largest reading of a bound: L2 over its bound, or the
                # elementwise use
                ratio = max(max(v[2] / grad_l2_bound(k, dtype), v[1])
                            for k, v in stats_row.items())
                log(f"{b},{h},{w},{c},{heads} {ln_type} {name}: max L2 "
                    f"{worst:.3e} ({ratio:.3g} of its bound); gdfn "
                    f"{t[0]:.3f} ms (plain {t[2]:.3f}), attn {t[1]:.3f} ms "
                    f"(plain {t[3]:.3f}); forward {t[4]:.3f} ms (plain "
                    f"{t[5]:.3f})")
                log("    " + " ".join(
                    f"{k}:{v[0]:.2e}/{v[1]:.3f}/{v[2]:.2e}"
                    for k, v in stats_row.items()))
                bad = [k for k, v in stats_row.items() if not v[3]]
                if bad:
                    failures.append((b, h, w, c, heads, ln_type, name, bad))
                wg = [float("nan")] * 4
                if timed and split and dtype == torch.bfloat16 \
                        and ln_type == "WithBias":
                    split_by_group(lambda: gb.gdfn_half_bwd(
                        x1, g, p, ln_type, kw), "gdfn_half_bwd")
                    split_by_group(lambda: ab.attn_half_bwd(
                        x, dx1, p, heads, ln_type, stats, kw),
                        "attn_half_bwd")
                    wg = []
                    for half, names, fn in (
                            ("gdfn_half_bwd", ("dW1", "dW2"),
                             lambda: gb.gdfn_half_bwd(x1, g, p, ln_type, kw)),
                            ("attn_half_bwd", ("dA", "dWproj", "dWqkv"),
                             lambda: ab.attn_half_bwd(
                                 x, dx1, p, heads, ln_type, stats, kw))):
                        with block_bwd_tool.captured_wgrad() as calls:
                            fn()
                        prods = block_bwd_tool.product_rows(
                            calls, names, torch.device("cuda"))
                        del calls
                        log(f"    {half} weight gradients (wgrad.cu / "
                            f"torch.matmul / bound ms): " + ", ".join(
                                f"{r['product']} {r['m']}x{r['n']}"
                                f"x{r['batches']} {r['ms']:.4f} / "
                                f"{r['library_ms']:.4f} / "
                                f"{r['bound_ms']:.4f}" for r in prods))
                        wg += [sum(r["ms"] for r in prods),
                               sum(r["library_ms"] for r in prods)]
                if kept:
                    half = {k: k == "dx1" or k.startswith(("gd_", "norm2"))
                            for k in stats_row}
                    rows.append((nblk, worst, *(
                        max(v[0] for k, v in stats_row.items()
                            if half[k] == gdfn) for gdfn in (True, False)),
                        *t, (b, h, w, c, heads), *wg))
                del x, g, x1, dx1, dx, gg, ga, kw
                torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"backward kernels disagree with plain at "
                           f"{failures}")
    return rows


def remat_vs_save(gen):
    """Phase 6: bwd_mode 'remat' recomputes x1 and the statistics with the
    same kernel, so its gradients must equal 'save''s bit for bit."""
    for b, h, w, c, heads, _ in (TRAIN_SHAPES[4], TRAIN_SHAPES[-1]):
        blk = TransformerBlock(c, heads)
        randomize_block(blk, gen)
        blk = blk.cuda()
        x0 = torch.randn(b, h, w, c, generator=gen).to("cuda", torch.bfloat16)
        g = torch.randn(b, h, w, c, generator=gen).to("cuda", torch.bfloat16)
        grads = {}
        for mode in ("save", "remat"):
            blk.bwd_mode = mode
            blk.zero_grad()
            x = x0.clone().requires_grad_(True)
            before = tb.tblock_fused.launches
            blk(x).backward(g)
            launches = tb.tblock_fused.launches - before
            if launches != (2 if mode == "remat" else 1):
                raise RuntimeError(f"{mode}: {launches} forward launches")
            grads[mode] = [x.grad] + [q.grad.clone() for q in
                                      blk.parameters()]
        same = all(torch.equal(u, v) for u, v in zip(grads["save"],
                                                     grads["remat"]))
        log(f"remat vs save at {b},{h},{w},{c},{heads} bf16: "
            f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise RuntimeError("remat gradients differ from save")


def plant_fault(fault: str) -> None:
    """Point the build at a temporary copy of csrc/ with `fault` planted."""
    src, old, new, _ = FAULTS[fault]
    tmp = Path(tempfile.mkdtemp(prefix="planted_"))
    shutil.copytree(_build._CSRC, tmp / "csrc")
    path = tmp / "csrc" / src
    text = path.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"fault {fault}: pattern not found once in {src}")
    path.write_text(text.replace(old, new))
    _build._CSRC, _build.BUILD_DIR = tmp / "csrc", tmp / "build"
    log(f"planted {fault} in a copy of {src} under {tmp}")


# ---------------------------------------------------------------------------
# Phase 7: the training main path
# ---------------------------------------------------------------------------

# options/train_restoration/restormer_motion_deblur.yml as a dict (no YAML
# on the card's machine), param_fix_iterations cut to 2
TRAIN_OPT = {
    "network_g": {
        "type": "RestormerRefFusion", "inp_channels": 3, "out_channels": 3,
        "dim": 48, "num_blocks": [4, 6, 6, 8], "num_refinement_blocks": 4,
        "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
        "LayerNorm_type": "WithBias", "dual_pixel_task": False, "nf": 48,
        "ext_n_blocks": [4, 4, 4, 4], "reffusion_n_blocks": [2, 2, 2, 2],
        "reffusion_n_blocks_middle": 1, "num_nbr": 1, "psize": 3,
        "lr_block_size": 8, "ref_down_block_size": 1.5,
        "dilations": [1, 2, 3]},
    "train": {
        "total_iter": 1000000, "warmup_iter": -1, "use_grad_clip": True,
        "param_fix_iterations": 2,
        "scheduler": {"type": "CosineAnnealingRestartCyclicLR",
                      "periods": [306000, 694000], "restart_weights": [1, 1],
                      "eta_mins": [0.0003, 0.000001]},
        "optim_g": {"type": "AdamW", "lr": 2e-4, "ref_lr": 1e-4,
                    "weight_decay": 1e-4, "betas": [0.9, 0.999]},
        "pixel_opt": {"type": "L1Loss", "loss_weight": 1,
                      "reduction": "mean"}},
}


def _trainer(model, topt):
    """The optimizer, state and both step functions, as the CLI builds
    them."""
    lr, ref_lr = topt["optim_g"]["lr"], topt["optim_g"]["ref_lr"]
    sched = warmup_wrap(build_schedule(lr, topt["scheduler"]), -1, lr)
    ref_sched = warmup_wrap(build_schedule(ref_lr, topt["scheduler"]), -1,
                            ref_lr)
    opt = build_optimizer(
        model, sched, ref_sched, weight_decay=topt["optim_g"]["weight_decay"],
        betas=tuple(topt["optim_g"]["betas"]), grad_clip=0.01,
        param_fix_iterations=topt["param_fix_iterations"])
    loss_fn = build_loss(topt["pixel_opt"])
    return (create_train_state(model, opt), make_train_step(loss_fn),
            make_train_step(loss_fn, masa_frozen=True))


def _plain_blocks(x, p, heads, ln_type="WithBias", kw=None,
                  bwd_mode="save"):
    """The plain-autograd route of phase 7's comparison turns (never the
    main path): tblock_ref, checkpointed per block, since autograd's saved
    tensors of 52 plain blocks at 384 px batch 8 would not fit the card."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(tb.tblock_ref, x, p, heads, ln_type,
                      use_reentrant=False)


def _swap(route_name: str, plain_fn):
    """A switch of the comparison turns (`train_main_path`'s `plain`):
    switch(model, True) puts plain_fn in place of models.layers'
    `route_name`, switch(model, False) puts the kernel route back."""
    kernel_fn = getattr(layers, route_name)

    def switch(_, on: bool):
        setattr(layers, route_name, plain_fn if on else kernel_fn)
    return switch


def train_main_path(seed: int, opt=TRAIN_OPT, kernels=None, per_step=None,
                    plain=None, batch_size=8, resolve_kw=None,
                    compare_plain=True):
    """Phases 7, 10 and 22, the training path of `opt` (resolve_network
    with `resolve_kw`) in bf16 at 384 px, batch `batch_size`: every step
    launches each of `kernels` per_step times; the comparison turns call
    plain(model, True) before a plain turn and plain(model, False) after
    it (default: `_plain_blocks` for `tblock_fused`); without
    compare_plain, three kernel turns and no plain ones (plain ms and peak
    nan).  Default kernels:
    `tblock_fused`, the two backward rows and `tblock_pipeline`'s block
    calls, 52 each (under 'remat' the forward counts double).  Returns
    (launches of each kernel over the counted steps, kernel step ms, plain
    step ms, kernel peak GiB, plain peak GiB)."""
    kernels = kernels or (tb.tblock_fused, gb.gdfn_half_bwd,
                          ab.attn_half_bwd, tb.tblock_pipeline)
    per_step = per_step or (52, 52, 52, 52)
    switch = plain or _swap("tblock_fused", _plain_blocks)
    name = opt["network_g"]["type"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, _, _ = resolve_network(opt, mixed_precision="bf16",
                                      **(resolve_kw or {}))
    model = gate_and_temperatures(model, seed).cuda()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed + 4)
    trip = [synthetic_triple(rng, 384) for _ in range(batch_size)]
    batch = {k: torch.from_numpy(np.stack([t[i] for t in trip])).cuda()
             for i, k in enumerate(("lq", "gt", "ref"))}

    def counted_step(fn):
        for k in kernels:
            k.launches = 0
        state_m = fn(state, batch)
        return state_m, tuple(k.launches for k in kernels)

    # warm-up: one frozen and one released step, then back to the start
    state, step_fn, frozen_fn = _trainer(model, opt["train"])
    state, _ = frozen_fn(state, batch)
    state, _ = step_fn(state, batch)
    model.load_state_dict(init)
    state, step_fn, frozen_fn = _trainer(model, opt["train"])
    torch.cuda.synchronize()

    totals = [0] * len(kernels)
    names = [n for n, _ in model.named_parameters()]
    for i in range(4):
        frozen = state.opt.count < state.opt.fix
        seen = {}
        if i == 2:  # the first released step: every gradient as handed on
            def capture(gs, update=state.opt.step, seen=seen):
                seen.update(zip(names, gs))
                update(gs)
            state.opt.step = capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, m), counts = counted_step(frozen_fn if frozen else step_fn)
        loss = float(m["l_pix"])
        ms = (time.perf_counter() - t0) * 1e3
        # back to the class's step: an instance attribute holding a bound
        # method of its own object is a reference cycle, which would keep
        # the model and optimizer on the card until the next full collection
        state.opt.__dict__.pop("step", None)
        totals = [a + b for a, b in zip(totals, counts)]
        log(f"{name} train step {i + 1} "
            f"({'frozen' if frozen else 'released'}): {ms:.1f} ms, l_pix "
            f"{loss:.5f}, grad_norm {float(m['grad_norm']):.4e}, launches "
            f"{'/'.join(k.__name__ for k in kernels)} {counts}")
        if counts != per_step or not np.isfinite(loss):
            raise RuntimeError(f"step {i + 1}: launches {counts}, loss {loss}")
        if i == 1:
            sd = model.state_dict()
            moved = [n for n in names if "masa" in n
                     and not torch.equal(sd[n], init[n])]
            if moved:
                raise RuntimeError(f"masa parameters moved while frozen: "
                                   f"{moved[:3]}")
        if i == 2:
            bad = [n for n in names if seen.get(n) is None
                   or not torch.isfinite(seen[n]).all()]
            log(f"first released step: {len(names) - len(bad)} of "
                f"{len(names)} parameters have a finite gradient")
            if bad:
                raise RuntimeError(f"parameters without a finite gradient: "
                                   f"{bad[:5]}")
    sd = model.state_dict()
    still = [n for n in names if "masa" not in n
             and torch.equal(sd[n], init[n])]
    masa_moved = sum(not torch.equal(sd[n], init[n]) for n in names
                     if "masa" in n)
    log(f"after 2 frozen + 2 released steps: {len(still)} trunk parameters "
        f"unmoved, {masa_moved} masa parameters moved")
    if still:
        raise RuntimeError(f"trunk parameters did not move: {still[:3]}")

    # one step with the memory-lean backward of the whole-block kernels:
    # one more forward launch per block
    blocks = [m for m in model.modules() if isinstance(m, TransformerBlock)
              and m.fused]
    if blocks:
        for mod in blocks:
            mod.bwd_mode = "remat"
        (state, m), counts = counted_step(step_fn)
        log(f"remat step: launches {counts}, l_pix {float(m['l_pix']):.5f}")
        forward = (tb.tblock_fused, tb.tblock_pipeline)
        if counts != tuple(2 * n if k in forward else n
                           for k, n in zip(kernels, per_step)):
            raise RuntimeError(f"remat step launches {counts}")
        for mod in blocks:
            mod.bwd_mode = "save"

    # the step through the kernels vs through plain-autograd blocks, in
    # alternating turns; peak memory of each
    turns = {"kernel": [], "plain": []}
    peak = {"plain": float("nan")}
    for route in (("kernel", "plain", "plain", "kernel", "kernel", "plain")
                  if compare_plain else ("kernel",) * 3):
        if route == "plain":
            switch(model, True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        float(m["l_pix"])
        torch.cuda.synchronize()
        turns[route].append((time.perf_counter() - t0) * 1e3)
        peak[route] = torch.cuda.max_memory_allocated() / 2 ** 30
        switch(model, False)
    k_ms = statistics.median(turns["kernel"])
    p_ms = statistics.median(turns["plain"] or [float("nan")])
    profile_device(lambda: float(step_fn(state, batch)[1]["l_pix"]),
                   f"{name} step")
    if compare_plain:
        switch(model, True)
        profile_device(lambda: float(step_fn(state, batch)[1]["l_pix"]),
                       f"{name} step through the plain route")
        switch(model, False)
    log(f"{name} train step 384 px batch {batch_size} bf16, alternating "
        f"turns: kernel "
        f"{[round(v, 2) for v in turns['kernel']]} ms, plain blocks "
        f"{[round(v, 2) for v in turns['plain']]} ms; medians {k_ms:.2f} vs "
        f"{p_ms:.2f} ms; peak memory {peak['kernel']:.2f} vs "
        f"{peak['plain']:.2f} GiB")
    del state, model, batch
    torch.cuda.empty_cache()
    return totals, k_ms, p_ms, peak["kernel"], peak["plain"]


def _union_ms(spans) -> float:
    """Length of the union of (start, end) intervals in us, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profile_device(fn, what: str):
    """Device time of one call of fn by kernel (torch.profiler), the share
    of the port's kernels, and the device's idle share of its wall time
    (returned; None where the profiler recorded no device time).
    Busy is the union of the device events' intervals, so events that
    overlap (another stream) are not counted twice; the per-kernel sums
    can exceed it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the profiler's raw events: building its FunctionEvent tree
    # (`events()`, `key_averages()`) took 2-30 s a call on the card's host
    cuda = torch.autograd.DeviceType.CUDA
    by_name, spans = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            start, ns = e.start_ns(), e.duration_ns()
            spans.append((start / 1e3, (start + ns) / 1e3))
            t, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (t + ns / 1e6, n + 1)
    kernels = [(k, t, n) for k, (t, n) in by_name.items()]
    summed = sum(t for _, t, _ in kernels)
    busy = _union_ms(spans)
    if busy <= 0:
        log("profiler: no device time recorded")
        return
    ours = ("tblock_", "gdfn_bwd", "attn_bwd", "wgrad", "nafblock_", "naf_",
            "flash_", "gdfn_kernel", "mdta_", "bwd_gemm", "_stencil_kernel",
            "ln_rows_")
    # cuDNN's weight-gradient kernels are named sm80_xmma_wgrad_*
    mine = sum(t for k, t, _ in kernels
               if any(o in k for o in ours) and "xmma" not in k)
    idle = 1 - busy / wall
    log(f"profiled {what}: wall {wall:.1f} ms, {len(spans)} device events, "
        f"device busy {busy:.1f} ms (summed {summed:.1f} ms), idle share "
        f"{idle:.4f}; the port's kernels {mine:.1f} ms "
        f"({mine / summed:.3f} of the summed device time)")
    for k, t, n in sorted(kernels, key=lambda r: -r[1])[:14]:
        log(f"    {t:9.2f} ms {n:6d}x  {k[:90]}")
    profile_device.busy_ms = busy
    return idle


def train_step_vs_cpu(seed: int, opt=TRAIN_OPT, resolve_kw=None,
                      kernels=(), batch_size=1, grad_floor=0.0,
                      update_tol=1e-2, ref_fn=None):
    """Phases 7, 22, 32 and 34: one f32 step of `opt` (resolve_network
    with `resolve_kw`) at 128 px, batch `batch_size`, on the card (kernels)
    against the same step on the CPU (plain blocks); each (kernel, n) of
    `kernels` is launched n times in the card's step.  ref_fn(rng, b): the
    network's second input in place of the reference images (DiffIR's
    embedding, which the step takes in the `ref` slot).  Each parameter's
    gradient, as the step hands it to the optimizer, is held to
    ||g_card - g_cpu|| <= 1e-3 ||g_cpu|| + grad_floor ||all of g_cpu||, so
    that one small tensor with a wrong gradient fails (the first Adam
    update, about lr * g / |g|, keeps only the sign of each element; the
    floor is for gradients that vanish in exact arithmetic, as a bias
    before a norm that subtracts it); and every element of the update, the
    BN running statistics included, to |d_card - d_cpu| <= update_tol lr
    (Adam's first step, lr g / (|g| + eps), turns a difference of 1e-9 in
    a gradient element near eps into a tenth of lr: C3's 0.5 lr where a
    network has such elements)."""
    topt = dict(opt["train"], param_fix_iterations=0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model_cpu, _, _ = resolve_network(opt, **(resolve_kw or {}))
    model_cpu = gate_and_temperatures(model_cpu, seed)
    model_gpu = copy.deepcopy(model_cpu).cuda()
    init = {k: v.clone() for k, v in model_cpu.state_dict().items()}
    rng = np.random.default_rng(seed + 5)
    trip = [synthetic_triple(rng, 128) for _ in range(batch_size)]
    batch = {k: torch.from_numpy(np.stack([tr[i] for tr in trip]))
             for i, k in enumerate(("lq", "gt", "ref"))}
    if ref_fn is not None:
        batch["ref"] = torch.from_numpy(ref_fn(rng, batch_size))
    losses, grads, after = [], [], []
    for k, _ in kernels:
        k.launches = 0
    for model, dev in ((model_cpu, "cpu"), (model_gpu, "cuda")):
        state, step_fn, _ = _trainer(model, topt)
        seen = {}
        update = state.opt.step

        def capture(gs, update=update, seen=seen, names=state.opt.names):
            seen.update((n, g.detach().cpu()) for n, g in zip(names, gs))
            update(gs)

        state.opt.step = capture
        state, m = step_fn(state, {k: v.to(dev) for k, v in batch.items()})
        del state.opt.step  # no cycle through the capture's bound method
        losses.append(float(m["l_pix"]))
        grads.append(seen)
        after.append({k: v.detach().cpu() for k, v in
                      model.state_dict().items()})
    lr = opt["train"]["optim_g"]["lr"]
    total = float(torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in grads[0].values()])))
    g_rel = sorted(
        (((grads[1][k] - g).norm() / g.norm().clamp_min(1e-30)).item(),
         ((grads[1][k] - g).norm() / (1e-3 * g.norm() + grad_floor * total)
          .clamp_min(1e-30)).item(), k)
        for k, g in grads[0].items())
    g_use = max(r[1] for r in g_rel)
    worst = max(((after[1][k] - v) - (after[0][k] - v)).abs().float().max()
                .item() for k, v in init.items())
    bn_moved = sum(not torch.equal(after[0][k], v) for k, v in init.items()
                   if k.endswith(("running_mean", "running_var")))
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    log(f"{opt['network_g']['type']} f32 train step 128 px batch "
        f"{batch_size}, card vs CPU: l_pix {losses[1]:.7f} vs "
        f"{losses[0]:.7f} (rel {rel:.2e}); gradient L2 error / norm over "
        f"{len(g_rel)} parameters: median {g_rel[len(g_rel) // 2][0]:.2e}, "
        f"largest " + ", ".join(f"{k} {v:.2e}" for v, _, k in g_rel[-3:])
        + f", bound use {g_use:.3f} (floor {grad_floor} of {total:.3e}); "
        f"update difference max {worst:.3e} (lr {lr}, bound {update_tol} "
        "lr)"
        + (f", BN statistics moved {bn_moved}" if bn_moved else "") + "".join(
            f"; {k.__name__} launches {k.launches}" for k, _ in kernels))
    if not rel <= 1e-4 or not g_use <= 1.0 or worst > update_tol * lr \
            or any(k.launches != n for k, n in kernels):
        raise RuntimeError("the f32 step on the card disagrees with the CPU")
    return bn_moved


# ---------------------------------------------------------------------------
# Phase 8: the whole-NAFBlock kernel against its plain version
# ---------------------------------------------------------------------------

NAF_TASK = "nafnet_deblur"
NAF_BLOCKS = 45  # NAFBlocks of one nafnet_deblur forward, each one launch
# (B, H, W, C, blocks of that shape in one 512 px nafnet_deblur forward),
# and a ragged shape with no block in the forward
NAF_SHAPES = naf_tool.EVAL_SHAPES
# (B, H, W, C, blocks of that shape in one 384 px batch-8 step of
# nafnet_motion_deblur); the first two are the largest tensors
NAF_TRAIN_SHAPES = naf_tool.TRAIN_SHAPES
# NAFBlock kernel vs plain: pass when |k - p| <= a max|p| + r |p| at every
# element and ||k - p|| <= branch ||p - x|| over the output.  float32: sums
# in other orders.  bfloat16: the kernel rounds the dwconv once with f32
# taps where the plain path casts the taps to bf16 and rounds the conv and
# its bias add; a differing ulp of the gate, then of y1, goes on through
# LN2 and the FFN, so an element may differ by several ulps of the block's
# larger intermediate values even where the output itself is near zero:
# hence an absolute term in units of max|p| (5e-2 is 6 to 13 bf16 ulps of
# it).  On an H100 the pair's bf16 branch error read 8.4e-3 at every
# shape; the bf16 pipeline rounds where the pair does.  Both residual
# branches count: beta, gamma and the SCA scale are O(1), so a fault in
# either half shows in ||k - p|| against ||p - x||.
NAF_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (5e-2, 5e-2)}


# weights at a trained block's scale (the card-only tests import it here)
randomize_nafblock = naf_tool.randomize_nafblock


def nafblock_route(x) -> str:
    """The route of a call at x: the pipeline with its stencil's splits,
    or the pair's tiles of both passes and how many CTAs of each one SM
    holds."""
    lib = _build.load_library()
    b, h, w, c = x.shape
    if nb._takes_naf_pipeline(x):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return (f"pipeline, {nb._naf_nsplit(lib, b, h, w, -(-c // 32), sms)}"
                f" splits")
    eb = x.element_size()
    is_bf16 = int(x.dtype == torch.bfloat16)
    tiles = nb.pick_tiles(lib, c, eb)
    return "pair " + " ".join(
        f"{'AB'[i]} {t[0]}x{t[1]} "
        f"{lib.nafblock_smem_bytes(i, c, t[0], t[1], eb) / 1024:.0f}KB "
        f"{lib.nafblock_ctas_per_sm(i, c, t[0], t[1], is_bf16)}/SM"
        for i, t in enumerate(tiles))


def _pair_call(x, kw):
    """csrc/nafblock.cu's pair on x with `_forward_kernel`'s tiles and
    splits: the route that bf16 took before the pipeline, timed beside
    it."""
    lib = _build.load_library()
    b, h, w, c = x.shape
    sum_tile, apply_tile = nb.pick_tiles(lib, c, x.element_size())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nsplit = max(1, min(-(-h // sum_tile[0]) * -(-w // sum_tile[1]),
                        -(-2 * sms // b)))
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: nb._launch(lib, x, kw, sum_tile, apply_tile, nsplit,
                              stream)


def nafblock_vs_plain(gen, shapes, dtypes=(torch.float32, torch.bfloat16),
                      timed=True):
    """Phases 8 and 10.  Every bf16 call must run the pipeline
    (`naf_pipeline`, the route rule of nafblock.py at these widths) and two
    calls must be bitwise equal; float32 runs csrc/nafblock.cu's pair.
    Returns the bf16 rows as (blocks of that shape, max_abs, kernel ms,
    plain ms, shape, pair ms); untimed, the ms are NaN.  Timed, each bf16
    row's device time is split by kernel (`split_by_group`).  Raises after
    printing if any row fails."""
    log("nafblock kernel vs plain: |k-p| <= a*max|p| + r*|p| and ||k-p|| <= "
        f"branch * ||p-x||; f32 a/r/branch {NAF_TOL[torch.float32]}/"
        f"{BRANCH_TOL[torch.float32]}, bf16 {NAF_TOL[torch.bfloat16]}/"
        f"{BRANCH_TOL[torch.bfloat16]}; bf16 beside the pair csrc/"
        f"nafblock.cu (pair_ms)")
    log(f"{'B,H,W,C':>16} {'dtype':>8} {'max|p|':>8} {'max_abs':>10} "
        f"{'tol_use':>8} {'branch':>10} {'kernel_ms':>10} {'plain_ms':>10} "
        f"{'pair_ms':>10}  route")
    rows, failures = [], []
    for b, h, w, c, nblk in shapes:
        blk = NAFBlock(c)
        randomize_nafblock(blk, gen)
        blk = blk.cuda()
        x32 = torch.randn(b, h, w, c, generator=gen)
        for dtype in dtypes:
            x = x32.to("cuda", dtype)
            params = blk.block_params()
            pipeline = nb._takes_naf_pipeline(x)
            with torch.inference_mode():
                calls = nb.naf_pipeline.launches
                got_d = blk(x)
                routed = nb.naf_pipeline.launches - calls == pipeline
                same = not pipeline or torch.equal(got_d, blk(x))
                got = got_d.float()
                want = nb.nafblock_ref(x, params).float()
                torch.cuda.synchronize()
                a, r = NAF_TOL[dtype]
                diff = (got - want).abs()
                max_abs = diff.max().item()
                peak = want.abs().max().item()
                tol_use = (diff / (a * peak + r * want.abs())).max().item()
                branch = (diff.norm() / (want - x.float()).norm()
                          .clamp_min(1e-30)).item()
                finite = bool(torch.isfinite(got).all())
                del got, got_d, want, diff
                k_ms = p_ms = pair_ms = float("nan")
                if timed:
                    k_ms = median_ms(lambda: blk(x))
                    p_ms = median_ms(lambda: nb.nafblock_ref(x, params))
                    if pipeline:
                        pair_ms = median_ms(_pair_call(
                            x, nb.prepare_nafblock_weights(params, dtype)))
            name = str(dtype).split(".")[-1]
            log(f"{f'{b},{h},{w},{c}':>16} {name:>8} {peak:8.3f} "
                f"{max_abs:10.3e} {tol_use:8.3f} {branch:10.3e} "
                f"{k_ms:10.4f} {p_ms:10.4f} {pair_ms:10.4f}  "
                f"{nafblock_route(x)}"
                f"{'' if routed else '  NOT ROUTED AS RULED'}"
                f"{'' if same else '  NOT REPEATABLE'}")
            if timed and pipeline:
                with torch.inference_mode():
                    split_by_group(lambda: blk(x), "naf_pipeline",
                                   kernel_groups=NAF_KERNEL_GROUPS)
            if not finite or tol_use > 1.0 or branch > BRANCH_TOL[dtype] \
                    or not routed or not same:
                failures.append((b, h, w, c, name))
            if dtype == torch.bfloat16:
                rows.append((nblk, max_abs, k_ms, p_ms, (b, h, w, c),
                             pair_ms))
            del x
        del blk
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"nafblock kernel disagrees with plain at "
                           f"{failures}")
    return rows


# ---------------------------------------------------------------------------
# Phases 9 and 10: the NAFNetRefFusion evaluation and training paths, run
# by the functions of phases 4, 5 and 7
# ---------------------------------------------------------------------------

# options/train_restoration/nafnet_motion_deblur.yml as a dict (no YAML on
# the card's machine), param_fix_iterations cut to 2
NAF_TRAIN_OPT = {
    "network_g": {
        "type": "NAFNetRefFusion", "img_channel": 3, "width": 64,
        "middle_blk_num": 1, "enc_blk_nums": [1, 1, 1, 28],
        "dec_blk_nums": [1, 1, 1, 1], "nf": 64, "ext_n_blocks": [4, 4, 4, 4],
        "reffusion_n_blocks": [2, 2, 2, 2], "reffusion_n_blocks_middle": 1,
        "num_nbr": 1, "psize": 3, "lr_block_size": 8,
        "ref_down_block_size": 1.5, "dilations": [1, 2, 3]},
    "train": {**TRAIN_OPT["train"],
              "pixel_opt": {"type": "PSNRLoss", "loss_weight": 1,
                            "reduction": "mean"}},
}


def _plain_nafblocks(x, p, kw=None, shard=None):
    """The plain-autograd route of phase 10's comparison turns (never the
    main path): nafblock_ref, with autograd keeping its intermediates (45
    plain blocks at 384 px batch 8 fit the card)."""
    return nb.nafblock_ref(x, p, shard)


# ---------------------------------------------------------------------------
# Phase 11: the flash self-attention kernel against its plain version
# ---------------------------------------------------------------------------

# (B, N, H, D, launches of that shape in one 512 px UNet forward)
FLASH_SHAPES = [
    (2, 4096, 5, 64, 5),   # the 64 x 64 latent under CFG: down_0, up_3
    (1, 4096, 5, 128, 0),  # head_dim 128
    (2, 2048, 10, 64, 0),  # the shortest sequence flash_applies routes
    (2, 1000, 3, 64, 0),   # ragged: no 64-row tile divides N
]
FLASH_PEAK = 3.0  # standard deviation of the logits q.k / sqrt(D)
# flash kernel vs attention_ref: pass when |k - p| <= a max|p| + r |p| at
# every element and ||k - p|| <= l2 ||p||, (a, r, l2) below.  float32: the
# same f32 math, sums in other orders and exp2 of prescaled logits.
# bfloat16: the kernel rounds the unnormalised probabilities to bf16 for
# the PV product and divides by the f32 row sum at the end, the plain
# version rounds the normalised probabilities; both round the output, so
# they differ by about one bf16 ulp (2^-8 relative) of the output.
FLASH_TOL = {torch.float32: (1e-5, 1e-4, 1e-5),
             torch.bfloat16: (1e-2, 1e-2, 1e-2)}


def flash_vs_plain(gen, shapes=FLASH_SHAPES,
                   dtypes=(torch.float32, torch.bfloat16), timed=True):
    """Phase 11.  Returns the bf16 rows as (launches of that shape per UNet
    forward, max_abs, kernel ms, plain ms, SDPA ms, shape, kernel device
    ms, SDPA device ms); untimed, the ms are NaN.  Raises after printing
    if any row fails."""
    log("flash kernel vs attention_ref: |k-p| <= a*max|p| + r*|p| and "
        "||k-p|| <= l2*||p||; a/r/l2 f32 "
        f"{FLASH_TOL[torch.float32]}, bf16 {FLASH_TOL[torch.bfloat16]}; "
        f"logits std {FLASH_PEAK}; SDPA is the library yardstick only")
    log(f"{'B,N,H,D':>16} {'dtype':>8} {'max|p|':>7} {'max_abs':>10} "
        f"{'tol_use':>8} {'l2':>10} {'repeat':>7} {'kernel_ms':>10} "
        f"{'plain_ms':>10} {'sdpa_ms':>10} {'bound_ms':>9}")
    rows, failures = [], []
    s = FLASH_PEAK ** 0.5
    for b, n, h, d, per_fwd in shapes:
        q32, k32, v32 = (torch.randn(b, n, h, d, generator=gen) * sc
                         for sc in (s, s, 1.0))
        for dtype in dtypes:
            q, k, v = (x.to("cuda", dtype) for x in (q32, k32, v32))
            with torch.inference_mode():
                got = fa.flash_attention(q, k, v)
                again = fa.flash_attention(q, k, v)
                want = fa.attention_ref(q, k, v)
                torch.cuda.synchronize()
            same = torch.equal(got, again)
            g, w = got.float(), want.float()
            diff = (g - w).abs()
            a, r, l2_bound = FLASH_TOL[dtype]
            peak = w.abs().max().item()
            use = (diff / (a * peak + r * w.abs())).max().item()
            l2 = (diff.norm() / w.norm()).item()
            max_abs = diff.max().item()
            finite = bool(torch.isfinite(g).all())
            del got, again, want, g, w, diff
            k_ms = p_ms = l_ms = k_dev = l_dev = float("nan")
            if timed:
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

                def kernel():
                    return fa.flash_attention(q, k, v)

                def sdpa():
                    return F.scaled_dot_product_attention(qt, kt, vt)

                with torch.inference_mode():
                    k_ms = median_ms(kernel, reps=10)
                    p_ms = median_ms(lambda: fa.attention_ref(q, k, v))
                    l_ms = median_ms(sdpa, reps=10)
                    if dtype == torch.bfloat16:
                        k_dev = time_ms(kernel, q.device, 20, 5)
                        l_dev = time_ms(sdpa, q.device, 20, 5)
                        log(f"{f'{b},{n},{h},{d}':>16} bfloat16 device "
                            f"kernel {k_dev:.4f} ms "
                            f"({4 * b * h * n * n * d / k_dev / 1e9:.1f} "
                            f"TFLOP/s as the bound counts), SDPA "
                            f"{l_dev:.4f} ms; enqueue "
                            f"{flash_tool.enqueue_us(kernel):.1f} us a call"
                            + ("; SDPA's kernel "
                               f"{flash_tool.sdpa_backend(sdpa)}"
                               if not rows else ""))
            name = str(dtype).split(".")[-1]
            bound = flash_bound_ms(b, n, h, d, torch.finfo(dtype).bits // 8)
            log(f"{f'{b},{n},{h},{d}':>16} {name:>8} {peak:7.3f} "
                f"{max_abs:10.3e} {use:8.3f} {l2:10.3e} {str(same):>7} "
                f"{k_ms:10.4f} {p_ms:10.4f} {l_ms:10.4f} {bound[0]:9.4f}")
            if not finite or use > 1.0 or l2 > l2_bound or not same:
                failures.append((b, n, h, d, name))
            if dtype == torch.bfloat16:
                rows.append((per_fwd, max_abs, k_ms, p_ms, l_ms,
                             (b, n, h, d), k_dev, l_dev))
            del q, k, v
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"flash kernel disagrees with plain at {failures}")
    return rows


# ---------------------------------------------------------------------------
# Phases 12 and 13: pipeline A's towers and the generation path
# ---------------------------------------------------------------------------

# per flash launch shape at 512 px under CFG: 5 per UNet forward, 100 steps
FLASH_PER_IMAGE = 500
# tower on the card vs on the CPU (or the UNet through the kernel vs with
# attn_impl='plain'), float32: |card - cpu| <= TOWER_TOL max|cpu| at every
# element; cuBLAS/cuDNN and the CPU's f32 products sum in other orders
# through up to 32 layers
TOWER_TOL = 1e-3


def build_guidance(seed: int, dtype) -> GuidanceModules:
    """sd21_config towers on the card with the generation CLI's seeded
    random weights (`random_init`)."""
    with torch.device("cuda"):
        mods = GuidanceModules.sd21_config(num_words=20, dtype=dtype)
    return random_init(mods, torch.Generator("cuda").manual_seed(seed))


def _compare(what: str, got: torch.Tensor, want: torch.Tensor, extra=""):
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    l2 = ((got - want).norm() / want.norm()).item()
    log(f"{what}: max_abs {err:.3e} at max|ref| {peak:.3f} (bound "
        f"{TOWER_TOL:g} max|ref|), L2 {l2:.3e}{extra}")
    if not torch.isfinite(got).all() or err > TOWER_TOL * peak:
        raise RuntimeError(f"{what}: the card disagrees ({err})")


def towers_vs_reference(seed: int):
    """Phase 12."""
    log(f"phase 12 float32, torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    mods = build_guidance(seed, torch.float32)
    gen = torch.Generator("cuda").manual_seed(seed + 1)
    unet = mods.unet
    with torch.device("cuda"):
        plain = UNet2DCondition(attn_impl="plain")
    plain.load_state_dict(unet.state_dict())
    lat = torch.randn(2, 64, 64, 4, generator=gen, device="cuda")
    ctx = torch.randn(2, 77, 1024, generator=gen, device="cuda")
    ts = torch.tensor([981, 981], device="cuda")
    with torch.inference_mode():
        fa.flash_attention.launches = 0
        got = unet(lat, ts, ctx, use_global_kv=True)
        n_kernel = fa.flash_attention.launches
        want = plain(lat, ts, ctx, use_global_kv=True)
        n_plain = fa.flash_attention.launches - n_kernel
    _compare("UNet f32 2x64x64 (512 px), kernel vs attn_impl='plain' on the "
             "card", got, want, f"; launches {n_kernel} vs {n_plain}")
    if n_kernel != 5 or n_plain != 0:
        raise RuntimeError(f"UNet launches {n_kernel} / {n_plain}")
    del plain, got, want
    torch.cuda.empty_cache()

    rng = np.random.default_rng(seed + 5)

    def arr(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    ids, _, inj = tokenize_template(PROMPT_TEMPLATE)
    ids = torch.from_numpy(ids)
    words = arr(1, 20, 1024, scale=1024 ** -0.5)
    inj = torch.tensor([inj])
    pixels = arr(1, 224, 224, 3)
    z = arr(1, 16, 16, 4)
    lat = arr(1, 32, 64, 4)
    ctx = arr(1, 77, 1024)
    ts = torch.tensor([501])
    with torch.inference_mode():
        for what, mod, args, kw in (
                ("text tower with 20 injected words", mods.text_encoder,
                 (ids,), dict(inj_embedding=words, inj_index=inj)),
                ("vision tower 224 px", mods.image_encoder, (pixels,), {}),
                ("VAE decoder 16x16 latent", mods.vae, (z,), {}),
                ("UNet 1x32x64 latent (N = 2048)", mods.unet,
                 (lat, ts, ctx), dict(use_global_kv=True))):
            cpu = copy.deepcopy(mod).cpu()
            fn = (lambda m: m.decode) if mod is mods.vae else (lambda m: m)
            t0 = time.perf_counter()
            want = fn(cpu)(*args, **kw)
            cpu_s = time.perf_counter() - t0
            fa.flash_attention.launches = 0
            got = fn(mod)(*(a.cuda() for a in args), **{
                k: v.cuda() if torch.is_tensor(v) else v
                for k, v in kw.items()})
            if isinstance(want, tuple):
                got, want = got[0], want[0]
            _compare(f"{what}, card vs CPU", got, want,
                     f"; flash launches {fa.flash_attention.launches}; CPU "
                     f"{cpu_s:.1f} s")
            if what.startswith("vision"):
                embs = want
            del cpu
        for what, mod in (("I2T mapper", mods.mapper),
                          ("clean mapper", mods.clean_mapper)):
            cpu = copy.deepcopy(mod).cpu()
            want = cpu(embs)
            got = mod(embs.cuda())
            _compare(f"{what}, card vs CPU", got, want)
            embs = want
            del cpu
    del mods
    torch.cuda.empty_cache()


def synthetic_image(rng, h=600, w=480):
    """A smooth HWC float32 image in [0, 1] (not square: the CLI crops)."""
    low = rng.random((h // 24 + 1, w // 24 + 1, 3)).astype(np.float32)
    img = np.kron(low, np.ones((24, 24, 1), np.float32))[:h, :w]
    return np.clip(img + 0.03 * rng.standard_normal(img.shape), 0, 1).astype(
        np.float32)


def generation_path(seed: int):
    """Phase 13.  Returns {dtype name: (seconds per image, DDIM step ms,
    peak GiB, flash launches over the images)}."""
    log(f"phase 13, cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    rng = np.random.default_rng(seed + 6)
    images = [synthetic_image(rng) for _ in range(3)]
    ids, uids, inj = tokenize_template(PROMPT_TEMPLATE)
    ids = torch.from_numpy(ids).cuda()
    uids = torch.from_numpy(uids).cuda()
    inj = torch.tensor([inj], dtype=torch.int32, device="cuda")
    out = {}
    for dtype, n_images in ((torch.bfloat16, 3), (torch.float32, 1)):
        name = str(dtype).split(".")[-1]
        mods = build_guidance(seed, dtype)
        held = torch.cuda.memory_allocated() / 2 ** 30
        log(f"{name} towers built: {held:.2f} GiB allocated before the "
            f"first image")
        gen = torch.Generator("cuda").manual_seed(seed)
        secs, launches = [], 0
        for i in range(n_images):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.flash_attention.launches = 0
            t0 = time.perf_counter()
            img = generate_one(mods, images[i], ids, uids, inj, gen)
            secs.append(time.perf_counter() - t0)
            n = fa.flash_attention.launches
            launches += n
            log(f"generate_one {name} image {i} "
                f"({'warm-up' if n_images > 1 and i == 0 else 'timed'}): "
                f"{secs[-1]:.3f} s, flash launches {n}, output {img.shape} "
                f"{img.dtype}, mean {img.mean():.2f}")
            if n != FLASH_PER_IMAGE or img.shape != (512, 512, 3) \
                    or img.dtype != np.uint8:
                raise RuntimeError(f"generation: {n} launches, {img.shape}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        # one DDIM step at 512 px: the batch-2 UNet call, the guidance and
        # the scheduler update
        with torch.inference_mode():
            cond, _ = mods.text_encoder(ids)
            uncond, _ = mods.text_encoder(uids)
            ctx = torch.cat([uncond, cond])
            lat = torch.randn(1, 64, 64, 4, device="cuda", generator=gen)
            ts = torch.full((2,), 981, dtype=torch.int32, device="cuda")

            def step():
                o = mods.unet(torch.cat([lat, lat]), ts, ctx,
                              use_global_kv=True)
                o_u, o_c = o.chunk(2)
                return mods.scheduler.step(o_u + 5.0 * (o_c - o_u), 981, 971,
                                           lat)

            step_ms = median_ms(step, reps=5)
            profile_device(step, f"DDIM step 512 px {name}")
        timed = secs[1:] if n_images > 1 else secs
        per_image = statistics.median(timed)
        log(f"generation {name} 512 px, 100 steps, CFG 5: "
            f"{[round(v, 3) for v in secs]} s per image (median of the timed "
            f"{per_image:.3f} s, {1 / per_image:.4f} images/s), DDIM step "
            f"{step_ms:.2f} ms, peak memory {peak:.2f} GiB")
        out[name] = (per_image, step_ms, peak, launches)
        del mods
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 14: the flash backward kernels against their plain versions
# ---------------------------------------------------------------------------

# (B, N, H, D, backward launches of that shape per I2T micro-step at 512
# px, batch 4: the five 64 x 64 self-attentions but the first, which comes
# before every trainable parameter and so gets no gradient)
FLASH_BWD_PER_STEP = 4
FLASH_BWD_SHAPES = [
    (4, 4096, 5, 64, FLASH_BWD_PER_STEP),  # the training micro-step
    (2, 4096, 5, 64, 0),    # the CFG shape of generation
    (1, 4096, 5, 128, 0),   # head_dim 128
    (2, 2048, 10, 64, 0),   # the shortest sequence flash_applies routes
    (2, 1000, 3, 64, 0),    # ragged: no 64-row tile divides N
]
# backward kernels vs attention_bwd_ref and vs autograd through
# attention_ref, per gradient: |k - p| <= a max|p| + r |p| and
# ||k - p|| <= l2 ||p||.  float32: the same f32 math in other orders; dS =
# P (dP - di) cancels where dP is near di, which raises the sums' relative
# error on the gradients (the host build: L2 7e-7).  bfloat16: the kernel
# rounds P and dS to bf16 as product operands, the plain backward keeps
# them f32 and plain autograd rounds P and dP to bf16; each rounds the
# gradient once: about one bf16 ulp apart (the host build: L2 2.8e-3 vs
# the plain backward, 3.3e-3 vs autograd), while no_di and dk_unscaled
# read L2 above 1.
FLASH_BWD_TOL = {torch.float32: (1e-4, 1e-3, 1e-4),
                 torch.bfloat16: (2e-2, 2e-2, 1e-2)}
LSE_ATOL = 1e-4  # the forward's lse vs logsumexp of the f32 logits


def _grad_err(got, want, tol):
    """(max abs error, use of the elementwise bound, L2 relative error,
    within the bounds)."""
    a, r, l2_bound = tol
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    use = (diff / (a * w.abs().max() + r * w.abs())).max().item()
    l2 = (diff.norm() / w.norm()).item()
    ok = bool(torch.isfinite(g).all()) and use <= 1.0 and l2 <= l2_bound
    return diff.max().item(), use, l2, ok


def flash_bwd_vs_plain(gen, shapes=FLASH_BWD_SHAPES,
                       dtypes=(torch.float32, torch.bfloat16), timed=True):
    """Phase 14.  Returns the bf16 rows as (backward launches of that shape
    per training micro-step, max_abs vs the plain backward, kernel-pair ms,
    plain autograd backward ms, SDPA backward ms, shape, pair device ms,
    SDPA backward device ms); untimed, the ms are NaN.  Raises after
    printing if any row fails."""
    log("flash backward kernels vs attention_bwd_ref and autograd through "
        "attention_ref, per gradient: |k-p| <= a*max|p| + r*|p| and "
        "||k-p|| <= l2*||p||; a/r/l2 f32 "
        f"{FLASH_BWD_TOL[torch.float32]}, bf16 "
        f"{FLASH_BWD_TOL[torch.bfloat16]}; lse vs logsumexp to {LSE_ATOL}; "
        f"logits std {FLASH_PEAK}; SDPA's backward is the yardstick only")
    log(f"{'B,N,H,D':>16} {'dtype':>8} {'grad':>4} {'max_abs':>10} "
        f"{'use':>6} {'l2':>10} {'ag_use':>6} {'ag_l2':>10}")
    from textualdegremoval_tpu_torch.ops._build import load_library

    lib = load_library()
    rows, failures = [], []
    s = FLASH_PEAK ** 0.5
    for b, n, h, d, per_step in shapes:
        q32, k32, v32, do32 = (torch.randn(b, n, h, d, generator=gen) * sc
                               for sc in (s, s, 1.0, 1.0))
        for dtype in dtypes:
            name = str(dtype).split(".")[-1]
            q, k, v, do = (x.to("cuda", dtype) for x in (q32, k32, v32,
                                                          do32))
            o, lse = fa._forward_kernel(q, k, v, want_lse=True)
            got = fa._backward_kernel(q, k, v, o, lse, do)
            again = fa._backward_kernel(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            lse_err = (lse - fa.lse_ref(q, k)).abs().max().item()
            ok = same and lse_err <= LSE_ATOL
            plain = fa.attention_bwd_ref(q, k, v, o, lse, do)
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            auto = torch.autograd.grad(fa.attention_ref(*leaves), leaves, do)
            errs = []
            for gname, x, p, ag in zip(("dq", "dk", "dv"), got, plain, auto):
                m_abs, use, l2, ok_p = _grad_err(x, p, FLASH_BWD_TOL[dtype])
                _, ag_use, ag_l2, ok_a = _grad_err(x, ag, FLASH_BWD_TOL[dtype])
                ok = ok and ok_p and ok_a
                errs.append(m_abs)
                log(f"{f'{b},{n},{h},{d}':>16} {name:>8} {gname:>4} "
                    f"{m_abs:10.3e} {use:6.3f} {l2:10.3e} {ag_use:6.3f} "
                    f"{ag_l2:10.3e}")
            del again, plain, auto, leaves
            k_ms = p_ms = l_ms = k_dev = l_dev = float("nan")
            if timed:
                stream = torch.cuda.current_stream().cuda_stream

                def pair():
                    return fa._launch_bwd(lib, q, k, v, o, lse, do, stream)

                k_ms = median_ms(pair, reps=10)
                leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
                out = fa.attention_ref(*leaves)
                p_ms = median_ms(lambda: torch.autograd.grad(
                    out, leaves, do, retain_graph=True))
                del out
                tl = [x.transpose(1, 2).detach().clone().requires_grad_(True)
                      for x in (q, k, v)]
                out = F.scaled_dot_product_attention(*tl)
                dot = do.transpose(1, 2)

                def sdpa():
                    return torch.autograd.grad(out, tl, dot,
                                               retain_graph=True)

                l_ms = median_ms(sdpa, reps=10)
                if dtype == torch.bfloat16:
                    k_dev = time_ms(pair, q.device, 20, 5)
                    l_dev = time_ms(sdpa, q.device, 20, 5)
                    log(f"{f'{b},{n},{h},{d}':>16} bfloat16 device pair "
                        f"{k_dev:.4f} ms "
                        f"({10 * b * h * n * n * d / k_dev / 1e9:.1f} TFLOP/s "
                        f"as the bound counts), SDPA backward {l_dev:.4f} ms; "
                        f"enqueue {flash_tool.enqueue_us(pair):.1f} us a pair"
                        + ("; SDPA's backward kernel "
                           f"{flash_tool.sdpa_backend(sdpa)}"
                           if not rows else ""))
                del out, tl, leaves
            bound = flash_bwd_bound_ms(b, n, h, d,
                                       torch.finfo(dtype).bits // 8)
            log(f"{f'{b},{n},{h},{d}':>16} {name:>8} lse max_abs "
                f"{lse_err:.3e}, repeat {same}; kernel pair {k_ms:.4f} ms, "
                f"plain autograd backward {p_ms:.4f} ms, SDPA backward "
                f"{l_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
            if not ok:
                failures.append((b, n, h, d, name))
            if dtype == torch.bfloat16:
                rows.append((per_step, max(errs), k_ms, p_ms, l_ms,
                             (b, n, h, d), k_dev, l_dev))
            del q, k, v, do, o, lse, got
            torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"flash backward disagrees with plain at "
                           f"{failures}")
    return rows


# ---------------------------------------------------------------------------
# Phase 15: pipeline A's training path
# ---------------------------------------------------------------------------

# training flash launches per micro-step: forward, forward under remat,
# backward
FLASH_FWD_PER_STEP, FLASH_FWD_PER_REMAT_STEP = 5, 10
I2T_ACCUM = 4  # the CLI's default gradient_accumulation_steps
STEP_LOSS_RTOL, STEP_GRAD_L2 = 1e-5, 1e-3  # f32, kernel vs plain


def _train_args(**kw):
    """The training CLI's options for a run on seeded random towers."""
    argv = ["--train_data_dir", "unused", "--output_dir", "unused",
            "--random_init"]
    for k, v in kw.items():
        argv += [f"--{k}"] + ([] if v is True else [str(v)])
    return train_cli.parse_args("i2t", argv)


def guidance_batch(args, mods, rng, b):
    """The CLI's device batch of b numpy-made images at args.resolution
    (SD view in [-1, 1], the CLIP view: 224 px for ViT-H/14)."""
    size = args.resolution
    imgs = [synthetic_image(rng, size + 40, size + 24)[:size, :size]
            for _ in range(b)]
    ids, _, inj = train_cli.prompt_ids(args, mods)
    host = {"pixel_values": torch.from_numpy(np.stack(imgs) * 2 - 1),
            "pixel_values_clip": torch.from_numpy(np.stack([
                guidance_data.clip_view(im, mods.image_encoder.image_size)
                for im in imgs])),
            "index": [inj] * b}
    return train_cli.device_batch(host, ids, mods.device)


def set_flash(mods, on: bool):
    """Route the UNet's self-attentions through the kernels (True) or
    attention_ref (attn_impl='plain')."""
    for m in mods.unet.modules():
        if hasattr(m, "use_flash"):
            m.use_flash = on


def _draws(mods, batch, gen):
    """Fixed noise, t and VAE eps for a batch (one generator draw)."""
    with torch.no_grad():
        mean, _ = mods.vae.encode_moments(batch["pixel_values"])
    return {"vae_eps": torch.randn(mean.shape, generator=gen,
                                   device=mean.device, dtype=mean.dtype),
            "noise": torch.randn(mean.shape, generator=gen,
                                 device=mean.device, dtype=mean.dtype),
            "t": torch.randint(0, 1000, (mean.shape[0],), generator=gen,
                               device=mean.device)}


def _counts():
    return fa.flash_attention.launches, fa.flash_attention.launches_bwd


def _reset_counts():
    fa.flash_attention.launches = fa.flash_attention.launches_bwd = 0


def training_path(seed: int):
    """Phase 15.  Returns (backward launches over the counted micro-steps,
    kernel micro-step ms, plain micro-step ms, kernel peak GiB, plain peak
    GiB, backward launches per micro-step)."""
    args = _train_args(mixed_precision="bf16")
    log(f"phase 15: train_i2t at {args.resolution} px, batch "
        f"{args.train_batch_size}, --mixed_precision bf16, accumulation "
        f"{args.gradient_accumulation_steps}, seeded random towers")
    mods = train_cli.build_towers(args, "i2t")
    _, step_fn, lr = train_cli.build_step(args, mods, "i2t")
    train, frozen = pipeline.partition(mods, "i2t")
    if {p.dtype for _, p in frozen} != {torch.bfloat16} or \
            {p.dtype for _, p in train} != {torch.float32}:
        raise RuntimeError("mixed precision: frozen towers not bf16 or "
                           "trainables not f32")
    rng = np.random.default_rng(seed + 7)
    batch = guidance_batch(args, mods, rng, args.train_batch_size)
    gen = torch.Generator(mods.device).manual_seed(seed)

    # warm-up: the loss and gradients outside the optimizer; every
    # trainable parameter gets a finite, non-zero gradient
    loss, grads = pipeline.guidance_loss_and_grads(mods, batch, "i2t", gen)
    bad = [n for n, g in grads.items()
           if not torch.isfinite(g).all() or not g.abs().max() > 0]
    log(f"warm-up micro-step: loss {float(loss):.5f}; {len(grads) - len(bad)}"
        f" of {len(grads)} trainable parameters with a finite non-zero "
        f"gradient")
    if bad or not np.isfinite(float(loss)):
        raise RuntimeError(f"gradients missing or not finite: {bad[:4]}")
    del grads

    frozen_before = [p.detach().clone() for _, p in frozen]
    train_prev = [p.detach().clone() for _, p in train]
    _reset_counts()
    moved_at = []
    for i in range(2 * I2T_ACCUM):
        before = _counts()
        loss = float(step_fn(batch, gen))
        fwd, bwd = (a - b for a, b in zip(_counts(), before))
        moved = [not torch.equal(p, q) for (_, p), q in zip(train,
                                                             train_prev)]
        if any(moved):
            moved_at.append(i + 1)
            train_prev = [p.detach().clone() for _, p in train]
        log(f"micro-step {i + 1}: loss {loss:.5f}, flash launches forward "
            f"{fwd} backward {bwd}, trainables moved {sum(moved)} of "
            f"{len(moved)}")
        if (fwd, bwd) != (FLASH_FWD_PER_STEP, FLASH_BWD_PER_STEP) or \
                not np.isfinite(loss) or any(moved) != all(moved):
            raise RuntimeError(f"micro-step {i + 1}: launches {fwd}/{bwd}, "
                               f"loss {loss}, moved {sum(moved)}")
    launches_fwd, launches_bwd = _counts()
    still = sum(torch.equal(p, q) for (_, p), q in zip(frozen,
                                                        frozen_before))
    log(f"8 micro-steps: flash launches forward {launches_fwd} backward "
        f"{launches_bwd}; trainables moved at micro-steps {moved_at}; "
        f"{still} of {len(frozen)} frozen parameters bitwise unchanged")
    if moved_at != [I2T_ACCUM, 2 * I2T_ACCUM] or still != len(frozen):
        raise RuntimeError("the accumulation or the frozen towers are wrong")
    del frozen_before, train_prev

    # remat: 5 more forward launches, loss and gradients bitwise equal to
    # the no-remat call's, as a second no-remat call is (cuDNN's
    # deterministic algorithms for this comparison only)
    draws = _draws(mods, batch, gen)
    torch.backends.cudnn.deterministic = True
    out = []
    for remat in (False, False, True):
        before = _counts()
        loss, grads = pipeline.guidance_loss_and_grads(
            mods, batch, "i2t", remat=remat, **draws)
        out.append((loss, grads,
                    tuple(a - b for a, b in zip(_counts(), before))))
    torch.backends.cudnn.deterministic = False

    def equal(x, y):
        return torch.equal(x[0], y[0]) and all(
            torch.equal(g, y[1][n]) for n, g in x[1].items())

    repeat, same = equal(out[1], out[0]), equal(out[2], out[0])
    log(f"no remat twice: bitwise equal {repeat}, launches {out[0][2]}; "
        f"remat: loss {float(out[2][0]):.6f}, launches {out[2][2]}, bitwise "
        f"equal to no remat {same}")
    if not (repeat and same) or out[0][2] != (
            FLASH_FWD_PER_STEP, FLASH_BWD_PER_STEP) or out[2][2] != (
            FLASH_FWD_PER_REMAT_STEP, FLASH_BWD_PER_STEP):
        raise RuntimeError("remat: launches or gradients differ")
    del out, grads

    # the micro-step through the kernels vs through attention_ref
    # (attn_impl='plain'), in alternating turns (CUDA events); peak memory
    turns = {"kernel": [], "plain": []}
    peak = {}
    for route in ("kernel", "plain", "plain", "kernel", "kernel", "plain"):
        set_flash(mods, route == "kernel")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        step_fn(batch, gen)
        e.record()
        torch.cuda.synchronize()
        turns[route].append(s.elapsed_time(e))
        peak[route] = torch.cuda.max_memory_allocated() / 2 ** 30
    set_flash(mods, True)
    k_ms = statistics.median(turns["kernel"])
    p_ms = statistics.median(turns["plain"])
    log(f"I2T micro-step {args.resolution} px batch "
        f"{args.train_batch_size} bf16, alternating turns: kernels "
        f"{[round(v, 2) for v in turns['kernel']]} ms, plain "
        f"{[round(v, 2) for v in turns['plain']]} ms; medians {k_ms:.2f} vs "
        f"{p_ms:.2f} ms; peak memory {peak['kernel']:.2f} vs "
        f"{peak['plain']:.2f} GiB; lr {lr:g}")
    profile_device(lambda: step_fn(batch, gen),
                   f"I2T micro-step {args.resolution} px bf16")
    del mods, batch, step_fn, train, frozen
    torch.cuda.empty_cache()

    f32_step_vs_plain(seed)
    return launches_bwd, k_ms, p_ms, peak["kernel"], peak["plain"]


def f32_step_vs_plain(seed: int):
    """Phase 15: one f32 I2T micro-step at batch 1 through the kernels
    against attn_impl='plain' on the card (TF32 off), the same draws: loss
    to 1e-5 relative, each trainable gradient to 1e-3 in L2; then one
    TR-stage update, after which only the clean mapper has moved."""
    args = _train_args(train_batch_size=1)
    mods = train_cli.build_towers(args, "i2t")
    batch = guidance_batch(args, mods, np.random.default_rng(seed + 8), 1)
    draws = _draws(mods, batch,
                   torch.Generator(mods.device).manual_seed(seed))
    res = {}
    for on in (True, False):
        set_flash(mods, on)
        _reset_counts()
        res[on] = pipeline.guidance_loss_and_grads(mods, batch, "i2t",
                                                   **draws)
        res[on] += (_counts(),)
    set_flash(mods, True)
    (lk, gk, ck), (lp, gp, cp) = res[True], res[False]
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    l2 = {n: ((gk[n] - gp[n]).norm() / gp[n].norm()).item() for n in gk}
    worst = max(l2, key=l2.get)
    log(f"f32 I2T micro-step batch 1, kernels vs plain: loss {float(lk):.7f} "
        f"vs {float(lp):.7f} (rel {rel:.2e}, bound {STEP_LOSS_RTOL:g}); "
        f"gradients L2 median {statistics.median(l2.values()):.2e}, largest "
        f"{l2[worst]:.2e} ({worst}; bound {STEP_GRAD_L2:g}); launches "
        f"{ck} vs {cp}")
    if rel > STEP_LOSS_RTOL or l2[worst] > STEP_GRAD_L2 or \
            ck != (FLASH_FWD_PER_STEP, FLASH_BWD_PER_STEP) or cp != (0, 0):
        raise RuntimeError("f32 micro-step: kernels disagree with plain")
    del res, gk, gp

    opt = pipeline.make_guidance_optimizer(mods, "tr", lr=1e-5)
    step = pipeline.make_guidance_train_step(mods, opt, "tr")
    named = pipeline.partition(mods, "tr")
    before = {n: p.detach().clone() for part in named for n, p in part}
    loss = float(step(batch, **draws))
    moved = {n for part in named for n, p in part
             if not torch.equal(p, before[n])}
    want = {n for n, _ in named[0]}
    log(f"TR update: loss {loss:.5f}; {len(moved)} parameters moved, "
        f"{len(want)} clean_mapper parameters")
    if moved != want or not all(n.startswith("clean_mapper.") for n in want):
        raise RuntimeError(f"TR update moved {sorted(moved ^ want)[:4]}")
    del mods, before
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 16-18: PromptIR's widths, the cross-block chain, PromptIRRefFusion
# ---------------------------------------------------------------------------

PROMPTIR_TASK = "promptir_all_in_one"
# one 512 px promptir_all_in_one forward: 44 blocks in 8 stages of two or
# more, 8 fusion blocks and 3 noise blocks; chain off, every block is one
# launch of the whole-block kernel; chain on, 11 such launches, 8 chain
# calls and 36 chain kernel launches (one per block but the last of a
# stage)
PROMPTIR_BLOCKS = 55
PROMPTIR_CHAIN_BLOCKS = 11
PROMPTIR_CHAIN = (8, 36)
# (B, H, W, C, heads, blocks of that shape in one forward): the noise
# blocks of the 512 px forward, 4 heads each, and a ragged shape
NOISE_SHAPES = block_fwd_tool.NOISE_SHAPES
# (B, H, W, C, heads, blocks in the stage, stages of that shape in one
# 512 px forward)
CHAIN_SHAPES = [
    (1, 512, 512, 48, 1, 4, 1),    # encoder level 1
    (1, 256, 256, 96, 2, 6, 2),    # encoder / decoder level 2
    (1, 128, 128, 192, 4, 6, 2),   # encoder / decoder level 3
    (1, 64, 64, 384, 8, 8, 1),     # latent
    (1, 512, 512, 96, 1, 4, 2),    # decoder level 1, refinement
    (2, 37, 53, 96, 2, 3, 0),      # ragged, batch 2
]


def _errors(got, want, x, dtype, depth=1):
    """(max_abs, tol_use, branch use) of got against want: the elementwise
    error over phase 3's atol + rtol |want| and the L2 error over what the
    blocks add to x, over phase 3's branch bound, both bounds times
    sqrt(depth).  Each is within its bound when at most 1."""
    atol, rtol = TOL[dtype]
    scale = depth ** 0.5
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    added = (want - x.float()).norm().clamp_min(1e-30)
    return (diff.max().item(),
            (diff / (scale * (atol + rtol * want.abs()))).max().item(),
            (diff.norm() / added).item() / (scale * BRANCH_TOL[dtype]))


def _chain_route(x, heads) -> str:
    """The route `tblock_chain_fused` takes for x (bf16: the pipeline,
    its boundaries fused up to C = 384; else csrc/tblock_chain.cu)."""
    if not tb._takes_pipeline(x, heads):
        return "tblock_chain.cu"
    return "pipeline" + ("" if tb._chain_fuses(x.shape[-1]) else
                         " (unfused)")


def chain_epilogue_vs_unfused(lib, x, kws, heads, ln_type, sms, stream):
    """Phase 17, the chain epilogue's own contract at a stage's first block
    boundary, on block 0's x1 and gates as the pipeline makes them: out
    bitwise what `fwd_gemm_residual` writes, and y within one bf16 ulp of
    `bwd_ln_rows` on that out (|y - y_ref| <= 2^-7 |y_ref| + 1e-6: the
    moments are summed in another order; on an H100 the two were equal at
    every shape of the tests).  Returns (out bitwise equal, the largest
    |y - y_ref| over that bound, the share of y bitwise equal)."""
    c = x.shape[-1]
    npix, hpad = x.numel() // c, kws[0]["hpad"]
    bias_free = int(ln_type == "BiasFree")
    ys = gb._ln_rows(lib, x, kws[0]["ln1w"], kws[0]["ln1b"], bias_free,
                     stream)[0]
    x1, _ = tb._pipeline_attn(lib, x, ys, kws[0], heads, sms, stream)
    gates = tb._pipeline_gates(lib, x1, kws[0], ln_type, sms, stream)
    kn, ptr = kws[1], tb._ptr
    out, y, want = (torch.empty_like(x) for _ in range(3))
    tb._check(lib.fwd_gemm_residual_ln(
        ptr(gates), ptr(kws[0]["w2"]), ptr(x1), ptr(kn["ln1w"]),
        ptr(kn["ln1b"]), bias_free, gb._EPS, ptr(out), ptr(y), npix, c, hpad,
        stream), lib, "fwd_gemm_residual_ln")
    tb._check(lib.fwd_gemm_residual(ptr(gates), ptr(kws[0]["w2"]), ptr(x1),
                                    ptr(want), npix, c, hpad, stream), lib,
              "fwd_gemm_residual")
    want_y = gb._ln_rows(lib, want, kn["ln1w"], kn["ln1b"], bias_free,
                         stream)[0].float()
    got_y = y.view(npix, c).float()
    use = ((got_y - want_y).abs() / (2 ** -7 * want_y.abs() + 1e-6)).max()
    return (torch.equal(out, want), use.item(),
            (got_y == want_y).float().mean().item())


def chain_vs_plain(gen, shapes=CHAIN_SHAPES,
                   dtypes=(torch.float32, torch.bfloat16), timed=True):
    """Phase 17: a stage of n blocks through the chain (`TBlockStage` with
    chain=True; bf16 `chain_pipeline`, float32 csrc/tblock_chain.cu)
    against the whole-block kernels run block by block and against the
    plain chain `tblock_chain_ref`, with phase 3's weights and its bounds
    times sqrt(n): rounding differences add up block after block.  On an
    H100 the whole-block kernel run block by block differed from the
    plain chain as much as the chain did (1.3 times phase 3's per-block
    bound at n = 8 in bf16); the bf16 chain is the block pipeline's
    kernels but at each boundary, where the epilogue's LayerNorm sums the
    row's moments in another order than `bwd_ln_rows`.  Two calls bitwise
    equal; in bf16 every boundary a `chain_pipeline` launch and the
    epilogue's own contract (`chain_epilogue_vs_unfused`: out bitwise,
    epi_use the y error over one ulp, at most 1); the median time of the
    three routes, and in bf16 of csrc/tblock_chain.cu's route on the same
    stage (`chain_kernel_route`, held to the same bounds).
    Returns the bf16 WithBias rows of the main path as (stages per
    forward, max_abs against the plain chain, chain ms, plain ms,
    block-by-block ms, tblock_chain.cu ms, shape)."""
    log("chain vs the plain chain and vs the block kernels block by block, "
        "phase 3's bounds times sqrt(n); tol_use and branch_use are the "
        "errors over their bounds; bf16: csrc/tblock_chain.cu's route on "
        "the same stage beside (kc_*)")
    log(f"{'B,H,W,C,heads,n':>24} {'LN':>8} {'dtype':>8} {'max_abs':>10} "
        f"{'tol_use':>8} {'branch_use':>10} {'blk_tol':>8} {'blk_branch':>10} "
        f"{'kc_branch':>10} {'epi_use':>8} {'chain_ms':>10} "
        f"{'blocks_ms':>10} {'plain_ms':>10} {'kc_ms':>10}  route")
    lib = _build.load_library()
    stream, sms = tb._card(torch.device("cuda"))
    rows, failures = [], []
    for b, h, w, c, heads, n, stages in shapes:
        for ln_type in ("WithBias", "BiasFree"):
            stage = layers.TBlockStage(c, heads, n, ln_type=ln_type,
                                       chain=True)
            for blk in stage:
                randomize_block(blk, gen)
            x32 = torch.randn(b, h, w, c, generator=gen)
            for dtype in dtypes:
                st = stage.to(device="cuda", dtype=dtype)
                x = x32.to(device="cuda", dtype=dtype)
                ps = [blk.block_params() for blk in st]
                kws = [blk._kernel_weights(p, x) for blk, p in zip(st, ps)]
                route = _chain_route(x, heads)
                pipeline = route.startswith("pipeline")

                def blocks():
                    y = x
                    for blk in st:
                        y = blk(y)
                    return y

                def kernel_route():
                    return tb.chain_kernel_route(lib, x, kws, heads, ln_type,
                                                 sms, stream)

                with torch.inference_mode():
                    _reset_chain_counts()
                    tb.chain_pipeline.launches = 0
                    got = st(x)
                    same = torch.equal(got, st(x))
                    counts = _chain_counts()
                    piped = tb.chain_pipeline.launches
                    want = tb.tblock_chain_ref(x, ps, heads, ln_type)
                    max_abs, tol_use, branch = _errors(got, want, x, dtype,
                                                       n)
                    _, tol_b, branch_b = _errors(got, blocks(), x, dtype,
                                                 n)
                    finite = bool(torch.isfinite(got).all())
                    kc_tol = kc_branch = epi_use = 0.0
                    epi_out, epi_same = True, 1.0
                    c_ms = b_ms = p_ms = k_ms = float("nan")
                    if pipeline:
                        _, kc_tol, kc_branch = _errors(kernel_route(), want,
                                                       x, dtype, n)
                    if route == "pipeline":
                        epi_out, epi_use, epi_same = \
                            chain_epilogue_vs_unfused(lib, x, kws, heads,
                                                      ln_type, sms, stream)
                    if timed:
                        c_ms = median_ms(lambda: st(x))
                        b_ms = median_ms(blocks)
                        p_ms = median_ms(lambda: tb.tblock_chain_ref(
                            x, ps, heads, ln_type))
                        if pipeline:
                            k_ms = median_ms(kernel_route)
                name = str(dtype).split(".")[-1]
                log(f"{f'{b},{h},{w},{c},{heads},{n}':>24} {ln_type:>8} "
                    f"{name:>8} {max_abs:10.3e} {tol_use:8.3f} "
                    f"{branch:10.3f} {tol_b:8.3f} {branch_b:10.3f} "
                    f"{kc_branch:10.3f} {epi_use:8.3f} {c_ms:10.4f} "
                    f"{b_ms:10.4f} {p_ms:10.4f} {k_ms:10.4f}  {route}"
                    f"{'' if same else '  NOT REPEATABLE'}"
                    f"{'' if epi_out else '  EPILOGUE OUT DIFFERS'}")
                if not finite or not same or counts != (2, 2 * (n - 1)) \
                        or piped != 2 * (n - 1) * pipeline \
                        or not epi_out or epi_same < 0.95 \
                        or max(tol_use, branch, tol_b, branch_b, kc_tol,
                               kc_branch, epi_use) > 1.0:
                    failures.append((b, h, w, c, heads, n, ln_type, name,
                                     counts, piped))
                if dtype == torch.bfloat16 and ln_type == "WithBias" \
                        and stages:
                    rows.append((stages, max_abs, c_ms, p_ms, b_ms, k_ms,
                                 (b, h, w, c, heads, n)))
                del got, want, kws
            stage.cpu().float()
    if failures:
        raise RuntimeError(f"chain disagrees at {failures}")
    return rows


def chain_grad_vs_autograd(gen, shape=(8, 96, 96, 192, 4, 2)):
    """Phase 17, the gradient: `_TBlockChainFunction` (the chain forward,
    the backward through the plain chain block by block) against plain
    autograd through `tblock_chain_ref`, f32, at a 384 px batch-8 training
    shape: x and every parameter in L2 against its own norm (phase 6's
    f32 bound)."""
    b, h, w, c, heads, n = shape
    stage = layers.TBlockStage(c, heads, n, chain=True)
    for blk in stage:
        randomize_block(blk, gen)
    stage = stage.to("cuda")
    x = torch.randn(b, h, w, c, generator=gen).cuda().requires_grad_(True)
    g = torch.randn(b, h, w, c, generator=gen).cuda()
    names = ["x", *(k for k, _ in stage.named_parameters())]
    params = list(stage.parameters())
    _reset_chain_counts()
    got = torch.autograd.grad(stage(x), [x, *params], g)
    counts = _chain_counts()
    ps = [blk.block_params() for blk in stage]
    want = torch.autograd.grad(tb.tblock_chain_ref(x, ps, heads),
                               [x, *params], g)
    errs = [((a - r).norm() / r.norm().clamp_min(1e-30)).item()
            for a, r in zip(got, want)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    log(f"chain gradient at {shape} f32 vs plain autograd: largest L2 "
        f"{errs[worst]:.3e} ({names[worst]}, bound "
        f"{GRAD_L2[torch.float32]}), chain calls/launches {counts}")
    if errs[worst] > GRAD_L2[torch.float32] or counts != (1, n - 1):
        raise RuntimeError(f"chain gradient disagrees: {errs[worst]} at "
                           f"{names[worst]}, counts {counts}")
    del stage, x, g, got, want
    torch.cuda.empty_cache()


def promptir_path(seed: int):
    """Phase 18: the full-width promptir_all_in_one network on the card
    against the CPU (f32, chain off and on: csrc/tblock.cu's pair and
    csrc/tblock_chain.cu, no pipeline call), then the evaluation path at
    512 px in bf16 through both routes (every whole-block call through the
    pipeline, every chain boundary through the chain epilogue of
    `chain_pipeline`), each forward's host enqueue time beside its time.
    Returns the chain-off and chain-on results of `main_path` (with
    enqueue ms)."""
    network_vs_cpu(seed, PROMPTIR_TASK, tb.tblock_fused,
                   ((PROMPTIR_BLOCKS, None),
                    (PROMPTIR_CHAIN_BLOCKS, PROMPTIR_CHAIN)),
                   more=((tb.tblock_pipeline, 0), (tb.chain_pipeline, 0)))
    off = main_path(seed, PROMPTIR_TASK, tb.tblock_fused, PROMPTIR_BLOCKS,
                    more=((tb.tblock_pipeline, PROMPTIR_BLOCKS),
                          (tb.chain_pipeline, 0)), enqueue=True)
    on = main_path(seed, PROMPTIR_TASK, tb.tblock_fused,
                   PROMPTIR_CHAIN_BLOCKS, PROMPTIR_CHAIN,
                   more=((tb.tblock_pipeline, PROMPTIR_CHAIN_BLOCKS),
                         (tb.chain_pipeline, PROMPTIR_CHAIN[1])),
                   enqueue=True)
    log(f"{PROMPTIR_TASK} forward 512 px bf16: chain off {off[1]:.2f} ms "
        f"({1e3 / off[1]:.3f} images/s, enqueue {off[4]:.2f} ms), chain on "
        f"{on[1]:.2f} ms ({1e3 / on[1]:.3f} images/s, enqueue {on[4]:.2f} "
        f"ms)")
    return off, on


# ---------------------------------------------------------------------------
# Phases 19-22: the module path, its GDFN kernel (B6) and its MDTA
# statistics kernel (B7)
# ---------------------------------------------------------------------------

# the module path with both kernels: JAX TransformerBlock(fused=False) with
# GDFN(fused=True) and MDTAAttention(use_pallas=True); one launch of each
# kernel per block, none of the whole-block kernel
MODULE_ROUTE = {"fused": False, "gdfn_fused": True, "mdta_pallas": True}
MODULE_BLOCKS = 52
# (B, H, W, C, blocks of that shape in one 512 px restormer_deblur
# forward): every GDFN of SHAPES, the ragged one included
GDFN_SHAPES = [(b, h, w, c, n) for b, h, w, c, _, n in SHAPES]
# B6 vs gdfn_ref: pass when |k - p| <= a max|p| + r |p| at every element
# and ||k - p|| <= l2 ||p|| (the GDFN's output is all it adds to the
# block's residual), (a, r, l2).  float32: sum orders only; on an H100 the
# first version read at most 2.5e-6 of max|p| and 8.4e-7 in L2.
# bfloat16: the kernel keeps the depthwise sums and the gate in f32 and
# rounds where JAX's kernel does, the plain version after every op: 0.9%
# of max|p| and 5.4e-3 in L2 there.
GDFN_TOL = {torch.float32: (2e-5, 1e-4, 1e-5),
            torch.bfloat16: (2e-2, 2e-2, 1.5e-2)}
# (B, H, W, C, heads, blocks of that shape in one forward): every
# attention of SHAPES and PromptIR's three noise blocks (cph 176 / 80 /
# 40)
MDTA_SHAPES = SHAPES + [(b, h, w, c, heads, 0)
                        for b, h, w, c, heads, _ in NOISE_SHAPES[:3]]
# B7 vs mdta_stats_ref, (atol, rtol, l2) for attn (f32 in both, entries in
# [0, 1]; both take the same inputs to f32 and differ in sum order only:
# the first version read at most 5.5e-6 on an H100) and (a, r, l2) as
# GDFN_TOL's for attn . v, which casts attn to v's dtype: in bf16 an
# attention entry whose rounding flips moves the output by up to a bf16
# ulp of that term.
MDTA_TOL = {torch.float32: (5e-5, 1e-3, 1e-4),
            torch.bfloat16: (5e-5, 1e-3, 1e-4)}
MDTA_OUT_TOL = {torch.float32: (1e-4, 1e-4, 1e-4),
                torch.bfloat16: (1e-2, 1e-2, 1e-2)}
# the training protocol's options with fused_kernels off (module blocks)
MODULE_TRAIN_OPT = {**TRAIN_OPT, "train": {**TRAIN_OPT["train"],
                                           "fused_kernels": "off"}}
# phase 22's batch: module blocks save every activation for autograd
# (about 100 KB per 384 px pixel with B6, 150 KB without, measured by a
# saved-tensor count on the CPU), so the protocol's batch of 8 would need
# more than the card's 80 GB on either route; 2 fits both
MODULE_TRAIN_BATCH = 2


def _err_use(got, want, a, r, l2):
    """(max_abs, elementwise use, L2 use) of got against want under the
    bound |k - p| <= a max|p| + r |p| and ||k - p|| <= l2 ||p||; each is
    within its bound when at most 1."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    lim = (a * w.abs().max() + r * w.abs()).clamp_min(1e-30)
    return (diff.max().item(), (diff / lim).max().item(),
            (diff.norm() / w.norm().clamp_min(1e-30)).item() / l2)


def gdfn_weights(c: int, gen: torch.Generator):
    """A GDFN's (w1 (C, 2h), dwk (3, 3, 2h), w2 (h, C)) at a trained
    block's scale (randomize_block's N(0, 1/fan_in))."""
    hid = int(c * 2.66)
    return (torch.randn(c, 2 * hid, generator=gen) * c ** -0.5,
            torch.randn(3, 3, 2 * hid, generator=gen) / 3,
            torch.randn(hid, c, generator=gen) * hid ** -0.5)


def gdfn_vs_plain(gen, shapes=GDFN_SHAPES,
                  dtypes=(torch.float32, torch.bfloat16), timed=True):
    """Phase 19: `gdfn_fused` (bf16 at C % 8 == 0: `gdfn_pipeline`; else
    csrc/gdfn.cu) against `gdfn_ref` at every GDFN shape of the 512 px
    forward and a ragged batch-2 shape, float32 and bfloat16, under
    GDFN_TOL; two calls bitwise equal, one `gdfn_fused` launch per call and
    one `gdfn_pipeline` call per call on the pipeline's route; the median
    time of both, and in bf16 of csrc/gdfn.cu on the same inputs (the
    route the pipeline replaced; `_launch`, held to the same bounds).
    Returns the bf16 rows of the main path as (GDFNs per forward, max_abs,
    kernel ms, plain ms, csrc/gdfn.cu ms, shape)."""
    log("gdfn_fused vs gdfn_ref: |k-p| <= a max|p| + r|p|, ||k-p|| <= l2 "
        f"||p||; (a, r, l2) f32 {GDFN_TOL[torch.float32]}, bf16 "
        f"{GDFN_TOL[torch.bfloat16]}; tol_use and l2_use are the errors "
        "over their bounds; bf16: csrc/gdfn.cu on the same inputs beside")
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    rows, failures = [], []
    for b, h, w, c, n in shapes:
        w1, dwk, w2 = (t.cuda() for t in gdfn_weights(c, gen))
        x32 = torch.randn(b, h, w, c, generator=gen)
        for dtype in dtypes:
            x = x32.to("cuda", dtype)
            kw = gd.prepare_gdfn_weights(w1, dwk, w2, dtype)
            pipeline = gd._takes_gdfn_pipeline(x)
            tile = gd.pick_tile(lib, c, x.element_size())

            def gdfn_cu():
                return gd._launch(lib, x, kw, tile, stream)

            with torch.inference_mode():
                before = (gd.gdfn_fused.launches, gd.gdfn_pipeline.launches)
                got = gd.gdfn_fused(x, w1, dwk, w2, kw)
                same = torch.equal(got, gd.gdfn_fused(x, w1, dwk, w2, kw))
                launched = (gd.gdfn_fused.launches - before[0],
                            gd.gdfn_pipeline.launches - before[1])
                want = gd.gdfn_ref(x, w1, dwk, w2)
                max_abs, use, l2_use = _err_use(got, want, *GDFN_TOL[dtype])
                cu_use = cu_l2 = 0.0
                if pipeline:
                    _, cu_use, cu_l2 = _err_use(gdfn_cu(), want,
                                                *GDFN_TOL[dtype])
                finite = bool(torch.isfinite(got).all())
                k_ms = p_ms = cu_ms = float("nan")
                if timed:
                    k_ms = median_ms(lambda: gd.gdfn_fused(x, w1, dwk, w2,
                                                           kw))
                    p_ms = median_ms(lambda: gd.gdfn_ref(x, w1, dwk, w2))
                    if pipeline:
                        cu_ms = median_ms(gdfn_cu)
            name = str(dtype).split(".")[-1]
            log(f"{b},{h},{w},{c} {name}: max_abs {max_abs:.3e} (max|p| "
                f"{want.abs().max().item():.3f}) tol_use {use:.3f} l2_use "
                f"{l2_use:.3f} kernel {k_ms:.4f} ms plain {p_ms:.4f} ms; "
                f"route {'pipeline' if pipeline else f'gdfn.cu tile {tile}'}"
                + (f"; gdfn.cu tol_use {cu_use:.3f} l2_use {cu_l2:.3f} "
                   f"{cu_ms:.4f} ms" if pipeline else "")
                + ('' if same else '  NOT REPEATABLE'))
            if not finite or not same or launched != (2, 2 * pipeline) \
                    or max(use, l2_use, cu_use, cu_l2) > 1.0:
                failures.append((b, h, w, c, name, launched))
            if dtype == torch.bfloat16 and n:
                rows.append((n, max_abs, k_ms, p_ms, cu_ms, (b, h, w, c)))
            del got, want, x, kw
    if failures:
        raise RuntimeError(f"gdfn_fused disagrees with gdfn_ref at "
                           f"{failures}")
    return rows


def gdfn_grad_vs_autograd(gen, shape=(8, 384, 384, 48)):
    """Phase 19, the gradient: `gdfn_fused` under autograd (the kernel
    forward, the backward recomputing through gdfn_ref) against autograd
    through `gdfn_ref`, f32, at a 384 px batch-8 training shape: x and
    each weight in L2 against its own norm (phase 6's f32 bound)."""
    b, h, w, c = shape
    ws = [t.cuda().requires_grad_(True) for t in gdfn_weights(c, gen)]
    x = torch.randn(b, h, w, c, generator=gen).cuda().requires_grad_(True)
    g = torch.randn(b, h, w, c, generator=gen).cuda()
    before = gd.gdfn_fused.launches
    got = torch.autograd.grad(gd.gdfn_fused(x, *ws), [x, *ws], g)
    launched = gd.gdfn_fused.launches - before
    want = torch.autograd.grad(gd.gdfn_ref(x, *ws), [x, *ws], g)
    errs = [((a - r).norm() / r.norm().clamp_min(1e-30)).item()
            for a, r in zip(got, want)]
    log(f"gdfn_fused gradient at {shape} f32 vs autograd through gdfn_ref: "
        f"L2 x/w1/dwk/w2 {' '.join(f'{e:.3e}' for e in errs)} (bound "
        f"{GRAD_L2[torch.float32]}), {launched} launch")
    if max(errs) > GRAD_L2[torch.float32] or launched != 1:
        raise RuntimeError(f"gdfn_fused gradient disagrees: {errs}")
    del x, g, ws, got, want
    torch.cuda.empty_cache()


def mdta_vs_plain(gen, shapes=MDTA_SHAPES,
                  dtypes=(torch.float32, torch.bfloat16), timed=True):
    """Phase 20: `mdta_stats` against `mdta_stats_ref` and `mdta_attention`
    against the module path's `mdta_attention_nhwc`, at every attention
    shape of the 512 px forward, PromptIR's noise blocks and a ragged
    batch-2 shape, float32 and bfloat16.  q, k and v are the chunks of one
    qkv = x . W (W ~ N(0, 1/C), so channel correlations are O(C^-1/2)) with
    temperatures ~ sqrt(C), so each softmax row is far from uniform; q and
    k go to the kernels as strided views.  Bounds MDTA_TOL / MDTA_OUT_TOL;
    two calls bitwise equal; three `mdta_stats` calls counted, and on the
    gram route (`_takes_gram`: every bf16 shape here) three `mdta_gram`
    calls, none in float32 (csrc/mdta.cu); the median time of the kernels
    and of `mdta_stats_ref`, and in bf16 of csrc/mdta.cu on the same
    inputs (held to the same bounds) and of one torch.matmul of the gram
    q_h^T k_h on the same operands (the yardstick, never called by the
    port).  Returns the bf16 rows of the main path as (blocks per forward,
    max_abs of attn, kernel ms, plain ms, shape, mdta.cu ms, matmul ms)."""
    log("mdta_stats vs mdta_stats_ref (attn: |k-p| <= atol + rtol|p|, "
        "||k-p|| <= l2 ||p||) and attn.v vs mdta_attention_nhwc (|k-p| <= a "
        f"max|p| + r|p|, l2); f32 {MDTA_TOL[torch.float32]} / "
        f"{MDTA_OUT_TOL[torch.float32]}, bf16 {MDTA_TOL[torch.bfloat16]} / "
        f"{MDTA_OUT_TOL[torch.bfloat16]}; bf16: csrc/mdta.cu on the same "
        "inputs beside")
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    rows, failures = [], []

    def attn_use(got, want, dtype):
        atol, rtol, l2 = MDTA_TOL[dtype]
        diff = (got - want).abs()
        return (diff.max().item(),
                (diff / (atol + rtol * want.abs())).max().item(),
                (diff.norm() / want.norm()).item() / l2)

    for b, h, w, c, heads, n in shapes:
        x = torch.randn(b, h, w, c, generator=gen).cuda()
        wqkv = (torch.randn(c, 3 * c, generator=gen) * c ** -0.5).cuda()
        temp = (c ** 0.5 * (0.5 + torch.rand(heads, 1, 1,
                                              generator=gen))).cuda()
        cph = c // heads
        for dtype in dtypes:
            with torch.inference_mode():
                qkv = (x @ wqkv).to(dtype)
                q, k, v = torch.chunk(qkv, 3, dim=-1)
                gram = md._takes_gram(q, k, heads)
                tl, nsplit = md.plan(lib, q, heads)

                def mdta_cu():
                    return md._launch(lib, q, k, temp, heads, tl, nsplit,
                                      stream)

                before = (md.mdta_stats.launches, md.mdta_gram.launches)
                got = md.mdta_stats(q, k, temp, heads)
                same = torch.equal(got, md.mdta_stats(q, k, temp, heads))
                out = md.mdta_attention(q, k, v, temp, heads)
                launched = (md.mdta_stats.launches - before[0],
                            md.mdta_gram.launches - before[1])
                want = md.mdta_stats_ref(q, k, temp, heads)
                want_out = mdta_attention_nhwc(q, k, v, temp, heads)
                max_abs, use, l2_use = attn_use(got, want, dtype)
                out_abs, out_use, out_l2 = _err_use(out, want_out,
                                                    *MDTA_OUT_TOL[dtype])
                cu_use = cu_l2 = 0.0
                if gram:
                    _, cu_use, cu_l2 = attn_use(mdta_cu(), want, dtype)
                finite = bool(torch.isfinite(got).all()
                              and torch.isfinite(out).all())
                k_ms = p_ms = cu_ms = lib_ms = float("nan")
                if timed:
                    k_ms = median_ms(lambda: md.mdta_stats(q, k, temp,
                                                           heads))
                    p_ms = median_ms(lambda: md.mdta_stats_ref(q, k, temp,
                                                               heads))
                    if gram:
                        cu_ms = median_ms(mdta_cu)
                        qv, kv = (torch.as_strided(
                            t, (b, heads, h * w, cph),
                            (t.stride(0), cph, t.stride(2), 1),
                            t.storage_offset()) for t in (q, k))
                        lib_ms = median_ms(lambda: torch.matmul(
                            qv.transpose(-1, -2), kv))
            name = str(dtype).split(".")[-1]
            route = "mdta_gram" if gram else f"mdta.cu {tl}, {nsplit}"
            log(f"{b},{h},{w},{c},{heads} {name}: attn max_abs "
                f"{max_abs:.3e} tol_use {use:.3f} l2_use {l2_use:.3f} "
                f"(row max {want.max().item():.3f}); attn.v max_abs "
                f"{out_abs:.3e} tol_use {out_use:.3f} l2_use {out_l2:.3f}; "
                f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms; route {route}"
                + (f"; mdta.cu tol_use {cu_use:.3f} l2_use {cu_l2:.3f} "
                   f"{cu_ms:.4f} ms; matmul {lib_ms:.4f} ms" if gram else "")
                + ('' if same else '  NOT REPEATABLE'))
            if not finite or not same or launched != (3, 3 * gram) \
                    or gram != (dtype == torch.bfloat16) \
                    or max(use, l2_use, out_use, out_l2, cu_use,
                           cu_l2) > 1.0:
                failures.append((b, h, w, c, heads, name, launched,
                                 round(max(use, l2_use, out_use, out_l2), 3)))
            if dtype == torch.bfloat16 and n:
                rows.append((n, max_abs, k_ms, p_ms, (b, h, w, c, heads),
                             cu_ms, lib_ms))
            del qkv, q, k, v, got, want, out, want_out
    if failures:
        raise RuntimeError(f"mdta_stats disagrees with mdta_stats_ref or its "
                           f"route at (B, H, W, C, heads, dtype, launches of "
                           f"mdta_stats and mdta_gram, the error over its "
                           f"bound) {failures}")
    return rows


def mdta_refuses_grad():
    """Phase 20: the statistics kernel is forward only (as is JAX's): a
    call that would need a gradient raises, and launches nothing."""
    q = torch.randn(1, 8, 8, 16, device="cuda", requires_grad=True)
    before = md.mdta_stats.launches
    try:
        md.mdta_attention(q, q.detach(), q.detach(), torch.ones(2, 1, 1,
                                                                device="cuda"),
                          2)
    except RuntimeError as e:
        if "forward only" in str(e) and md.mdta_stats.launches == before:
            log(f"mdta_stats under autograd refused: {e}")
            return
    raise RuntimeError("mdta_stats did not refuse a call needing a "
                       "gradient")


def module_eval_path(seed: int):
    """Phase 21: the full-width restormer_deblur network on the module path
    with both kernels (MODULE_ROUTE) on the card against the CPU in f32,
    then the evaluation path at 512 px in bf16: 52 launches of each
    kernel per forward (every bf16 GDFN through `gdfn_pipeline` and every
    B7 call through `mdta_gram`, none in f32) and none of the whole-block
    kernel; then the module path without
    the two kernels.  Returns (with, without) as `main_path`
    returns them."""
    counted = ((gd.gdfn_fused, MODULE_BLOCKS), (md.mdta_stats,
                                                MODULE_BLOCKS))
    network_vs_cpu(seed, TASK, tb.tblock_fused, ((0, None),), MODULE_ROUTE,
                   counted + ((gd.gdfn_pipeline, 0), (md.mdta_gram, 0)))
    on = main_path(seed, TASK, tb.tblock_fused, 0, None, MODULE_ROUTE,
                   counted + ((gd.gdfn_pipeline, MODULE_BLOCKS),
                              (md.mdta_gram, MODULE_BLOCKS)))
    off = main_path(seed, TASK, tb.tblock_fused, 0, None, {"fused": False},
                    ((gd.gdfn_fused, 0), (md.mdta_stats, 0),
                     (gd.gdfn_pipeline, 0), (md.mdta_gram, 0)))
    log(f"{TASK} module path forward 512 px bf16: with both kernels "
        f"{on[1]:.2f} ms ({1e3 / on[1]:.3f} images/s), without "
        f"{off[1]:.2f} ms ({1e3 / off[1]:.3f} images/s)")
    return on, off


def _module_gdfn(model, plain: bool):
    """Phase 22's comparison turns: every GDFN of `model` op by op
    (plain) or through its kernel."""
    for m in model.modules():
        if isinstance(m, layers.GDFN):
            m.fused = not plain


def module_train_path(seed: int):
    """Phase 22: the training CLI's step function with
    restormer_motion_deblur.yml's options, fused_kernels off and
    --gdfn_kernel (resolve_network's gdfn_kernel), at 384 px, batch
    MODULE_TRAIN_BATCH, bf16: 52 B6 launches per step, all through
    `gdfn_pipeline`, and none of the whole-block kernel, timed against the same step with every GDFN op by
    op in alternating turns; then one f32 step at 128 px on the card
    against the CPU.  Returns `train_main_path`'s results."""
    res = train_main_path(
        seed, MODULE_TRAIN_OPT,
        (gd.gdfn_fused, tb.tblock_fused, gd.gdfn_pipeline),
        (MODULE_BLOCKS, 0, MODULE_BLOCKS), _module_gdfn, MODULE_TRAIN_BATCH,
        {"gdfn_kernel": True})
    module_step_memory(seed)
    train_step_vs_cpu(seed, MODULE_TRAIN_OPT, {"gdfn_kernel": True},
                      ((gd.gdfn_fused, MODULE_BLOCKS),
                       (gd.gdfn_pipeline, 0)))
    return res


def module_step_memory(seed: int, batches=(1, MODULE_TRAIN_BATCH)):
    """Phase 22: the peak memory of one module-path step at 384 px, bf16,
    with and without B6, at two batch sizes, and the peak that the
    protocol's batch of 8 would need on the line through them."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, _, _ = resolve_network(MODULE_TRAIN_OPT, mixed_precision="bf16",
                                      gdfn_kernel=True)
    model = model.cuda()
    state, step_fn, _ = _trainer(model, MODULE_TRAIN_OPT["train"])
    rng = np.random.default_rng(seed + 9)
    trip = [synthetic_triple(rng, 384) for _ in range(max(batches))]
    peaks = {}
    for plain in (False, True):
        _module_gdfn(model, plain)
        for n in batches:
            batch = {k: torch.from_numpy(np.stack([t[i] for t in trip[:n]]))
                     .cuda() for i, k in enumerate(("lq", "gt", "ref"))}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, m = step_fn(state, batch)
            float(m["l_pix"])
            peaks[plain, n] = torch.cuda.max_memory_allocated() / 2 ** 30
            del batch
    _module_gdfn(model, False)
    (b0, b1), out = batches, []
    for plain in (False, True):
        slope = (peaks[plain, b1] - peaks[plain, b0]) / (b1 - b0)
        out.append(f"{'without' if plain else 'with'} gdfn_fused "
                   f"{peaks[plain, b0]:.2f} / {peaks[plain, b1]:.2f} GiB "
                   f"at batch {b0} / {b1}, {slope:.2f} GiB per image, batch "
                   f"8 about {peaks[plain, b1] + (8 - b1) * slope:.1f} GiB")
    log("module-path step peak memory, 384 px bf16: " + "; ".join(out))
    del state, model, step_fn
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 23-24: the probes of the block's linear + depthwise stage (B9)
# ---------------------------------------------------------------------------

# (px, C, co): the qkv-form tool's cases
QKV_CASES = [(512, c, co) for c, co in qkv_tool.CASES]
# (B, H, W, C, co): beside them, shapes no 8 x 16 tile divides, batch 2,
# and widths off the tool's (checked, not timed): 24 -> 40 on the TMA
# route; in bf16 12 -> 20 (neither a multiple of 8) on probe_qkv_form.cu
# in both forms, and 264 -> 8 on it in the current form (C past
# TMA_CURRENT_MAX_C), the composed form on the TMA route
QKV_RAGGED = [(2, 37, 53, 96, 256), (1, 19, 7, 24, 40), (2, 45, 70, 48, 128),
              (1, 19, 7, 12, 20), (1, 9, 13, 264, 8)]
# qkv form kernel vs its own plain version, (a, r, l2) as GDFN_TOL's.
# float32 (csrc/probe_qkv_form.cu): sums in another order only (read at
# most 0.0037 / 0.0063 on an H100).  bfloat16 (csrc/probe_qkv_tma.cu, and
# probe_qkv_form.cu at the widths the TMA route does not take, QKV_RAGGED's
# last two, on which the bound was first read at the tool's cases): the
# kernel's f32 sums (tensor cores) and the
# plain product's (cuBLAS) run in other orders, so a value at a
# rounding boundary rounds the other way: the output by one bf16 ulp (at
# most 2^-7 of max|p|), and in the current form also lin, which moves the
# output by a tap times an ulp of lin.  The first version read at most
# 0.27 of a and r (one-ulp flips) and 6.8e-5 in L2, so l2 is 5e-4.  The
# two forms round at other points (lin against W9) and differ from each
# other by more than from their own plain versions, so each is held
# against its own.
QKV_TOL = {form: {torch.float32: (2e-5, 1e-4, 1e-5),
                  torch.bfloat16: (1e-2, 1e-2, 5e-4)}
           for form in ("current", "composed")}
# the stencil probe at the tool's shape: t = 8 rows of W = 512, ch = 128
STENCIL_SHAPE = (8, 512, 128)
# phase 24's ragged shape: pixels past W = 509 in the last lane
STENCIL_RAGGED = (8, 509, 16)
STENCIL_ITERS = (1, 2, 3, 4)
# stencil kernel vs `stencil_ref` on a bf16 slab after 1-4 iterations,
# (a, r, l2) as above, for every variant.  concat and mulonly sum f32
# products in the same (dy, dx) order as the plain version, but the card
# contracts each product and sum into one FMA, so a sum at a rounding
# boundary rounds the other way (one ulp, at most 2^-7 of max|p|) and feeds
# the next iteration: the first version's largest elementwise error was
# 0.18 of this a and r, 8.8e-5 in L2, so l2 is 1e-3.  The bf16 variants
# round every product and sum once, as the plain version does (bitwise
# equal in the first version's run), under the same bound.
STENCIL_TOL = (1e-2, 1e-2, 1e-3)


def _probe_time(fn) -> float:
    """ms per call on the card, the probe tools' timer: the median of 5
    runs (as `median_ms` takes of 5 calls), each 10 calls back to back
    behind a spin, since a probe call's host work outlasts its kernel."""
    return time_ms(fn, torch.device("cuda"), 10, 5)


def _ragged_qkv_inputs(b, h, w, c, co, gen):
    """x (B, H, W, C) f32, w (C, co), dw (9, co) on the card at the tool's
    scales."""
    return (torch.randn(b, h, w, c, generator=gen).cuda(),
            (torch.randn(c, co, generator=gen) / c ** 0.5).cuda(),
            (torch.randn(9, co, generator=gen) / 3.0).cuda())


def qkv_form_vs_plain(gen, cases=QKV_CASES, ragged=QKV_RAGGED,
                      dtypes=(torch.float32, torch.bfloat16), timed=True):
    """Phase 23: the qkv-form kernels `qkv_current` and `qkv_composed`
    against their plain versions at the tool's four cases and QKV_RAGGED,
    float32 and bfloat16, under QKV_TOL; two calls bitwise equal, one
    launch per call, those the route rule `takes_tma` gives
    csrc/probe_qkv_tma.cu counted in `tma_launches` and the rest
    (csrc/probe_qkv_form.cu) not; at the tool's cases in bf16 the time of
    each kernel, its
    plain version and the cuDNN conv computing the same function, beside
    the design model (`bench_qkv_form.reckon`).  Returns {form: [(max_abs,
    kernel ms, plain ms, cudnn ms, (px, C, co)) per tool case]} of the bf16
    rows."""
    log("qkv probe kernels vs plain: |k-p| <= a max|p| + r|p|, ||k-p|| <= "
        f"l2 ||p||; (a, r, l2) f32 {QKV_TOL['current'][torch.float32]}, "
        f"bf16 {QKV_TOL['current'][torch.bfloat16]}")
    rows = {"current": [], "composed": []}
    failures = []
    shapes = [((1, px, px, c, co), True) for px, c, co in cases] \
        + [(shape, False) for shape in ragged]
    for (b, h, wd, c, co), tool_case in shapes:
        x32, w, dw = (qkv_tool.case_inputs(h, c, co, gen, "cuda",
                                           torch.float32) if tool_case
                      else _ragged_qkv_inputs(b, h, wd, c, co, gen))
        w9 = pr.compose_w9(w, dw)
        for dtype in dtypes:
            x = x32.to(dtype)
            kw = pr.prepare_qkv_weights(w, dw, dtype)
            timed_here = timed and tool_case and dtype == torch.bfloat16
            lib_ms = float("nan")
            if timed_here:
                wconv = qkv_tool.conv_weight(w9, c, dtype)
                with torch.inference_mode():
                    lib_ms = _probe_time(lambda: qkv_tool.cudnn_stage(
                        x, wconv))
            plain = {"current": lambda: pr.qkv_current_ref(x, w, dw),
                     "composed": lambda: pr.qkv_composed_ref(x, w9)}
            for form, kernel in (("current", pr.qkv_current),
                                 ("composed", pr.qkv_composed)):
                tma = pr.takes_tma(x, kw, form)
                with torch.inference_mode():
                    before = (kernel.launches, kernel.tma_launches)
                    got = kernel(x, kw)
                    same = torch.equal(got, kernel(x, kw))
                    launched = (kernel.launches - before[0],
                                kernel.tma_launches - before[1])
                    want = plain[form]()
                    max_abs, use, l2_use = _err_use(got, want,
                                                    *QKV_TOL[form][dtype])
                    finite = bool(torch.isfinite(got).all())
                    k_ms = p_ms = model = float("nan")
                    if timed_here:
                        k_ms = _probe_time(lambda: kernel(x, kw))
                        p_ms = _probe_time(plain[form])
                        model = qkv_tool.reckon(c, co, h)[form]["ms"]
                name = str(dtype).split(".")[-1]
                route = "probe_qkv_tma.cu" if tma else (
                    "probe_qkv_form.cu tile " + str(pr.pick_tile(
                        _build.load_library(), form, c, co,
                        x.element_size())))
                log(f"{b},{h},{wd} {c}->{co} {form:8s} {name}: max_abs "
                    f"{max_abs:.3e} (max|p| {want.abs().max().item():.3f}) "
                    f"tol_use {use:.4f} l2_use {l2_use:.4f} kernel "
                    f"{k_ms:.4f} ms (model {model:.4f}) plain {p_ms:.4f} ms "
                    f"cudnn {lib_ms:.4f} ms; {route}"
                    f"{'' if same else '  NOT REPEATABLE'}")
                if not finite or not same or launched != (2, 2 * tma) \
                        or max(use, l2_use) > 1.0:
                    failures.append((b, h, wd, c, co, form, name, launched,
                                     round(max(use, l2_use), 3)))
                if tool_case and dtype == torch.bfloat16:
                    rows[form].append((max_abs, k_ms, p_ms, lib_ms,
                                       (h, c, co)))
                del got, want
    if failures:
        raise RuntimeError(f"qkv probe kernels disagree with their plain "
                           f"versions or their route at (B, H, W, C, co, "
                           f"form, dtype, launches of the form and of its "
                           f"TMA kernel, the error over its bound) "
                           f"{failures}")
    return rows


def stencil_vs_plain(gen, shape=STENCIL_SHAPE, iters_list=STENCIL_ITERS,
                     timed=True, ragged=STENCIL_RAGGED):
    """Phase 24: `stencil_loop` against `stencil_ref` for every variant on
    a bf16 slab at the tool's shape and the ragged one after 1-4
    iterations (the values grow about 3x a step and overflow long before
    the tool's 3000), under STENCIL_TOL; two calls bitwise equal, one
    launch per call.  The time per stencil step at the tool's shape of the
    kernel (at the tool's 3000 iterations in one launch), the plain
    version (4 iterations) and one cuDNN depthwise conv step.  Returns
    {variant: (max_abs, kernel ms, plain ms, cudnn ms)} per step at the
    tool's shape."""
    t, w, ch = shape
    log(f"stencil probe kernel vs stencil_ref at t={t} W={w} ch={ch} and "
        f"{ragged} bfloat16, iters {list(iters_list)}: (a, r, l2) "
        f"{STENCIL_TOL}")
    x = torch.randn(t + 2, w, ch, generator=gen).to("cuda", torch.bfloat16)
    taps = torch.randn(9, ch, generator=gen).cuda()
    xr = torch.randn(ragged[0] + 2, *ragged[1:], generator=gen).to(
        "cuda", torch.bfloat16)
    tr = torch.randn(9, ragged[2], generator=gen).cuda()
    rows, failures = {}, []
    for variant in pr.VARIANTS:
        max_abs = 0.0
        with torch.inference_mode():
            for iters, (xs, ts) in ((i, s) for s in ((x, taps), (xr, tr))
                                    for i in iters_list):
                before = pr.stencil_loop.launches
                got = pr.stencil_loop(xs, ts, variant, iters)
                same = torch.equal(got, pr.stencil_loop(xs, ts, variant,
                                                        iters))
                launched = pr.stencil_loop.launches - before
                want = pr.stencil_ref(xs, ts, variant, iters)
                err, use, l2_use = _err_use(got, want, *STENCIL_TOL)
                if xs is x:
                    max_abs = max(max_abs, err)
                log(f"{variant:12s} W={xs.shape[1]} iters {iters}: max_abs "
                    f"{err:.3e} (max|p| {want.abs().max().item():.1f}) "
                    f"tol_use {use:.4f} l2_use {l2_use:.4f}"
                    f"{'' if same else '  NOT REPEATABLE'}")
                if not bool(torch.isfinite(got).all()) or not same \
                        or launched != 2 or max(use, l2_use) > 1.0:
                    failures.append((variant, xs.shape[1], iters,
                                     round(max(use, l2_use), 3)))
            if timed:
                n = stencil_tool.parse_args([]).iters
                k_ms = _probe_time(lambda: pr.stencil_loop(
                    x, taps, variant, n)) / n
                p_ms = _probe_time(lambda: pr.stencil_ref(
                    x, taps, variant, 4)) / 4
                wconv = taps.reshape(3, 3, ch).permute(2, 0, 1)[:, None]
                lib_ms = _probe_time(lambda: stencil_tool.depthwise_step(
                    x, wconv.to(x.dtype)))
                log(f"{variant:12s} per step: kernel {k_ms * 1e3:.3f} us "
                    f"plain {p_ms * 1e3:.3f} us cudnn {lib_ms * 1e3:.3f} us")
                rows[variant] = (max_abs, k_ms, p_ms, lib_ms)
    if failures:
        raise RuntimeError(f"stencil_loop disagrees with stencil_ref at "
                           f"(variant, W, iters, the error over its bound) "
                           f"{failures}")
    return rows


def probe_tool_runs():
    """The probe path: both port tools as `python -m` runs them, with the
    kernels' counts set to 0 just before and read just after.  Returns
    (qkv rows, stencil result, {kernel: launches})."""
    kernels = (pr.qkv_current, pr.qkv_composed, pr.stencil_loop)
    for k in kernels:
        k.launches = 0
    pr.qkv_current.tma_launches = pr.qkv_composed.tma_launches = 0
    qkv_rows = qkv_tool.main([])
    stencil_res = stencil_tool.main([])
    counts = {k.__name__: k.launches for k in kernels}
    counts |= {k.__name__ + "_tma": k.tma_launches
               for k in (pr.qkv_current, pr.qkv_composed)}
    log(f"launches: probe tools (one run each) {counts}")
    if not all(counts.values()):
        raise RuntimeError(f"a probe kernel was not launched by its tool: "
                           f"{counts}")
    return qkv_rows, stencil_res, counts


# ---------------------------------------------------------------------------
# Phases 25-27: every Restormer / PromptIR YAML trains
# ---------------------------------------------------------------------------

# options/train_restoration/promptir_all_in_one.yml as a dict (no YAML on
# the card's machine; tests/test_torch_cli_train.py holds it against the
# file), param_fix_iterations cut to 2 as TRAIN_OPT's
PROMPTIR_TRAIN_OPT = {
    "network_g": {
        "type": "PromptIRRefFusion", "inp_channels": 3, "out_channels": 3,
        "dim": 48, "num_blocks": [4, 6, 6, 8], "num_refinement_blocks": 4,
        "heads": [1, 2, 4, 8], "ffn_expansion_factor": 2.66, "bias": False,
        "LayerNorm_type": "WithBias", "decoder": True, "nf": 48,
        "ext_n_blocks": [4, 4, 4, 4], "reffusion_n_blocks": [2, 2, 2, 2],
        "reffusion_n_blocks_middle": 1, "num_nbr": 1, "psize": 3,
        "lr_block_size": 8, "ref_down_block_size": 1.5,
        "dilations": [1, 2, 3]},
    "train": TRAIN_OPT["train"],
}
PROMPTIR_TRAIN_BATCH = 8  # bf16; float32 takes batch 2
PROMPTIR_F32_BATCH = 2
BLOCK_KERNELS = (tb.tblock_fused, gb.gdfn_half_bwd, ab.attn_half_bwd,
                 tb.tblock_pipeline)


def f32_train_steps(seed: int, opt, per_step, batch_size: int):
    """Phase 25: float32 steps of `opt` at 384 px on the card (the CLI's
    step function, the masa group released): a warm-up, then two timed
    steps, each launching BLOCK_KERNELS per_step times.  Returns (median
    ms, peak GiB)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, _, _ = resolve_network(opt)
    model = gate_and_temperatures(model, seed).cuda()
    rng = np.random.default_rng(seed + 6)
    trip = [synthetic_triple(rng, 384) for _ in range(batch_size)]
    batch = {k: torch.from_numpy(np.stack([t[i] for t in trip])).cuda()
             for i, k in enumerate(("lq", "gt", "ref"))}
    state, step_fn, _ = _trainer(model, dict(opt["train"],
                                             param_fix_iterations=0))
    state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2):
        for k in BLOCK_KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = float(m["l_pix"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = tuple(k.launches for k in BLOCK_KERNELS)
        if counts != tuple(per_step) or not np.isfinite(loss):
            raise RuntimeError(f"f32 step {i + 1}: launches {counts}, loss "
                               f"{loss}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    name = opt["network_g"]["type"]
    log(f"{name} f32 train step 384 px batch {batch_size}: "
        f"{[round(v, 2) for v in times]} ms, l_pix {loss:.5f}, launches "
        f"{'/'.join(k.__name__ for k in BLOCK_KERNELS)} {counts}, peak "
        f"{peak:.2f} GiB")
    del state, model, batch
    torch.cuda.empty_cache()
    return statistics.median(times), peak


def promptir_train_path(seed: int):
    """Phase 25: the network of promptir_all_in_one.yml at full width
    through the CLI's step function at 384 px: bf16 at batch 8 as phase 7
    runs it (55 blocks a step, all through the pipeline; three timed
    steps, no plain turns, which phase 7 times for Restormer), float32 at
    batch 2 (the f32 kernels: csrc/tblock.cu, csrc/tblock_bwd.cu,
    csrc/tblock_attn_bwd.cu at 176 channels a head), and one float32 step
    at 128 px on the card against the CPU.  Returns (bf16 launches, bf16
    ms, bf16 peak, f32 ms, f32 peak)."""
    n = PROMPTIR_BLOCKS
    launches, ms, _, peak, _ = train_main_path(
        seed, PROMPTIR_TRAIN_OPT, BLOCK_KERNELS, (n, n, n, n),
        batch_size=PROMPTIR_TRAIN_BATCH, compare_plain=False)
    f32_ms, f32_peak = f32_train_steps(seed, PROMPTIR_TRAIN_OPT,
                                       (n, n, n, 0), PROMPTIR_F32_BATCH)
    train_step_vs_cpu(seed, PROMPTIR_TRAIN_OPT,
                      kernels=tuple((k, n) for k in BLOCK_KERNELS[:3]))
    return launches, ms, peak, f32_ms, f32_peak


# the networks of phase 26's YAMLs over TRAIN_OPT's (tests/
# test_torch_cli_train.py holds them against the files)
CLI_YAML_NETS = {
    "restormer_gaussian_gray_denoise_blind": {
        "inp_channels": 1, "out_channels": 1, "LayerNorm_type": "BiasFree"},
    "restormer_defocus_dual_pixel_16bit": {
        "inp_channels": 6, "dual_pixel_task": True},
}


def _yaml_opt(name, train_ds, val_ds, **train):
    """A shipped restoration YAML's options as a dict (the card's machine
    may lack PyYAML): TRAIN_OPT's network with CLI_YAML_NETS[name] over
    it, the datasets, the logger's lq|gt|pred|ref strip at iteration 2."""
    return {
        "name": name, "scale": 1, "manual_seed": 100,
        "datasets": {"train": {
            "name": "Trainset", "geometric_augs": True,
            "io_backend": {"type": "disk"}, "num_worker_per_gpu": 0,
            "iters": [1000000], "gt_size": 384, "gt_sizes": [384],
            **train_ds}, "val": {"name": "Valset", **val_ds}},
        "network_g": dict(TRAIN_OPT["network_g"], **CLI_YAML_NETS[name]),
        "path": {"pretrain_dino": None, "pretrain_network_g": None},
        "train": dict(TRAIN_OPT["train"], **train),
        "val": {"val_freq": 5000}, "logger": {
            "print_freq": 1, "save_checkpoint_freq": 5000, "check_freq": 2}}


def cli_yaml_runs(seed: int, iters: int = 2):
    """Phase 26: restormer_gaussian_gray_denoise_blind.yml (1-channel
    denoise, its Dataset_GaussianDenoisingWithRef at sigma 0-50, bf16,
    batch 8) and restormer_defocus_dual_pixel_16bit.yml (6-channel dual
    pixel from 16-bit PNGs, its own float32, batch 2) through
    cli/train_restoration.py's `main` on the card, full width, 384 px
    crops, `iters` iterations over synthesised folders (numpy-written PNGs
    in a temporary directory): every block through the kernels (52 of each
    a step), the strip of logger.check_freq written.  Returns {name:
    (launches, s of the last iteration)}."""
    from textualdegremoval_tpu_torch.cli import train_restoration as cli
    from textualdegremoval_tpu_torch.data.png import write_png

    root = Path(tempfile.mkdtemp(prefix="cli_yamls_"))
    rng = np.random.default_rng(seed + 7)
    for sub, n, top in (("hq", 8, 255), ("ref", 8, 255), ("dp_gt", 4, 65535),
                        ("dp_lqL", 4, 65535), ("dp_lqR", 4, 65535),
                        ("dp_ref", 4, 255), ("val_lq", 1, 255),
                        ("val_hq", 1, 255), ("val_ref", 1, 255)):
        (root / sub).mkdir()
        for i in range(n):
            img = rng.random((400, 440, 3)) * top
            write_png(str(root / sub / f"{i:03d}.png"),
                      img.astype(np.uint16 if top > 255 else np.uint8))
    val = {"type": "Dataset_PairedImageWithRef",
           **{f"{k}root": str(root / f"val_{k}") for k in ("lq", "hq",
                                                           "ref")}}
    runs = {
        "restormer_gaussian_gray_denoise_blind": (_yaml_opt(
            "restormer_gaussian_gray_denoise_blind",
            {"type": "Dataset_GaussianDenoisingWithRef",
             "hqroot": str(root / "hq"), "refroot": str(root / "ref"),
             "batch_size_per_gpu": 8, "mini_batch_sizes": [8],
             "sigma_type": "random", "sigma_range": [0, 50], "in_ch": 1},
            {"type": "Dataset_GaussianDenoisingWithRef",
             "hqroot": str(root / "val_hq"), "refroot": str(root / "val_ref"),
             "sigma_test": 25, "in_ch": 1}), ["--mixed_precision", "bf16"]),
        "restormer_defocus_dual_pixel_16bit": (_yaml_opt(
            "restormer_defocus_dual_pixel_16bit",
            {"type": "Dataset_PairedImageWithRef_DualPixel_16bit",
             "hqroot": str(root / "dp_gt"), "lqlroot": str(root / "dp_lqL"),
             "lqrroot": str(root / "dp_lqR"), "refroot": str(root / "dp_ref"),
             "batch_size_per_gpu": 2, "mini_batch_sizes": [2]}, val), []),
    }
    out, cwd = {}, Path.cwd()
    try:
        for name, (opt, flags) in runs.items():
            cfg = root / f"{name}.json"
            cfg.write_text(json.dumps(opt))
            os.chdir(root)
            for k in BLOCK_KERNELS:
                k.launches = 0
            t0 = time.perf_counter()
            state = cli.main(["--opt", str(cfg), "--max_iters", str(iters),
                              "--device", "cuda", *flags])
            secs = time.perf_counter() - t0
            counts = tuple(k.launches for k in BLOCK_KERNELS)
            exp = root / "experiments" / name
            times = [float(line.split(" time ")[1].split("s")[0])
                     for line in (exp / "train.log").read_text().splitlines()
                     if " l_pix " in line]
            # each step 52 of each; the strip's forward 52 more of the
            # forward's
            bf16 = "--mixed_precision" in flags
            fwd = (tb.tblock_fused, tb.tblock_pipeline)
            want = tuple(52 * (iters + (iters // 2 if k in fwd else 0))
                         * (k is not tb.tblock_pipeline or bf16)
                         for k in BLOCK_KERNELS)
            strip = exp / "visualization" / "000002.png"
            log(f"phase 26 {name}: {iters} iterations through the CLI in "
                f"{secs:.1f} s, s per iteration {times}, launches "
                f"{'/'.join(k.__name__ for k in BLOCK_KERNELS)} {counts}, "
                f"strip {'written' if strip.exists() else 'MISSING'}")
            if state.step != iters or counts != want or len(times) != iters \
                    or not strip.exists():
                raise RuntimeError(f"{name} through the CLI: step "
                                   f"{state.step}, launches {counts} (want "
                                   f"{want}), {len(times)} logged steps")
            out[name] = (counts, times[-1])
            del state
            torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    return out


# matcher card vs CPU (float32, TF32 off): the tokens are LayerNorm
# outputs of O(1); the card's sums in other orders move them by about
# 1e-5, and the cosine of two 602,112-value token vectors by about 1e-6
DINO_TOKEN_ATOL = 1e-3
DINO_SCORE_ATOL = 1e-4
DINO_BATCH, DINO_CPU_BATCH = 8, 2


def dino_matcher(seed: int):
    """Phase 27: the DINO matcher of training at vit_base full width
    (img_size 518, embed 768, 12 blocks) from a seeded random state dict in
    the reference layout (saved, then loaded by `load_dino` with
    strict=True), float32: 8 lq crops of 384 px against 480 x 480 refs (4
    windows each, 40 ViT forwards of 785 tokens a step).  Card against CPU
    on the first 2 images: lq's tokens within DINO_TOKEN_ATOL, every score
    within DINO_SCORE_ATOL, and the same top-1 wherever the CPU's top-2
    margin exceeds it.  Returns (ms per step, peak GiB, windows per
    image)."""
    from textualdegremoval_tpu_torch.models import dino as dn

    vit = dn.vit_base()
    gen = torch.Generator().manual_seed(seed + 9)
    with torch.no_grad():
        for name, prm in vit.named_parameters():
            if name.endswith("bias") or name == "mask_token":
                prm.zero_()
            elif "norm" in name or name.endswith("gamma"):
                prm.fill_(1.0)
            else:
                prm.copy_(torch.randn(prm.shape, generator=gen) * 0.02)
    tmp = Path(tempfile.mkdtemp(prefix="dino_"))
    try:
        torch.save(vit.state_dict(), tmp / "dinov2_vitb14.pth")
        gpu = dn.load_dino(str(tmp / "dinov2_vitb14.pth"), device="cuda")
        cpu = dn.load_dino(str(tmp / "dinov2_vitb14.pth"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if (gpu.embed_dim, len(gpu.blocks), gpu.img_size) != (768, 12, 518):
        raise RuntimeError("load_dino did not build vit_base")
    rng = np.random.default_rng(seed + 10)
    refs, lqs = [], []
    for i in range(DINO_BATCH):
        _, hq, _ = synthetic_triple(rng, 480)
        y, x = 96 * (i % 2), 96 * ((i // 2) % 2)
        lqs.append(np.clip(hq[y:y + 384, x:x + 384] + rng.standard_normal(
            (384, 384, 3)).astype(np.float32) * 15 / 255, 0, 1))
        refs.append(hq)
    lq = torch.from_numpy(np.stack(lqs).astype(np.float32))
    ref = torch.from_numpy(np.stack(refs))
    win_g, sc_g, tok_g = dn.ref_scores(gpu, lq.cuda(), ref.cuda())
    _, sc_c, tok_c = dn.ref_scores(cpu, lq[:DINO_CPU_BATCH],
                                   ref[:DINO_CPU_BATCH])
    k = DINO_CPU_BATCH
    tok_err = (tok_g[:k].cpu() - tok_c).abs().max().item()
    sc_err = (sc_g[:k].cpu() - sc_c).abs().max().item()
    top2 = sc_c.topk(2, -1)
    margin = top2.values[:, 0] - top2.values[:, 1]
    clear = margin > DINO_SCORE_ATOL
    same = bool((sc_g[:k].argmax(-1).cpu() == top2.indices[:, 0])[clear]
                .all())
    crop = dn.select_ref_crop(gpu, lq.cuda(), ref.cuda())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(lambda: dn.select_ref_crop(gpu, lq.cuda(), ref.cuda()),
                   reps=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    picked = sc_g.argmax(-1).tolist()
    log(f"phase 27 DINO matcher (vit_base f32, {DINO_BATCH} crops of 384 "
        f"px, {win_g.shape[1]} windows each): {ms:.2f} ms a step, peak "
        f"{peak:.2f} GiB; card vs CPU on {k} images: tokens max abs "
        f"{tok_err:.2e} (bound {DINO_TOKEN_ATOL}), scores {sc_err:.2e} "
        f"(bound {DINO_SCORE_ATOL}), top-2 margins "
        f"{[round(v, 6) for v in margin.tolist()]}, same top-1 where clear: "
        f"{same}; picked windows {picked} (lq cut from "
        f"{[(i % 2) * 2 + (i // 2) % 2 for i in range(DINO_BATCH)]})")
    if not (tok_err <= DINO_TOKEN_ATOL and sc_err <= DINO_SCORE_ATOL
            and same and crop.shape == (DINO_BATCH, 384, 384, 3)
            and crop.is_cuda and torch.isfinite(sc_g).all()):
        raise RuntimeError("the DINO matcher on the card disagrees with the "
                           "CPU")
    return ms, peak, win_g.shape[1]


# ---------------------------------------------------------------------------
# Phases 28-32: DRSformer and SFNet, whose path reaches no kernel
# ---------------------------------------------------------------------------

# every launch counter of the port's kernels, as (function, attribute)
KERNEL_COUNTERS = [
    (tb.tblock_fused, "launches"), (tb.tblock_pipeline, "launches"),
    (tb.tblock_chain_fused, "calls"), (tb.tblock_chain_fused, "launches"),
    (tb.chain_pipeline, "launches"), (gb.gdfn_half_bwd, "launches"),
    (ab.attn_half_bwd, "launches"), (nb.nafblock_fused, "launches"),
    (nb.naf_pipeline, "launches"), (gd.gdfn_fused, "launches"),
    (gd.gdfn_pipeline, "launches"), (md.mdta_stats, "launches"),
    (md.mdta_gram, "launches"), (fa.flash_attention, "launches"),
    (fa.flash_attention, "launches_bwd"), (pr.qkv_current, "launches"),
    (pr.qkv_current, "tma_launches"), (pr.qkv_composed, "launches"),
    (pr.qkv_composed, "tma_launches"), (pr.stencil_loop, "launches")]


def _reset_all_counts():
    for fn, attr in KERNEL_COUNTERS:
        setattr(fn, attr, 0)


def _all_counts() -> dict:
    return {f"{fn.__name__}.{attr}": getattr(fn, attr)
            for fn, attr in KERNEL_COUNTERS}


def no_kernel_launched(what: str, seen: dict):
    """Raise if any kernel counter moved since the last reset; add the
    counts into `seen` (the summary's drsformer_sfnet_launches)."""
    counts = _all_counts()
    for k, v in counts.items():
        seen[k] = seen.get(k, 0) + v
    moved = {k: v for k, v in counts.items() if v}
    if moved:
        raise RuntimeError(f"{what}: kernels launched on a path that has "
                           f"none: {moved}")


DRS_TASK = "drsformer_derain"
DRS_SPA_TASK = "drsformer_derain_200l_spa"
SFNET_TASKS = ("sfnet_dehaze_indoor", "sfnet_dehaze_outdoor")
# the networks and train sections of
# options/train_restoration/drsformer_derain_rain200h.yml and
# sfnet_dehaze_indoor.yml (tests/test_torch_cli_train.py holds them
# against the files), param_fix_iterations aside
DRS_TRAIN_OPT = {
    "network_g": {
        "type": "DRSformerRefFusion", "inp_channels": 3, "out_channels": 3,
        "dim": 48, "num_blocks": [4, 6, 6, 8], "heads": [1, 2, 4, 8],
        "ffn_expansion_factor": 2.66, "bias": False,
        "LayerNorm_type": "WithBias", "use_mefc": True, "nf": 48,
        "ext_n_blocks": [4, 4, 4, 4], "reffusion_n_blocks": [2, 2, 2, 2],
        "reffusion_n_blocks_middle": 1, "num_nbr": 1, "psize": 3,
        "lr_block_size": 8, "ref_down_block_size": 1.5,
        "dilations": [1, 2, 3]},
    "train": TRAIN_OPT["train"],
}
SFNET_TRAIN_OPT = {
    "network_g": {
        "type": "SFNetRefFusion", "num_res": 16, "base_channel": 32,
        "nf": 32, "ext_n_blocks": [4, 4, 4], "reffusion_n_blocks": [1, 1, 1],
        "reffusion_n_blocks_middle": 1, "num_nbr": 1, "psize": 3,
        "lr_block_size": 8, "ref_down_block_size": 1.5,
        "dilations": [1, 2, 3]},
    "train": TRAIN_OPT["train"],
}
FAMILY_BATCHES = (8, 4, 2, 1)  # the largest that fits the card is taken
# phase 29 and 31 try no batch whose peak, predicted from batch 1's,
# passes this many times the card's memory (read on an H100: DRSformer
# f32 batch 1 61.77 GiB and bf16 batch 2 66.09, SFNet batch 8 66.99 f32
# and 34.63 bf16; activations grow about linearly with the batch)
FAMILY_PREDICT_MARGIN = 1.25
# SFNet's BN statistics on the CPU side of phase 32 need batch 2: at
# batch 1 the pooled input has no variance and BN returns its bias
SFNET_CPU_BATCH = 2
# phase 32's gradient floors, as fractions of the global gradient norm:
# in SFNet the SCM's last bias (before its InstanceNorm) and, at the
# default zero init of Gap's fscale and PatchAP's h and l, the biases
# that feed only them have gradients that vanish in exact arithmetic, so
# card and CPU differ there by rounding alone (0.92 of a 1e-6 floor used
# on an H100); DRSformer's blend weights attn1..4 are scalars whose
# gradients cancel, where card and CPU differ by 2e-2 of their norm
SFNET_GRAD_FLOOR = 1e-5
DRS_GRAD_FLOOR = 1e-5
FAMILY_UPDATE_TOL = 0.5


def bn_statistics(model, seed: int):
    """Running means N(0, 0.1^2) and variances in [0.5, 1.5], drawn from
    a seed, on every BatchNorm of `model` (SFNet's dynamic filters), so
    that the evaluation's normalisation is not the identity."""
    gen = torch.Generator().manual_seed(seed + 8)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=gen))
    return model


def _family_network(seed, task, dtype, device):
    return bn_statistics(build_network(seed, dtype, "cpu", task), seed).to(
        device)


def _outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def family_vs_cpu(seed: int, task: str, seen: dict, size: int = 128):
    """Phases 28 and 30: the task's network at full width (seeded random
    weights, non-zero fusion gates, random BN statistics) on the card
    against the same network on the CPU, float32, on a size x size input:
    every output (SFNet's three scales) within NET_ATOL, no kernel
    launched."""
    model_cpu = _family_network(seed, task, torch.float32, "cpu")
    model_gpu = copy.deepcopy(model_cpu).to("cuda")
    rng = np.random.default_rng(seed + 2)
    lq = torch.from_numpy(rng.random((1, size, size, 3), dtype=np.float32))
    ref = torch.from_numpy(rng.random((1, size, size, 3), dtype=np.float32))
    with torch.inference_mode():
        want = _outputs(model_cpu(lq, ref))
        _reset_all_counts()
        got = [g.cpu() for g in _outputs(model_gpu(lq.cuda(), ref.cuda()))]
    no_kernel_launched(f"{task} card vs CPU", seen)
    errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
    log(f"{task} f32 {size}x{size}, card vs CPU: max_abs per output "
        f"{[f'{e:.3e}' for e in errs]} (atol {NET_ATOL}), max|out| "
        f"{max(w.abs().max().item() for w in want):.3f}, no kernel launched")
    if len(got) != len(want) or any(
            g.shape != w.shape or not torch.isfinite(g).all()
            for g, w in zip(got, want)) or max(errs) > NET_ATOL:
        raise RuntimeError(f"{task} on the card disagrees with the CPU: "
                           f"{errs}")


def family_eval_path(seed: int, task: str, dtype, seen: dict,
                     profile: bool = True):
    """Phases 28 and 30: the evaluation CLI's `restore_and_score` on
    synthetic 512 x 512 triples, one warm-up and two timed, with the
    network in `dtype` (f32 parameters); the finest output scored, finite
    and of the image's shape; the forward's median ms (of 3 calls after a
    warm-up; in float32 one), peak memory, the same of its MASA encoder
    alone and, with `profile`, a profiled
    forward (device time, idle share); no kernel launched.  Returns (forward ms, restore + score ms of the two
    timed images, peak GiB)."""
    model = _family_network(seed, task, dtype, "cuda")
    rng = np.random.default_rng(seed + 3)
    triples = [synthetic_triple(rng) for _ in range(2)]
    name = str(dtype).split(".")[-1]
    # float32 DRSformer takes 3.3 s a forward: a warm-up and one call
    reps = 1 if dtype == torch.float32 else 3
    _reset_all_counts()
    restore_and_score(model, *triples[0])
    times = []
    for i, (lq, hq, ref) in enumerate(triples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred, psnr, ssim = restore_and_score(model, lq, hq, ref)
        times.append((time.perf_counter() - t0) * 1e3)
        if pred.shape != hq.shape or not np.isfinite(pred).all() \
                or not np.isfinite(psnr) or not np.isfinite(ssim):
            raise RuntimeError(f"{task} {name} image {i}: bad output "
                               f"{pred.shape}")
        log(f"{task} {name} image {i}: {times[-1]:.1f} ms (restore + "
            f"score), psnr {psnr:.4f} ssim {ssim:.4f}")
    args = [torch.from_numpy(a)[None].to("cuda", dtype)
            for a in (triples[0][0], triples[0][2])]
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: model(*args), reps=reps)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        masa_ms = median_ms(lambda: layers.masa_encode_pair(
            model.masa_enc, *(a.to(model.dtype) for a in args)), reps=reps)
        log(f"{task} forward 512x512 {name}: {fwd_ms:.2f} ms "
            f"({1e3 / fwd_ms:.3f} images/s), peak memory {peak:.2f} GiB; "
            f"its MASA encoder on lq and ref {masa_ms:.2f} ms")
        if profile:
            profile_device(lambda: model(*args), f"{task} {name} forward")
    no_kernel_launched(f"{task} {name} evaluation", seen)
    del model
    torch.cuda.empty_cache()
    return fwd_ms, times, peak


def _bn_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def family_train_step(seed: int, opt, dtype, seen: dict,
                      batches=FAMILY_BATCHES, size: int = 384,
                      profile: bool = False):
    """Phases 29 and 31: the training CLI's step function with `opt` (its
    YAML's options, the masa group released) at size px in `dtype` (f32
    parameters), at the largest batch of `batches` whose step fits the
    card: batch 1's step first, whose peak predicts the others' (what the
    state holds after the step, plus b times the rest); a batch predicted
    past FAMILY_PREDICT_MARGIN times the card's memory is not tried (a
    step that runs out of memory took 10-15 s), a step that runs out of
    memory is dropped and the next batch tried: a warm-up and two timed
    steps, finite losses, the peak memory, the BN running statistics moved
    (where the network has them), no kernel launched; with `profile` a
    profiled step.  Returns (batch, median ms, peak GiB, the batches that
    did not fit or were predicted not to)."""
    name = f"{opt['network_g']['type']} {str(dtype).split('.')[-1]}"
    mp = "bf16" if dtype == torch.bfloat16 else None

    def warmed(b):
        """(state, step_fn, model, batch, BN statistics before, peak GiB,
        GiB held after the step) after one step at batch b, or None where
        the step runs out of memory."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model, _, _ = resolve_network(opt, mixed_precision=mp)
        model = bn_statistics(gate_and_temperatures(model, seed), seed)
        model = model.cuda()
        rng = np.random.default_rng(seed + 6)
        trip = [synthetic_triple(rng, size) for _ in range(b)]
        batch = {k: torch.from_numpy(np.stack([tr[i] for tr in trip]))
                 .cuda() for i, k in enumerate(("lq", "gt", "ref"))}
        state, step_fn, _ = _trainer(model, dict(opt["train"],
                                                 param_fix_iterations=0))
        before = _bn_state(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fits = True
        try:
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            fits = False
        if not fits:  # outside the handler: its traceback holds the step
            log(f"{name} step {size} px batch {b}: out of device memory")
            del state, step_fn, model, batch
            gc.collect()
            torch.cuda.empty_cache()
            return None
        return (state, step_fn, model, batch, before,
                torch.cuda.max_memory_allocated() / 2 ** 30,
                torch.cuda.memory_allocated() / 2 ** 30)

    run = warmed(1)
    if run is None:
        raise RuntimeError(f"{name} step at {size} px: batch 1 does not fit "
                           "the card")
    peak1, held1 = run[5:]
    card = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    did_not_fit = []
    for b in sorted(batches, reverse=True):
        if b == 1:
            break
        predicted = held1 + b * (peak1 - held1)
        if predicted > FAMILY_PREDICT_MARGIN * card:
            log(f"{name} step {size} px batch {b}: not tried, predicted "
                f"peak {predicted:.1f} GiB from batch 1's {peak1:.2f}")
            did_not_fit.append(b)
            continue
        if run is not None and run[3]["lq"].shape[0] == 1:
            del run  # batch 1's state off the card before a larger try
            gc.collect()
            torch.cuda.empty_cache()
        run = warmed(b)
        if run is not None:
            break
        did_not_fit.append(b)
    if run is None:  # every larger batch ran out: batch 1 again
        run = warmed(1)
    state, step_fn, model, batch, before = run[:5]
    b = batch["lq"].shape[0]
    del run
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    times, losses = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["l_pix"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if profile:
        profile_device(lambda: float(step_fn(state, batch)[1]["l_pix"]),
                       f"{name} step batch {b}")
    no_kernel_launched(f"{name} step", seen)
    after = _bn_state(model)
    unmoved = [k for k, v in before.items() if torch.equal(v, after[k])]
    log(f"{name} train step {size} px batch {b}: "
        f"{[round(v, 2) for v in times]} ms, l_pix "
        f"{[round(v, 5) for v in losses]}, peak {peak:.2f} GiB, BN "
        f"statistics moved {len(before) - len(unmoved)} of "
        f"{len(before)}; did not fit: {did_not_fit}")
    if not np.isfinite(losses).all() or unmoved:
        raise RuntimeError(f"{name} step: losses {losses}, BN "
                           f"statistics unmoved {unmoved[:3]}")
    del state, step_fn, model, batch
    torch.cuda.empty_cache()
    return b, statistics.median(times), peak, did_not_fit


def family_phases(seed: int) -> dict:
    """Phases 28-32: DRSformer and SFNet, no kernel on their path; each
    phase's seconds printed.  Returns the readings for the summary."""
    out, seen = {}, {}
    t0 = time.perf_counter()
    family_vs_cpu(seed, DRS_TASK, seen)
    # the float32 forward is not profiled: its 264192 FFT kernels (the
    # MASA encoder's level-3 convs, tools/bench_family_ops.py) take the
    # profiler over two minutes
    out["drs_eval"] = {str(d).split(".")[-1]: family_eval_path(
        seed, DRS_TASK, d, seen, profile=d == torch.bfloat16)
        for d in (torch.bfloat16, torch.float32)}
    out["drs_spa_ms"] = family_eval_path(seed, DRS_SPA_TASK, torch.bfloat16,
                                         seen, profile=False)[0]
    log(f"phase 28 (DRSformerRefFusion evaluation) took "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["drs_step"] = {
        "float32": family_train_step(seed, DRS_TRAIN_OPT, torch.float32,
                                     seen, profile=True),
        "bfloat16": family_train_step(seed, DRS_TRAIN_OPT, torch.bfloat16,
                                      seen)}
    log(f"phase 29 (DRSformer training step) took "
        f"{time.perf_counter() - t0:.1f} s")
    log_held("phases 28-29")
    t0 = time.perf_counter()
    family_vs_cpu(seed, SFNET_TASKS[0], seen)
    out["sfnet_eval"] = {str(d).split(".")[-1]: family_eval_path(
        seed, SFNET_TASKS[0], d, seen) for d in (torch.bfloat16,
                                                  torch.float32)}
    out["sfnet_outdoor_ms"] = family_eval_path(
        seed, SFNET_TASKS[1], torch.bfloat16, seen, profile=False)[0]
    log(f"phase 30 (SFNetRefFusion evaluation) took "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["sfnet_step"] = {
        "float32": family_train_step(seed, SFNET_TRAIN_OPT, torch.float32,
                                     seen, profile=True),
        "bfloat16": family_train_step(seed, SFNET_TRAIN_OPT, torch.bfloat16,
                                      seen)}
    log(f"phase 31 (SFNet training step) took "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _reset_all_counts()
    train_step_vs_cpu(seed, DRS_TRAIN_OPT, grad_floor=DRS_GRAD_FLOOR,
                      update_tol=FAMILY_UPDATE_TOL)
    moved = train_step_vs_cpu(seed, SFNET_TRAIN_OPT,
                              batch_size=SFNET_CPU_BATCH,
                              grad_floor=SFNET_GRAD_FLOOR,
                              update_tol=FAMILY_UPDATE_TOL)
    no_kernel_launched("the f32 steps, card vs CPU", seen)
    if not moved:
        raise RuntimeError("SFNet's step on the CPU moved no BN statistic")
    log(f"phase 32 (training steps, card vs CPU) took "
        f"{time.perf_counter() - t0:.1f} s")
    out["launches"] = seen
    return out


# ---------------------------------------------------------------------------
# Phases 33-35: the DiffIR path (no kernel) and the keyed archives
# ---------------------------------------------------------------------------

# NAFNetDynamicFusion's defaults (width 64, enc 1/1/1/28, middle 1, dec
# 1/1/1/1) with the 10 words its shipped Linear(10 * 1024, ...) takes; the
# towers are CLIPVisionEncoder's and I2TMapper's defaults (ViT-H/14 at 224
# px, width 1280, 32 layers) at 10 words
DIFFIR_NET = {"type": "NAFNetDynamicFusion", "img_channel": 3, "width": 64,
              "middle_blk_num": 1, "enc_blk_nums": [1, 1, 1, 28],
              "dec_blk_nums": [1, 1, 1, 1], "num_words": 10}
DIFFIR_TRAIN = {**TRAIN_OPT["train"], "param_fix_iterations": 0,
                "ema_decay": 0.999}
DIFFIR_GT = 256
# phase 34's step card vs CPU: the full widths, one block a level (the
# 1.8 B-parameter net's f32 step would take some 50 GB of host memory)
DIFFIR_CPU_NET = dict(DIFFIR_NET, enc_blk_nums=[1, 1, 1, 1])
DIFFIR_GRAD_FLOOR = 1e-5  # of the global gradient norm, as phase 32's


def diffir_forward(seed: int, seen: dict):
    """Phase 33: NAFNetDynamicFusion at full width, float32 (TF32 off),
    seeded weights (non-zero beta and gamma): its parameter count (all
    and the affine heads'); a 512 px forward on the card with the
    embedding of seeded full-width towers (the CLI's view and towers),
    median ms of 3 after a warm-up, peak memory, a profiled forward's
    idle share, the embedding's ms per image; the network on the card
    against the CPU at 128 px within NET_ATOL; no kernel launched."""
    from textualdegremoval_tpu_torch.cli import train_diffir as dcli

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model_cpu = gate_and_temperatures(define_network(DIFFIR_NET), seed)
    n_all = sum(p.numel() for p in model_cpu.parameters())
    n_heads = sum(p.numel() for n, p in model_cpu.named_parameters()
                  if n.endswith("kernel.0.weight"))
    opt = {"manual_seed": seed, "path": {},
           "network_mapper": {"num_words": DIFFIR_NET["num_words"]}}
    enc, mapper = dcli.build_towers(opt, "cuda")
    embed = dcli.make_device_embed_fn(enc, mapper)
    rng = np.random.default_rng(seed + 9)
    lq = torch.from_numpy(synthetic_triple(rng)[0][None]).cuda()
    _reset_all_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        emb_ms = median_ms(lambda: embed(lq), reps=3)
        kv = embed(lq)
    del enc, mapper, embed
    model = copy.deepcopy(model_cpu).cuda()
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: model(lq, kv), reps=3)
        out = model(lq, kv)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        idle = profile_device(lambda: model(lq, kv),
                              "NAFNetDynamicFusion f32 512 px forward")
        x = torch.from_numpy(rng.random((1, 128, 128, 3), np.float32))
        k = kv.cpu()
        got = model(x.cuda(), kv).cpu()
        want = model_cpu(x, k)
    no_kernel_launched("NAFNetDynamicFusion forward", seen)
    err = (got - want).abs().max().item()
    log(f"NAFNetDynamicFusion: {n_all} parameters, {n_heads} in the affine "
        f"heads; f32 512 px forward {fwd_ms:.2f} ms, peak {peak:.2f} GiB, "
        f"idle share {idle}; the embedding (ViT-H/14 + I2T, 10 words) "
        f"{emb_ms:.2f} ms an image; card vs CPU at 128 px max_abs "
        f"{err:.3e} (atol {NET_ATOL}, max|out| {want.abs().max().item():.3f})"
        f"; no kernel launched")
    if out.shape != lq.shape or not torch.isfinite(out).all() \
            or not torch.isfinite(got).all() or err > NET_ATOL:
        raise RuntimeError(f"NAFNetDynamicFusion: output {tuple(out.shape)}"
                           f", card vs CPU {err}")
    del model, model_cpu, out, kv
    torch.cuda.empty_cache()
    return {"params": n_all, "head_params": n_heads, "fwd_ms": fwd_ms,
            "peak_gib": peak, "idle": idle, "embed_ms": emb_ms,
            "cpu_err": err}


def _write_pngs(root: Path, subs, n: int, hw, seed: int):
    from textualdegremoval_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    for sub in subs:
        (root / sub).mkdir(parents=True)
        for i in range(n):
            write_png(str(root / sub / f"{i:03d}.png"),
                      (rng.random((*hw, 3)) * 255).astype(np.uint8))


class _RecordedCheckpoints:
    """The CLI's CheckpointManager with its writes recorded, not made (a
    training state of the 1.8 B-parameter net is 29 GB); restore finds
    none.  The CPU tests write and resume real checkpoints."""

    def __init__(self, *dirs):
        self.saved = []

    def restore_state(self, state):
        return None

    def save_state(self, state, step):
        self.saved.append(("state", step))

    def save_network(self, state, step):
        self.saved.append(("network", step))


def diffir_cli(seed: int, seen: dict, iters: int = 3):
    """Phase 34: the DiffIR CLI (`train_diffir.main`) on the card with a
    synthesized options dict over numpy-written PNGs: the frozen
    full-width towers and phase 33's net, float32, gt_size 256, at the
    largest batch of FAMILY_BATCHES whose step fits (a run that runs out
    of memory is dropped and the next batch tried), `iters` iterations
    through the DevicePrefetcher, each iteration's embedding and step
    timed apart (synchronised), the peak memory, a profiled iteration's
    idle share, finite logged losses, the final checkpoint asked for; then
    one f32 step card vs CPU (train_step_vs_cpu at DIFFIR_CPU_NET, C3's
    bounds); no kernel launched."""
    from textualdegremoval_tpu_torch.cli import train_diffir as dcli

    root = Path(tempfile.mkdtemp(prefix="diffir_cli_"))
    _write_pngs(root, ("lq", "hq"), 8, (272, 288), seed + 10)
    out, cwd = {}, Path.cwd()
    make_embed, make_step = dcli.make_device_embed_fn, \
        dcli.make_diffir_train_step
    manager = dcli.CheckpointManager
    try:
        os.chdir(root)
        for b in FAMILY_BATCHES:
            times = {"embed": [], "step": []}
            last = {}

            def timed(fn, key):
                def run(*a):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    r = fn(*a)
                    torch.cuda.synchronize()
                    times[key].append((time.perf_counter() - t0) * 1e3)
                    last[key] = (fn, a)
                    return r
                return run

            dcli.make_device_embed_fn = lambda *a: timed(make_embed(*a),
                                                         "embed")
            dcli.make_diffir_train_step = lambda *a: timed(make_step(*a),
                                                           "step")
            ckpts = []
            dcli.CheckpointManager = lambda *d: ckpts.append(
                _RecordedCheckpoints(*d)) or ckpts[-1]
            opt = {
                "name": f"diffir_b{b}", "manual_seed": seed,
                "datasets": {"train": {
                    "name": "T", "type": "Dataset_PairedImage",
                    "lqroot": str(root / "lq"), "hqroot": str(root / "hq"),
                    "io_backend": {"type": "disk"}, "num_worker_per_gpu": 0,
                    "batch_size_per_gpu": b, "gt_size": DIFFIR_GT,
                    "geometric_augs": True}},
                "network_g": DIFFIR_NET,
                "network_mapper": {"num_words": DIFFIR_NET["num_words"]},
                "path": {}, "train": DIFFIR_TRAIN,
                "logger": {"print_freq": 1, "save_checkpoint_freq": 10 ** 6}}
            cfg = root / f"diffir_b{b}.json"
            cfg.write_text(json.dumps(opt))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _reset_all_counts()
            t0 = time.perf_counter()
            try:
                state = dcli.main(["--opt", str(cfg), "--max_iters",
                                   str(iters), "--device", "cuda"])
            except torch.cuda.OutOfMemoryError:
                log(f"DiffIR CLI batch {b} at {DIFFIR_GT} px: out of device "
                    "memory")
                last.clear()
                continue
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            steps = state.step  # before the profiled iteration below
            (efn, (lq,)), (sfn, (st, batch)) = last["embed"], last["step"]
            idle = profile_device(lambda: sfn(st, {**batch, "embed": efn(
                lq)}), f"DiffIR iteration batch {b}")
            no_kernel_launched("the DiffIR CLI", seen)
            scalars = [json.loads(line) for line in (
                root / "experiments" / f"diffir_b{b}" / "scalars.jsonl"
            ).read_text().splitlines()]
            losses = [s["l_pix"] for s in scalars]
            log(f"phase 34 DiffIR CLI: batch {b}, {DIFFIR_GT} px, {iters} "
                f"iterations in {secs:.1f} s (the build included); embedding "
                f"ms {[round(v, 2) for v in times['embed']]}, step ms "
                f"{[round(v, 2) for v in times['step']]}, peak {peak:.2f} "
                f"GiB, idle share {idle}, l_pix {losses}, checkpoints asked "
                f"{ckpts[0].saved}")
            if steps != iters or len(losses) != iters \
                    or not np.isfinite(losses).all() \
                    or ckpts[0].saved != [("state", iters),
                                          ("network", iters)]:
                raise RuntimeError(f"the DiffIR CLI: step {steps}, "
                                   f"losses {losses}, {ckpts[0].saved}")
            out = {"batch": b, "embed_ms": statistics.median(
                times["embed"][1:]), "step_ms": statistics.median(
                times["step"][1:]), "peak_gib": peak, "idle": idle}
            break
        else:
            raise RuntimeError("the DiffIR CLI: no batch of "
                               f"{FAMILY_BATCHES} fits the card")
    finally:
        dcli.make_device_embed_fn, dcli.make_diffir_train_step = \
            make_embed, make_step
        dcli.CheckpointManager = manager
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    del state, last
    gc.collect()
    torch.cuda.empty_cache()
    _reset_all_counts()
    train_step_vs_cpu(seed, {"network_g": DIFFIR_CPU_NET,
                             "train": DIFFIR_TRAIN},
                      grad_floor=DIFFIR_GRAD_FLOOR,
                      update_tol=FAMILY_UPDATE_TOL,
                      ref_fn=lambda rng, b: rng.standard_normal(
                          (b, DIFFIR_NET["num_words"], 1024)).astype(
                          np.float32))
    no_kernel_launched("the DiffIR step, card vs CPU", seen)
    return out


def _lmdb_writer():
    """tests/lmdb_spec_writer.py's `write_lmdb` (LMDB's on-disk format
    written from its specification, with BasicSR's meta_info.txt)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "lmdb_spec_writer", Path(__file__).resolve().parent / "tests"
        / "lmdb_spec_writer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.write_lmdb


def keyed_archives(seed: int, iters: int = 2, gt_size: int = 128):
    """Phase 35: an LMDB (the spec writer) and a packed TFRecord
    (`pack_image_folder`) of one seeded folder of PNGs; every item of
    Dataset_PairedImageWithRef through each archive equal, bit for bit, to
    the disk backend's for the same index and seed; then
    cli/train_restoration.py's `main` for `iters` iterations on each
    archive at nafnet_motion_deblur.yml's network (its float32), gt_size
    reduced to `gt_size`, batch 8: 45 `nafblock_fused` launches a step.
    Returns the decoder that read the disk images and each run's
    launches."""
    from textualdegremoval_tpu_torch.cli import train_restoration as cli
    from textualdegremoval_tpu_torch.data import datasets as dsets
    from textualdegremoval_tpu_torch.data import native
    from textualdegremoval_tpu_torch.data.loader import create_dataset
    from textualdegremoval_tpu_torch.data.packed import pack_image_folder

    decoder = ("native (native/tdr_decode.cc)" if native.decode_available()
               else "cv2" if dsets._cv2() is not None else "data/png.py")
    crc = ("native (native/tdr_dataio.cc)" if native.dataio_available()
           else "Python")
    root = Path(tempfile.mkdtemp(prefix="archives_"))
    kinds = ("lq", "hq", "ref")
    _write_pngs(root, kinds, 8, (272, 288), seed + 11)
    write_lmdb = _lmdb_writer()
    t0 = time.perf_counter()
    for kind in kinds:
        files = sorted((root / kind).iterdir())
        write_lmdb(str(root / f"{kind}.lmdb"),
                   {f.stem: f.read_bytes() for f in files})
        pack_image_folder(str(root / kind), str(root / f"{kind}_packed"))
    pack_s = time.perf_counter() - t0
    suffix = {"disk": "", "lmdb": ".lmdb", "tfrecord": "_packed"}

    def ds_opt(io):
        return {"type": "Dataset_PairedImageWithRef", "phase": "train",
                "gt_size": gt_size, "geometric_augs": True, "seed": seed,
                "io_backend": {"type": io},
                **{f"{k}root": str(root / f"{kind}{suffix[io]}")
                   for k, kind in zip(("lq", "hq", "ref"), kinds)}}

    out, cwd = {"decoder": decoder}, Path.cwd()
    try:
        items = {io: [create_dataset(ds_opt(io))[i] for i in range(8)]
                 for io in suffix}
        same = all(np.array_equal(a[k], d[k]) for io in ("lmdb", "tfrecord")
                   for a, d in zip(items[io], items["disk"])
                   for k in ("lq", "gt", "ref"))
        log(f"phase 35: 8 items a backend, the lmdb and tfrecord items "
            f"{'equal' if same else 'DIFFER from'} the disk backend's bit for "
            f"bit; disk images decoded by {decoder}; archives built in "
            f"{pack_s:.2f} s, crc32c {crc}")
        if not same:
            raise RuntimeError("an archive's items differ from the disk "
                               "backend's")
        os.chdir(root)
        for io in ("lmdb", "tfrecord"):
            opt = {"name": f"archive_{io}", "manual_seed": seed,
                   "datasets": {"train": {
                       **ds_opt(io), "num_worker_per_gpu": 0,
                       "batch_size_per_gpu": 8, "mini_batch_sizes": [8],
                       "iters": [10 ** 6], "gt_sizes": [gt_size]}},
                   "network_g": NAF_TRAIN_OPT["network_g"],
                   "path": {"pretrain_dino": None},
                   "train": dict(NAF_TRAIN_OPT["train"],
                                 param_fix_iterations=0),
                   "logger": {"print_freq": 1,
                              "save_checkpoint_freq": 10 ** 6}}
            cfg = root / f"{io}.json"
            cfg.write_text(json.dumps(opt))
            nb.nafblock_fused.launches = 0
            t0 = time.perf_counter()
            state = cli.main(["--opt", str(cfg), "--max_iters", str(iters),
                              "--device", "cuda"])
            secs = time.perf_counter() - t0
            n = nb.nafblock_fused.launches
            log(f"phase 35 {io}: {iters} iterations of "
                f"nafnet_motion_deblur.yml's network through the CLI in "
                f"{secs:.1f} s, nafblock_fused launches {n}")
            if state.step != iters or n != NAF_BLOCKS * iters:
                raise RuntimeError(f"training on the {io} archive: step "
                                   f"{state.step}, launches {n}")
            out[io] = n
            del state
            torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    return out


def diffir_phases(seed: int) -> dict:
    """Phases 33-35, each one's seconds printed.  33 and 34 read every
    kernel counter of the port: none may move (the DiffIR path reaches no
    Pallas kernel); the kernels line gives each kernel's count there as
    diffir_launches."""
    out, seen = {}, {}
    t0 = time.perf_counter()
    out["forward"] = diffir_forward(seed, seen)
    log(f"phase 33 (NAFNetDynamicFusion at full width) took "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["cli"] = diffir_cli(seed, seen)
    log(f"phase 34 (the DiffIR CLI) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["archives"] = keyed_archives(seed)
    log(f"phase 35 (the keyed archives) took "
        f"{time.perf_counter() - t0:.1f} s")
    out["launches"] = seen
    return out


# ---------------------------------------------------------------------------
# Phases 36-37: tiled restoration and the metrics
# ---------------------------------------------------------------------------

TILED_HW = (1536, 2048)  # 4 x 5 tiles of 512 at overlap 64
TILED_TILE, TILED_OVERLAP = 512, 64
TILED_TILES = 20
C13_HW = (480, 1280)  # one side within the tile: one row of 3 tiles
# bf16 tiled image, kernel route vs the same tiling on plain blocks (both
# on the card): the blend is a convex combination of the tiles, so its
# error is at most the largest tile's (plus float32 rounding of the blend,
# BLEND_ATOL); the tiles are held to TILED_BF16_ATOL and the image to
# TILED_BF16_L2 of the plain image's norm.  Read on an H100: 1.5625e-2
# (two bf16 ulps of outputs near 2; max|out| 1.97) and 4.0e-3 in L2;
# the bounds are four and five times those.
TILED_BF16_ATOL = 6.25e-2
TILED_BF16_L2 = 2e-2
BLEND_ATOL = 1e-6  # the identity through the blend: a few f32 ulps at 1
# FID: N images a set, 2049 being the least N at which the 2048-d
# covariance of N samples has full rank (its rank is at most N - 1);
# 2080 = 65 batches of 32
FID_N, FID_SIZE, FID_BATCH = 2080, 512, 32
FID_CPU_REL = 1e-4  # card vs CPU features, of max|CPU| (the CPU tests')


def synthetic_large(rng, h, w, ref_size=512):
    """A smooth h x w image, its noisy version and a shifted 512 px
    reference crop, HWC f32 (synthetic_triple's recipe)."""
    low = rng.random((h // 16, w // 16, 3)).astype(np.float32)
    hq = np.kron(low, np.ones((16, 16, 1), np.float32))
    hq = np.clip(hq + 0.05 * rng.standard_normal(hq.shape), 0, 1).astype(
        np.float32)
    lq = np.clip(hq + rng.standard_normal(hq.shape) * 15 / 255, 0, 1).astype(
        np.float32)
    ref = np.ascontiguousarray(np.roll(hq, (7, -5), axis=(0, 1))[
        :ref_size, :ref_size])
    return lq, hq, ref


def _plain_block_forward(x, p, heads, ln_type="WithBias", kw=None,
                         bwd_mode="save"):
    """The plain route of phase 36's comparison (never the main path)."""
    return tb.tblock_ref(x, p, heads, ln_type)


def tiled_restoration(seed: int) -> dict:
    """Phase 36: `utils/tiled.py` `infer_tiled` of a seeded 1536 x 2048
    image with a 512 px reference through the full-width restormer_deblur
    network in bf16 (main_path's build), tile 512, overlap 64: 20 tiles,
    52 B1 launches each, all through the pipeline; ms an image and a tile,
    peak memory beside one 512 px forward's, the idle share (of the C13
    shape's 3 tiles); the tiled
    image against the same tiling on plain blocks (TILED_BF16_ATOL, and
    the blend within the largest tile's error); the C13 shape; the
    identity through the blend of 1536 x 2048; `measure_inference_speed`
    beside `time_ms`; `model_complexity` from the plain route (fake CPU
    tensors); a `trace` naming B1's kernels.  Returns the readings."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from textualdegremoval_tpu_torch.utils.profiling import (
        measure_inference_speed, model_complexity, trace)
    from textualdegremoval_tpu_torch.utils.tiled import infer_tiled

    h, w = TILED_HW
    model = build_network(seed, torch.bfloat16, "cuda")
    lq_np, hq, ref_np = synthetic_large(np.random.default_rng(seed + 11),
                                        h, w)
    lq = torch.from_numpy(lq_np)[None].to("cuda", torch.bfloat16)
    ref = torch.from_numpy(ref_np)[None].to("cuda", torch.bfloat16)
    tile_lq = lq[:, :TILED_TILE, :TILED_TILE].contiguous()
    tiles = []

    def fwd(a, b):
        return model(a, b)

    def recording(a, b):
        tiles.append(model(a, b))
        return tiles[-1]

    def tiled(fn=fwd, x=lq):
        return infer_tiled(fn, x, ref, TILED_TILE, TILED_OVERLAP)

    out = {}
    with torch.inference_mode():
        model(tile_lq, ref)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model(tile_lq, ref)
        out["tile_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        tiled()  # warm-up at the tiled image's shapes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_all_counts()
        t0 = time.perf_counter()
        pred = tiled()
        out["image_ms"] = (time.perf_counter() - t0) * 1e3
        counts = _all_counts()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["launches"] = counts["tblock_fused.launches"]
        want = {"tblock_fused.launches": 52 * TILED_TILES,
                "tblock_pipeline.launches": 52 * TILED_TILES}
        moved = {k: v for k, v in counts.items() if v}
        log(f"tiled {h}x{w} bf16 (tile {TILED_TILE}, overlap "
            f"{TILED_OVERLAP}): {out['image_ms']:.1f} ms an image, "
            f"{out['image_ms'] / TILED_TILES:.2f} ms a tile; peak "
            f"{out['peak_gib']:.2f} GiB (one 512 px forward "
            f"{out['tile_peak_gib']:.2f} GiB); launches {moved}")
        if moved != want or pred.shape != (1, h, w, 3) \
                or not np.isfinite(pred).all():
            raise RuntimeError(f"tiled restoration: launches {moved} (want "
                               f"{want}), output {pred.shape}")

        got = tiled(recording)
        kernel_tiles, tiles = tiles, []
        switch = _swap("tblock_fused", _plain_block_forward)
        switch(None, True)
        try:
            _reset_all_counts()
            plain = tiled(recording)
            plain_launches = _all_counts()["tblock_fused.launches"]
        finally:
            switch(None, False)
        tile_err = max((k.float() - p.float()).abs().max().item()
                       for k, p in zip(kernel_tiles, tiles))
        del kernel_tiles, tiles
        err = float(np.abs(got - plain).max())
        rel_l2 = float(np.linalg.norm(got - plain) / np.linalg.norm(plain))
        out.update(max_abs_err=err, tile_err=tile_err, rel_l2=rel_l2,
                   repeat_equal=bool(np.array_equal(got, pred)))
        log(f"tiled image, kernel route vs plain blocks (both bf16 on the "
            f"card; {plain_launches} launches on the plain route): max_abs "
            f"{err:.4e}, the largest tile's {tile_err:.4e} (bound "
            f"{TILED_BF16_ATOL}: tiles; the blend <= the largest tile's + "
            f"{BLEND_ATOL}), L2 {rel_l2:.4e} of the plain image (bound "
            f"{TILED_BF16_L2}), max|plain| {np.abs(plain).max():.3f}; a "
            f"second kernel-route image bitwise equal to the first: "
            f"{out['repeat_equal']}")
        if plain_launches or tile_err > TILED_BF16_ATOL \
                or err > tile_err + BLEND_ATOL or rel_l2 > TILED_BF16_L2:
            raise RuntimeError(f"tiled image vs plain blocks: {err}, tiles "
                               f"{tile_err}, {plain_launches} launches")

        _reset_all_counts()
        log_dir = Path(tempfile.mkdtemp(prefix="tiled_trace_"))
        try:
            with trace(str(log_dir)):
                c13 = tiled(x=lq[:, :C13_HW[0], :C13_HW[1]])
            files = list(log_dir.glob("*.pt.trace.json"))
            text = files[0].read_text() if len(files) == 1 else ""
        finally:
            shutil.rmtree(log_dir, ignore_errors=True)
        c13_launches = _all_counts()["tblock_fused.launches"]
        named = [k for k in ("qkv_stencil_kernel", "gate_stencil_kernel",
                             "attn_glue_kernel") if k in text]
        log(f"trace of the C13 shape's tiled image: {[f.name for f in files]}"
            f", {len(text) / 2 ** 20:.1f} MiB, B1's kernels named: {named}")
        if len(named) != 3:
            raise RuntimeError(f"trace: {files}, B1 kernels {named}")

        x32 = lq.float()
        ident = infer_tiled(lambda a, b: a, x32, ref, TILED_TILE,
                            TILED_OVERLAP)
        ident_err = float(np.abs(ident - x32.cpu().numpy()).max())
        log(f"C13 shape {C13_HW[0]}x{C13_HW[1]}: {c13.shape}, finite "
            f"{bool(np.isfinite(c13).all())}, {c13_launches} launches (3 "
            f"tiles); the identity through the {h}x{w} blend on the card: "
            f"max_abs {ident_err:.3e} (bound {BLEND_ATOL})")
        if c13.shape != (1, *C13_HW, 3) or not np.isfinite(c13).all() \
                or c13_launches != 3 * 52 or ident_err > BLEND_ATOL:
            raise RuntimeError(f"C13 shape / identity blend: {c13.shape}, "
                               f"{c13_launches}, {ident_err}")
        # the profiler's own processing grows with the events (37 000 for
        # the whole image took some 40 s), so the idle share is read on
        # the C13 shape's 3 tiles
        out["idle"] = profile_device(
            lambda: tiled(x=lq[:, :C13_HW[0], :C13_HW[1]]),
            f"tiled {C13_HW[0]}x{C13_HW[1]} bf16 (3 tiles)")

        out["rate"] = measure_inference_speed(fwd, (tile_lq, ref),
                                              max_iter=50)
        out["time_ms"] = time_ms(lambda: model(tile_lq, ref),
                                 torch.device("cuda"), 10, 3)
        log(f"measure_inference_speed (512 px, 50 iterations, a scalar "
            f"fetched each): {out['rate']:.3f} images/s = "
            f"{1e3 / out['rate']:.2f} ms an image; _card.time_ms "
            f"{out['time_ms']:.2f} ms a forward")

    model_cpu = build_network(seed, torch.float32, "cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.zeros(1, TILED_TILE, TILED_TILE, 3)
        cx = model_complexity(model_cpu, x, x)
    out["complexity"] = cx
    log(f"model_complexity of restormer_deblur at 512 px (the plain route, "
        f"fake CPU tensors; ATen convolutions and products only): "
        f"{cx['params']} parameters, {cx['flops'] / 1e12:.4f} TFLOP, "
        f"{cx['macs'] / 1e12:.4f} TMAC")
    out["pred"], out["hq"] = pred, hq
    del model, model_cpu
    torch.cuda.empty_cache()
    return out


def fid_and_metrics(seed: int, pred: np.ndarray, hq: np.ndarray,
                    seen: dict) -> dict:
    """Phase 37: an InceptionV3 with `seeded_init` weights (O(1)
    features); two seeded sets of FID_N 512 px images made on the card
    batch by batch; float32 features (TF32 off) at batch 32, the card's
    against the CPU's on 4 images; extraction images/s; FID(a, a) and the
    host seconds of one `frechet_distance`; `calculate_fid_from_images(a,
    b)`; NIQE, PSNR and SSIM (crop_border 4, test_y_channel) of phase 36's
    image passed as a card tensor.  No kernel may launch."""
    from textualdegremoval_tpu_torch.metrics import (
        calculate_psnr, calculate_ssim)
    from textualdegremoval_tpu_torch.metrics.fid import (
        calculate_fid, calculate_fid_from_images)
    from textualdegremoval_tpu_torch.metrics.inception import (
        InceptionV3, extract_features, seeded_init)
    from textualdegremoval_tpu_torch.metrics.niqe import calculate_niqe

    _reset_all_counts()
    model_cpu = seeded_init(InceptionV3(), seed)
    model = copy.deepcopy(model_cpu).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    sets = []
    for noise in (0.0, 0.1):
        imgs = torch.empty(FID_N, FID_SIZE, FID_SIZE, 3, device="cuda")
        for i in range(0, FID_N, FID_BATCH):
            low = torch.rand(FID_BATCH, FID_SIZE // 16, FID_SIZE // 16, 3,
                             generator=gen, device="cuda")
            x = low.repeat_interleave(16, 1).repeat_interleave(16, 2)
            x = x + noise * torch.randn(x.shape, generator=gen,
                                        device="cuda")
            imgs[i:i + FID_BATCH] = x.clamp(0, 1)
        sets.append(imgs)
    a, b = sets
    torch.cuda.synchronize()
    out = {"make_s": time.perf_counter() - t0}

    got = extract_features(model, a[:4]).cpu()
    want = extract_features(model_cpu, a[:4].cpu())
    cpu_err = (got - want).abs().max().item() / want.abs().max().item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fa = extract_features(model, a, FID_BATCH).cpu().numpy()
    out["extract_rate"] = FID_N / (time.perf_counter() - t0)
    out["extract_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    fid_aa = calculate_fid(fa, fa)
    out["frechet_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid_ab = calculate_fid_from_images(a, b, model=model,
                                       batch_size=FID_BATCH)
    out["fid_ab_s"] = time.perf_counter() - t0
    eig = np.linalg.eigvalsh(np.cov(fa, rowvar=False))
    out.update(cpu_err=cpu_err, fid_aa=fid_aa, fid_ab=fid_ab)
    log(f"FID: {FID_N} + {FID_N} images of {FID_SIZE} px made on the card "
        f"in {out['make_s']:.1f} s; features card vs CPU (4 images) "
        f"{cpu_err:.3e} of max|CPU| (bound {FID_CPU_REL}); extraction "
        f"{out['extract_rate']:.1f} images/s (f32, TF32 off, batch "
        f"{FID_BATCH}; peak {out['extract_peak_gib']:.2f} GiB with both "
        f"sets held), features |mean| {np.abs(fa).mean():.4f}, covariance "
        f"eigenvalues {eig.min():.3e} .. {eig.max():.3e}; FID(a, a) "
        f"{fid_aa:.3e} (frechet_distance {out['frechet_s']:.2f} s on the "
        f"host); FID(a, b) {fid_ab:.4f} (calculate_fid_from_images "
        f"{out['fid_ab_s']:.2f} s)")
    if not cpu_err <= FID_CPU_REL or not abs(fid_aa) <= 1e-3 \
            or not np.isfinite(fid_ab) or not fid_ab > fid_aa:
        raise RuntimeError(f"FID: card vs CPU {cpu_err}, FID(a, a) "
                           f"{fid_aa}, FID(a, b) {fid_ab}")
    del a, b, sets, model
    torch.cuda.empty_cache()

    # BGR at [0, 255], as the metrics' Y channel reads it
    bgr = np.ascontiguousarray(pred[0, ..., ::-1].transpose(2, 0, 1))
    card = torch.from_numpy(bgr)[None].cuda() * 255
    gt = hq[..., ::-1] * 255
    t0 = time.perf_counter()
    out["niqe"] = calculate_niqe(card, crop_border=4)
    out["niqe_s"] = time.perf_counter() - t0
    out["psnr"] = calculate_psnr(card, gt, crop_border=4,
                                 test_y_channel=True)
    out["ssim"] = calculate_ssim(card, gt, crop_border=4,
                                 test_y_channel=True)
    log(f"phase 36's image as a card tensor: NIQE {out['niqe']:.4f} "
        f"({out['niqe_s']:.1f} s on the host), Y-channel PSNR "
        f"{out['psnr']:.4f} dB, SSIM {out['ssim']:.4f} (crop_border 4)")
    if not all(np.isfinite(out[k]) for k in ("niqe", "psnr", "ssim")) \
            or not 0 < out["ssim"] <= 1:
        raise RuntimeError(f"metrics of the tiled image: {out}")
    no_kernel_launched("FID and the metrics", seen)
    return out


def metric_phases(seed: int) -> dict:
    """Phases 36-37, each one's seconds printed; the kernels line gives
    each kernel's count in phase 37 as fid_launches."""
    seen = {}
    t0 = time.perf_counter()
    tiled = tiled_restoration(seed)
    log(f"phase 36 (tiled restoration) took {time.perf_counter() - t0:.1f} "
        "s")
    t0 = time.perf_counter()
    metrics = fid_and_metrics(seed, tiled.pop("pred"), tiled.pop("hq"),
                              seen)
    log(f"phase 37 (FID and the metrics) took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"tiled": tiled, "metrics": metrics, "launches": seen}

# ---------------------------------------------------------------------------
# Phase 39: the whole-image forward split by rows over ranks (--spatial_shard)
# ---------------------------------------------------------------------------

SPATIAL_WORLD = 2
SPATIAL_HW = TILED_HW  # phase 36's image: 768 rows a rank
SPATIAL_F32_HW = (512, 512)  # (c): 256 rows a rank
SPATIAL_CLI_HW = (515, 512)  # (d): reflect-padded to 516, 9 units: 5 + 4
SPATIAL_CLI_IMAGES = 2
SPATIAL_B1 = 52  # B1 launches a rank a forward
# the statistics window at one block shape a level of (b)'s forward: a
# slab of own rows with both halos (a middle rank's), rows (own, W, C,
# heads); the window takes the own rows only
SPATIAL_WINDOW_SHAPES = ((768, 2048, 96, 1), (384, 1024, 192, 2),
                         (192, 512, 384, 4), (96, 256, 768, 8))
# the window's sums against the plain sums over the same rows: float32
# pass A against torch's float32 q and k (TF32 off), the bf16 pipeline's
# against torch's sums of its own q and k; both add the same products in
# another order (about 1e-6 of the sum), while a window that takes the
# halo's 4 rows moves the sums by 4 / (own + 4) of them, 5e-3 to 4e-2 here
WINDOW_L2 = 1e-4
# (b) the gathered bf16 image against one process: the same kernels on
# the same pixels, but each rank's statistics are partial sums added
# over the ranks and the stencils' and the gram's splits follow the slab's
# height, so the float32 gram and square sums differ in the order of
# their sums; where that flips a rounding of the bf16 attention, the flip
# runs through the later blocks as one or two bf16 ulps of the output
# (outputs near 2: 2^-7 an ulp).  Elementwise |d| <= a max|p| + r |p|
# with a = 2^-5 (four ulps at the largest output), r = 2^-6, and in L2
# within 1e-2 of ||p||, phase 36's TILED_BF16_L2 halved (one tiling)
SPATIAL_BF16_A, SPATIAL_BF16_R, SPATIAL_BF16_L2 = 2 ** -5, 2 ** -6, 1e-2
# (c) float32: JAX's own bound for its sharded forward, and in L2 1e-5
SPATIAL_F32_ATOL, SPATIAL_F32_L2 = 1e-4, 1e-5
# (d) the sharded CLI's mean PSNR / SSIM against the unsharded CLI's on
# the same folder (bf16; (b)'s bound moves the PSNR of an image by less)
SPATIAL_CLI_DB, SPATIAL_CLI_SSIM = 2e-2, 2e-4


def _window_block(gen, c, heads, dtype):
    blk = TransformerBlock(c, heads)
    randomize_block(blk, gen)
    p = {k: v.detach().cuda() for k, v in blk.block_params().items()}
    return p, tb.prepare_tblock_weights(p, dtype, "WithBias")


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def window_vs_plain(gen, shapes=SPATIAL_WINDOW_SHAPES,
                    dtypes=(torch.float32, torch.bfloat16), phase="39"):
    """Phase 39's window check: the statistics of a slab with both halos
    taken over its own rows only, float32 pass A (`tblock_stats_rows`,
    csrc/tblock.cu) against torch's float32 sums over those rows of q and
    k computed in torch, and the bf16 pipeline's (`_pipeline_attn`:
    `fwd_qkv_stencil_rows`' square sums, csrc/wgrad.cu's gram on the view
    of those rows, as the glue hands them back) against torch's sums over
    those rows of the pipeline's own q and k; WINDOW_L2.  Each row must be
    the route `tblock_fused` takes at its shape and dtype (phase 40 runs
    it at PromptIR's noise widths).  Returns rows (dtype, shape, worst L2
    error, ms of the windowed statistics)."""
    from textualdegremoval_tpu_torch.ops.dwconv import dwconv
    from textualdegremoval_tpu_torch.ops.pallas.mdta import mdta_sums_ref
    from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import (
        _EPS, _ln_rows)

    lib = _build.load_library()
    stream, sms = tb._card(torch.device("cuda"))
    # the inputs drawn on the card (drawn on the host they took seconds)
    card_gen = torch.Generator(device="cuda").manual_seed(
        int(torch.randint(1 << 30, (1,), generator=gen)))
    rows_out = []
    for dtype in dtypes:
        for own, w, c, heads in shapes:
            p, kw = _window_block(gen, c, heads, dtype)
            x = torch.randn(1, own + 4, w, c, generator=card_gen,
                            device="cuda").to(dtype)
            rows = (2, 2 + own)
            if tb._takes_pipeline(x, heads) != (dtype == torch.bfloat16):
                raise RuntimeError(f"window check at {own}x{w}x{c}, heads "
                                   f"{heads}, {dtype}: not the route "
                                   "tblock_fused takes")
            with torch.no_grad():
                if dtype == torch.float32:
                    tiles = tb._block_tiles(lib, x, heads, sms)

                    def stats():
                        return tb._pass_a(lib, x, kw, heads, "WithBias",
                                          tiles[0], tiles[2], stream, rows)
                    got = stats()
                    y = tb._ln(x, p["norm1_w"], p["norm1_b"], "WithBias")
                    qkv = dwconv(y @ p["qkv"].reshape(c, 3 * c), p["qkv_dw"])
                else:
                    ys = _ln_rows(lib, x, kw["ln1w"], kw["ln1b"], 0, stream,
                                  _EPS)[0]
                    buf = {}

                    def stats():
                        return tb._pipeline_attn(lib, x, ys, kw, heads, sms,
                                                 stream, buf, rows)[1]
                    got = stats()
                    qkv = buf["qkv"].reshape(x.shape[:3] + (3 * c,))
                want = mdta_sums_ref(qkv[..., :c], qkv[..., c:2 * c], heads,
                                     rows)
                err = max(_rel_l2(g, wn) for g, wn in zip(got, want))
                ms = median_ms(stats, reps=3)
            name = "f32 tblock_stats_rows" if dtype == torch.float32 \
                else "bf16 fwd_qkv_stencil_rows + wgrad view"
            log(f"phase {phase} window {name} at own rows {own} of "
                f"{own + 4}, W {w}, C {c}, heads {heads}: L2 error "
                f"{err:.3e} (bound {WINDOW_L2}), {ms:.3f} ms")
            if not err <= WINDOW_L2:
                raise RuntimeError(f"statistics window {name} at {own}x{w}x"
                                   f"{c}: L2 error {err:.3e} > {WINDOW_L2}")
            rows_out.append((str(dtype), (own, w, c, heads), err, ms))
            del x, qkv, got, want
    torch.cuda.empty_cache()
    return rows_out


def _spatial_inputs(seed, dtype, hw=SPATIAL_HW):
    lq_np, _, ref_np = synthetic_large(np.random.default_rng(seed + 11),
                                       *SPATIAL_HW)
    lq = torch.from_numpy(lq_np[: hw[0], : hw[1]].copy())[None]
    ref = torch.from_numpy(ref_np)[None]
    return lq.to("cuda", dtype), ref.to("cuda", dtype)


def _spatial_cli_argv(work: Path, task=TASK):
    return ["--task", task, "--dtype", "bfloat16",
            "--hqroot", str(work / "hq"), "--refroot", str(work / "ref"),
            "--device", "cuda"]


def _spatial_reference(seed: int, work: Path) -> dict:
    """(a) in this process: the bf16 forward of the whole image (a warm-up,
    one timed with its B1 launches and peak, one profiled), the float32
    forward at 512 px, and the unsharded CLI on (d)'s folder; the outputs
    to <work>/spatial_expected.pt for the comparison after the ranks."""
    from textualdegremoval_tpu_torch.cli import evaluate

    out = {}
    t0 = time.perf_counter()
    model = build_network(seed, torch.bfloat16, "cuda")
    lq, ref = _spatial_inputs(seed, torch.bfloat16)
    out["build_s"] = time.perf_counter() - t0
    with torch.inference_mode():
        model(lq, ref)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_all_counts()
        t0 = time.perf_counter()
        pred = model(lq, ref)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
        out["launches"] = {k: v for k, v in _all_counts().items() if v}
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["idle"] = profile_device(lambda: model(lq, ref),
                                     f"phase 39 (a) {SPATIAL_HW} bf16 forward")
        out["device_ms"] = profile_device.busy_ms
    expected = {"bf16": pred.float().cpu()}
    del model, lq, pred
    model = build_network(seed, torch.float32, "cuda")
    lq, ref = _spatial_inputs(seed, torch.float32, SPATIAL_F32_HW)
    with torch.inference_mode():
        expected["f32"] = model(lq, ref).cpu()
    del model, lq, ref
    torch.cuda.empty_cache()
    _write_pngs(work, ("hq", "ref"), SPATIAL_CLI_IMAGES, SPATIAL_CLI_HW,
                seed + 39)
    t0 = time.perf_counter()
    out["cli"] = evaluate.main(_spatial_cli_argv(work))
    out["cli_s"] = time.perf_counter() - t0
    torch.save(expected, work / "spatial_expected.pt")
    log(f"phase 39 (a) one process (build {out['build_s']:.1f} s): "
        f"{SPATIAL_HW} bf16 forward "
        f"{out['ms']:.1f} ms wall, {out['device_ms']:.1f} ms device busy "
        f"(idle {out['idle']}), peak {out['peak_gib']:.2f} GiB, launches "
        f"{out['launches']}; the unsharded CLI {out['cli']} in "
        f"{out['cli_s']:.1f} s")
    torch.cuda.empty_cache()
    return out


def _spatial_job(rank: int, world: int, work: Path, seed: int) -> dict:
    """One rank of phase 39 (b)-(d): its slab of the whole-image bf16
    forward (a warm-up; one untraced, timed with its launches and peak;
    one traced, with its exchanges and reductions counted and timed),
    gathered on rank 0; the float32 forward at 512 px likewise; the
    evaluate CLI with --spatial_shard 3 (refused) and 2.  Then phase 40's
    (b)-(d) in the same ranks (`_family_spatial_job`)."""
    from textualdegremoval_tpu_torch.cli import evaluate
    from textualdegremoval_tpu_torch.parallel import (
        CollectiveTrace, RowShard, gather_rows)

    out = {"start_s": time.time()}
    model = build_network(seed, torch.bfloat16, "cuda")
    lq, ref = _spatial_inputs(seed, torch.bfloat16)
    shard = RowShard.split(lq.shape[1], model.row_unit, rank, world)
    slab = shard.slab(lq)
    del lq
    with torch.inference_mode():
        model(slab, ref, shard=shard)
        torch.cuda.synchronize()
        torch.distributed.barrier()
        torch.cuda.reset_peak_memory_stats()
        _reset_all_counts()
        t0 = time.perf_counter()
        pred = model(slab, ref, shard=shard)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
        out["launches"] = {k: v for k, v in _all_counts().items() if v}
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        trace = CollectiveTrace()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        model(slab, ref, shard=dataclasses.replace(shard, trace=trace))
        torch.cuda.synchronize()
        out["traced_ms"] = (time.perf_counter() - t0) * 1e3
        out["trace"] = trace.as_dict()
        out["rows"] = shard.rows
        whole = gather_rows(pred, shard)
    if whole is not None:
        torch.save(whole.float().cpu(), work / "spatial_bf16.pt")
    out["bf16_done_s"] = time.time()
    del model, slab, pred, whole
    model = build_network(seed, torch.float32, "cuda")
    lq, ref = _spatial_inputs(seed, torch.float32, SPATIAL_F32_HW)
    shard = RowShard.split(lq.shape[1], model.row_unit, rank, world)
    with torch.inference_mode():
        whole = gather_rows(model(shard.slab(lq), ref, shard=shard), shard)
    if whole is not None:
        torch.save(whole.cpu(), work / "spatial_f32.pt")
    del model, lq, ref, whole
    torch.cuda.empty_cache()
    out["f32_done_s"] = time.time()
    try:
        evaluate.main(_spatial_cli_argv(work) + ["--spatial_shard", "3"])
        out["refusal"] = None
    except SystemExit as e:
        out["refusal"] = str(e)
    t0 = time.perf_counter()
    out["cli"] = evaluate.main(_spatial_cli_argv(work)
                               + ["--spatial_shard", "2"])
    out["cli_s"] = time.perf_counter() - t0
    out["end_s"] = time.time()
    torch.cuda.empty_cache()
    out["families"] = _family_spatial_job(rank, world, work, seed)
    torch.cuda.empty_cache()
    out["pools"] = _pool_spatial_job(rank, world, work, seed)
    return out


def _elementwise_use(got, want, a, r):
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    return float((d / (a * w.max() + r * w).clamp_min(1e-30)).max())


def spatial_phases(seed: int, gen=None) -> dict:
    """Phase 39: the row-sharded whole-image forward (the evaluate CLI's
    --spatial_shard) of the full-width restormer_deblur network, two ranks
    sharing the card over gloo (the backend rule's pick where ranks
    outnumber cards), each spawned as phase 38's are: the statistics
    window of B1's kernels against plain sums (`window_vs_plain`); (a) one
    process: the 1536 x 2048 bf16 forward with a 512 px reference (phase
    36's image), the float32 forward at 512 px, and the unsharded CLI on
    two 515 x 512 images; (b) each rank's 768 rows of (a)'s forward, 52
    B1 launches a rank, its exchanges and reductions, wall ms and peak,
    the gathered image against (a) (SPATIAL_BF16_*); (c) the float32
    forward sharded against one process (SPATIAL_F32_*: csrc/tblock.cu's
    window on the card); (d) the CLI with --spatial_shard 3 (refused) and
    2 against the unsharded CLI (SPATIAL_CLI_*).  Then phase 40, the same
    for nafnet_deblur and promptir_all_in_one in the same spawn: B5's SCA
    window (`naf_window_vs_plain`) and B1's at PromptIR's noise widths
    (`window_vs_plain`), (a) `_family_spatial_reference`, (b)-(d)
    `_family_spatial_job` in the ranks, `family_spatial_check`; and phase
    41 for DRSformer and SFNet: (a) `_pool_spatial_reference`, (b)-(d)
    `_pool_spatial_job` in the ranks, `pool_spatial_check`.  Returns the
    readings."""
    gen = gen or torch.Generator().manual_seed(seed + 39)
    work = Path(tempfile.mkdtemp(prefix="spatial_"))
    t0 = time.perf_counter()
    parts = []

    def timed(what, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        parts.append(f"{what} {time.perf_counter() - t:.1f}")
        return res

    try:
        windows = timed("window", window_vs_plain, gen)
        ref = timed("(a)", _spatial_reference, seed, work)
        fam_windows = timed("40 (e) window", naf_window_vs_plain, gen)
        noise_windows = timed("40 noise window", window_vs_plain, gen,
                              NOISE_WINDOW_SHAPES,
                              (torch.float32, torch.bfloat16), "40")
        fam_ref = timed("40 (a)", _family_spatial_reference, seed, work)
        pool_ref = timed("41 (a)", _pool_spatial_reference, seed, work)
        spawned = time.time()
        ranks = timed("(b)-(d) ranks", _spawn_ranks, "spatial", work, seed,
                      SPATIAL_WORLD)
        # the ranks' parts: start-up, (b), (c), (d)
        parts.append("in rank 0: start-up {:.1f}, (b) {:.1f}, (c) {:.1f}, "
                     "(d) {:.1f}".format(
                         ranks[0]["start_s"] - spawned,
                         ranks[0]["bf16_done_s"] - ranks[0]["start_s"],
                         ranks[0]["f32_done_s"] - ranks[0]["bf16_done_s"],
                         ranks[0]["end_s"] - ranks[0]["f32_done_s"]))
        fam_rank_s = (ranks[0]["families"][FAMILY_SPATIAL_TASKS[-1]]
                      ["end_s"] - ranks[0]["end_s"])
        parts.append(f"in rank 0: phase 40 {fam_rank_s:.1f}")
        pool_rank_s = (ranks[0]["pools"]["end_s"] - ranks[0]["families"][
            FAMILY_SPATIAL_TASKS[-1]]["end_s"])
        parts.append(f"in rank 0: phase 41 {pool_rank_s:.1f}")
        expected = torch.load(work / "spatial_expected.pt")
        got_bf16 = torch.load(work / "spatial_bf16.pt")
        got_f32 = torch.load(work / "spatial_f32.pt")
        fam_errors = family_spatial_check(fam_ref, ranks, work)
        pool_errors = timed("41 check", pool_spatial_check, pool_ref, ranks,
                            work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    h, w = SPATIAL_HW
    want = expected["bf16"]
    err = {"bf16_use": _elementwise_use(got_bf16[:, :h], want,
                                        SPATIAL_BF16_A, SPATIAL_BF16_R),
           "bf16_l2": _rel_l2(got_bf16[:, :h], want),
           "bf16_max_abs": float((got_bf16[:, :h] - want).abs().max()),
           "f32_max_abs": float((got_f32[:, :SPATIAL_F32_HW[0]]
                                 - expected["f32"]).abs().max()),
           "f32_l2": _rel_l2(got_f32[:, :SPATIAL_F32_HW[0]],
                             expected["f32"])}
    cli = ranks[0]["cli"]
    d_psnr, d_ssim = abs(cli[0] - ref["cli"][0]), abs(cli[1] - ref["cli"][1])
    secs = time.perf_counter() - t0
    # phase 40's share: its checks and (a) here, its part of the ranks
    fam_secs = fam_rank_s + sum(
        float(p.split()[-1]) for p in parts if p.startswith("40 "))
    pool_secs = pool_rank_s + sum(
        float(p.split()[-1]) for p in parts if p.startswith("41 "))
    log(f"phase 40: {fam_secs:.1f} s, phase 41: {pool_secs:.1f} s of the "
        f"{secs:.1f} s of phases 39-41")
    for r, rk in enumerate(ranks):
        tr = rk["trace"]
        log(f"phase 39 (b) rank {r}: {rk['rows']} rows, forward "
            f"{rk['ms']:.1f} ms wall ({rk['traced_ms']:.1f} traced), peak "
            f"{rk['peak_gib']:.2f} GiB, launches {rk['launches']}; "
            f"{tr['exchanges']} exchanges {tr['exchange_bytes']} bytes "
            f"{tr['exchange_s'] * 1e3:.1f} ms, {tr['reduces']} reductions "
            f"{tr['reduce_bytes']} bytes {tr['reduce_s'] * 1e3:.1f} ms; CLI "
            f"{rk['cli']} in {rk['cli_s']:.1f} s; --spatial_shard 3: "
            f"{rk['refusal']!r}")
    log(f"phase 39: {secs:.1f} s ({', '.join(parts)} s); (b) gathered vs "
        f"one process: max abs {err['bf16_max_abs']:.4e}, elementwise use "
        f"{err['bf16_use']:.4f} of a={SPATIAL_BF16_A} max|p| + "
        f"r={SPATIAL_BF16_R} |p|, L2 {err['bf16_l2']:.3e} (bound "
        f"{SPATIAL_BF16_L2}); (c) f32 max abs {err['f32_max_abs']:.3e} "
        f"(bound {SPATIAL_F32_ATOL}), L2 {err['f32_l2']:.3e} (bound "
        f"{SPATIAL_F32_L2}); (d) CLI PSNR / SSIM {cli} against {ref['cli']}")
    want_launches = {"tblock_fused.launches": SPATIAL_B1,
                     "tblock_pipeline.launches": SPATIAL_B1}
    bad = []
    if ref["launches"] != want_launches:
        bad.append(f"(a) launches {ref['launches']}")
    for r, rk in enumerate(ranks):
        if rk["launches"] != want_launches:
            bad.append(f"rank {r} launches {rk['launches']}")
        if rk["refusal"] != "--spatial_shard 3 needs 3 ranks, have 2":
            bad.append(f"rank {r} --spatial_shard 3: {rk['refusal']!r}")
    if ranks[1]["cli"] is not None:
        bad.append(f"rank 1 scored {ranks[1]['cli']}")
    if not (err["bf16_use"] <= 1 and err["bf16_l2"] <= SPATIAL_BF16_L2):
        bad.append("(b) gathered image outside its bound")
    if not (err["f32_max_abs"] <= SPATIAL_F32_ATOL
            and err["f32_l2"] <= SPATIAL_F32_L2):
        bad.append("(c) float32 outside its bound")
    if not (d_psnr <= SPATIAL_CLI_DB and d_ssim <= SPATIAL_CLI_SSIM):
        bad.append(f"(d) CLI off by {d_psnr:.4f} dB, {d_ssim:.5f} SSIM")
    if bad:
        raise RuntimeError("phase 39: " + "; ".join(bad))
    return {"seconds": secs, "fam_seconds": fam_secs, "ref": ref,
            "ranks": ranks, "errors": err, "windows": windows,
            "fam_ref": fam_ref, "fam_errors": fam_errors,
            "fam_windows": fam_windows, "noise_windows": noise_windows,
            "pool_seconds": pool_secs, "pool_ref": pool_ref,
            "pool_errors": pool_errors}


# ---------------------------------------------------------------------------
# Phase 40: NAFNet and PromptIR split by rows over ranks (--spatial_shard)
# ---------------------------------------------------------------------------

FAMILY_SPATIAL_TASKS = (NAF_TASK, PROMPTIR_TASK)
# the kernel launches of a forward, in one process and a rank: every
# NAFBlock through B5's pipeline, every PromptIR TransformerBlock through
# B1's
FAMILY_SPATIAL_LAUNCHES = {
    NAF_TASK: {"nafblock_fused.launches": NAF_BLOCKS,
               "naf_pipeline.launches": NAF_BLOCKS},
    PROMPTIR_TASK: {"tblock_fused.launches": 55,
                    "tblock_pipeline.launches": 55}}
# B5's SCA sums' window at block shapes of the sharded forwards: a slab of
# own rows with its 1-row halos (a middle rank's), rows (own, W, C): bf16
# at (b)'s levels 0, 2 and 4 (the fusion blocks' widths), float32 at
# (c)'s (512 px, 256 rows a rank); the window takes the own rows only
NAF_WINDOW_SHAPES = {torch.bfloat16: ((768, 2048, 128), (192, 512, 512),
                                      (48, 128, 2048)),
                     torch.float32: ((256, 512, 64), (64, 128, 512),
                                     (16, 32, 2048))}
# B1's statistics window at PromptIR's noise blocks in (b) (C = 704, 320,
# 160 with 4 heads: 176, 80, 40 channels a head), (own, W, C, heads)
NOISE_WINDOW_SHAPES = ((96, 256, 704, 4), (192, 512, 320, 4),
                       (384, 1024, 160, 4))


def naf_window_vs_plain(gen, shapes=NAF_WINDOW_SHAPES,
                        dtypes=(torch.float32, torch.bfloat16)):
    """Phase 40 (e): the SCA sums of a slab with both 1-row halos taken
    over its own rows only: float32 pass A of the pair
    (`nafblock_sum_rows`, csrc/nafblock.cu) against torch's float32 sums
    over those rows of the gate computed in torch (TF32 off), and the bf16
    pipeline's SUM pass (`naf_gate_stencil_rows`, csrc/naf_stencil.cu)
    against torch's float32 sums over those rows of the same rounded gate,
    which its APPLY pass writes with a scale of 1; WINDOW_L2.  Returns
    rows (dtype, shape, L2 error, ms of the windowed sums)."""
    from textualdegremoval_tpu_torch.ops.dwconv import dwconv
    from textualdegremoval_tpu_torch.ops.norm import layer_norm_2d
    from textualdegremoval_tpu_torch.ops.pallas.tblock_bwd import _ln_rows

    lib = _build.load_library()
    stream, sms = tb._card(torch.device("cuda"))
    card_gen = torch.Generator(device="cuda").manual_seed(
        int(torch.randint(1 << 30, (1,), generator=gen)))
    rows_out = []
    for dtype in dtypes:
        for own, w, c in shapes[dtype]:
            p = naf_tool.block_params(c, gen)
            kw = nb.prepare_nafblock_weights(p, dtype)
            cpad = kw["cpad"]
            x = torch.randn(1, own + 2, w, c, generator=card_gen,
                            device="cuda").to(dtype)
            hgt, lo, hi = own + 2, 1, 1 + own
            with torch.no_grad():
                if dtype == torch.float32:
                    sum_tile, _ = nb.pick_tiles(lib, c, 4)
                    nsplit = max(1, min(-(-hgt // sum_tile[0])
                                        * -(-w // sum_tile[1]), 2 * sms))
                    part = torch.empty(1, nsplit, cpad, device="cuda")

                    def sums():
                        tb._check(lib.nafblock_sum_rows(
                            tb._ptr(x), tb._ptr(kw["ln1w"]),
                            tb._ptr(kw["ln1b"]), tb._ptr(kw["w1"]),
                            tb._ptr(kw["b1"]), tb._ptr(kw["taps"]),
                            tb._ptr(kw["dwb"]), tb._ptr(part), 1, hgt, w, c,
                            cpad, 0, *sum_tile, nsplit, lo, hi, stream),
                            lib, "nafblock_sum_rows")
                        return part.sum(1)[:, :c]
                    y = layer_norm_2d(x, p["norm1_w"], p["norm1_b"])
                    h = y @ p["w1"].reshape(c, 2 * c) + p["b1"]
                    h = dwconv(h, p["dw"]) + p["dwb"]
                    want = (h[..., :c] * h[..., c:])[:, lo:hi].sum((1, 2))
                    del y, h
                    name = "f32 nafblock_sum_rows"
                else:
                    npix = hgt * w
                    ys = _ln_rows(lib, x, kw["ln1w"], kw["ln1b"], 0, stream,
                                  nb._EPS)[0]
                    hids = torch.empty(npix, 2 * cpad, dtype=torch.bfloat16,
                                       device="cuda")
                    tb._check(lib.naf_gemm_bias(
                        tb._ptr(ys), tb._ptr(kw["w1"]), tb._ptr(kw["b1i"]),
                        None, None, tb._ptr(hids), npix, 2 * cpad, c,
                        stream), lib, "naf_gemm_bias")
                    del ys
                    nsplit = nb._naf_nsplit(lib, 1, hgt, w, cpad // 32, sms)
                    part = torch.empty(1, nsplit, cpad, device="cuda")

                    def stencil(apply, s=None, gs=None, out=None):
                        tb._check(lib.naf_gate_stencil_rows(
                            tb._ptr(hids), tb._ptr(kw["taps"]),
                            tb._ptr(kw["dwb"]), fa._ptr(s), fa._ptr(gs),
                            fa._ptr(out), 1, hgt, w, cpad, nsplit, apply, lo,
                            hi, stream), lib, "naf_gate_stencil_rows")

                    def sums():
                        stencil(0, out=part)
                        return part.sum(1)[:, :c]
                    gs = torch.empty(npix, cpad, dtype=torch.bfloat16,
                                     device="cuda")
                    stencil(1, s=torch.ones(1, cpad, device="cuda"), gs=gs)
                    want = gs.float().reshape(1, hgt, w, cpad)[
                        :, lo:hi, :, :c].sum((1, 2))
                    del gs
                    name = "bf16 naf_gate_stencil_rows"
                got = sums()
                err = _rel_l2(got, want)
                ms = median_ms(sums, reps=3)
            log(f"phase 40 (e) window {name} at own rows {own} of {hgt}, W "
                f"{w}, C {c}: L2 error {err:.3e} (bound {WINDOW_L2}), "
                f"{ms:.3f} ms")
            if not err <= WINDOW_L2:
                raise RuntimeError(f"SCA sums' window {name} at {own}x{w}x"
                                   f"{c}: L2 error {err:.3e} > {WINDOW_L2}")
            rows_out.append((str(dtype), (own, w, c), err, ms))
            del x, got, want, part
    torch.cuda.empty_cache()
    return rows_out


def _family_spatial_reference(seed: int, work: Path) -> dict:
    """Phase 40 (a) in this process, for each task of
    FAMILY_SPATIAL_TASKS: the bf16 forward of phase 39's whole image (a
    warm-up, one timed with its launches and peak, one profiled), the
    float32 forward at 512 px, and the unsharded CLI on phase 39's
    folder; the outputs to <work>/family_expected.pt."""
    from textualdegremoval_tpu_torch.cli import evaluate

    out, expected = {}, {}
    for task in FAMILY_SPATIAL_TASKS:
        r = {}
        t0 = time.perf_counter()
        model = build_network(seed, torch.bfloat16, "cuda", task)
        lq, ref = _spatial_inputs(seed, torch.bfloat16)
        with torch.inference_mode():
            model(lq, ref)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_all_counts()
            t1 = time.perf_counter()
            pred = model(lq, ref)
            torch.cuda.synchronize()
            r["ms"] = (time.perf_counter() - t1) * 1e3
            r["launches"] = {k: v for k, v in _all_counts().items() if v}
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            r["idle"] = profile_device(
                lambda: model(lq, ref),
                f"phase 40 (a) {task} {SPATIAL_HW} bf16 forward")
            r["device_ms"] = profile_device.busy_ms
        expected[task] = {"bf16": pred.float().cpu()}
        del model, lq, pred
        model = build_network(seed, torch.float32, "cuda", task)
        lq, ref = _spatial_inputs(seed, torch.float32, SPATIAL_F32_HW)
        with torch.inference_mode():
            expected[task]["f32"] = model(lq, ref).cpu()
        del model, lq, ref
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        r["cli"] = evaluate.main(_spatial_cli_argv(work, task))
        r["cli_s"] = time.perf_counter() - t1
        r["seconds"] = time.perf_counter() - t0
        log(f"phase 40 (a) {task} one process: {SPATIAL_HW} bf16 forward "
            f"{r['ms']:.1f} ms wall, {r['device_ms']:.1f} ms device busy "
            f"(idle {r['idle']}), peak {r['peak_gib']:.2f} GiB, launches "
            f"{r['launches']}; the unsharded CLI {r['cli']} in "
            f"{r['cli_s']:.1f} s; {r['seconds']:.1f} s")
        out[task] = r
        torch.cuda.empty_cache()
    torch.save(expected, work / "family_expected.pt")
    return out


def _family_spatial_job(rank: int, world: int, work: Path, seed: int):
    """Phase 40 (b)-(d) in one rank of phase 39's spawn, for each task of
    FAMILY_SPATIAL_TASKS: its slab of the whole-image bf16 forward (a
    warm-up; one untraced, timed with its launches and peak; one traced),
    gathered on rank 0; the float32 forward at 512 px likewise; the
    evaluate CLI with --spatial_shard 2."""
    from textualdegremoval_tpu_torch.cli import evaluate
    from textualdegremoval_tpu_torch.parallel import (
        CollectiveTrace, RowShard, gather_rows)

    out = {}
    for task in FAMILY_SPATIAL_TASKS:
        r = {"start_s": time.time()}
        model = build_network(seed, torch.bfloat16, "cuda", task)
        lq, ref = _spatial_inputs(seed, torch.bfloat16)
        shard = RowShard.split(lq.shape[1], model.row_unit, rank, world)
        slab = shard.slab(lq)
        del lq
        with torch.inference_mode():
            model(slab, ref, shard=shard)
            torch.cuda.synchronize()
            torch.distributed.barrier()
            torch.cuda.reset_peak_memory_stats()
            _reset_all_counts()
            t0 = time.perf_counter()
            pred = model(slab, ref, shard=shard)
            torch.cuda.synchronize()
            r["ms"] = (time.perf_counter() - t0) * 1e3
            r["launches"] = {k: v for k, v in _all_counts().items() if v}
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            trace = CollectiveTrace()
            torch.distributed.barrier()
            t0 = time.perf_counter()
            model(slab, ref, shard=dataclasses.replace(shard, trace=trace))
            torch.cuda.synchronize()
            r["traced_ms"] = (time.perf_counter() - t0) * 1e3
            r["trace"] = trace.as_dict()
            r["rows"] = shard.rows
            whole = gather_rows(pred, shard)
        if whole is not None:
            torch.save(whole.float().cpu(), work / f"family_{task}_bf16.pt")
        r["bf16_done_s"] = time.time()
        del model, slab, pred, whole
        model = build_network(seed, torch.float32, "cuda", task)
        lq, ref = _spatial_inputs(seed, torch.float32, SPATIAL_F32_HW)
        shard = RowShard.split(lq.shape[1], model.row_unit, rank, world)
        with torch.inference_mode():
            whole = gather_rows(model(shard.slab(lq), ref, shard=shard),
                                shard)
        if whole is not None:
            torch.save(whole.cpu(), work / f"family_{task}_f32.pt")
        del model, lq, ref, whole
        torch.cuda.empty_cache()
        r["f32_done_s"] = time.time()
        t0 = time.perf_counter()
        r["cli"] = evaluate.main(_spatial_cli_argv(work, task)
                                 + ["--spatial_shard", "2"])
        r["cli_s"] = time.perf_counter() - t0
        r["end_s"] = time.time()
        out[task] = r
    return out


def family_spatial_check(ref: dict, ranks: list, work: Path) -> dict:
    """Phase 40 (b)-(d) against (a), under phase 39's bounds, for each
    task: the gathered bf16 image (SPATIAL_BF16_*), the float32 one
    (SPATIAL_F32_*), the CLI's PSNR and SSIM (SPATIAL_CLI_*), and each
    rank's launches (FAMILY_SPATIAL_LAUNCHES).  Returns the errors by
    task; raises on any miss after printing every reading."""
    expected = torch.load(work / "family_expected.pt")
    h = SPATIAL_HW[0]
    errors, bad = {}, []
    for task in FAMILY_SPATIAL_TASKS:
        want = expected[task]["bf16"]
        got = torch.load(work / f"family_{task}_bf16.pt")[:, :h]
        got32 = torch.load(work / f"family_{task}_f32.pt")[
            :, : SPATIAL_F32_HW[0]]
        e = {"bf16_use": _elementwise_use(got, want, SPATIAL_BF16_A,
                                          SPATIAL_BF16_R),
             "bf16_l2": _rel_l2(got, want),
             "bf16_max_abs": float((got - want).abs().max()),
             "f32_max_abs": float((got32 - expected[task]["f32"])
                                  .abs().max()),
             "f32_l2": _rel_l2(got32, expected[task]["f32"])}
        errors[task] = e
        cli, cli_ref = ranks[0]["families"][task]["cli"], ref[task]["cli"]
        d_psnr, d_ssim = abs(cli[0] - cli_ref[0]), abs(cli[1] - cli_ref[1])
        for r, rk in enumerate(ranks):
            fr = rk["families"][task]
            tr = fr["trace"]
            log(f"phase 40 (b) {task} rank {r}: {fr['rows']} rows, forward "
                f"{fr['ms']:.1f} ms wall ({fr['traced_ms']:.1f} traced), "
                f"peak {fr['peak_gib']:.2f} GiB, launches {fr['launches']}; "
                f"{tr['exchanges']} exchanges {tr['exchange_bytes']} bytes "
                f"{tr['exchange_s'] * 1e3:.1f} ms, {tr['reduces']} "
                f"reductions {tr['reduce_bytes']} bytes "
                f"{tr['reduce_s'] * 1e3:.1f} ms; CLI {fr['cli']} in "
                f"{fr['cli_s']:.1f} s")
            if fr["launches"] != FAMILY_SPATIAL_LAUNCHES[task]:
                bad.append(f"{task} rank {r} launches {fr['launches']}")
        f0 = ranks[0]["families"][task]
        log(f"phase 40 {task}: rank 0's (b) "
            f"{f0['bf16_done_s'] - f0['start_s']:.1f} s, (c) "
            f"{f0['f32_done_s'] - f0['bf16_done_s']:.1f} s, (d) "
            f"{f0['end_s'] - f0['f32_done_s']:.1f} s; (b) gathered vs one "
            f"process: max abs {e['bf16_max_abs']:.4e}, elementwise use "
            f"{e['bf16_use']:.4f} of a={SPATIAL_BF16_A} max|p| + "
            f"r={SPATIAL_BF16_R} |p|, L2 {e['bf16_l2']:.3e} (bound "
            f"{SPATIAL_BF16_L2}); (c) f32 max abs {e['f32_max_abs']:.3e} "
            f"(bound {SPATIAL_F32_ATOL}), L2 {e['f32_l2']:.3e} (bound "
            f"{SPATIAL_F32_L2}); (d) CLI PSNR / SSIM {cli} against "
            f"{cli_ref}")
        if ref[task]["launches"] != FAMILY_SPATIAL_LAUNCHES[task]:
            bad.append(f"{task} (a) launches {ref[task]['launches']}")
        if ranks[1]["families"][task]["cli"] is not None:
            bad.append(f"{task} rank 1 scored")
        if not (e["bf16_use"] <= 1 and e["bf16_l2"] <= SPATIAL_BF16_L2):
            bad.append(f"{task} (b) gathered image outside its bound")
        if not (e["f32_max_abs"] <= SPATIAL_F32_ATOL
                and e["f32_l2"] <= SPATIAL_F32_L2):
            bad.append(f"{task} (c) float32 outside its bound")
        if not (d_psnr <= SPATIAL_CLI_DB and d_ssim <= SPATIAL_CLI_SSIM):
            bad.append(f"{task} (d) CLI off by {d_psnr:.4f} dB, "
                       f"{d_ssim:.5f} SSIM")
    if bad:
        raise RuntimeError("phase 40: " + "; ".join(bad))
    return errors


# ---------------------------------------------------------------------------
# Phase 41: DRSformer and SFNet split by rows over ranks (--spatial_shard)
# ---------------------------------------------------------------------------

POOL_SPATIAL_TASKS = (DRS_TASK, SFNET_TASKS[0])  # the full-width forwards
POOL_F32_TASKS = (DRS_TASK, DRS_SPA_TASK, SFNET_TASKS[0])  # (c) at 512 px
# (b), (c): a free-running sharded DRSformer takes other top-k masks than
# one process where the ranks' roundings reorder near-ties; at most this
# fraction of its mask entries (the upper end of what was predicted
# before the first run on the card: 1e-5 to 1e-3).  A flip moves the
# output by far more than a rounding: at a trained scale in float32, 56
# of 2 543 616 entries moved the 512 px output by up to 1.653e-3, past
# JAX's 1e-4, on an H100.  So (c) holds the sharded float32 forward with
# one process's masks replayed to SPATIAL_F32_*, and reads the
# free-running one beside it with how near their thresholds the flipped
# entries lay (`_flip_margin`)
POOL_FLIP_FRACTION = 1e-3
# (b) in L2: phase 39's SPATIAL_BF16_L2 assumes that one process's bf16
# forward reproduces itself far inside it.  DRSformer at a trained scale
# does not: the image twice in a batch of 2 (other kernels for its grams
# and convs, so other orders of summation) moves one process's output
# by more than 1e-2 in L2 on an H100, and the sharded forward's
# roundings move it as far with one process's top-k masks replayed as
# without them (PERF.md, section 6).  So the gathered image is held in
# L2 to the larger of SPATIAL_BF16_L2 and that spread, `_pool_noise`'s
# 'batch2', measured in the same run; the elementwise bound stays phase
# 39's
# (d): the sharded CLI's runs, as (task, dtype, images, held to
# SPATIAL_CLI_*).  On phase 39's odd height the sharded CLI reflect-pads a
# row that the unsharded CLI does not see (JAX's semantics), and
# DRSformer's top-k masks spread that row over the image, so each run is
# held to one process's forward on the same reflect-padded images
# (`reflect_padded_scores`, as the CPU tests hold it to JAX's).
# DRSformer's float32 runs are held; its bf16 runs, which move by the
# network's amplified roundings ((b)'s note), are read beside them with
# their top-k flips
POOL_CLI_RUNS = (
    (DRS_TASK, "float32", 1, True), (DRS_TASK, "bfloat16", 1, False),
    (DRS_SPA_TASK, "float32", 1, True), (DRS_SPA_TASK, "bfloat16", 1, False),
    (SFNET_TASKS[0], "bfloat16", SPATIAL_CLI_IMAGES, True),
    (SFNET_TASKS[1], "bfloat16", SPATIAL_CLI_IMAGES, True))


def _pool_cli_argv(work: Path, task: str, dtype: str, images: int) -> list:
    return _spatial_cli_argv(work, task) + [
        "--dtype", dtype, "--max_images", str(images)]


def reflect_padded_scores(work: Path, task: str, dtype: str, images: int,
                          world=SPATIAL_WORLD):
    """What the sharded CLI (`_pool_cli_argv`) computes, in one process:
    each image of the folder read and degraded as the CLI does (sigma 15,
    RandomState(0)), lq reflect-padded on H to a multiple of `world`, the
    CLI's network (seed 0's init, in `dtype`) on it whole, cropped back
    and scored.  Returns (mean PSNR, mean SSIM)."""
    from textualdegremoval_tpu_torch.cli import evaluate
    from textualdegremoval_tpu_torch.data import imread_f32, scan_images

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = define_network(dict(evaluate.TASK_TABLE[task]),
                               dtype=getattr(torch, dtype)).to("cuda")
    refs = scan_images(str(work / "ref"))
    psnrs, ssims = [], []
    for i, path in enumerate(scan_images(str(work / "hq"))[:images]):
        hq = imread_f32(path)
        ref = imread_f32(refs[min(i, len(refs) - 1)])
        rng = np.random.RandomState(0)
        lq = hq + rng.randn(*hq.shape).astype(np.float32) * (15 / 255.0)
        lq = np.pad(lq, ((0, (-lq.shape[0]) % world), (0, 0), (0, 0)),
                    "reflect")
        with torch.inference_mode():
            out = model(torch.from_numpy(lq)[None].cuda(),
                        torch.from_numpy(ref)[None].cuda())
        pred = np.clip(evaluate.last_output(out)[0, : hq.shape[0]].float()
                       .cpu().numpy(), 0, 1)
        psnrs.append(evaluate.calculate_psnr(pred * 255, hq * 255))
        ssims.append(evaluate.calculate_ssim(pred * 255, hq * 255))
    del model
    torch.cuda.empty_cache()
    return float(np.mean(psnrs)), float(np.mean(ssims))


def trained_scale(model, seed: int):
    """Seeded weights at a trained network's scale, drawn as the CPU tests
    draw them (tests/test_torch_spatial.py `trained_scale`, numpy's
    generator of `seed`): matrices and conv kernels N(0, 1/fan_in),
    LayerNorm weights 1 + N(0, 0.1^2), fusion gates in [0.25, 0.75],
    temperatures in [0.5, 1.5], the rest N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("temperature"):
                v = 0.5 + rng.random(p.shape, np.float32)
            elif p.dim() > 1:
                v = (rng.standard_normal(p.shape)
                     * p[0].numel() ** -0.5).astype(np.float32)
            elif name.endswith("alpha"):
                v = 0.25 + 0.5 * rng.random(p.shape, np.float32)
            else:
                v = (rng.standard_normal(p.shape) * 0.1).astype(np.float32)
                if name.endswith("weight"):
                    v = v + 1.0
            p.copy_(torch.from_numpy(np.ascontiguousarray(v)))
    return model


def _pool_network(seed, task, dtype):
    """A DRSformer or SFNet task's network at full width on the card.
    DRSformer's at a trained scale (`trained_scale`).  SFNet's at
    PyTorch's init with `_family_network`'s gates and BatchNorm statistics
    and its zero-initialised Gap scales and PatchAP h and l drawn in
    [0.25, 0.75], so that every pool reaches the output: at the trained
    scale the full-width SFNet's 99 residual blocks, which no norm
    follows, grow its outputs past 7e5 on phase 39's image."""
    model = _family_network(seed, task, dtype, "cpu")
    if task not in SFNET_TASKS:
        return trained_scale(model, seed).to("cuda")
    gen = torch.Generator().manual_seed(seed + 41)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("fscale_d", "fscale_h", "h", "l"):
                p.copy_(0.25 + 0.5 * torch.rand(p.shape, generator=gen))
    return model.to("cuda")


class recorded_masks:
    """While entered, every call of ops/attention.py `tksa_masks` (a TKSA
    gram's four top-k masks) appends its masks, stacked, to `into` on the
    host, and its gram to `grams` where given."""

    def __init__(self, into: list, grams: list | None = None):
        self.into, self.grams = into, grams

    def __enter__(self):
        from textualdegremoval_tpu_torch.ops import attention

        self.kept = attention.tksa_masks

        def record(attn):
            masks = self.kept(attn)
            self.into.append(torch.stack(masks).cpu())
            if self.grams is not None:
                self.grams.append(attn.float().cpu())
            return masks
        attention.tksa_masks = record
        return self

    def __exit__(self, *exc):
        from textualdegremoval_tpu_torch.ops import attention

        attention.tksa_masks = self.kept


class replayed_masks:
    """While entered, the n-th call of ops/attention.py `tksa_masks` returns
    the n-th of `masks` (another run's `recorded_masks`) in place of the
    masks of its own gram; on leaving, every one of them must have been
    taken."""

    def __init__(self, masks: list):
        self.masks = masks

    def __enter__(self):
        from textualdegremoval_tpu_torch.ops import attention

        self.kept, self.taken = attention.tksa_masks, 0

        def replay(attn):
            masks = self.masks[self.taken].to(attn.device)
            self.taken += 1
            if masks.shape[1:] != attn.shape:
                raise RuntimeError(f"TKSA call {self.taken}: masks of "
                                   f"{tuple(masks.shape[1:])}, a gram of "
                                   f"{tuple(attn.shape)}")
            return list(masks.unbind(0))
        attention.tksa_masks = replay
        return self

    def __exit__(self, exc_type, *exc):
        from textualdegremoval_tpu_torch.ops import attention

        attention.tksa_masks = self.kept
        if exc_type is None and self.taken != len(self.masks):
            raise RuntimeError(f"TKSA masks: {self.taken} calls replayed "
                               f"{len(self.masks)}")


def _flips(got: list, want: list) -> tuple[int, int]:
    """(entries whose top-k membership differs, entries) over the masks of
    two runs of one network, call by call."""
    if len(got) != len(want):
        raise RuntimeError(f"TKSA masks: {len(got)} calls against "
                           f"{len(want)}")
    return (sum(int((g != w).sum()) for g, w in zip(got, want)),
            sum(w.numel() for w in want))


def _flip_margin(got: list, want: list, grams: list) -> float:
    """How near its threshold the furthest flipped entry lay: over every
    entry whose top-k membership differs between two runs (`_flips`), the
    largest distance of its one-process gram value (`grams`, the run of
    `want`) from its row's k-th largest at the level that flipped, over
    the row's range.  Near 0 where only near-ties flip."""
    worst = 0.0
    for g, w, a in zip(got, want, grams):
        differ = g != w
        if not differ.any():
            continue
        c = a.shape[-1]
        ks = [int(c / 2), int(c * 2 / 3), int(c * 3 / 4), int(c * 4 / 5)]
        top = torch.topk(a, max(ks), dim=-1).values
        span = (a.amax(-1, keepdim=True) - a.amin(-1, keepdim=True))
        for i, kk in enumerate(ks):
            m = ((a - top[..., kk - 1: kk]).abs()
                 / span.clamp_min(1e-30))[differ[i]]
            if m.numel():
                worst = max(worst, float(m.max()))
    return worst


def _scale_layouts(shard, n: int) -> list:
    """The layouts of a network's n outputs, coarse to fine (SFNet's
    three scales; one for the others)."""
    return [shard.scaled(2 ** (n - 1 - i)) for i in range(n)]


def _scale_errors(got: list, want: list) -> dict:
    """Every output scale of got (its rows cropped to want's) against
    want's: the largest elementwise use of SPATIAL_BF16_A / _R, relative
    L2 and max abs."""
    e = {"use": 0.0, "l2": 0.0, "max_abs": 0.0}
    for g, w in zip(got, want):
        g = g[:, : w.shape[1]]
        e["use"] = max(e["use"], _elementwise_use(g, w, SPATIAL_BF16_A,
                                                  SPATIAL_BF16_R))
        e["l2"] = max(e["l2"], _rel_l2(g, w))
        e["max_abs"] = max(e["max_abs"], float((g.float() - w.float())
                                               .abs().max()))
    return e


def _f32_errors(got: list, want: list) -> dict:
    """Every output scale of got (its rows cropped to want's) against
    want's: the largest max abs and relative L2."""
    e = {"max_abs": 0.0, "l2": 0.0}
    for g, w in zip(got, want):
        g = g[:, : w.shape[1]]
        e["max_abs"] = max(e["max_abs"], float((g - w).abs().max()))
        e["l2"] = max(e["l2"], _rel_l2(g, w))
    return e


def _describe(e: dict) -> str:
    return (f"max abs {e['max_abs']:.4e}, elementwise use {e['use']:.4f}, "
            f"L2 {e['l2']:.3e}")


def _pool_noise(model, lq, ref, want: list, want_masks: list,
                seed: int) -> dict:
    """How far one process's bf16 forward moves under roundings alone,
    against its own output `want` and masks: 'batch2', the image twice in
    a batch of 2 (other GEMM and conv shapes, so other kernels and orders
    of summation); 'ulp', the bf16 input one ulp up at a seeded half of
    its entries.  Each: `_scale_errors` and top-k flips."""
    gen = torch.Generator().manual_seed(seed + 41)
    pick = (torch.rand(lq.shape, generator=gen) < 0.5).to(lq.device)
    bumped = (lq.view(torch.int16) + pick.to(torch.int16)).view(lq.dtype)
    out = {}
    for name, fn in (
            ("batch2", lambda: [o[:1] for o in _outputs(
                model(torch.cat([lq, lq]), torch.cat([ref, ref])))]),
            ("ulp", lambda: _outputs(model(bumped, ref)))):
        masks = []
        with torch.inference_mode(), recorded_masks(masks):
            got = [o.float().cpu() for o in fn()]
        out[name] = dict(_scale_errors(got, want),
                         flips=_flips(masks, want_masks))
        del got
        torch.cuda.empty_cache()
    return out


def _pool_spatial_reference(seed: int, work: Path) -> dict:
    """Phase 41 (a) in this process: for each task of POOL_SPATIAL_TASKS
    the bf16 forward of phase 39's whole image (a warm-up recording TKSA's
    masks, one timed with its launches and peak, one profiled) and its
    moves under roundings alone (`_pool_noise`); for each of
    POOL_F32_TASKS the float32 forward at 512 px (its masks recorded); for
    each run of POOL_CLI_RUNS `reflect_padded_scores` ((d)'s reference,
    its masks recorded).  The outputs, masks and TKSA grams to
    <work>/pool_expected.pt, the masks also to <work>/pool_masks.pt for
    the ranks."""
    out, expected = {"padded": {}, "padded_masks": {}}, {}
    for task in POOL_SPATIAL_TASKS:
        r, e = {}, {"bf16_masks": [], "bf16_grams": []}
        t0 = time.perf_counter()
        model = _pool_network(seed, task, torch.bfloat16)
        lq, ref = _spatial_inputs(seed, torch.bfloat16)
        with torch.inference_mode():
            with recorded_masks(e["bf16_masks"], e["bf16_grams"]):
                model(lq, ref)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_all_counts()
            t1 = time.perf_counter()
            pred = model(lq, ref)
            torch.cuda.synchronize()
            r["ms"] = (time.perf_counter() - t1) * 1e3
            r["launches"] = {k: v for k, v in _all_counts().items() if v}
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            r["idle"] = profile_device(
                lambda: model(lq, ref),
                f"phase 41 (a) {task} {SPATIAL_HW} bf16 forward")
            r["device_ms"] = profile_device.busy_ms
        e["bf16"] = [o.float().cpu() for o in _outputs(pred)]
        del pred
        torch.cuda.empty_cache()
        r["noise"] = _pool_noise(model, lq, ref, e["bf16"], e["bf16_masks"],
                                 seed)
        del model, lq, ref
        torch.cuda.empty_cache()
        r["seconds"] = time.perf_counter() - t0
        log(f"phase 41 (a) {task} one process: {SPATIAL_HW} bf16 forward "
            f"{r['ms']:.1f} ms wall, {r['device_ms']:.1f} ms device busy "
            f"(idle {r['idle']}), peak {r['peak_gib']:.2f} GiB, launches "
            f"{r['launches']}, {len(e['bf16_masks'])} TKSA calls; under "
            "roundings alone: " + "; ".join(
                f"{k} {_describe(v)}, top-k flips {v['flips']}"
                for k, v in r["noise"].items())
            + f"; {r['seconds']:.1f} s")
        out[task], expected[task] = r, e
    for task in POOL_F32_TASKS:
        t0 = time.perf_counter()
        e = expected.setdefault(task, {})
        e["f32_masks"], e["f32_grams"] = [], []
        model = _pool_network(seed, task, torch.float32)
        lq, ref = _spatial_inputs(seed, torch.float32, SPATIAL_F32_HW)
        with torch.inference_mode(), recorded_masks(e["f32_masks"],
                                                    e["f32_grams"]):
            e["f32"] = [o.cpu() for o in _outputs(model(lq, ref))]
        del model, lq, ref
        torch.cuda.empty_cache()
        out.setdefault(task, {})["f32_s"] = time.perf_counter() - t0
    for task, dtype, images, _ in POOL_CLI_RUNS:
        masks = []
        with recorded_masks(masks):
            out["padded"][task, dtype] = reflect_padded_scores(
                work, task, dtype, images)
        out["padded_masks"][task, dtype] = masks
    log("phase 41 (a) one process on the reflect-padded images: "
        + "; ".join(f"{t} {d} {v}" for (t, d), v in out["padded"].items()))
    torch.save(expected, work / "pool_expected.pt")
    torch.save({(t, d): expected[t][f"{d}_masks"] for t in expected
                for d in ("bf16", "f32") if f"{d}_masks" in expected[t]},
               work / "pool_masks.pt")
    return out


def _pool_spatial_job(rank: int, world: int, work: Path, seed: int):
    """Phase 41 (b)-(d) in one rank of phase 39's spawn: for each task of
    POOL_SPATIAL_TASKS its slab of the whole-image bf16 forward (a warm-up
    recording TKSA's masks; one untraced, timed with its launches and
    peak; one traced; where TKSA runs, one with (a)'s masks replayed),
    every output gathered on rank 0 at its layout; for each of
    POOL_F32_TASKS the float32 forward at 512 px likewise (masks
    recorded; where TKSA runs, one more with (a)'s masks replayed); then
    the evaluate CLI with --spatial_shard 2 for each run
    of POOL_CLI_RUNS (masks recorded)."""
    from textualdegremoval_tpu_torch.cli import evaluate
    from textualdegremoval_tpu_torch.parallel import (
        CollectiveTrace, RowShard, gather_rows)

    out = {"cli": {}, "cli_s": {}, "cli_masks": {}}
    one_process_masks = torch.load(work / "pool_masks.pt")

    def gathered(pred, shard):
        whole = [gather_rows(o, s) for o, s in
                 zip(pred, _scale_layouts(shard, len(pred)))]
        return [w.float().cpu() for w in whole if w is not None]

    for task in POOL_SPATIAL_TASKS:
        r = {"start_s": time.time()}
        got = {"bf16_masks": []}
        model = _pool_network(seed, task, torch.bfloat16)
        lq, ref = _spatial_inputs(seed, torch.bfloat16)
        shard = RowShard.split(lq.shape[1], model.row_unit, rank, world)
        slab = shard.slab(lq)
        del lq
        with torch.inference_mode():
            with recorded_masks(got["bf16_masks"]):
                model(slab, ref, shard=shard)
            torch.cuda.synchronize()
            torch.distributed.barrier()
            torch.cuda.reset_peak_memory_stats()
            _reset_all_counts()
            t0 = time.perf_counter()
            pred = _outputs(model(slab, ref, shard=shard))
            torch.cuda.synchronize()
            r["ms"] = (time.perf_counter() - t0) * 1e3
            r["launches"] = {k: v for k, v in _all_counts().items() if v}
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            trace = CollectiveTrace()
            torch.distributed.barrier()
            t0 = time.perf_counter()
            model(slab, ref, shard=dataclasses.replace(shard, trace=trace))
            torch.cuda.synchronize()
            r["traced_ms"] = (time.perf_counter() - t0) * 1e3
            r["trace"] = trace.as_dict()
            r["rows"] = shard.rows
            got["bf16"] = gathered(pred, shard)
            del pred
            if one_process_masks[task, "bf16"]:
                with replayed_masks(one_process_masks[task, "bf16"]):
                    got["replay"] = gathered(
                        _outputs(model(slab, ref, shard=shard)), shard)
        if rank == 0:
            torch.save(got, work / f"pool_{task}.pt")
        del model, slab, got
        torch.cuda.empty_cache()
        r["end_s"] = time.time()
        out[task] = r
    for task in POOL_F32_TASKS:
        t0 = time.perf_counter()
        got = {"f32_masks": []}
        model = _pool_network(seed, task, torch.float32)
        lq, ref = _spatial_inputs(seed, torch.float32, SPATIAL_F32_HW)
        shard = RowShard.split(lq.shape[1], model.row_unit, rank, world)
        slab = shard.slab(lq)
        with torch.inference_mode():
            with recorded_masks(got["f32_masks"]):
                got["f32"] = gathered(
                    _outputs(model(slab, ref, shard=shard)), shard)
            if one_process_masks[task, "f32"]:
                with replayed_masks(one_process_masks[task, "f32"]):
                    got["replay"] = gathered(
                        _outputs(model(slab, ref, shard=shard)), shard)
        if rank == 0:
            torch.save(got, work / f"pool_f32_{task}.pt")
        del model, lq, ref, slab, got
        torch.cuda.empty_cache()
        out.setdefault(task, {})["f32_s"] = time.perf_counter() - t0
    for task, dtype, images, _ in POOL_CLI_RUNS:
        t0 = time.perf_counter()
        masks = []
        with recorded_masks(masks):
            out["cli"][task, dtype] = evaluate.main(
                _pool_cli_argv(work, task, dtype, images)
                + ["--spatial_shard", "2"])
        out["cli_s"][task, dtype] = time.perf_counter() - t0
        out["cli_masks"][task, dtype] = masks if rank == 0 else None
    out["end_s"] = time.time()
    return out


def pool_spatial_check(ref: dict, ranks: list, work: Path) -> dict:
    """Phase 41 (b)-(d) against (a).  (b): no launch in (a) or a rank;
    every scale of the gathered bf16 output under phase 39's elementwise
    bound and in L2 within the larger of SPATIAL_BF16_L2 and (a)'s own
    batch-2 spread; DRSformer's top-k flips at most POOL_FLIP_FRACTION of
    the entries, its output with (a)'s masks replayed read beside;
    (c): every scale of the float32 output (SPATIAL_F32_*), DRSformer's
    with (a)'s masks replayed, its flips bounded as in (b) and its
    free-running output read beside; (d): each held run of
    POOL_CLI_RUNS within SPATIAL_CLI_* of one process on the same
    reflect-padded images, the others read, each with its flips; rank 1
    scoring nothing.  Returns the errors by task; raises on any miss after
    printing every reading."""
    expected = torch.load(work / "pool_expected.pt")
    errors, bad = {}, []
    for task in POOL_SPATIAL_TASKS:
        want, got = expected[task], torch.load(work / f"pool_{task}.pt")
        e = {"free": _scale_errors(got["bf16"], want["bf16"]),
             "flips": _flips(got["bf16_masks"], want["bf16_masks"]),
             "margin": _flip_margin(got["bf16_masks"], want["bf16_masks"],
                                    want["bf16_grams"]),
             "noise": ref[task]["noise"]}
        if "replay" in got:
            e["replay"] = _scale_errors(got["replay"], want["bf16"])
        errors[task] = e
        for r, rk in enumerate(ranks):
            fr = rk["pools"][task]
            tr = fr["trace"]
            log(f"phase 41 (b) {task} rank {r}: {fr['rows']} rows, forward "
                f"{fr['ms']:.1f} ms wall ({fr['traced_ms']:.1f} traced), "
                f"peak {fr['peak_gib']:.2f} GiB, launches {fr['launches']}; "
                f"{tr['exchanges']} exchanges {tr['exchange_bytes']} bytes "
                f"{tr['exchange_s'] * 1e3:.1f} ms, {tr['reduces']} "
                f"reductions {tr['reduce_bytes']} bytes "
                f"{tr['reduce_s'] * 1e3:.1f} ms, {tr['gathers']} gathers")
            if fr["launches"]:
                bad.append(f"{task} rank {r} launched {fr['launches']}")
        f0 = ranks[0]["pools"][task]
        n_flip, n_mask = e["flips"]
        log(f"phase 41 (b) {task}: rank 0's {f0['end_s'] - f0['start_s']:.1f}"
            f" s; gathered vs one process over {len(want['bf16'])} "
            f"scale(s) (bounds: elementwise use 1 of a={SPATIAL_BF16_A} "
            f"max|p| + r={SPATIAL_BF16_R} |p|, L2 the larger of "
            f"{SPATIAL_BF16_L2} and batch2's): {_describe(e['free'])}"
            + (f", top-k flips {n_flip} of {n_mask} mask entries "
               f"({n_flip / n_mask:.3e}, bound {POOL_FLIP_FRACTION}; "
               f"{len(want['bf16_masks'])} TKSA calls; the furthest "
               f"{e['margin']:.3e} of its row's range from its threshold); "
               f"with one process's "
               f"masks replayed {_describe(e['replay'])}"
               if "replay" in e else "")
            + "; one process under roundings alone: " + "; ".join(
                f"{k} {_describe(v)}, top-k flips {v['flips']}"
                for k, v in e["noise"].items()))
        if ref[task]["launches"]:
            bad.append(f"{task} (a) launched {ref[task]['launches']}")
        l2_bound = max(SPATIAL_BF16_L2, e["noise"]["batch2"]["l2"])
        e["l2_bound"] = l2_bound
        if e["free"]["l2"] > SPATIAL_BF16_L2:
            log(f"phase 41 (b) {task}: free-running L2 "
                f"{e['free']['l2']:.3e} over phase 39's {SPATIAL_BF16_L2}, "
                f"inside one process's own batch-2 spread {l2_bound:.3e}")
        if not (e["free"]["use"] <= 1 and e["free"]["l2"] <= l2_bound):
            bad.append(f"{task} (b) gathered output outside its bound")
        if n_flip > POOL_FLIP_FRACTION * n_mask:
            bad.append(f"{task} (b) {n_flip} top-k flips of {n_mask}")
    for task in POOL_F32_TASKS:
        want = expected[task]
        got = torch.load(work / f"pool_f32_{task}.pt")
        e = {"free": _f32_errors(got["f32"], want["f32"]),
             "flips": _flips(got["f32_masks"], want["f32_masks"]),
             "margin": _flip_margin(got["f32_masks"], want["f32_masks"],
                                    want["f32_grams"])}
        if "replay" in got:
            e["replay"] = _f32_errors(got["replay"], want["f32"])
        errors.setdefault(task, {})["f32"] = e
        n_flip, n_mask = e["flips"]
        log(f"phase 41 (c) {task}: {SPATIAL_F32_HW} float32 sharded vs one "
            f"process over {len(want['f32'])} scale(s) (bounds: max abs "
            f"{SPATIAL_F32_ATOL}, L2 {SPATIAL_F32_L2}): "
            + (f"with one process's masks replayed max abs "
               f"{e['replay']['max_abs']:.3e}, L2 {e['replay']['l2']:.3e} "
               "(held); free-running " if "replay" in e else "")
            + f"max abs {e['free']['max_abs']:.3e}, L2 {e['free']['l2']:.3e}"
            f", top-k flips {n_flip} of {n_mask} (bound "
            f"{POOL_FLIP_FRACTION} of them; the furthest {e['margin']:.3e} "
            f"of its row's range from its threshold); rank 0's "
            f"{ranks[0]['pools'][task]['f32_s']:.1f} s")
        held = e.get("replay", e["free"])
        if not (held["max_abs"] <= SPATIAL_F32_ATOL
                and held["l2"] <= SPATIAL_F32_L2):
            bad.append(f"{task} (c) float32 outside its bound")
        if n_flip > POOL_FLIP_FRACTION * n_mask:
            bad.append(f"{task} (c) {n_flip} top-k flips of {n_mask}")
    pools = ranks[0]["pools"]
    for task, dtype, _, held in POOL_CLI_RUNS:
        key = task, dtype
        cli, cli_ref = pools["cli"][key], ref["padded"][key]
        d_psnr, d_ssim = abs(cli[0] - cli_ref[0]), abs(cli[1] - cli_ref[1])
        flips = _flips(pools["cli_masks"][key], ref["padded_masks"][key])
        errors.setdefault(task, {})[f"cli {dtype}"] = (d_psnr, d_ssim, flips)
        log(f"phase 41 (d) {task} {dtype}: --spatial_shard 2 {cli} in "
            f"{pools['cli_s'][key]:.1f} s against one process on the "
            f"reflect-padded images {cli_ref}: {d_psnr:.3e} dB, "
            f"{d_ssim:.3e} SSIM ("
            + (f"bounds {SPATIAL_CLI_DB}, {SPATIAL_CLI_SSIM}" if held
               else "read") + f"), top-k flips {flips[0]} of {flips[1]}")
        if ranks[1]["pools"]["cli"][key] is not None:
            bad.append(f"{task} {dtype} rank 1 scored")
        if held and not (d_psnr <= SPATIAL_CLI_DB
                         and d_ssim <= SPATIAL_CLI_SSIM):
            bad.append(f"{task} {dtype} (d) CLI off by {d_psnr:.4f} dB, "
                       f"{d_ssim:.5f} SSIM")
    if bad:
        raise RuntimeError("phase 41: " + "; ".join(bad))
    return errors


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------

PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_F32 = 67e12  # float32 FLOP/s outside the tensor cores, H100 SXM
PEAK_BYTES = 3.35e12  # HBM3 bytes/s, H100 SXM


# -- phase 38: the distributed path, two ranks sharing the card -------------
#
# NCCL refuses two ranks on one device, so the port's rule picks gloo here
# (parallel/bootstrap.py `backend_for`): the ranks' collectives go through
# the host.  That shows the port's collectives on CUDA tensors and the
# step's result; it says nothing of NCCL or of several cards.
DIST_WORLD = 2
DIST_TIMEOUT = 600  # s for one spawn's ranks, build of the state included
DIST_BATCH = 8  # (a), (b): the global batch, 4 images a rank
DIST_TRAIN = dict(TRAIN_OPT["train"], param_fix_iterations=0)
# (a) and (b) against the single process on the whole batch.  Each launch
# of B1-B3 works on one image, so only the batch's sums (the loss, every
# weight gradient over the pixels, the reduce) group differently, and
# cuDNN may pick another algorithm for a batch of 4 than of 8 (bf16
# activations could round differently there).  Bounds: the loss 1e-4
# relative, the global norm 2e-3, each parameter's gradient within 1e-2 of
# its norm in L2 plus 1e-5 of the global norm (phase 32's floor for
# gradients that vanish in exact arithmetic).  The updated parameters:
# Adam's first update is lr (g / (|g| + eps) + wd p), so an element whose
# gradient is near 0 may take either sign (C3), and the bound is on the
# update, not the gradient.  Where the single process's update is
# saturated (|u| >= 0.9 of the element's lr: |g| >= 9 eps after the clip)
# the two updates must agree within 2e-2 lr, plus one f32 rounding of
# p + u on each side (2^-22 |p0|); and the share of elements whose updates
# differ by more than 0.5 lr must stay under 1e-6.  Both are set from the
# readings on an H100: the reduced step's saturated error 5.4e-3 lr (its
# bf16 gradients: a 6% error on an element at 9 eps), its share 0 of
# 60 096 138 elements; the stale plant 1.99 lr and 5.8e-5 / 6.2e-5; f32
# DiffIR in (c) 2.6e-7 lr.  The sum without division moves no update
# (Adam and the clip are scale-free); its loss, norm and gradients fail.
# The reduced step read 6.4e-7, 2.0e-4 and 0.28 of the gradient bound
# (the same cuDNN choices at batch 4 and 8); the stale plant 8.2e-4,
# 8.0e-3 and 2.9 of it, the sum without division 1.0, 1.0 and 100.
# Every check is written so that a NaN fails it.
DIST_LOSS_REL, DIST_NORM_REL = 1e-4, 2e-3
DIST_GRAD_REL, DIST_GRAD_FLOOR = 1e-2, 1e-5
DIST_SATURATED, DIST_SATURATED_TOL = 0.9, 2e-2  # of the element's lr
DIST_OVER_HALF = 1e-6  # share of elements whose updates differ > 0.5 lr
# (c): NAFNetDynamicFusion at full width, f32 at 256 px, 2 images a rank;
# its depth cut to 4 blocks in the deepest encoder level (of 28): 482 M
# parameters, 459 M of them in the affine heads, in 268 tensors (the
# whole net's 1.78 B in 772 took 63 s of the script's 1200 with the
# collectives through the host)
DIFFIR_DIST_BATCH = 2
DIFFIR_DIST_NET = dict(DIFFIR_NET, enc_blk_nums=[1, 1, 1, 4])


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_restormer(seed: int):
    """(a)'s network: restormer_motion_deblur.yml's at full width, bf16
    compute with f32 parameters, seeded as phase 7's."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, _, _ = resolve_network(TRAIN_OPT, mixed_precision="bf16")
    return gate_and_temperatures(model, seed).cuda()


def _dist_batch(seed: int, rank: int | None = None) -> dict:
    """(a)'s global batch of DIST_BATCH seeded 384 px triples on the card,
    or rank `rank`'s equal share of it."""
    rng = np.random.default_rng(seed + 38)
    trip = [synthetic_triple(rng, 384) for _ in range(DIST_BATCH)]
    if rank is not None:
        per = DIST_BATCH // DIST_WORLD
        trip = trip[rank * per: (rank + 1) * per]
    return {k: torch.from_numpy(np.stack([t[i] for t in trip])).cuda()
            for i, k in enumerate(("lq", "gt", "ref"))}


def _captured_step(step_fn, state, batch):
    """(state, metrics, the gradients as the step hands them to the
    optimizer) of one step."""
    seen = []
    update = state.opt.step

    def capture(gs):
        seen.extend(gs)
        update(gs)

    state.opt.step = capture
    try:
        state, m = step_fn(state, batch)
    finally:
        state.opt.__dict__.pop("step", None)  # no cycle through `capture`
    return state, m, seen


def _worst(a: float, b: float) -> float:
    """The larger of a and b, NaN where either is NaN."""
    return a if (a != a or a >= b) else b


def _dist_errors(m, grads, params, init, lrs, want) -> dict:
    """The step against the single process's (`want`: l_pix, grad_norm,
    grads and params by name, each as `grads` and `params` hold it: whole
    or this rank's FSDP slice): relative loss and norm errors, the largest
    gradient error as a share of its bound, the largest error of a
    saturated update in lr beyond the rounding, and the share of elements
    whose updates differ by more than 0.5 lr.  init: the parameters before
    the step, lrs: each parameter's lr, by name.  A NaN anywhere fails."""
    total = want["grad_norm"]
    g_use = sat_err = 0.0
    over = n = 0
    for name in want["params"]:
        w = want["grads"][name].cuda()
        bound = DIST_GRAD_REL * float(w.norm()) + DIST_GRAD_FLOOR * total
        g_use = _worst(g_use, float((grads[name].float() - w).norm())
                       / bound)
        p0 = init[name].cuda().float()
        wp = want["params"][name].cuda()
        lr = lrs[name]
        d = (params[name].detach().float() - wp).abs()
        sat = (wp - p0).abs() >= DIST_SATURATED * lr
        if sat.any():
            rounding = 2.0 ** -22 * p0.abs()
            sat_err = _worst(sat_err, float(
                (d - rounding)[sat].max()) / lr)
        over += int((~(d <= 0.5 * lr)).sum())
        n += d.numel()
    loss_rel = abs(float(m["l_pix"]) - want["l_pix"]) / abs(want["l_pix"])
    norm_rel = abs(float(m["grad_norm"]) - total) / total
    ok = (loss_rel <= DIST_LOSS_REL and norm_rel <= DIST_NORM_REL
          and g_use <= 1.0 and sat_err <= DIST_SATURATED_TOL
          and over / n <= DIST_OVER_HALF)
    return {"loss_rel": loss_rel, "norm_rel": norm_rel, "grad_use": g_use,
            "saturated_lr": sat_err, "over_half_lr": over / n, "ok": ok}


def _fmt(e: dict) -> str:
    return (f"l_pix rel {e['loss_rel']:.3e} (bound {DIST_LOSS_REL}), "
            f"grad_norm rel {e['norm_rel']:.3e} ({DIST_NORM_REL}), gradient "
            f"bound use {e['grad_use']:.3f}, saturated update error max "
            f"{e['saturated_lr']:.3e} lr ({DIST_SATURATED_TOL}), share over "
            f"0.5 lr {e['over_half_lr']:.2e} ({DIST_OVER_HALF})")


def _lrs(opt) -> dict:
    """Each parameter's lr at the first update, by name."""
    by_group = opt.lrs(opt.count)
    return {n: by_group[m] for n, m in zip(opt.names, opt.masa)}


def _reduce_without_division(tensors):
    """Planted fault: the sum over the ranks in place of the mean."""
    out = [t.detach().clone() for t in tensors]
    for t in out:
        torch.distributed.all_reduce(t)
    return out


def _reduce_stale_copy(tensors):
    """Planted fault: reduces a copy, hands back the rank's own values."""
    from textualdegremoval_tpu_torch.parallel.mesh import all_reduce_mean

    all_reduce_mean([t.detach().clone() for t in tensors])
    return list(tensors)


DIST_PLANTS = {"no_division": _reduce_without_division,
               "stale_copy": _reduce_stale_copy}
DIST_KERNELS = (tb.tblock_fused, gb.gdfn_half_bwd, ab.attn_half_bwd)


def _synced_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _dist_dp_job(rank: int, world: int, work: Path, seed: int) -> dict:
    """(a) and (b) on one rank: the reduced step of the training CLI's step
    function from the seeded state on this rank's 4 images, against the
    parent's single process on all 8; the planted reduces; the reduce
    timed apart; then one FSDP step of the same step function from the
    same state against it."""
    from textualdegremoval_tpu_torch.parallel import all_reduce_mean
    from textualdegremoval_tpu_torch.parallel import replicate
    from textualdegremoval_tpu_torch.parallel.fsdp import shard_train_state
    from textualdegremoval_tpu_torch.train import trainer

    want = torch.load(work / "dp_expected.pt", weights_only=True)
    batch = _dist_batch(seed, rank)
    model = _dist_restormer(seed)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    names = [n for n, _ in model.named_parameters()]

    def fresh():
        model.load_state_dict(init)
        state, step_fn, _ = _trainer(model, DIST_TRAIN)
        return replicate(state), step_fn

    state, step_fn = fresh()
    step_fn(state, batch)  # warm-up: kernel weights, cuDNN's choices
    state, step_fn = fresh()
    lrs = _lrs(state.opt)
    for k in DIST_KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    state, m, grads = _captured_step(step_fn, state, batch)
    float(m["l_pix"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = [k.launches for k in DIST_KERNELS]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dp_params = {n: p.detach().clone() for n, p in zip(names,
                                                       state.opt.params)}
    dp_grads = dict(zip(names, grads))
    err = _dist_errors(m, dp_grads, dp_params, init, lrs, want)
    dp_m = {k: float(v) for k, v in m.items()}
    log(f"phase 38 (a) rank {rank}: step {step_ms:.1f} ms, launches "
        f"{'/'.join(k.__name__ for k in DIST_KERNELS)} {launches}, peak "
        f"{peak:.2f} GiB; against one process on {DIST_BATCH} images: "
        + _fmt(err))
    if not err["ok"] or launches != [52, 52, 52]:
        raise RuntimeError(f"phase 38 (a) rank {rank}: {err}, launches "
                           f"{launches}")
    # the reduce alone, on the step's gradients: its ms and bytes
    nbytes = sum(g.numel() * g.element_size() for g in grads)
    reduce_ms = statistics.median(
        _synced_ms(lambda: all_reduce_mean(grads)) for _ in range(3))
    planted = {}
    honest = trainer.all_reduce_mean
    for name, plant in DIST_PLANTS.items():
        state, step_fn = fresh()
        trainer.all_reduce_mean = plant
        try:
            state, pm, pg = _captured_step(step_fn, state, batch)
        finally:
            trainer.all_reduce_mean = honest
        pe = _dist_errors(pm, dict(zip(names, pg)),
                          dict(zip(names, state.opt.params)), init, lrs,
                          want)
        log(f"phase 38 (a) rank {rank} planted {name}: " + _fmt(pe))
        if pe["ok"]:
            raise RuntimeError(f"phase 38 (a): the planted {name} reduce "
                               f"passed the bounds on rank {rank}")
        planted[name] = pe
    del grads, pg

    # (b) FSDP from the same state through the same step function: the
    # slices against (a)'s DP step
    state, fstep = fresh()
    replicated = sum(t.numel() * t.element_size() for t in (
        *state.opt.params, *state.opt.mu, *state.opt.nu, *(state.ema or [])))
    sstate = shard_train_state(state)
    del state
    for k in DIST_KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    sstate, fm, fgrads = _captured_step(fstep, sstate, batch)
    float(fm["l_pix"])
    torch.cuda.synchronize()
    fsdp_ms = (time.perf_counter() - t0) * 1e3
    fsdp_launches = [k.launches for k in DIST_KERNELS]
    fsdp_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dims = {lf.name: lf.dim for lf in sstate.leaves}

    def cut(name, x):
        d = dims[name]
        if d is None:
            return x
        k = x.shape[d] // world
        return x.narrow(d, rank * k, k)

    step_seconds = dict(sstate.seconds)

    def sliced(ref):
        return {"l_pix": ref["l_pix"], "grad_norm": ref["grad_norm"],
                **{k: {n: cut(n, t) for n, t in ref[k].items()}
                   for k in ("grads", "params")}}

    f_args = (fm, dict(zip(names, fgrads)),
              dict(zip(names, sstate.opt.params)),
              {n: cut(n, init[n]) for n in names}, lrs)
    ferr = _dist_errors(*f_args, sliced(want))
    vs_dp = _dist_errors(*f_args, sliced(
        {"l_pix": dp_m["l_pix"], "grad_norm": dp_m["grad_norm"],
         "grads": dp_grads, "params": dp_params}))
    gather_ms = _synced_ms(sstate.gather)
    sstate.release()
    scatter_ms = _synced_ms(lambda: sstate.reduce_gradients(
        [dp_grads[n].clone() for n in names], fm["l_pix"].clone()))
    held = sstate.held_bytes()
    log(f"phase 38 (b) rank {rank}: FSDP step {fsdp_ms:.1f} ms (gather "
        f"{step_seconds['gather'] * 1e3:.1f} ms, reduce-scatter "
        f"{step_seconds['reduce'] * 1e3:.1f} ms inside it; apart: gather "
        f"{gather_ms:.1f} ms, reduce-scatter {scatter_ms:.1f} ms), launches "
        f"{fsdp_launches}, peak {fsdp_peak:.2f} GiB; held {held} bytes "
        f"against {replicated} replicated; "
        f"{sum(d is not None for d in dims.values())} of {len(dims)} leaves "
        f"sharded; against one process: {_fmt(ferr)}"
        f"; against (a)'s DP step: {_fmt(vs_dp)}")
    if not (ferr["ok"] and vs_dp["ok"]) or fsdp_launches != [52, 52, 52]:
        raise RuntimeError(f"phase 38 (b) rank {rank}: {ferr}, {vs_dp}, "
                           f"launches {fsdp_launches}")
    return {"step_ms": step_ms, "launches": launches, "peak_gib": peak,
            "errors": err, "planted": planted, "reduce_ms": reduce_ms,
            "reduce_bytes": nbytes, "params": len(names),
            "param_count": sum(p.numel() for p in dp_params.values()),
            "fsdp": {"step_ms": fsdp_ms, "launches": fsdp_launches,
                     "peak_gib": fsdp_peak, "errors": ferr, "vs_dp": vs_dp,
                     "gather_ms": gather_ms, "scatter_ms": scatter_ms,
                     "step_gather_ms": step_seconds["gather"] * 1e3,
                     "step_scatter_ms": step_seconds["reduce"] * 1e3,
                     "held_bytes": held, "replicated_bytes": replicated}}


def _diffir_trainer(model):
    """The DiffIR CLI's optimizer, state and loss for DIFFIR_TRAIN."""
    topt = DIFFIR_TRAIN
    lr = topt["optim_g"]["lr"]
    opt = build_optimizer(
        model, warmup_wrap(build_schedule(lr, topt["scheduler"]), -1, lr),
        weight_decay=topt["optim_g"]["weight_decay"],
        betas=tuple(topt["optim_g"]["betas"]), grad_clip=0.01)
    return (create_train_state(model, opt, topt["ema_decay"]),
            build_loss(topt["pixel_opt"]))


def _diffir_model(seed: int):
    """NAFNetDynamicFusion at DiffIR's full width (DIFFIR_DIST_NET's
    depth), seeded, built on the card (the same weights in every process:
    one seed, one device)."""
    with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
        torch.manual_seed(seed)
        with torch.device("cuda"):
            model = define_network(DIFFIR_DIST_NET)
    return gate_and_temperatures(model, seed)


def _dist_diffir_job(rank: int, world: int, work: Path, seed: int) -> dict:
    """(c) on one rank: the full state built and sharded one rank after
    the other (482 M parameters with both moments and the EMA are 7.7 GB
    until sharded), then one FSDP step of `make_train_step` on this rank's
    images with the parent's embeddings: the loss, the norm, the gradient
    slices handed to the optimizer and the updated slices against the
    parent's single process."""
    from textualdegremoval_tpu_torch.parallel.fsdp import shard_train_state

    inp = torch.load(work / "diffir_input.pt", weights_only=True)
    per = DIFFIR_DIST_BATCH
    batch = {k: v[rank * per: (rank + 1) * per].cuda()
             for k, v in inp.items()}
    sstate = loss_fn = None
    torch.cuda.reset_peak_memory_stats()
    for turn in range(world):
        if turn == rank:
            state, loss_fn = _diffir_trainer(_diffir_model(seed))
            sstate = shard_train_state(state)
            del state
            gc.collect()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    held = sstate.held_bytes()
    names = sstate.opt.names
    init = {n: p.detach().cpu() for n, p in zip(names, sstate.opt.params)}
    lrs = _lrs(sstate.opt)
    step = make_train_step(loss_fn, DIFFIR_TRAIN["ema_decay"])
    _reset_all_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    sstate, m, grads = _captured_step(step, sstate, batch)
    float(m["l_pix"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = _all_counts()
    want = torch.load(work / f"diffir_expected_{rank}.pt", weights_only=True,
                      mmap=True)
    err = _dist_errors(m, dict(zip(names, grads)),
                       dict(zip(names, sstate.opt.params)), init, lrs, want)
    sharded = sum(lf.dim is not None for lf in sstate.leaves)
    log(f"phase 38 (c) rank {rank}: FSDP step {step_ms:.1f} ms (gather "
        f"{sstate.seconds['gather']:.2f} s, reduce-scatter "
        f"{sstate.seconds['reduce']:.2f} s), peak {peak:.2f} GiB in the "
        f"step, {build_peak:.2f} while building; held {held} bytes; "
        f"{sharded} of {len(sstate.leaves)} leaves sharded; against one "
        f"process: {_fmt(err)}")
    if not err["ok"] or any(counts.values()):
        raise RuntimeError(f"phase 38 (c) rank {rank}: {err}, counts "
                           f"{counts}")
    return {"step_ms": step_ms, "gather_s": sstate.seconds["gather"],
            "scatter_s": sstate.seconds["reduce"], "peak_gib": peak,
            "build_peak_gib": build_peak, "held_bytes": held,
            "errors": err}


DIST_JOBS = {"dp": _dist_dp_job, "diffir": _dist_diffir_job,
             "spatial": _spatial_job}


def _dist_rank(rank: int, world: int, port: int, job: str, work: str,
               seed: int) -> None:
    """One spawned rank of phase 38 or 39: joins through the port's own
    `init_distributed` (the torch launcher's env, a TCP rendezvous on
    `port`), loads the kernels phase 2 built, runs DIST_JOBS[job] and
    writes its readings to <work>/<job>_<rank>.pt."""
    from textualdegremoval_tpu_torch.parallel import init_distributed
    from textualdegremoval_tpu_torch.parallel.bootstrap import (
        backend_for, local_world_size,
    )

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = init_distributed("cuda")
    backend = torch.distributed.get_backend()
    want = backend_for("cuda", local_world_size(world),
                       torch.cuda.device_count())
    if got != (rank, world) or backend != want:
        raise RuntimeError(f"rank {rank}: joined as {got} on {backend}, "
                           f"the rule gives {want}")
    _build.load_library()
    out = DIST_JOBS[job](rank, world, Path(work), seed)
    out["backend"] = backend
    torch.save(out, Path(work) / f"{job}_{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _spawn_ranks(job: str, work: Path, seed: int,
                 world: int = DIST_WORLD) -> list:
    """`world` ranks of `job` (torch.multiprocessing, spawn); a rank that
    raises, or ranks that have not finished within DIST_TIMEOUT, fail the
    phase.  Returns each rank's readings."""
    ctx = torch.multiprocessing.spawn(
        _dist_rank, args=(world, _free_port(), job, str(work), seed),
        nprocs=world, join=False)
    deadline = time.monotonic() + DIST_TIMEOUT
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError(f"{job} ranks: not finished within "
                               f"{DIST_TIMEOUT} s")
    return [torch.load(work / f"{job}_{r}.pt", weights_only=False)
            for r in range(world)]


def _dist_reference(seed: int, work: Path) -> dict:
    """(a)'s single process: one step of the training CLI's step function
    on the whole global batch, after a warm-up from the same state; its
    loss, norm, gradients and updated parameters to <work>/dp_expected.pt
    for the ranks."""
    model = _dist_restormer(seed)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    names = [n for n, _ in model.named_parameters()]
    batch = _dist_batch(seed)
    state, step_fn, _ = _trainer(model, DIST_TRAIN)
    step_fn(state, batch)
    model.load_state_dict(init)
    state, step_fn, _ = _trainer(model, DIST_TRAIN)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m, grads = _captured_step(step_fn, state, batch)
    float(m["l_pix"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"l_pix": float(m["l_pix"]), "grad_norm": float(m["grad_norm"]),
            "grads": {n: g.float().cpu() for n, g in zip(names, grads)},
            "params": {n: p.detach().cpu()
                       for n, p in zip(names, state.opt.params)}}
    torch.save(want, work / "dp_expected.pt")
    n = sum(p.numel() for p in want["params"].values())
    log(f"phase 38 (a) one process: step {ms:.1f} ms on {DIST_BATCH} images, "
        f"peak {peak:.2f} GiB, l_pix {want['l_pix']:.6f}, grad_norm "
        f"{want['grad_norm']:.6e}, {n} parameters")
    del state, model, grads, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": ms, "peak_gib": peak, "params": n}


def _diffir_reference(seed: int, work: Path) -> dict:
    """(c)'s single process: the frozen full-width towers embed the 4
    images once (then freed), one step of the DiffIR step on all 4, and
    each rank's slices of the updated parameters and of the gradients
    handed to the optimizer to <work>/diffir_expected_<rank>.pt."""
    from textualdegremoval_tpu_torch.cli import train_diffir as dcli
    from textualdegremoval_tpu_torch.parallel.fsdp import fsdp_spec

    rng = np.random.default_rng(seed + 39)
    trip = [synthetic_triple(rng, DIFFIR_GT)
            for _ in range(DIST_WORLD * DIFFIR_DIST_BATCH)]
    lq, gt = (torch.from_numpy(np.stack([t[i] for t in trip]))
              for i in (0, 1))
    opt = {"manual_seed": seed, "path": {},
           "network_mapper": {"num_words": DIFFIR_NET["num_words"]}}
    enc, mapper = dcli.build_towers(opt, "cuda")
    with torch.inference_mode():
        emb = dcli.make_device_embed_fn(enc, mapper)(lq.cuda()).cpu()
    del enc, mapper
    torch.cuda.empty_cache()
    inp = {"lq": lq, "gt": gt, "ref": emb.clone()}
    torch.save(inp, work / "diffir_input.pt")
    state, loss_fn = _diffir_trainer(_diffir_model(seed))
    step = make_train_step(loss_fn, DIFFIR_TRAIN["ema_decay"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m, grads = _captured_step(
        step, state, {k: v.cuda() for k, v in inp.items()})
    float(m["l_pix"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    names, params = state.opt.names, state.opt.params
    count = sum(p.numel() for p in params)
    metrics = {"l_pix": float(m["l_pix"]), "grad_norm": float(m["grad_norm"])}
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    for r in range(DIST_WORLD):
        mine = {"params": {}, "grads": {}}
        for name, p, g in zip(names, params, grads):
            d = fsdp_spec(tuple(p.shape), DIST_WORLD)
            if d is not None:
                k = p.shape[d] // DIST_WORLD
                p, g = p.narrow(d, r * k, k), g.narrow(d, r * k, k)
            mine["params"][name] = p.detach().cpu()
            mine["grads"][name] = g.float().cpu()
        torch.save({**metrics, **mine}, work / f"diffir_expected_{r}.pt")
        del mine
    log(f"phase 38 (c) one process: {count} parameters, step {ms:.1f} ms "
        f"on {DIST_WORLD * DIFFIR_DIST_BATCH} images at {DIFFIR_GT} px, peak "
        f"{peak:.2f} GiB, l_pix {metrics['l_pix']:.6f}")
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": ms, "peak_gib": peak, "params": count}


def _dist_cli(seed: int, work: Path) -> dict:
    """(d): cli/train_restoration.py's `main` as two processes under the
    torch launcher's env (RANK, WORLD_SIZE=2, MASTER_ADDR, MASTER_PORT,
    LOCAL_RANK) on numpy-written PNGs: restormer_motion_deblur.yml's
    network at full width, bf16, 384 px crops, 4 images a rank, 2
    iterations, a checkpoint and a strip at iteration 2.  Each rank runs
    `main` as `python -m` does and writes the parameters it ends with
    beside (the CLI writes nothing on rank 1); then a third process,
    `python -m textualdegremoval_tpu_torch.cli.train_restoration`, resumes
    from rank 0's checkpoint for a third iteration."""
    from textualdegremoval_tpu_torch.data.png import write_png

    root = work / "cli"
    rng = np.random.default_rng(seed + 40)
    for sub in ("lq", "hq", "ref"):
        (root / sub).mkdir(parents=True)
    for i in range(8):
        for sub in ("lq", "hq", "ref"):
            write_png(str(root / sub / f"{i:03d}.png"),
                      (rng.random((400, 440, 3)) * 255).astype(np.uint8))
    opt = {
        "name": "dist_cli", "scale": 1, "manual_seed": 100,
        "datasets": {"train": {
            "name": "Trainset", "type": "Dataset_PairedImageWithRef",
            **{f"{s}root": str(root / s) for s in ("lq", "hq", "ref")},
            "geometric_augs": True, "io_backend": {"type": "disk"},
            "num_worker_per_gpu": 0, "batch_size_per_gpu": 4,
            "mini_batch_sizes": [4], "iters": [1000000], "gt_size": 384,
            "gt_sizes": [384]}},
        "network_g": TRAIN_OPT["network_g"],
        "path": {"pretrain_dino": None, "pretrain_network_g": None},
        "train": TRAIN_OPT["train"],
        "logger": {"print_freq": 1, "save_checkpoint_freq": 2,
                   "check_freq": 2}}
    cfg = root / "opt.json"
    cfg.write_text(json.dumps(opt))
    argv = ["--opt", str(cfg), "--mixed_precision", "bf16"]
    runner = ("import sys, torch; from textualdegremoval_tpu_torch.cli "
              "import train_restoration as cli; s = cli.main(sys.argv[2:]); "
              "torch.save({k: v.cpu() for k, v in "
              "s.model.state_dict().items()}, sys.argv[1])")
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    path = os.pathsep.join(filter(None, [str(Path(__file__).resolve().parent),
                                         os.environ.get("PYTHONPATH")]))
    for r in range(DIST_WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DIST_WORLD),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=path)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", runner, str(root / f"rank{r}.pt"), *argv,
             "--max_iters", "2"], env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=DIST_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError("phase 38 (d): the CLI's ranks did not "
                               f"finish within {DIST_TIMEOUT} s")
    secs = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise RuntimeError("phase 38 (d): a rank of the CLI failed:\n"
                           + "\n---\n".join(o[-3000:] for o in outs))
    exp = root / "experiments" / "dist_cli"
    text = (exp / "train.log").read_text()
    nets = sorted(p.name for p in (exp / "models").iterdir())
    states = sorted(p.name for p in (exp / "training_states").iterdir())
    strips = sorted(p.name for p in (exp / "visualization").iterdir())
    net = torch.load(exp / "models" / "net_g_2.pth", weights_only=True)
    define_network(TRAIN_OPT["network_g"]).load_state_dict(net["params"],
                                                           strict=True)
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=True)
             for r in range(DIST_WORLD)]
    equal = all(torch.equal(net["params"][k], rk[k])
                for rk in ranks for k in net["params"])
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = path
    res = subprocess.run(
        [sys.executable, "-m",
         "textualdegremoval_tpu_torch.cli.train_restoration", *argv,
         "--max_iters", "3"], env=env, cwd=root, capture_output=True,
        text=True, timeout=DIST_TIMEOUT)
    resumed = "auto-resumed from iter 2" in (exp / "train.log").read_text()
    ok = (text.count(" l_pix ") == 2 and "rank 0 of 2" in text
          and "rank 1 of 2" not in text and nets == ["net_g_2.pth"]
          and states == ["state_2.pth"] and strips == ["000002.png"]
          and equal and res.returncode == 0 and resumed
          and (exp / "models" / "net_g_3.pth").exists())
    log(f"phase 38 (d): two CLI ranks, 2 iterations in {secs:.1f} s; "
        f"train.log {text.count(' l_pix ')} step lines, rank 0's only "
        f"{'rank 1 of 2' not in text}; models {nets}, states {states}, "
        f"strips {strips}; net_g_2.pth loads strict and equals both ranks' "
        f"parameters bit for bit: {equal}; a third process resumed from "
        f"iter 2: {resumed} (rc {res.returncode})")
    if not ok:
        raise RuntimeError("phase 38 (d) failed:\n" + text[-3000:]
                           + res.stdout[-2000:] + res.stderr[-3000:])
    return {"seconds": secs, "equal": equal, "resumed": resumed}


def distributed_phases(seed: int) -> dict:
    """Phase 38: the port's multi-process training on the card, two ranks
    sharing it over gloo (the backend rule's pick where ranks outnumber
    cards): (a) the data-parallel step of the flagship at full width in
    bf16, 4 of 8 images a rank, against one process on all 8, with two
    planted reduce faults that must fail; (b) FSDP at the same setting
    against (a); (c) FSDP of NAFNetDynamicFusion at DiffIR's full width
    (DIFFIR_DIST_NET's depth), 2 images a rank, against one process on all 4; (d) the training CLI
    as two launched processes, rank-0 I/O, a resume.  The single-process
    references run first in this process and free the card before the
    ranks start.  Returns the readings."""
    work = Path(tempfile.mkdtemp(prefix="dist_"))
    t0 = time.perf_counter()
    parts = []

    def timed(what, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts.append(f"{what} {time.perf_counter() - t:.1f}")
        return out

    try:
        ref_a = timed("(a) one process", _dist_reference, seed, work)
        dp = timed("(a)-(b) ranks", _spawn_ranks, "dp", work, seed)
        log_held("phase 38 (a)-(b)")
        ref_c = timed("(c) one process", _diffir_reference, seed, work)
        diffir = timed("(c) ranks", _spawn_ranks, "diffir", work, seed)
        log_held("phase 38 (c)")
        cli = timed("(d)", _dist_cli, seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    secs = time.perf_counter() - t0
    log(f"phase 38: {secs:.1f} s ({', '.join(parts)} s); backend "
        f"{dp[0]['backend']}; (a) "
        f"{dp[0]['param_count']} parameters in {dp[0]['params']} tensors, "
        f"the reduce {dp[0]['reduce_bytes']} bytes a step in "
        f"{[round(r['reduce_ms'], 2) for r in dp]} ms (apart), step "
        f"{[round(r['step_ms'], 1) for r in dp]} ms a rank against "
        f"{ref_a['step_ms']:.1f} ms in one process")
    return {"seconds": secs, "ref_a": ref_a, "dp": dp, "ref_c": ref_c,
            "diffir": diffir, "cli": cli}


def bound_ms(kernel: str, b, h, w, c, heads, eb=2, n=1):
    """(ms, 'bytes' or 'operations') for one call at a shape, in bf16 (eb
    2: the tensor cores' rate) or float32 (eb 4: the CUDA cores' rate, as
    the f32 kernels run their products).
    Operations: the products of the block or its backward per pixel (the
    stencils, LayerNorms and softmax are below 3% and left out); bytes:
    each activation input read once, each output written once, the
    function's own f32 weights read once (and their gradients written once
    in a backward).  Each product is counted once, however many passes of
    the kernel recompute it.  Forward: qkv 6C^2, proj 2C^2, GDFN in 4Ch,
    out 2Ch (h = int(2.66 C)), gram and o 4 C cph.  A chain of n blocks
    (tblock_chain_fused): n times the forward's operations, x read and the
    last output written once, every block's weights read once.  GDFN half
    backward
    (x1, dout in; dx1 out; W_in, W_out): hid 4Ch, dgate 2Ch, dz 4Ch, dW1
    4Ch, dW2 2Ch.  Attention half backward (x, dx1 in; dx out; W_qkv,
    W_proj): q, k, v 6C^2, do 2C^2, dy 6C^2, dWqkv 6C^2, dWproj 2C^2, and
    per head o, dA, dv, dq, dk 10 C cph.  NAFBlock forward (x in, out
    out; its 1x1s, SCA, taps, biases and scales, 7 C^2 + 33 C values): conv1
    4C^2, conv3 2C^2, conv4 4C^2, conv5 2C^2 (heads ignored).  GDFN
    (gdfn_fused: x in, out out, W_in, taps, W_out): the 1x1s 6Ch and the
    stencils 36h (heads ignored).  MDTA statistics (mdta_stats: q and k in
    once, attn out in f32): the gram 2 C cph and the square sums 4C."""
    npix = b * h * w
    hid = int(c * 2.66)
    cph = c // heads
    attn_w, gdfn_w = 4 * c * c * 4, 3 * c * hid * 4
    if kernel in ("tblock_fused", "tblock_chain_fused"):
        flops = n * npix * (8 * c * c + 6 * c * hid + 4 * c * cph)
        nbytes = 2 * npix * c * eb + n * (attn_w + gdfn_w)
    elif kernel == "gdfn_half_bwd":
        flops = npix * 16 * c * hid
        nbytes = 3 * npix * c * eb + 2 * gdfn_w
    elif kernel == "attn_half_bwd":
        flops = npix * (22 * c * c + 10 * c * cph)
        nbytes = 3 * npix * c * eb + 2 * attn_w
    elif kernel == "gdfn_fused":
        flops = npix * (6 * c * hid + 36 * hid)
        nbytes = 2 * npix * c * eb + (3 * c * hid + 18 * hid) * 4
    elif kernel == "mdta_stats":
        flops = npix * (2 * c * cph + 4 * c)
        nbytes = 2 * npix * c * eb + b * heads * cph * cph * 4
    else:
        flops = npix * 12 * c * c
        nbytes = 2 * npix * c * eb + (7 * c * c + 33 * c) * 4
    t_ops = flops / (PEAK_BF16 if eb == 2 else PEAK_F32)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def flash_bound_ms(b, n, h, d, eb=2):
    """(ms, 'bytes' or 'operations') of one call: 4 B H N^2 D operations
    (q k^T and P v) at the peak of the element type (bf16 tensor cores, or
    float32 outside them), q, k, v read and o written once."""
    t_ops = 4 * b * h * n * n * d / (PEAK_BF16 if eb == 2 else PEAK_F32)
    t_bytes = 4 * b * n * h * d * eb / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def flash_bwd_bound_ms(b, n, h, d, eb=2):
    """(ms, 'bytes' or 'operations') of one backward (the dkv and dq pair):
    10 B H N^2 D operations (the recomputed S, dP, dV, dK and dQ, each
    counted once however many times the kernels recompute it) at the peak
    of the element type, q, k, v, o, do read and dq, dk, dv written once."""
    t_ops = 10 * b * h * n * n * d / (PEAK_BF16 if eb == 2 else PEAK_F32)
    t_bytes = 8 * b * n * h * d * eb / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plant", choices=sorted(FAULTS), default=None,
                    help="plant a fault in a copy of the sources and show "
                         "that its phase catches it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2

    card = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.plant:
        plant_fault(args.plant)
    so, secs = _build.build()
    _build.load_library()
    log(f"built {so.name} with {' '.join(_build.NVCC_FLAGS)} in {secs:.1f} s")
    log(so.with_suffix(".log").read_text().strip())

    gen = torch.Generator().manual_seed(args.seed)
    if args.plant:
        try:
            if FAULTS[args.plant][3] == 3:
                kernel_vs_plain(gen, False, [SHAPES[i] for i in (2, 6, 8)]
                                + NOISE_SHAPES[3:], (torch.bfloat16,))
            elif FAULTS[args.plant][3] == 6 and FAULTS[args.plant][0] \
                    == "tblock_attn_bwd.cu":
                backward_vs_plain(gen, [TRAIN_SHAPES[i] for i in (4, 8)]
                                  + NOISE_TRAIN_SHAPES[:1],
                                  dtypes=(torch.float32,), timed=False)
            elif FAULTS[args.plant][3] == 6:
                backward_vs_plain(gen, [TRAIN_SHAPES[i] for i in (0, 4, 7, 8)],
                                  dtypes=(torch.bfloat16,), timed=False)
            elif FAULTS[args.plant][3] == 11:
                flash_vs_plain(gen, dtypes=(torch.bfloat16,), timed=False)
            elif FAULTS[args.plant][3] == 14:
                flash_bwd_vs_plain(gen, [FLASH_BWD_SHAPES[i]
                                         for i in (1, 2, 4)],
                                   dtypes=(torch.bfloat16,), timed=False)
            elif FAULTS[args.plant][3] == 17:
                chain_vs_plain(gen, [CHAIN_SHAPES[i] for i in (1, 3, 5)],
                               timed=False)
            elif FAULTS[args.plant][3] == 19:
                gdfn_vs_plain(gen, [GDFN_SHAPES[i] for i in (2, 7, 8)],
                              dtypes=(torch.float32 if FAULTS[args.plant][0]
                                      == "tblock_fwd.cuh" else
                                      torch.bfloat16,), timed=False)
            elif FAULTS[args.plant][3] == 20:
                mdta_vs_plain(gen, [MDTA_SHAPES[i] for i in (2, 6, 8)],
                              dtypes=(torch.float32 if FAULTS[args.plant][0]
                                      == "mdta.cu" else torch.bfloat16,),
                              timed=False)
            elif FAULTS[args.plant][3] == 23:
                qkv_form_vs_plain(gen, dtypes=(torch.float32 if FAULTS[
                    args.plant][0] == "probe_qkv_form.cu" else
                    torch.bfloat16,), timed=False)
            elif FAULTS[args.plant][3] == 24:
                stencil_vs_plain(gen, timed=False)
            elif FAULTS[args.plant][3] == 39:
                window_vs_plain(gen, dtypes=(
                    torch.float32 if FAULTS[args.plant][0] == "tblock_fwd.cuh"
                    else torch.bfloat16,))
            elif FAULTS[args.plant][3] == 40:
                naf_window_vs_plain(gen, dtypes=(
                    torch.float32 if FAULTS[args.plant][0] == "nafblock.cu"
                    else torch.bfloat16,))
            else:  # the pair's faults in float32, the pipeline's in bf16
                nafblock_vs_plain(
                    gen, [NAF_SHAPES[i] for i in (7, 8, 10)],
                    dtypes=(torch.float32 if FAULTS[args.plant][0] ==
                            "nafblock.cu" else torch.bfloat16,), timed=False)
        except RuntimeError as e:
            log(f"planted fault {args.plant} caught: {e}")
            return 0
        log(f"planted fault {args.plant} NOT caught")
        return 1

    global T_START
    t_start = T_START = time.perf_counter()
    rows = kernel_vs_plain(gen)
    network_vs_cpu(args.seed, more=((tb.tblock_pipeline, 0),))
    eval_launches, _, _, (eval_pipeline,) = main_path(
        args.seed, more=((tb.tblock_pipeline, 52),))
    bwd_rows = backward_vs_plain(gen)
    # the kernel split and the products alone at C = 704 only
    noise_bwd_rows = [
        r for i, shapes in enumerate((NOISE_TRAIN_SHAPES[:1],
                                      NOISE_TRAIN_SHAPES[1:]))
        for r in backward_vs_plain(
            gen, shapes, split=i == 0,
            keep=lambda d, ln, _: d == torch.float32 and ln == "WithBias")]
    remat_vs_save(gen)
    launches, step_ms, plain_step_ms, peak, _ = train_main_path(args.seed)
    train_step_vs_cpu(args.seed)
    log(f"launches: evaluation path tblock_fused {eval_launches} "
        f"(tblock_pipeline {eval_pipeline}); training main path (4 steps) "
        f"tblock_fused/gdfn_half_bwd/attn_half_bwd/tblock_pipeline "
        f"{launches}")
    log_held("phases 3-7")

    naf_rows = nafblock_vs_plain(gen, NAF_SHAPES + NAF_TRAIN_SHAPES[:2])
    network_vs_cpu(args.seed, NAF_TASK, nb.nafblock_fused,
                   ((NAF_BLOCKS, None),), more=((nb.naf_pipeline, 0),))
    naf_launches, naf_fwd_ms, _, (naf_eval_pipeline,) = main_path(
        args.seed, NAF_TASK, nb.nafblock_fused, NAF_BLOCKS,
        more=((nb.naf_pipeline, NAF_BLOCKS),))
    naf_train_rows = nafblock_vs_plain(gen, NAF_TRAIN_SHAPES,
                                       dtypes=(torch.bfloat16,))
    (naf_train_launches, naf_step_ms, naf_plain_step_ms, naf_peak,
     naf_plain_peak) = train_main_path(
        args.seed, NAF_TRAIN_OPT, (nb.nafblock_fused, nb.naf_pipeline),
        (NAF_BLOCKS, NAF_BLOCKS), _swap("nafblock_fused", _plain_nafblocks))
    naf_main = [r for r in naf_rows if r[4][0] == 1 and r[0]]

    def naf_sum(rows, i):
        return sum(r[0] * r[i] for r in rows)

    log(f"nafblock_fused per 512 px forward (bf16, per-shape medians times "
        f"blocks): pipeline {naf_sum(naf_main, 2):.3f} ms, pair "
        f"{naf_sum(naf_main, 5):.3f} ms, plain {naf_sum(naf_main, 3):.3f} ms; "
        f"per 384 px batch-8 step's 45 forward calls: pipeline "
        f"{naf_sum(naf_train_rows, 2):.3f} ms, pair "
        f"{naf_sum(naf_train_rows, 5):.3f} ms, plain "
        f"{naf_sum(naf_train_rows, 3):.3f} ms")
    log(f"launches: nafnet evaluation path nafblock_fused {naf_launches} "
        f"(naf_pipeline {naf_eval_pipeline}); training path (4 steps) "
        f"nafblock_fused/naf_pipeline {naf_train_launches}")
    log_held("phases 8-10")

    flash_rows = flash_vs_plain(gen)
    log_held("phase 11")
    towers_vs_reference(args.seed)
    log_held("phase 12")
    gen_out = generation_path(args.seed)
    flash_main = [r for r in flash_rows if r[0]]
    log(f"flash_attention per UNet forward (bf16, "
        f"{sum(r[0] for r in flash_main)} launches): kernel median "
        f"{sum(r[0] * r[2] for r in flash_main):.4f} ms, device "
        f"{sum(r[0] * r[6] for r in flash_main):.4f} ms; SDPA median "
        f"{sum(r[0] * r[4] for r in flash_main):.4f} ms, device "
        f"{sum(r[0] * r[7] for r in flash_main):.4f} ms")
    flash_launches = sum(v[3] for v in gen_out.values())
    log(f"launches: generation path flash_attention {flash_launches} "
        f"({', '.join(f'{k} {v[3]}' for k, v in gen_out.items())})")

    bwd_flash_rows = flash_bwd_vs_plain(gen)
    (bwd_launches, i2t_ms, i2t_plain_ms, i2t_peak,
     i2t_plain_peak) = training_path(args.seed)
    log(f"launches: training path flash_attention_bwd {bwd_launches} over "
        f"{2 * I2T_ACCUM} micro-steps")
    bwd_main = [r for r in bwd_flash_rows if r[0]]
    log(f"flash_attention_bwd per I2T micro-step (bf16, "
        f"{sum(r[0] for r in bwd_main)} pairs): kernels median "
        f"{sum(r[0] * r[2] for r in bwd_main):.4f} ms, device "
        f"{sum(r[0] * r[6] for r in bwd_main):.4f} ms; SDPA backward median "
        f"{sum(r[0] * r[4] for r in bwd_main):.4f} ms, device "
        f"{sum(r[0] * r[7] for r in bwd_main):.4f} ms")
    log_held("phases 14-15")

    noise_rows = kernel_vs_plain(gen, shapes=NOISE_SHAPES)
    log(f"tblock_fused at PromptIR's noise blocks (bf16, 512 px forward): "
        f"kernel {sum(r[0] * r[2] for r in noise_rows):.3f} ms, plain "
        f"{sum(r[0] * r[3] for r in noise_rows):.3f} ms")
    chain_rows = chain_vs_plain(gen)
    chain_grad_vs_autograd(gen)
    ((pir_launches, pir_ms, _, _, pir_enqueue),
     (pir_chain_launches, pir_chain_ms, pir_chain_counts, pir_chain_more,
      pir_chain_enqueue)) = promptir_path(args.seed)
    log(f"launches: promptir evaluation path, chain off: tblock_fused "
        f"{pir_launches}; chain on: tblock_fused {pir_chain_launches}, "
        f"chain calls/launches {pir_chain_counts}, of them through the "
        f"chain epilogue {pir_chain_more[1]}")
    log_held("phases 16-18")

    gdfn_rows = gdfn_vs_plain(gen)
    gdfn_grad_vs_autograd(gen)
    mdta_rows = mdta_vs_plain(gen)
    mdta_refuses_grad()
    mod_on, mod_off = module_eval_path(args.seed)
    (mod_train_launches, mod_step_ms, mod_plain_step_ms, mod_peak,
     mod_plain_peak) = module_train_path(args.seed)
    log(f"launches: module-path evaluation path gdfn_fused/mdta_stats/"
        f"gdfn_pipeline/mdta_gram {mod_on[3]}, tblock_fused {mod_on[0]}; "
        f"training path (4 steps) "
        f"gdfn_fused/tblock_fused/gdfn_pipeline {mod_train_launches}")
    log_held("phases 19-22")

    qkv_rows = qkv_form_vs_plain(gen)
    stencil_rows = stencil_vs_plain(gen)
    tool_qkv, _, probe_launches = probe_tool_runs()
    log_held("phases 23-24")

    (pir_step_launches, pir_step_ms, pir_peak, pir_f32_ms,
     pir_f32_peak) = promptir_train_path(args.seed)
    yaml_runs = cli_yaml_runs(args.seed)
    dino_ms, dino_peak, dino_windows = dino_matcher(args.seed)
    log_held("phases 25-27")

    fam = family_phases(args.seed)
    log_held("phases 28-32")
    diffir = diffir_phases(args.seed)
    log_held("phases 33-35")
    mp = metric_phases(args.seed)
    log_held("phases 36-37")
    dist = distributed_phases(args.seed)
    log_held("phase 38")
    spatial = spatial_phases(args.seed)
    log_held("phases 39-41")

    # per-step kernel time: each training shape's median time times the
    # number of blocks of that shape in one step (bf16, WithBias); the
    # forward's from phase 3 at the evaluation shapes, per forward
    def bounds(kernel, shapes):
        """Sum over one pass's blocks, and what bounds the largest term."""
        per = [(n, *bound_ms(kernel, b, h, w, c, heads))
               for b, h, w, c, heads, n in shapes if n]
        return (sum(n * ms for n, ms, _ in per),
                max(per, key=lambda r: r[0] * r[1])[2])

    fwd_bound, fwd_by = bounds("tblock_fused", SHAPES)
    naf_bound, naf_by = bounds("nafblock_fused",
                               [(b, h, w, c, 1, n) for b, h, w, c, n in
                                NAF_SHAPES])
    naf_step_bound, naf_step_by = bounds(
        "nafblock_fused", [(b, h, w, c, 1, n) for b, h, w, c, n in
                           NAF_TRAIN_SHAPES])
    g_bound, g_by = bounds("gdfn_half_bwd", TRAIN_SHAPES)
    a_bound, a_by = bounds("attn_half_bwd", TRAIN_SHAPES)
    chain_per = [(n, *bound_ms("tblock_chain_fused", *shape[:5], n=shape[5]))
                 for n, *_, shape in chain_rows]
    gdfn_bound, gdfn_by = bounds("gdfn_fused", SHAPES)
    mdta_bound, mdta_by = bounds("mdta_stats", SHAPES)
    qkv_per = [qkv_tool.bound_ms(*case) for case in QKV_CASES]
    qkv_bound = sum(ms for ms, _ in qkv_per)
    qkv_by = max(qkv_per)[1]
    # composed's own bound, as the function's with its K = 9C product's
    # operations in place of the function's
    qkv_own_per = [qkv_tool.bound_ms(px, c, co, ops_per_px=2 * 9 * c * co)
                   for px, c, co in QKV_CASES]
    qkv_own = sum(ms for ms, _ in qkv_own_per)
    qkv_own_by = max(qkv_own_per)[1]
    # the tool's own run, per tool run
    qkv_tool_ms = {f: sum(r[f + "_ms"] for r in tool_qkv)
                   for f in ("current", "composed", "cudnn")}
    t_st, w_st, ch_st = STENCIL_SHAPE
    sms, mhz, core_peak = stencil_tool.cuda_core_peak(torch.device("cuda"))
    stencil_bound = stencil_tool.stencil_flops(t_st, w_st, ch_st) \
        / core_peak * 1e3
    src = "textualdegremoval_tpu_torch/csrc/"
    step_bound, step_by = bounds("tblock_fused", TRAIN_SHAPES)

    def f32_wide(half, src_file, ms_i, plain_i, err_i):
        """The float32 row at C = 704, 176 channels a head (phase 6):
        (the half, its f32 source, row indices of ms, plain ms, max
        abs)."""
        r = next(r for r in noise_bwd_rows if r[10][3] == 704)
        bound, by = bound_ms(half, *r[10], eb=4)
        return {"route": "cuda", "source": src + src_file,
                "shape": list(r[10]), "max_abs_err": r[err_i],
                "ms": r[ms_i], "plain_ms": r[plain_i], "bound_ms": bound,
                "bound_by": by,
                "ms_by_width": {str(q[10][3]): q[ms_i]
                                for q in noise_bwd_rows}}
    summary = {"kernels": [
        # per 512 px restormer_deblur forward (bf16: the pipeline of
        # fwd_stencil.cu, the products of bwd_gemm.cu, bwd_stencil.cu's LN
        # rows and wgrad.cu's gram; float32 and other bf16 widths run
        # tblock.cu's pair); step_*: per 384 px batch-8 step's 52 forward
        # calls (phase 6's times); launches: phase 7's 4 steps, of which
        # pipeline_launches through the pipeline
        {"name": "tblock_fused", "route": "cuda",
         "source": src + "fwd_stencil.cu",
         "sources": [src + f for f in ("fwd_stencil.cu", "bwd_gemm.cu",
                                       "bwd_stencil.cu", "wgrad.cu",
                                       "halo_tiles.cuh", "tma_maps.cuh",
                                       "hopper.cuh", "tblock_common.cuh",
                                       "tblock.cu", "tblock_fwd.cuh")],
         "replaces": "textualdegremoval_tpu/ops/pallas/tblock.py:557 "
                     "(_tblock_impl; _make_stats_kernel :170, call :627; "
                     "_make_apply_kernel :220, call :652)",
         "launches": launches[0], "pipeline_launches": launches[3],
         "eval_launches": eval_launches,
         "max_abs_err": max(r[1] for r in rows),
         "ms": sum(r[0] * r[2] for r in rows),
         "plain_ms": sum(r[0] * r[3] for r in rows),
         "bound_ms": fwd_bound, "bound_by": fwd_by,
         "library_ms": sum(r[0] * r[5] for r in rows),
         "library_of": "the gram: torch.matmul(q_h^T, k_h) per (image, "
                       "head) on the pipeline's q | k | v",
         "wgrad_ms": sum(r[0] * r[4] for r in rows),
         "step_ms": sum(r[0] * r[8] for r in bwd_rows),
         "step_plain_ms": sum(r[0] * r[9] for r in bwd_rows),
         "step_bound_ms": step_bound, "step_bound_by": step_by,
         "noise_ms_per_launch": [r[2] for r in noise_rows],
         "noise_plain_ms_per_launch": [r[3] for r in noise_rows],
         "promptir_step_launches": pir_step_launches[0]},
        # per 384 px batch-8 step (bf16: the passes of bwd_stencil.cu and
        # fwd_stencil.cu, the products of bwd_gemm.cu, then wgrad.cu;
        # "sources" names every source the row runs; library_ms: one
        # torch.matmul per weight-gradient product on its operands, beside
        # wgrad_ms, wgrad.cu's time on the same products)
        {"name": "gdfn_half_bwd", "route": "cuda",
         "source": src + "bwd_stencil.cu",
         "sources": [src + f for f in ("bwd_stencil.cu", "bwd_gemm.cu",
                                       "wgrad.cu", "tma_maps.cuh",
                                       "hopper.cuh", "tblock_common.cuh")],
         "replaces": "textualdegremoval_tpu/ops/pallas/tblock_bwd.py:253 "
                     "(gdfn_half_bwd; _make_gdfn_bwd_kernel :101, call "
                     ":300)",
         "launches": launches[1],
         "max_abs_err": max(r[2] for r in bwd_rows),
         "ms": sum(r[0] * r[4] for r in bwd_rows),
         "plain_ms": sum(r[0] * r[6] for r in bwd_rows),
         "bound_ms": g_bound, "bound_by": g_by,
         "library_ms": sum(r[0] * r[12] for r in bwd_rows),
         "library_of": "its weight gradients dW1, dW2: torch.matmul(A^T, B) "
                       "on the same operands",
         "wgrad_ms": sum(r[0] * r[11] for r in bwd_rows),
         "promptir_step_launches": pir_step_launches[1],
         # float32 at PromptIR's C = 704 (csrc/tblock_bwd.cu, a 2 x 2
         # tile), per call
         "f32_wide": f32_wide("gdfn_half_bwd", "tblock_bwd.cu", 4, 6, 2)},
        {"name": "attn_half_bwd", "route": "cuda",
         "source": src + "bwd_stencil.cu",
         "sources": [src + f for f in ("bwd_stencil.cu", "fwd_stencil.cu",
                                       "bwd_gemm.cu", "wgrad.cu",
                                       "halo_tiles.cuh", "tma_maps.cuh",
                                       "hopper.cuh", "tblock_common.cuh",
                                       "tblock_attn_bwd.cu")],
         "replaces": "textualdegremoval_tpu/ops/pallas/tblock_attn_bwd.py:312 "
                     "(attn_half_bwd; _make_attn_bwd_stats_kernel :112, call "
                     ":365; _make_attn_bwd_apply_kernel :168, call :382)",
         "launches": launches[2],
         "max_abs_err": max(r[3] for r in bwd_rows),
         "ms": sum(r[0] * r[5] for r in bwd_rows),
         "plain_ms": sum(r[0] * r[7] for r in bwd_rows),
         "bound_ms": a_bound, "bound_by": a_by,
         "library_ms": sum(r[0] * r[14] for r in bwd_rows),
         "library_of": "its weight gradients dA, dWproj, dWqkv: "
                       "torch.matmul(A^T, B) on the same operands",
         "wgrad_ms": sum(r[0] * r[13] for r in bwd_rows),
         "promptir_step_launches": pir_step_launches[2],
         # the float32 wide-head route: both passes of
         # csrc/tblock_attn_bwd.cu on 4 x 4 tiles at PromptIR's C = 704,
         # 176 channels a head, per call
         "f32_wide": f32_wide("attn_half_bwd", "tblock_attn_bwd.cu", 5, 7,
                              3)},
        # per 512 px nafnet_deblur forward (bf16: the pipeline of
        # naf_stencil.cu, bwd_gemm.cu's NAFBlock epilogues and
        # bwd_stencil.cu's LN rows; float32 and other bf16 widths run
        # nafblock.cu's pair, timed as pair_ms); step_*: per 384 px
        # batch-8 step's 45 forward calls (phase 10's times); launches:
        # phase 10's 4 steps, of which pipeline_launches through the
        # pipeline
        {"name": "nafblock_fused", "route": "cuda",
         "source": src + "naf_stencil.cu",
         "sources": [src + f for f in ("naf_stencil.cu", "bwd_gemm.cu",
                                       "bwd_stencil.cu", "halo_tiles.cuh",
                                       "tma_maps.cuh", "hopper.cuh",
                                       "tblock_common.cuh", "nafblock.cu")],
         "replaces": "textualdegremoval_tpu/ops/pallas/nafblock.py:246 "
                     "(_nafblock_impl; _make_sum_kernel :156, call :303; "
                     "_make_apply_kernel :180, call :321)",
         "launches": naf_train_launches[0],
         "pipeline_launches": naf_train_launches[1],
         "eval_launches": naf_launches,
         "max_abs_err": max(r[1] for r in naf_main),
         "ms": naf_sum(naf_main, 2), "plain_ms": naf_sum(naf_main, 3),
         "pair_ms": naf_sum(naf_main, 5),
         "bound_ms": naf_bound, "bound_by": naf_by, "library_ms": None,
         "step_ms": naf_sum(naf_train_rows, 2),
         "step_plain_ms": naf_sum(naf_train_rows, 3),
         "step_pair_ms": naf_sum(naf_train_rows, 5),
         "step_bound_ms": naf_step_bound, "step_bound_by": naf_step_by},
        # per 512 px UNet forward (5 launches at (2, 4096, 5, 64), bf16)
        {"name": "flash_attention", "route": "cuda",
         "source": src + "flash_attn.cu",
         "replaces": "textualdegremoval_tpu/ops/flash_attn.py:53",
         "launches": flash_launches,
         "max_abs_err": max(r[1] for r in flash_main),
         "ms": sum(r[0] * r[2] for r in flash_main),
         "plain_ms": sum(r[0] * r[3] for r in flash_main),
         "bound_ms": sum(r[0] * flash_bound_ms(*r[5])[0] for r in flash_main),
         "bound_by": flash_bound_ms(*flash_main[0][5])[1],
         "library_ms": sum(r[0] * r[4] for r in flash_main)},
        # per I2T micro-step at 512 px, batch 4 (4 pairs at (4, 4096, 5,
        # 64), bf16)
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": src + "flash_attn_bwd.cu",
         "replaces": "textualdegremoval_tpu/ops/flash_attn.py:59 (stock "
                     "_flash_attention_bwd: _flash_attention_bwd_dkv, "
                     "_flash_attention_bwd_dq)",
         "launches": bwd_launches,
         "max_abs_err": max(r[1] for r in bwd_flash_rows),
         "ms": sum(r[0] * r[2] for r in bwd_main),
         "plain_ms": sum(r[0] * r[3] for r in bwd_main),
         "bound_ms": sum(r[0] * flash_bwd_bound_ms(*r[5])[0]
                         for r in bwd_main),
         "bound_by": flash_bwd_bound_ms(*bwd_main[0][5])[1],
         "library_ms": sum(r[0] * r[4] for r in bwd_main)},
        # per 512 px promptir_all_in_one forward with chain on (its 8
        # stages, bf16: `chain_pipeline`, the block pipeline's kernels with
        # bwd_gemm.cu's chain epilogue at each boundary; float32 and other
        # bf16 widths run tblock_chain.cu, timed in bf16 beside as
        # tblock_chain_cu_ms); launches: phase 18's chain-on evaluation
        # path's boundaries, epilogue_launches of them through the chain
        # epilogue; blocks_ms: the stages' blocks one by one
        {"name": "tblock_chain_fused", "route": "cuda",
         "source": src + "bwd_gemm.cu",
         "sources": [src + f for f in ("bwd_gemm.cu", "fwd_stencil.cu",
                                       "bwd_stencil.cu", "wgrad.cu",
                                       "halo_tiles.cuh", "tma_maps.cuh",
                                       "hopper.cuh", "tblock_common.cuh",
                                       "tblock_chain.cu", "tblock.cu")],
         "replaces": "textualdegremoval_tpu/ops/pallas/tblock.py:829 "
                     "(_tblock_chain_impl; _make_apply_stats_kernel :314)",
         "launches": pir_chain_counts[1],
         "epilogue_launches": pir_chain_more[1],
         "max_abs_err": max(r[1] for r in chain_rows),
         "ms": sum(r[0] * r[2] for r in chain_rows),
         "plain_ms": sum(r[0] * r[3] for r in chain_rows),
         "blocks_ms": sum(r[0] * r[4] for r in chain_rows),
         "tblock_chain_cu_ms": sum(r[0] * r[5] for r in chain_rows),
         "bound_ms": sum(n * ms for n, ms, _ in chain_per),
         "bound_by": max(chain_per, key=lambda r: r[0] * r[1])[2],
         "library_ms": None},
        # per 512 px restormer_deblur forward on the module path (52
        # GDFNs, bf16: `gdfn_pipeline`, bwd_gemm.cu's two products around
        # fwd_stencil.cu's gate stencil; float32 and other bf16 widths run
        # gdfn.cu, timed in bf16 beside as gdfn_cu_ms); launches: phase
        # 21's evaluation path, pipeline_launches of them through the
        # pipeline
        {"name": "gdfn_fused", "route": "cuda",
         "source": src + "bwd_gemm.cu",
         "sources": [src + f for f in ("bwd_gemm.cu", "fwd_stencil.cu",
                                       "halo_tiles.cuh", "tma_maps.cuh",
                                       "hopper.cuh", "tblock_common.cuh",
                                       "gdfn.cu", "tblock_fwd.cuh")],
         "replaces": "textualdegremoval_tpu/ops/pallas/gdfn.py:215 "
                     "(_gdfn_fused_impl :156, _make_kernel :71)",
         "launches": mod_on[3][0], "pipeline_launches": mod_on[3][2],
         "max_abs_err": max(r[1] for r in gdfn_rows),
         "ms": sum(r[0] * r[2] for r in gdfn_rows),
         "plain_ms": sum(r[0] * r[3] for r in gdfn_rows),
         "gdfn_cu_ms": sum(r[0] * r[4] for r in gdfn_rows),
         "bound_ms": gdfn_bound, "bound_by": gdfn_by, "library_ms": None},
        # per 512 px restormer_deblur forward on the module path (52
        # attentions, bf16 q and k, f32 attn: csrc/wgrad.cu's gram with its
        # square sums, then csrc/mdta_gram.cu's finish; float32 and other
        # widths run csrc/mdta.cu, timed beside as mdta_cu_ms); launches:
        # phase 21's, gram_launches of them on the gram route; library: one
        # torch.matmul of the gram on the same operands
        {"name": "mdta_stats", "route": "cuda",
         "source": src + "mdta_gram.cu",
         "sources": [src + f for f in ("mdta_gram.cu", "wgrad.cu",
                                       "tma_maps.cuh", "hopper.cuh",
                                       "tblock_common.cuh", "mdta.cu")],
         "replaces": "textualdegremoval_tpu/ops/pallas/mdta.py:60 "
                     "(mdta_stats_pallas; _make_stats_kernel :24)",
         "launches": mod_on[3][1], "gram_launches": mod_on[3][3],
         "max_abs_err": max(r[1] for r in mdta_rows),
         "ms": sum(r[0] * r[2] for r in mdta_rows),
         "plain_ms": sum(r[0] * r[3] for r in mdta_rows),
         "mdta_cu_ms": sum(r[0] * r[5] for r in mdta_rows),
         "bound_ms": mdta_bound, "bound_by": mdta_by,
         "library_ms": sum(r[0] * r[6] for r in mdta_rows)},
        # B9, on no path of the model: per qkv tool run (its four 512 px
        # cases, one call each, bf16: csrc/probe_qkv_tma.cu; float32 and
        # other widths run csrc/probe_qkv_form.cu); ms: phase 23's, tool_ms
        # the tool's own run; launches: one run of the tool, tma_launches
        # of them on probe_qkv_tma.cu; library: the dense 3x3 cuDNN conv of
        # the same function; composed's own_bound_ms: its K = 9C product
        # or the bytes, per case
        *({"name": f"qkv_{form}", "route": "cuda",
           "source": src + "probe_qkv_tma.cu",
           "sources": [src + f for f in ("probe_qkv_tma.cu", "runs16.cuh",
                                         "halo_tiles.cuh", "tma_maps.cuh",
                                         "hopper.cuh", "tblock_common.cuh",
                                         "probe_qkv_form.cu")],
           "replaces": "tools/bench_qkv_form.py:109 (_run_pallas with "
                       f"_kernel_{form} :{line})",
           "launches": probe_launches[f"qkv_{form}"],
           "tma_launches": probe_launches[f"qkv_{form}_tma"],
           "max_abs_err": max(r[0] for r in qkv_rows[form]),
           "ms": sum(r[1] for r in qkv_rows[form]),
           "tool_ms": qkv_tool_ms[form],
           "plain_ms": sum(r[2] for r in qkv_rows[form]),
           "bound_ms": qkv_bound, "bound_by": qkv_by,
           **({"own_bound_ms": qkv_own, "own_bound_by": qkv_own_by}
              if form == "composed" else {}),
           "library_ms": sum(r[3] for r in qkv_rows[form])}
          for form, line in (("current", 51), ("composed", 70))),
        # per stencil step of the concat variant at the tool's shape (bf16,
        # the kernel looping 3000 steps in one launch); bound: its FMAs at
        # the CUDA-core rate; launches: one run of the tool (4 variants);
        # library: one cuDNN depthwise conv step
        {"name": "stencil_loop", "route": "cuda",
         "source": src + "probe_stencil.cu",
         "replaces": "tools/bench_stencil.py:109 (make_kernel :50)",
         "launches": probe_launches["stencil_loop"],
         "max_abs_err": stencil_rows["concat"][0],
         "ms": stencil_rows["concat"][1],
         "plain_ms": stencil_rows["concat"][2],
         "bound_ms": stencil_bound, "bound_by": "operations",
         "library_ms": stencil_rows["concat"][3]},
    ]}
    log(f"train step 384 px batch 8 bf16: {step_ms:.2f} ms through the "
        f"kernels vs {plain_step_ms:.2f} ms through plain blocks, peak "
        f"{peak:.2f} GiB")
    log(f"nafnet: forward 512 px bf16 {naf_fwd_ms:.2f} ms "
        f"({1e3 / naf_fwd_ms:.3f} images/s); train step 384 px batch 8 bf16 "
        f"{naf_step_ms:.2f} ms through the kernel vs {naf_plain_step_ms:.2f} "
        f"ms through plain blocks, peak {naf_peak:.2f} vs "
        f"{naf_plain_peak:.2f} GiB")
    for name, (per_image, step_ms, peak_gib, _) in gen_out.items():
        log(f"pipeline A {name}: {per_image:.3f} s per 512 px image "
            f"({1 / per_image:.4f} images/s), DDIM step {step_ms:.2f} ms, "
            f"peak {peak_gib:.2f} GiB")
    log(f"pipeline A training: I2T micro-step 512 px batch 4 bf16 "
        f"{i2t_ms:.2f} ms through the kernels vs {i2t_plain_ms:.2f} ms "
        f"through attention_ref, peak {i2t_peak:.2f} vs {i2t_plain_peak:.2f} "
        f"GiB")
    log(f"promptir_all_in_one: forward 512 px bf16 {pir_ms:.2f} ms "
        f"({1e3 / pir_ms:.3f} images/s) block by block, {pir_chain_ms:.2f} ms "
        f"({1e3 / pir_chain_ms:.3f} images/s) with the chain; host enqueue "
        f"{pir_enqueue:.2f} / {pir_chain_enqueue:.2f} ms; per forward "
        f"the chain {sum(r[0] * r[2] for r in chain_rows):.3f} ms "
        f"against {sum(r[0] * r[4] for r in chain_rows):.3f} ms block by "
        f"block, {sum(r[0] * r[5] for r in chain_rows):.3f} ms on "
        f"tblock_chain.cu and {sum(r[0] * r[3] for r in chain_rows):.3f} ms "
        f"plain")
    log(f"restormer_deblur module path: forward 512 px bf16 {mod_on[1]:.2f} "
        f"ms ({1e3 / mod_on[1]:.3f} images/s) with gdfn_fused and "
        f"mdta_stats, {mod_off[1]:.2f} ms ({1e3 / mod_off[1]:.3f} images/s) "
        f"without; per forward gdfn_fused "
        f"{sum(r[0] * r[2] for r in gdfn_rows):.3f} ms (gdfn.cu "
        f"{sum(r[0] * r[4] for r in gdfn_rows):.3f}, plain "
        f"{sum(r[0] * r[3] for r in gdfn_rows):.3f}), mdta_stats "
        f"{sum(r[0] * r[2] for r in mdta_rows):.3f} ms (mdta.cu "
        f"{sum(r[0] * r[5] for r in mdta_rows):.3f}, plain "
        f"{sum(r[0] * r[3] for r in mdta_rows):.3f}, the gram as "
        f"torch.matmul {sum(r[0] * r[6] for r in mdta_rows):.3f}); train "
        f"step 384 px "
        f"batch {MODULE_TRAIN_BATCH} bf16 {mod_step_ms:.2f} ms with "
        f"gdfn_fused vs {mod_plain_step_ms:.2f} ms without, peak "
        f"{mod_peak:.2f} vs {mod_plain_peak:.2f} GiB")
    log(f"B9 qkv per tool run (bf16, the tool's own run): current "
        f"{qkv_tool_ms['current']:.4f} / composed "
        f"{qkv_tool_ms['composed']:.4f} / cudnn {qkv_tool_ms['cudnn']:.4f} "
        f"ms")
    log("B9 probes (bf16), per case current / composed / cudnn ms and each "
        "one's fraction of the bound: " + "; ".join(
            f"{c}->{co} {cu[1]:.4f} / {cm[1]:.4f} / {cu[3]:.4f} "
            f"({b / cu[1]:.3f} / {b / cm[1]:.3f} / {b / cu[3]:.3f} of "
            f"{b:.4f} ms)"
            for cu, cm, (b, _), (_, c, co) in zip(
                qkv_rows["current"], qkv_rows["composed"], qkv_per,
                QKV_CASES)))
    log(f"B9 stencil per step (bf16, t={t_st} W={w_st} ch={ch_st}; CUDA-core "
        f"peak {core_peak / 1e12:.3f} TFLOP/s f32 from {sms} SMs at {mhz} "
        "MHz, packed bf16 twice that): " + "; ".join(
            f"{v} {r[1] * 1e3:.3f} us "
            f"({stencil_bound / r[1] / (2 if v in pr.BF16_VARIANTS else 1):.4f}"
            " of its peak)" for v, r in stencil_rows.items())
        + f"; plain concat {stencil_rows['concat'][2] * 1e3:.3f} us, cudnn "
        f"{stencil_rows['concat'][3] * 1e3:.3f} us")
    log(f"promptir_all_in_one training (phase 25): step 384 px batch "
        f"{PROMPTIR_TRAIN_BATCH} bf16 {pir_step_ms:.2f} ms through the "
        f"kernels, peak {pir_peak:.2f} GiB; f32 batch {PROMPTIR_F32_BATCH} "
        f"{pir_f32_ms:.2f} ms, peak {pir_f32_peak:.2f} GiB; launches (4 "
        f"bf16 steps) {pir_step_launches}")
    log("shipped YAMLs through the CLI (phase 26): " + "; ".join(
        f"{k} {v[1]:.3f} s an iteration, launches {v[0]}"
        for k, v in yaml_runs.items()))
    log(f"DINO matcher (phase 27): {dino_ms:.2f} ms a step of "
        f"{DINO_BATCH} crops x {dino_windows} windows (vit_base f32), peak "
        f"{dino_peak:.2f} GiB")
    for fam_name, key, spa_key, spa_task in (
            ("drsformer_derain", "drs", "drs_spa_ms", DRS_SPA_TASK),
            ("sfnet_dehaze_indoor", "sfnet", "sfnet_outdoor_ms",
             SFNET_TASKS[1])):
        ev, st = fam[f"{key}_eval"], fam[f"{key}_step"]
        log(f"{fam_name} (phases 28-31, no kernel): forward 512 px "
            + ", ".join(f"{d} {v[0]:.2f} ms ({1e3 / v[0]:.3f} images/s, "
                        f"peak {v[2]:.2f} GiB)" for d, v in ev.items())
            + f"; {spa_task} bf16 {fam[spa_key]:.2f} ms; train step 384 px "
            + ", ".join(f"{d} batch {v[0]} {v[1]:.2f} ms (peak {v[2]:.2f} "
                        f"GiB; did not fit {v[3]})" for d, v in st.items()))
    fwd, dcli = diffir["forward"], diffir["cli"]
    log(f"NAFNetDynamicFusion (phases 33-35, no kernel): {fwd['params']} "
        f"parameters ({fwd['head_params']} in the affine heads); forward 512 "
        f"px f32 {fwd['fwd_ms']:.2f} ms (peak {fwd['peak_gib']:.2f} GiB, idle "
        f"share {fwd['idle']}), the embedding {fwd['embed_ms']:.2f} ms an "
        f"image; the DiffIR CLI at {DIFFIR_GT} px batch {dcli['batch']}: "
        f"embedding {dcli['embed_ms']:.2f} ms + step {dcli['step_ms']:.2f} ms "
        f"an iteration, peak {dcli['peak_gib']:.2f} GiB, idle share "
        f"{dcli['idle']}; the keyed archives' decoder "
        f"{diffir['archives']['decoder']}")
    # launches of each kernel on the DRSformer and SFNet paths (phases
    # 28-32) and the DiffIR path (33-34): 0 wherever the run got this far
    for row in summary["kernels"]:
        counter = ("flash_attention.launches_bwd"
                   if row["name"] == "flash_attention_bwd"
                   else f"{row['name']}.launches")
        row["drsformer_sfnet_launches"] = fam["launches"][counter]
        row["diffir_launches"] = diffir["launches"][counter]
        row["fid_launches"] = mp["launches"][counter]
        if row["name"] == "tblock_fused":
            row["tiled_launches"] = mp["tiled"]["launches"]
        if row["name"] == "nafblock_fused":
            row["archive_launches"] = {
                io: diffir["archives"][io] for io in ("lmdb", "tfrecord")}
        # phases 39 and 40: each rank's launches in (b)'s sharded forwards
        # (two ranks sharing the card, 768 rows each): restormer_deblur's
        # and promptir_all_in_one's B1, nafnet_deblur's B5
        if row["name"] == "tblock_fused":
            row["spatial_launches"] = [
                r["launches"].get("tblock_fused.launches", 0)
                for r in spatial["ranks"]]
            row["promptir_spatial_launches"] = [
                r["families"][PROMPTIR_TASK]["launches"].get(
                    "tblock_fused.launches", 0) for r in spatial["ranks"]]
        if row["name"] == "nafblock_fused":
            row["spatial_launches"] = [
                r["families"][NAF_TASK]["launches"].get(
                    "nafblock_fused.launches", 0) for r in spatial["ranks"]]
            row["spatial_pipeline_launches"] = [
                r["families"][NAF_TASK]["launches"].get(
                    "naf_pipeline.launches", 0) for r in spatial["ranks"]]
        # phase 38: each rank's launches in (a)'s reduced step and (b)'s
        # FSDP step (two ranks sharing the card)
        for i, k in enumerate(DIST_KERNELS):
            if row["name"] == k.__name__:
                row["dist_launches"] = [r["launches"][i] for r in dist["dp"]]
                row["fsdp_launches"] = [r["fsdp"]["launches"][i]
                                        for r in dist["dp"]]
    til, met = mp["tiled"], mp["metrics"]
    log(f"tiled restoration (phase 36): {TILED_HW[0]}x{TILED_HW[1]} bf16 "
        f"{til['image_ms']:.1f} ms an image ({TILED_TILES} tiles, "
        f"{til['launches']} B1 launches), peak {til['peak_gib']:.2f} GiB "
        f"(one 512 px forward {til['tile_peak_gib']:.2f}), idle share "
        f"{til['idle']}, vs plain blocks {til['max_abs_err']:.4e}; "
        f"model_complexity {til['complexity']['flops'] / 1e12:.4f} TFLOP a "
        f"512 px forward; FID (phase 37): extraction "
        f"{met['extract_rate']:.1f} images/s, frechet_distance "
        f"{met['frechet_s']:.2f} s on the host, FID(a, b) "
        f"{met['fid_ab']:.4f}, NIQE {met['niqe']:.4f}, Y PSNR "
        f"{met['psnr']:.4f} dB, SSIM {met['ssim']:.4f}")
    dp, dc = dist["dp"], dist["diffir"]
    log(f"distributed (phase 38, {DIST_WORLD} ranks on one card over "
        f"{dp[0]['backend']}): (a) flagship step 384 px bf16, "
        f"{DIST_BATCH // DIST_WORLD} images a rank: "
        f"{[round(r['step_ms'], 1) for r in dp]} ms a rank against "
        f"{dist['ref_a']['step_ms']:.1f} ms in one process on "
        f"{DIST_BATCH}; all-reduce of {dp[0]['reduce_bytes']} bytes "
        f"{[round(r['reduce_ms'], 1) for r in dp]} ms; peak "
        f"{[round(r['peak_gib'], 2) for r in dp]} GiB; (b) FSDP step "
        f"{[round(r['fsdp']['step_ms'], 1) for r in dp]} ms, gather "
        f"{[round(r['fsdp']['gather_ms'], 1) for r in dp]} ms, "
        f"reduce-scatter {[round(r['fsdp']['scatter_ms'], 1) for r in dp]} "
        f"ms; (c) DiffIR FSDP step "
        f"{[round(r['step_ms'], 1) for r in dc]} ms, gather "
        f"{[round(r['gather_s'], 2) for r in dc]} s, reduce-scatter "
        f"{[round(r['scatter_s'], 2) for r in dc]} s, peak "
        f"{[round(r['peak_gib'], 2) for r in dc]} GiB a rank; (d) the CLI "
        f"{dist['cli']['seconds']:.1f} s; phase 38 {dist['seconds']:.1f} s")
    sr, se, ranks = spatial["ref"], spatial["errors"], spatial["ranks"]

    def per_rank(key, scale=1.0, nd=1):
        return [round(r["trace"][key] * scale, nd) if key in r["trace"]
                else round(r[key] * scale, nd) for r in ranks]
    log(f"spatially sharded forward (phase 39, {SPATIAL_WORLD} ranks on one "
        f"card over {ranks[0]['backend']}): {SPATIAL_HW} bf16 "
        f"{per_rank('ms')} ms a rank against {sr['ms']:.1f} ms in one "
        f"process (device busy {sr['device_ms']:.1f} ms); exchanges "
        f"{per_rank('exchanges', nd=0)} of {per_rank('exchange_bytes', nd=0)}"
        f" bytes in {per_rank('exchange_s', 1e3)} ms, reductions "
        f"{per_rank('reduce_s', 1e3)} ms; peak {per_rank('peak_gib', nd=2)} "
        f"GiB a rank against {sr['peak_gib']:.2f}; gathered vs one process "
        f"L2 {se['bf16_l2']:.3e}, f32 max abs {se['f32_max_abs']:.3e}; "
        f"phase 39 {spatial['seconds']:.1f} s")
    for task in FAMILY_SPATIAL_TASKS:
        fr, fe = spatial["fam_ref"][task], spatial["fam_errors"][task]
        rk = [r["families"][task] for r in ranks]
        log(f"{task} sharded (phase 40, {SPATIAL_WORLD} ranks on one card): "
            f"{SPATIAL_HW} bf16 {[round(r['ms'], 1) for r in rk]} ms a rank "
            f"against {fr['ms']:.1f} ms in one process (device busy "
            f"{fr['device_ms']:.1f} ms, idle {fr['idle']}); exchanges "
            f"{[r['trace']['exchanges'] for r in rk]} of "
            f"{[r['trace']['exchange_bytes'] for r in rk]} bytes in "
            f"{[round(r['trace']['exchange_s'] * 1e3, 1) for r in rk]} ms, "
            f"reductions {[r['trace']['reduces'] for r in rk]} of "
            f"{[r['trace']['reduce_bytes'] for r in rk]} bytes in "
            f"{[round(r['trace']['reduce_s'] * 1e3, 1) for r in rk]} ms; peak "
            f"{[round(r['peak_gib'], 2) for r in rk]} GiB a rank against "
            f"{fr['peak_gib']:.2f}; gathered vs one process L2 "
            f"{fe['bf16_l2']:.3e}, f32 max abs {fe['f32_max_abs']:.3e}")
    log(f"phase 40 {spatial['fam_seconds']:.1f} s")
    for task in POOL_SPATIAL_TASKS:
        pool_r = spatial["pool_ref"][task]
        pool_e = spatial["pool_errors"][task]
        rk = [r["pools"][task] for r in ranks]
        log(f"{task} sharded (phase 41, {SPATIAL_WORLD} ranks on one card, "
            f"no kernel): {SPATIAL_HW} bf16 "
            f"{[round(r['ms'], 1) for r in rk]} ms a rank against "
            f"{pool_r['ms']:.1f} ms in one process (device busy "
            f"{pool_r['device_ms']:.1f} ms, idle {pool_r['idle']}); "
            f"exchanges "
            f"{[r['trace']['exchanges'] for r in rk]} of "
            f"{[r['trace']['exchange_bytes'] for r in rk]} bytes in "
            f"{[round(r['trace']['exchange_s'] * 1e3, 1) for r in rk]} ms, "
            f"reductions {[r['trace']['reduces'] for r in rk]} of "
            f"{[r['trace']['reduce_bytes'] for r in rk]} bytes in "
            f"{[round(r['trace']['reduce_s'] * 1e3, 1) for r in rk]} ms; peak "
            f"{[round(r['peak_gib'], 2) for r in rk]} GiB a rank against "
            f"{pool_r['peak_gib']:.2f}; gathered vs one process "
            + (f"with its masks L2 {pool_e['replay']['l2']:.3e}, "
               if "replay" in pool_e else "")
            + f"free-running L2 {pool_e['free']['l2']:.3e} (one process "
            f"under roundings alone {pool_e['noise']['batch2']['l2']:.3e}, "
            f"{pool_e['noise']['ulp']['l2']:.3e}), f32 max abs "
            f"{pool_e['f32']['free']['max_abs']:.3e}"
            + (f" ({pool_e['f32']['replay']['max_abs']:.3e} with its "
               "masks)" if "replay" in pool_e["f32"] else "")
            + f"; top-k flips bf16 {pool_e['flips']}, f32 "
            f"{pool_e['f32']['flips']}")
    log(f"phase 41 {spatial['pool_seconds']:.1f} s")
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s after "
        f"the build")
    log(json.dumps(summary))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
