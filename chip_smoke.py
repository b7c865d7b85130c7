#!/usr/bin/env python
"""Chip smoke test of the PyTorch + CUDA port (`cld_tpu_torch`) on one GPU.

    python chip_smoke.py

1. Fails unless CUDA is available; prints the card's name and power limit.
2. Builds the port's CUDA kernels from `cld_tpu_torch/csrc/` (nvcc, sm_90a).
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes of the guided pipeline (B=128 agents, T=52, H=64; 5200 map
   queries per agent on a 224x224 map), with TF32 off: the LSTM forward
   outputs, the LSTM reverse sweep's gate cotangents, the VJP of
   `Lstm2Core` in all five arguments against autograd through the plain
   forward, and the bit gather (exactly). The two LSTM kernels are also held
   at B/T/H 32/52/64 (the closed loop), 512/52/64 (two rows per CTA),
   130/52/64 (a ragged last CTA) and 5/7/16 (small H), two launches of each
   must agree bit for bit, and their registers and spills per thread are
   reported. Times each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (cuDNN's LSTM forward, and its
   backward beside the port's whole `Lstm2Core` VJP; one `torch.take` for
   the two map gathers of step 6); the LSTM kernels also from a CUDA graph
   at B = 32, 128 and 512. Computes each kernel's bound from its bytes and
   operations (a gather's bound counts, of its source, only the bytes under
   this run's queries).
4. Runs `pipeline.guided_collect` at the full width of the config of record
   (ResNet-18 over 224x224x34, cond 256, UNet dim 32 x (2, 4, 8), LSTM H=64,
   100 DDPM steps, agent + map collision guidance) with seeded random
   weights, guided then unguided: launch counts are zeroed just before the
   guided run and read just after; outputs must be finite; prints NFE/s.
5. Runs the slice at a small size (B=8, raster 64, 10 steps) on the card and
   on the CPU (plain versions) with the same weights and noise, and holds
   the results against each other.
6. Holds the two map-gather kernels of the closed loop against their plain
   versions, exactly, at the closed loop's shapes: `value_gather` (64
   windows of 256x256x3 int8, 25,088 queries each; also with Q % 4 != 0,
   C = 1, 4 and 5, one window, and pix 8 bytes off a 16-byte boundary, with
   its registers and spills, and its time from a CUDA graph beside one
   `torch.take`) and `drivable_gather` (32 maps of 224x224, 5,200 queries
   each; int8 and float32 maps; also at `DRIVABLE_GATHER_EDGES`, B 1/32/33
   and Q 1/3/4/5/5,199/5,200/5,201, with coordinates outside the map, and
   through a pix view 8 bytes off a 16-byte boundary, so on its 16-byte and
   its scalar path, two launches bit for bit; its registers and spills and
   its time from a CUDA graph beside one `torch.take`); and the banded
   `warp_scene_maps` against the exact one for the 32-agent pack.
7. Runs the guided closed loop `sim.env.simulate` at full width: 4 scenes x
   8 agents, raster 224x224x34, world maps 512x512x3, 100 frames, a replan
   every 5 frames, each replan one guided 100-step DDPM call. Launch counts
   are zeroed just before the episode and read just after, and must be
   exact (`value_gather` = replans, `lstm2_fwd` = 100 x replans,
   `lstm2_bwd` = `bit_gather` = 99 x replans); the trajectory log must be
   finite; prints `summarize_metrics`, agent-steps/s and the host time per
   replan split into render / policy / step.
8. Runs one replan with `MapCollisionLoss(gather_impl="px")`: its guidance
   gradient and its plan must equal the "bits" ones exactly, with 99
   `drivable_gather` launches and no `bit_gather` launch.
9. Runs a small closed loop (2 x 3 agents, raster 64, 10 DDPM steps, 10
   frames) on the card and on the CPU with the same weights and noise.
10. Holds the three rigid map-distance kernels against their plain versions
   on the card at the open loop's shape (B=128 agents, Q=52 steps, P=100 bbox
   points; the distance cache from `prepack_map_bbox` on the synthetic batch,
   the on-road mask from the batch's own map with random bits mixed in and
   an all-off-road and an all-on-road step forced) and at two ragged shapes:
   `rigid_min` and `rigid_min_fused` give `dist` and `idx` equal to the
   plain version's bit for bit, and so to each other, there and at 14 edge
   shapes on lattice caches (P = 1, 31, 32, 33, 65, 224; Q = 1, 3, 5, 7, 9,
   17, 53, 65; B = 1, 133); `rigid_bwd` agrees within rtol 1e-4 / atol 1e-5
   and repeats itself bit for bit, there and at P = 1, P = 33 and with every
   column routed to one row (P = 100 and 224). Past 224 bbox points
   (`RIGID_TILED`: P = 225, 256, 400, 1,024, where the forward kernels tile
   the cache's columns and the backward loops over its chunks) all three at
   ragged B and Q on lattice caches: `dist` and `idx` exact, the backward
   within rtol 1e-4 / atol 1e-5 (the argmin's routing; at P = 256 also every
   column to one row), each relaunch bit-equal; the same holds at the 16 x
   16 paths' own shape (B = 128, Q = 52, P = 256). Times each, from a CUDA
   graph at B = 128 and 32 beside its bound at both and at B = 128, P = 256, with the
   forward kernels' registers and spills (untiled and tiled) and
   `rigid_bwd`'s at P = 1, 33, 100, 224 and 256.
11. Runs `pipeline.guided_collect` at full width with
   `MapCollisionLoss(min_dist_impl="rigid_kernel")` (99 `rigid_min`, 99
   `rigid_bwd`, no `rigid_min_fused`) and with `min_dist_impl="rigid",
   min_fwd_impl="fused"` (99 `rigid_min_fused`, none of the other two);
   launch counts zeroed before each and exact; prints NFE/s; then both
   again with `num_points_lw=(16, 16)` (P = 256, the tiled kernels; the
   loss's full-horizon budget, 2^27 elements of T B P^2 as in the JAX
   package, raised for the fused call): exact launches, finite outputs. One guidance
   gradient at B=128 under "rigid_kernel", "rigid" + "fused" and
   "separable": the first two agree within rtol 1e-4, the loss values of
   all three within 1e-5 relative.
12. Runs one closed-loop replan (4 x 8 agents) and the small slice of 5 with
   "rigid_kernel" specs: exact launch counts, a finite plan, card vs CPU.
13. Holds the two reward kernels against their plain versions on the card:
   `offroad_count` exactly, at the reward's shape (B=128 maps of 224x224, 52
   points each), with 5 groups of points per map, at two odd small shapes
   and at every combination of `OFFROAD_EDGES` (P 1/31/32/33/52/64/65/
   127/128/129/200, G 1/3/5, B 1/128/129, coordinates outside the map), two
   launches bit for bit, with its registers and spills; `disk_collision`
   within rtol 1e-5 / atol 1e-6 at T=52, B=128, D=5 (scenes of 4,
   same-scene off-diagonal pairs, and every off-diagonal pair), at T/B/D
   8/6/4, 3/5/1 and 6/7/9 (more disks than the kernel unrolls, so its
   runtime-D loop), at B=1 (an agent paired with itself), B=33 (one past a
   warp of mask columns), with an empty mask (exactly 0) and at D=9 under
   the same-scene mask, and the runtime-D loop at D=5 too; two launches
   bit-identical. Times each from Python and from a CUDA graph (both
   masks), the runtime-D loop beside the unrolled one.
14. Trains at full width on a synthetic batch (B=128, raster 224x224x34, the
   config of record with `steps_per_epoch` 1 so that the warm-up rate leaves
   0 after the first step): 2 warm-up and 5 timed `VAETrainer.train_step`s
   and one `eval_step` (one `lstm2_fwd` launch), then the same of
   `DMTrainer.train_step` on the trained VAE; losses finite, parameters
   moved; prints steps/s.
15. Runs the PPO stage at full width: a buffer of 3,000, 3 `collect_step`s
   (exactly 3 `lstm2_fwd` and 3 `offroad_count` launches), one update phase
   at mini-batch 128 cut to 30 iterations, one `test_step` (one more
   `lstm2_fwd`); prints collect steps/s and update iterations/s. Then, as a
   path of its own (`ppo_disk_penalty`: the trainer's entry points never call
   this op), the `disk_collision` penalty of the last collection's
   trajectories (scenes of 4 agents parked 3 m apart, so that they overlap;
   held against its plain version and against `AgentCollisionLoss`'s flat
   path): exactly 1 launch.
16. Holds one VAE step's and one DM step's gradients and one `collect_step`'s
   trajectories and rewards on the card against the CPU at a small size (the
   `cld_smoke` widths, B=8), same weights and explicit noise.
17. Runs the guidance rule library through the rollout CLI
   (`rollout.main`) at the closed loop's width (4 scenes x 8 agents, raster
   224, 100 DDPM steps), cut to 20 frames (4 replans), with `--editing-source
   config,heuristic`: `RULE_CONFIGS` and `RULE_HEURISTICS` instantiate all 15
   rule classes. The CLI runs a warm-up episode and times a second one,
   whose launches it reports; the counts, zeroed before the call and read
   after it, are exact: per replan of each episode 100 `lstm2_fwd`, 99
   `lstm2_bwd`, 99 `bit_gather`, 1 `value_gather`, and 1 `bit_gather` for
   the satisfaction report's map rule; the trajectory
   log and the guidance-satisfaction report must be finite. Then one guided
   replan's guidance gradient under the same rules at 2 x 4 agents on the
   card and on the CPU: a finite loss within 1e-5 relative, the gradient
   within 1e-4 relative (plus 1e-5 of its largest entry).
18. Runs the checkpoint path at the full width of the config of record:
   trains the VAE and then the DM stage through `train.main`, 2 steps each
   (a JSON config sets one-step epochs, so that the rate leaves 0), writing
   `ckpt_final` files under chiprun_out/; rolls them out through
   `rollout.main` with `--registered-name cld_dm_nusc`, `--vae-ckpt`,
   `--dm-ckpt` and `--cle-report` (4 scenes x 8 agents, raster 224, 100
   DDPM steps, 20 frames: 4 replans; launch counts zeroed before and exact
   after, as the rules path's with the flagship rules); `summarize_metrics`,
   the occupancy metrics and the CLE summary must be finite, and the first
   replan's plan of the CLI's models must equal, bit for bit, the plan of
   models loaded straight from the trainers' state dicts with the same
   generator. Then the same weights as a Lightning-style `.ckpt`
   (`{"state_dict": {"vae.*", "dm.model.*"}}`) through the same CLI: the
   same first plan and the same trajectory log, bit for bit. Times the eval
   layer on the rollout's log (the occupancy report and the CLE summary,
   host seconds per call). Then `--mode test` on the checkpoints, 2 validation batches of 128: exactly 2
   `lstm2_fwd` launches, finite failure rates and realism deviation. Prints
   the phase's seconds and the rollout's agent-steps/s beside the card.
19. Runs the data path at full width: writes 2 x 32 synthetic samples at
   raster 224 with the port's converter into a temporary directory (deleted
   at the end); the loader's first batch of 128 on the card must equal the
   host's bit for bit; times the loader per batch of 128 (host gather, copy
   to the card) beside a VAE step on its batch; trains the VAE and then the
   DM stage 2 steps each through `train.main` from the shards (finite
   losses, no kernel launch); runs the rollout CLI on `--scene-data` (4
   scenes x 8 agents, 20 frames) with `--policy dm --agents-policy
   gt_replay`, the flagship rules, `--num-action-samples 2 --guide-with-gt`
   and `--cle-report`: launches exact as the rules path's, a finite log and
   report with `compile_and_first_run_s`; runs `occupancy_report` twice on
   its log on the card (grids within rtol 1e-5 / atol 1e-7, every cell clear
   of the 0.1 threshold, equal metrics); runs `--policy gt_replay`,
   `lattice`, `mpc` and `contingency` at the same width (no LSTM or bit
   gather launch, one `value_gather` a replan of each episode; seconds per
   replan); then
   card against CPU: the replay with every agent uncontrolled follows the
   pack's `gt_states` within 1e-5 m; one MPC and one contingency replan on
   `planner_observation`, each held where it is continuous
   (`check_planners_card_vs_cpu`: the MPC's controls after 20 iterations,
   and its final costs after the record's 100).
20. Runs the model zoo at full width from step 19's shards (the config of
   record: batch 128, raster 224x224x34, horizon 52, ResNet-18, cond_feat
   256): each of the eleven algos through `train.main` with
   `--registered-name nusc_<algo> --mode zoo --steps 3` (ms per step over
   steps 2 and 3, peak device memory, final loss, `ckpt_final`; finite
   metrics and no kernel launch); one VAE step with ResNet-50 and with the
   spatial-softmax head and one DM step with the residual-MLP denoiser
   (finite, no launch); then each algo's loss and gradients with
   `train=False` on the card and on the CPU from the same weights and draws
   at B=4, raster 64 (the loss within 1e-4 relative, each gradient within
   1e-4 of its largest entry).
21. Runs the learned path at full width: from step 19's shards (batch 128,
   raster 224x224x34, ResNet-18, cond_feat 256) `train.main` 3 steps each
   of `--registered-name nusc_ebm --mode ebm`, `nusc_gan --mode gan` and
   `nusc_transformer_gan --mode gan`, and of `trajdata_nusc_scene_diff
   --mode scene_dm` (16 synthetic scenes x 8 agents, horizon 52, width 128,
   4 layers): ms per step (steps 2-3), peak memory, finite metrics, no
   kernel launch; the rollout CLI with `--ebm-ckpt` on the EBM just trained
   (4 scenes x 8 agents, raster 224, 100 DDPM steps, 20 frames, the
   flagship rules): the rules path's launches plus one `value_gather` per
   anchor of the scored log (frames 0 and 10 of 20), finite
   `ebm_score_mean` / `ebm_score_min`; `sim.env.simulate` with
   `scene_dm_policy` of the scene model just trained (4 scenes x 8 agents,
   20 frames, 100 diffusion steps a replan): one `value_gather` a replan
   and nothing else; `latent_attack` at B=128, z [52, 4], through the
   frozen H=64 decoder and the unicycle, 50 Adam steps on the rule
   library's collision attack: 51 `lstm2_fwd` and 50 `lstm2_bwd`, the
   objective lower at the end; then card vs CPU at the `cld_smoke` widths
   (B=4, raster 64): the EBM's InfoNCE loss and gradients, each GAN
   update's (both generators), the scene model's loss and gradients and 10
   steps of `scene_sample`, `ebm_rollout_scores` on a log of k/255 maps,
   and one attack step's gradient (within 1e-4).
22. Runs the composer path: each of the 24 policy composers
   (`eval.composers`) through `rollout.main --composer <name>` at the
   closed loop's width (4 scenes x 8 agents, raster 224, the config of
   record: ResNet-18, `cond_feat` 256, horizon 52, 100 diffusion steps for
   Diffuser, DSPolicy and SceneDiffuser), cut to 20 frames (4 replans): s
   per replan of the timed episode, a finite log, and exact launches: the
   timed episode 4 `value_gather` and nothing else, the whole call twice
   that plus one for a model-based composer's sample observation;
   GroundTruth and GroundTruthNaN, whose actions have no controls, are
   refused at the first replan (`TypeError`, one `value_gather`), as the
   JAX CLI refuses them. `--composer BC --composer-ckpt` on step 20's
   `nusc_bc` `ckpt_final`: loaded strictly, a log unlike the fresh
   weights'. One replan of BC, TrafficSimplan, TPPplan, GANplan, Diffuser,
   DSPolicy and SceneDiffuser on the card and on the CPU at the `cld_smoke`
   widths (1 scene x 2 agents, raster 64) from the same weights,
   observation and draws: actions within 1e-4 of their largest entry, the
   same samples selected. One BC replan under `utils.timer.device_trace`:
   the Chrome trace names `value_gather_kernel`. Data parallelism on a NCCL
   group of world size 1 (localhost store): 2 VAE steps at batch 128,
   raster 224 through the train CLI's wrapping equal the plain ones (1e-6
   relative asked), and with the collectives forced on, one float64 step's
   gradients within 1e-9 and one PPO collection into the global buffer and
   a 2-iteration update phase on rank 0's minibatches within 1e-6 of the
   plain ones. No `--render`: the card's machine has no
   matplotlib.
23. Runs bf16 mixed precision (every step before this one asks for
   precision fp32, whose tolerances it holds; "auto" is bf16 on the card):
   the bf16 instantiation of both LSTM kernels at B = 32, 128, 512 (T = 52,
   H = 64) against their bf16 plain versions on the card, within 2^-7 of
   max |plain|, with the share of elements that are not bit-equal, two
   launches bit for bit, registers and spills, and the times from Python and
   from a CUDA graph beside the f32 kernels' and cuDNN's bf16 `nn.LSTM`; the
   VAE, DM and PPO stages at the config of record (batch 128, raster 224)
   under "auto" beside fp32 from the same weights, batch and draws: ms per
   step, peak memory, the first step's loss within rtol 2e-3 / atol 1e-2 of
   f32's (PPO: its first update iteration on the f32 collection's
   transitions), exact launches; the train CLI at its default precision,
   one step each of `--mode vae|dm|ppo` (every network bf16, every parameter
   f32, exact launches); the guided call at B=128 under "auto": 100
   bf16 `lstm2_fwd`, 99 bf16 `lstm2_bwd`, 99 `bit_gather`, 1
   `offroad_count`, NFE/s beside step 4's, one step's guidance gradient
   through the bf16 decoder at cosine > 0.999 against the f32 decoder's, the
   decoded trajectories beside f32's (reported); the rollout CLI under
   `--precision auto` with step 15's rules argv: 400 / 396 / 396 / 4 bf16
   `lstm2_fwd`, bf16 `lstm2_bwd`, `bit_gather`, `value_gather` in the timed
   episode, agent-steps/s beside step 15's; the other trainers under "auto"
   beside fp32 from the same weights, batch and draws, in turns (fp32,
   bf16, bf16, fp32 blocks of 3 steps): the eleven zoo algos, both GANs and
   the EBM at batch 128, raster 224 (synthetic batch) and scene diffusion at
   16 scenes x 8 agents, with ms per step (steps 2-3), peak memory, no
   kernel launch, every network bf16 but `diff`'s (f32, as the JAX factory
   builds it), every parameter f32 but TransformerPred's two embeddings and
   the scene model's `time_pos_emb` (bf16, as the JAX modules store them),
   and the first loss (the GANs' d_loss) within 5% / atol 1e-2 of f32's
   (`TRAINER_TWIN_RTOL`); `--ebm-ckpt`'s scoring of a 20-frame log of 4 x 8
   agents at raster 224 (one `value_gather` per anchor, 2 anchors) and one
   `SceneDiffuser` composer replan (no launch) at the closed loop's width,
   each timed in turns beside fp32.
24. Runs the LSTM decoder kernels at every hidden size the JAX kernels take
   (H 1-320; `WIDE_HELD`): both sweeps in f32 and bf16 against their plain
   versions at H = 1, 5, 50 (padded onto the H <= 64 kernels) and 72, 96,
   128, 200, 256, 320 (`csrc/lstm_wide.cu`, a thread-block cluster per 8
   or 16 batch rows) at small B / T, B ragged against the cluster's rows:
   f32 within 1e-5 and bf16 within 2^-7 of max |plain|, two launches bit for
   bit; the wide kernels' registers, spills, shared memory and cluster size
   (the f32 forward's and the reverse sweep's chain at 8 and 16 rows a
   cluster, the chain's slice rows in shared memory, its gates GEMM), and
   their times from Python and from a CUDA graph at B = 32, 128, 512, T =
   52, H = 128 and 320, beside the plain versions' and cuDNN's `nn.LSTM`
   (forward, and backward beside the `Lstm2Core` VJP) at that H in the same
   dtype, and cuDNN's from a CUDA graph (f32 with TF32 on, PyTorch's
   default, and off; bf16); the reverse sweep's gates / chain split from
   `torch.profiler` over graph replays at B = 128; the f32 forward and both
   reverse sweeps also held at each timed B, with the rows a cluster each
   chose. Then the guided call at the config of record with
   `algo.vae.hidden_size` 128 (B=128 in scenes of 4, raster 224, 100 DDPM
   steps, agent + map collision guidance), fresh weights from seed 0, under
   "auto" (bf16) and fp32: exactly 100 wide forward and 99 wide reverse
   sweeps of the run's dtype, 99 `bit_gather`, 1 `offroad_count`; NFE/s
   beside step 23's H = 64 rows (no claim); one guidance step's gradient
   bf16 against fp32 at cosine > 0.999; and the small slice of step 5 at
   H = 128, card against CPU. Last the bulk-copy probe (`python -m
   cld_tpu_torch.dma_probe`, the counterpart of
   `scripts/micro_dma_probe.py`): its four cases (minor 128 / 64, the whole
   array or a batch slice) equal to 2 x bit for bit, 4 launches, the copy
   shapes printed, more CTAs than the card has SMs at [52, 128, 128], timed
   from a graph beside `2 * x` and its target of twice its byte bound.
25. Times the launch floor: `torch.cuda._sleep(0)` (one thread that exits
   at once) from a CUDA graph, as every kernel's graph time is taken.
26. Prints the card line, one `{"kernels": [...]}` line (`launches_by_path`
   there holds each main-path run's own count, of 4, 7, 8, 11 (both bbox
   grids), 12, 14, 15,
   17, 18 (its rollout and its `--mode test`), 19 (its training, its
   guided rollout and each model-free policy), 20 (the zoo, 0 of every
   kernel), 21 (each trainer, 0 of every kernel; the `--ebm-ckpt`
   rollout; the scene policy; the latent attack), 22 (each composer's
   call, `--composer-ckpt`, the traced replan), 23 (the bf16 VAE eval
   step, DM steps, PPO collection, train CLI, guided call, rollout, the
   other trainers, the EBM's scoring and the SceneDiffuser replan) and 24
   (the hidden-128 guided calls, the bulk-copy probe), each zeroed
   before its run and checked exactly; `launches` is their sum;
   `graph_ms` is each kernel's time from a CUDA graph at the main path's
   shape, B=128 for the LSTM kernels, beside `launch_floor_ms`), and last
   `{"ok": true, "device": {...}}`. Any failed check exits non-zero first.

A longer report goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate, the f32 (non-tensor-core) and bf16 dense peaks.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

B, T, H, L, COND = 128, 52, 64, 4, 256
AGENTS_PER_SCENE = 4
N_STEPS = 100
RASTER = 224
Q = T * 100  # map-loss query points per agent: horizon x 10x10 bbox grid

# closed loop of record (`bench.py`: CL_SCENES, CL_AGENTS, CL_STEPS; replan / 5)
CL_SCENES, CL_AGENTS, CL_STEPS, CL_N_STEP = 4, 8, 100, 5
CL_B = CL_SCENES * CL_AGENTS
WORLD_MAP = 512

LSTM_REL_TOL = 1e-5  # max |kernel - plain| / max |plain|: f32, other summation order
# B/T/H at which both LSTM kernels are held: the open and closed loops, two rows
# per CTA, a ragged last CTA, a small H
LSTM_SHAPES = ((B, T, H), (CL_B, T, H), (512, T, H), (130, T, H), (5, 7, 16))
SLICE_RTOL = 1e-4  # small-slice card vs CPU: f32 networks on two backends
# the MPC's final FTOCP cost per agent after 100 Adam iterations, card vs CPU:
# 2.4x the largest float32-vs-float64 spread on the CPU (4.2e-2)
MPC_COST_RTOL = 0.1
# gradients that are 0 in exact arithmetic (a bias shifting every logit of a
# softmax), held against the model's largest gradient entry
ZERO_IN_EXACT = ("key.bias", "kp_conv.bias", "score_net.bias")
# bf16 LSTM kernels against their bf16 plain versions, of max |plain|: the two
# round their stores to bf16 from f32 sums taken in other orders, so an element
# may land one bf16 ulp (2^-8 relative) apart, and an ulp of an element near
# max |plain| is at most 2^-7 of it
BF16_REL_TOL = 2.0 ** -7
# bf16 against f32 from the same weights and inputs (ROADMAP "bf16 twins")
TWIN_RTOL, TWIN_ATOL, TWIN_COSINE = 2e-3, 1e-2, 0.999
# the first losses of the trainers beyond the main paths, bf16 against f32:
# they compound a ResNet with a 52-step unicycle integration or a pixel
# softmax, where bf16's rounding alone moves a first loss by up to 0.51% in
# the JAX package (its bf16 against its f32, `bc_gc` on the CPU parity
# fixture of `tests/test_torch_bf16_zoo.py`) and by up to 2.1% in the port
# (`discrete_vae` at B=8, raster 64 on the CPU); 5% tells rounding from a
# network computed wrong
TRAINER_TWIN_RTOL = 5e-2
BF16_LSTM_BATCHES = (CL_B, B, 512)
# further B/T/H at which the bf16 LSTM kernels are held (not timed): every
# other hidden size, K and M padded for H = 8, 24, 40, 56; a ragged last CTA
# (130, 601); more four-row CTAs than an H100 has SMs (601: a second wave)
BF16_LSTM_EDGES = ((3, 5, 8), (33, 6, 16), (5, 7, 24), (64, 4, 32), (17, 9, 40), (7, 3, 48),
                   (601, 5, 56), (130, T, H))


class CheckFailed(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def counts(**launched) -> dict:
    """Expected launch counts: the named kernels, every other kernel 0."""
    from cld_tpu_torch.ops import native

    return {**{k: 0 for k in native.KERNELS}, **launched}


def cli_launches(episode: dict, **extra) -> dict:
    """The process-wide launch counts of one `rollout.main` call: its
    warm-up and its timed episode (`episode` each, the count the CLI reports
    for the timed one), plus `extra` (the reports' launches)."""
    return {k: 2 * v + extra.get(k, 0) for k, v in episode.items()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def timed_method(owner, name, sink):
    """Each call of `owner.name` inside the block, synchronized around it,
    appends its seconds to `sink`."""
    import torch

    untimed = getattr(owner, name)

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = untimed(*a, **k)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out

    setattr(owner, name, timed)  # on a class, `timed` takes the instance as its first argument
    try:
        yield
    finally:
        setattr(owner, name, untimed)


def graph_ms(fn, launches: int = 100, replays: int = 20, windows: int = 1) -> float:
    """Device ms per call of fn, from replays of a CUDA graph of `launches`
    calls (the median over `windows` timed runs of `replays` replays each):
    back-to-back launches from Python read the host's launch path
    (~0.02-0.03 ms) for any kernel shorter than that, the graph takes it out."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (launches * replays))
    return statistics.median(times)


def graph_kernel_ms(fn, launches: int = 10, replays: int = 5) -> dict:
    """Device ms per call of fn of each kernel it launches, by kernel name:
    torch.profiler's per-kernel device times (as `profile_guided.py` reads
    them) over `replays` replays of a CUDA graph of `launches` calls. Empty
    where the profiler saw no device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time > 0:
            out[e.name] = out.get(e.name, 0.0) + e.device_time * 1e-3 / (launches * replays)
    return out


def sweep_split(by_kernel: dict) -> dict:
    """A reverse sweep's device ms by part, from `graph_kernel_ms`: its
    gates kernel(s), its chain, and the rest (the weight packs' gathers)."""
    part = lambda e: "gates" if "gates" in e else "chain" if "chain" in e else "other"
    out = {"gates": 0.0, "chain": 0.0, "other": 0.0}
    for name, ms in by_kernel.items():
        out[part(name)] += ms
    return out if by_kernel else {}


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lstm_bounds(Bn, Tn, Hn, elem, flops_per_s):
    """(forward, reverse sweep) bounds, each (ms, by): every input read once
    and every output written once (the weights once), and the recurrent
    products' operations (the reverse sweep's gate recompute too)."""
    w_bytes = elem * (Hn * 4 * Hn + 2 * Hn * 4 * Hn + 4 * Hn)
    seq, gates = Bn * Tn * Hn, Bn * Tn * 4 * Hn
    fwd = bound(elem * (gates + Bn * Hn + 4 * seq) + w_bytes,
                2.0 * Bn * Tn * (Hn * 4 * Hn + 2 * Hn * 4 * Hn), flops_per_s)
    bwd = bound(elem * (seq + gates + Bn * Hn + 4 * seq + 2 * gates) + w_bytes,
                2.0 * Bn * Tn * (Hn * 4 * Hn + 2 * Hn * 4 * Hn + 4 * Hn * 2 * Hn + 4 * Hn * Hn),
                flops_per_s)
    return fwd, bwd


def gather_bound(pix, rows: int, row_elems: int, elem_bytes: int, out_bytes: int,
                 col_shift: int = 0):
    """Bound of a gather over pix [M, Q, 2] (col, row) into M sources of
    [rows, row_elems] elements: the queries read once, each output written
    once, and of the sources only the distinct elements that this run's
    queries land on (a gather needs no other byte of its source). Returns
    (bound_ms, bound_by, source bytes needed)."""
    import torch

    M, Qn = pix.shape[:2]
    col = pix[..., 0].long().clamp(0, (row_elems << col_shift) - 1) >> col_shift
    row = pix[..., 1].long().clamp(0, rows - 1)
    src = torch.arange(M, device=pix.device)[:, None]
    needed = int(torch.unique((src * rows + row) * row_elems + col).numel()) * elem_bytes
    return (*bound(8 * M * Qn + needed + out_bytes * M * Qn, 0.0), needed)


def rel_err(got, want) -> tuple:
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, err / max(scale, 1e-30)


def gather_pix(g, M, Qn, W, Hm, dev):
    """Random in-range (col, row) queries with the four corners forced in."""
    import torch

    pix = torch.stack([torch.randint(0, W, (M, Qn), generator=g),
                       torch.randint(0, Hm, (M, Qn), generator=g)], dim=-1)
    pix[:, :4] = torch.tensor([[0, 0], [W - 1, 0], [0, Hm - 1], [W - 1, Hm - 1]])
    return pix.to(torch.int32).to(dev).contiguous()


def lstm_inputs(g, Bn, Tn, Hn, dev):
    """Random core inputs at one shape, the weights at the init scale
    1/sqrt(H): ((xg1, h0, Wh1, W2, b2), dy)."""
    import torch

    k = Hn ** -0.5
    u = lambda *shape: (torch.rand(shape, generator=g) * 2 - 1) * k
    xs = (torch.randn((Bn, Tn, 4 * Hn), generator=g), torch.randn((Bn, Hn), generator=g) * 0.5,
          u(Hn, 4 * Hn), u(2 * Hn, 4 * Hn), u(4 * Hn))
    return tuple(x.to(dev).contiguous() for x in xs), torch.randn((Bn, Tn, Hn), generator=g).to(dev)


def hold_lstm(args, dy):
    """Both LSTM kernels against their plain versions on one input, and each
    against a second launch of itself. Returns (the reverse sweep's inputs,
    {fwd_abs, fwd_rel, bwd_abs, bwd_rel})."""
    import torch

    from cld_tpu_torch.ops import lstm_kernels as lk

    Bn, Tn, Hn = dy.shape
    got, again = lk.lstm2_fwd(*args), lk.lstm2_fwd(*args)
    want = lk.lstm2_core_ref(*args)
    y, h1s, c1s, c2s = want
    bargs = (dy, *args, h1s, c1s, y, c2s)
    dg_k, dg_k2 = lk.lstm2_bwd(*bargs), lk.lstm2_bwd(*bargs)
    dg_p = lk.lstm2_bwd_ref(*bargs)
    torch.cuda.synchronize()
    fe = [rel_err(a, b) for a, b in zip(got, want)]
    be = [rel_err(a, b) for a, b in zip(dg_k, dg_p)]
    e = dict(fwd_abs=max(x[0] for x in fe), fwd_rel=max(x[1] for x in fe),
             bwd_abs=max(x[0] for x in be), bwd_rel=max(x[1] for x in be))
    shape = f"B/T/H {Bn}/{Tn}/{Hn}"
    log(f"lstm2_fwd {shape}: max abs err {e['fwd_abs']:.3e}, max rel err {e['fwd_rel']:.3e}; "
        f"lstm2_bwd: max abs err {e['bwd_abs']:.3e}, max rel err {e['bwd_rel']:.3e} "
        f"(tolerance {LSTM_REL_TOL:.0e} of max |plain|)")
    check(e["fwd_rel"] <= LSTM_REL_TOL, f"lstm2_fwd disagrees with its plain version at {shape}")
    check(e["bwd_rel"] <= LSTM_REL_TOL, f"lstm2_bwd disagrees with its plain version at {shape}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"two lstm2_fwd launches differ at {shape}")
    check(all(torch.equal(a, b) for a, b in zip(dg_k, dg_k2)),
          f"two lstm2_bwd launches differ at {shape}")
    return bargs, e


def check_lstm(models, dev, report):
    """LSTM forward, reverse sweep and VJP against the plain versions."""
    import torch

    from cld_tpu_torch.ops import lstm_kernels as lk

    g = torch.Generator().manual_seed(1)
    p = lk.extract_decoder_params(models.decoder)
    z = torch.randn((B, T, L), generator=g).to(dev)
    cond = torch.randn((B, COND), generator=g).to(dev)
    xg1 = (z @ p.Wx1 + p.b1).contiguous()
    h0 = (cond @ p.Wc + p.bc).contiguous()
    args = (xg1, h0, p.Wh1, p.W2, p.b2)
    dy = torch.randn((B, T, H), generator=g).to(dev)
    bargs, e128 = hold_lstm(args, dy)  # the decoder's own weights at the open loop's shape
    held = {(B, T, H): (args, bargs)}
    errs = {f"{B}/{T}/{H}": e128}
    for shape in LSTM_SHAPES[1:]:
        a, d = lstm_inputs(g, *shape, dev)
        ba, errs["/".join(map(str, shape))] = hold_lstm(a, d)
        held[shape] = (a, ba)
    y = bargs[8]  # the plain forward's y

    def grads(fn):
        ts = [a.detach().clone().requires_grad_(True) for a in args]
        (fn(*ts) * dy).sum().backward()
        return [t.grad for t in ts]

    gk = grads(lk.lstm2_core)
    gp = grads(lambda *a: lk.lstm2_core_ref(*a)[0])
    torch.cuda.synchronize()
    names = ("xg1", "h0", "Wh1", "W2", "b2")
    for name, a, b in zip(names, gk, gp):
        e_abs, e_rel = rel_err(a, b)
        log(f"Lstm2Core VJP d{name}: max abs err {e_abs:.3e}, rel {e_rel:.3e} "
            f"(tolerance {LSTM_REL_TOL:.0e})")
        check(e_rel <= LSTM_REL_TOL, f"Lstm2Core VJP d{name} disagrees: {e_rel:.3e}")

    # the compiler's verdict on each instantiation at H = 64
    attrs = {}
    for which, kname in enumerate(("lstm2_fwd_kernel", "lstm2_bwd_gates_kernel",
                                   "lstm2_bwd_kernel")):
        for R in ((1,) if which == 1 else lk.ROWS_PER_CTA):
            a = lk.kernel_attributes(which, H, R)
            attrs[f"{kname}<{H},{R}>" if which != 1 else f"{kname}<{H}>"] = a
            log(f"{kname} H={H} R={R}: {a['registers']} registers, {a['local_bytes']} bytes of "
                f"local memory per thread{' (spills: reported, not failed)' if a['local_bytes'] else ''}"
                f", max {a['max_threads']} threads per block")

    # timings: kernel, plain version, and cuDNN's LSTM from the same latents
    fwd_ms = cuda_ms(lambda: lk.lstm2_fwd(*args), 50)
    fwd_plain_ms = cuda_ms(lambda: lk.lstm2_core_ref(*args), 5)
    bwd_ms = cuda_ms(lambda: lk.lstm2_bwd(*bargs), 50)
    bwd_plain_ms = cuda_ms(lambda: lk.lstm2_bwd_ref(*bargs), 5)
    fwd_graph, bwd_graph = {}, {}
    for Bn in (CL_B, B, 512):
        a, ba = held[(Bn, T, H)]
        fwd_graph[Bn] = graph_ms(lambda: lk.lstm2_fwd(*a), launches=20)
        bwd_graph[Bn] = graph_ms(lambda: lk.lstm2_bwd(*ba), launches=20)
    log("from a CUDA graph (weight pack included), ms at B=" + ", ".join(
        f"{Bn}: lstm2_fwd {fwd_graph[Bn]:.4f}, lstm2_bwd {bwd_graph[Bn]:.4f}" for Bn in fwd_graph))

    cudnn = torch.nn.LSTM(L, H, num_layers=2, batch_first=True).to(dev)
    with torch.no_grad():
        lstm = models.decoder.lstm
        for n in range(2):
            for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(cudnn, f"{k}_l{n}").copy_(getattr(lstm, f"{k}_l{n}"))
        hc = (h0[None].expand(2, B, H).contiguous(), torch.zeros((2, B, H), device=dev))
        lib_y = cudnn(z, hc)[0]
        e_lib = float((lib_y - y).abs().max())
        log(f"cuDNN nn.LSTM from z vs the plain core: max abs diff {e_lib:.3e}")
        fwd_lib_ms = cuda_ms(lambda: cudnn(z, hc), 50)
        fwd_lib_graph = graph_ms(lambda: cudnn(z, hc), launches=20)

    # backward yardsticks: cuDNN's (train mode; input, h0 and weights) and the
    # port's whole Lstm2Core VJP (kernel + batched matmuls), each as forward +
    # backward minus the same forward
    zr = z.clone().requires_grad_(True)
    h0r = hc[0].clone().requires_grad_(True)
    lib_in = (zr, h0r, *cudnn.parameters())
    lib_fwd = lambda: cudnn(zr, (h0r, hc[1]))[0]
    lib_train_fwd_ms = cuda_ms(lib_fwd, 50)
    bwd_lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_fwd(), lib_in, dy), 50) - lib_train_fwd_ms
    core_in = [a.detach().clone().requires_grad_(True) for a in args]
    core_fwd = lambda: lk.lstm2_core(*core_in)
    core_fwd_ms = cuda_ms(core_fwd, 50)
    vjp_ms = cuda_ms(lambda: torch.autograd.grad(core_fwd(), core_in, dy), 50) - core_fwd_ms
    log(f"lstm2_fwd {fwd_ms:.4f} ms from Python ({fwd_graph[B]:.4f} from a graph) vs cuDNN "
        f"nn.LSTM forward {fwd_lib_ms:.4f} ({fwd_lib_graph:.4f}); lstm2_bwd {bwd_ms:.4f} ms, "
        f"Lstm2Core VJP {vjp_ms:.4f} vs cuDNN backward {bwd_lib_ms:.4f} (B={B})")

    (fwd_b, fwd_by), (bwd_b, bwd_by) = lstm_bounds(B, T, H, 4, F32_FLOPS_PER_S)
    report["lstm2_fwd"] = dict(max_abs_err=e128["fwd_abs"], max_rel_err=e128["fwd_rel"],
                               ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=fwd_b, bound_by=fwd_by,
                               library_ms=fwd_lib_ms, library_graph_ms=fwd_lib_graph,
                               graph_ms={str(k): v for k, v in fwd_graph.items()},
                               held={k: dict(abs=e["fwd_abs"], rel=e["fwd_rel"])
                                     for k, e in errs.items()},
                               attributes={k: v for k, v in attrs.items() if "fwd" in k})
    report["lstm2_bwd"] = dict(max_abs_err=e128["bwd_abs"], max_rel_err=e128["bwd_rel"],
                               ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bwd_b, bound_by=bwd_by,
                               library_ms=bwd_lib_ms, library_train_fwd_ms=lib_train_fwd_ms,
                               lstm2core_vjp_ms=vjp_ms,
                               graph_ms={str(k): v for k, v in bwd_graph.items()},
                               held={k: dict(abs=e["bwd_abs"], rel=e["bwd_rel"])
                                     for k, e in errs.items()},
                               attributes={k: v for k, v in attrs.items() if "bwd" in k})


def check_gather(batch, dev, report):
    import torch

    from cld_tpu_torch.ops import gather_kernels as gk

    packed = gk.pack_drivable_bits(batch.drivable_map)
    Hm, W8 = packed.shape[1:]
    W = batch.drivable_map.shape[-1]
    g = torch.Generator().manual_seed(2)
    pix = gather_pix(g, B, Q, W, Hm, dev)
    got = gk.drivable_bit_gather(pix, packed)
    want = gk.drivable_bit_gather_ref(pix, packed)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    n_on = int(want.sum())
    log(f"bit_gather: max abs err {err} (tolerance 0, exact); {n_on} of {B * Q} on-road")
    check(err == 0.0, "bit_gather disagrees with its plain version")
    check(0 < n_on < B * Q, "bit_gather fixture is degenerate")
    ms = cuda_ms(lambda: gk.drivable_bit_gather(pix, packed), 200)
    plain_ms = cuda_ms(lambda: gk.drivable_bit_gather_ref(pix, packed), 50)
    b_ms, b_by, needed = gather_bound(pix, Hm, W8, 1, 4, col_shift=3)
    g_ms = graph_ms(lambda: gk.drivable_bit_gather(pix, packed))
    log(f"bit_gather bound counts {needed} of {B * Hm * W8} map bytes (those under a query); "
        f"{ms:.4f} ms from Python, {g_ms:.5f} from a graph")
    report["bit_gather"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None, source_bytes_needed=needed,
                                graph_ms=g_ms)


def run_main_path(models, batch, report):
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.ops import native

    g = torch.Generator(device=batch.image.device)
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline.guided_collect(models, batch, guided=True,
                                  agents_per_scene=AGENTS_PER_SCENE,
                                  generator=g.manual_seed(10))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = native.launch_counts()
    log(f"guided pipeline (first call, {first_s:.2f} s): launches {launches}, "
        f"reward {float(out['reward']):.4f}")
    want = counts(lstm2_fwd=N_STEPS, lstm2_bwd=N_STEPS - 1, bit_gather=N_STEPS - 1,
                  offroad_count=1)  # the reward's off-road count, once per call
    check(launches == want, f"kernel launches {launches}, expected {want}")
    for k in ("pred_traj", "traj", "reward_per_agent", "cond_feat"):
        check(bool(torch.isfinite(out[k]).all()), f"guided output {k} is not finite")
    check(tuple(out["traj"].shape) == (B, 1, T, 6), f"traj shape {tuple(out['traj'].shape)}")
    report["launches"] = launches

    def timed(guided, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = pipeline.guided_collect(models, batch, guided=guided,
                                    agents_per_scene=AGENTS_PER_SCENE,
                                    generator=g.manual_seed(seed))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, o

    guided_s, _ = timed(True, 11)
    unguided_s, uo = timed(False, 12)
    check(uo["launches"] == counts(lstm2_fwd=1, offroad_count=1),
          f"unguided launches {uo['launches']}")
    for k in ("pred_traj", "traj", "reward_per_agent"):
        check(bool(torch.isfinite(uo[k]).all()), f"unguided output {k} is not finite")
    nfe = B * N_STEPS
    report["pipeline"] = dict(first_guided_s=first_s, guided_s=guided_s,
                              guided_nfe_per_s=nfe / guided_s, unguided_s=unguided_s,
                              unguided_nfe_per_s=nfe / unguided_s)
    log(f"guided {nfe / guided_s:.1f} NFE/s ({guided_s:.3f} s/call), unguided "
        f"{nfe / unguided_s:.1f} NFE/s ({unguided_s:.3f} s/call) at B={B}, "
        f"{N_STEPS} steps, on {report['card']}")


def road_edge_shift(g, Bn):
    """[Bn, 1, 1, 6] sideways shifts of 5.5 to 8.5 m to either side: added to
    trajectories that run along the synthetic road (7 m wide to each side of
    its centre line), they put the bbox grids across its edge."""
    import torch

    side = torch.zeros((Bn, 1, 1, 6))
    side[:, 0, 0, 1] = (torch.rand((Bn,), generator=g) * 3.0 + 5.5) * (
        torch.randint(0, 2, (Bn,), generator=g) * 2 - 1)
    return side


def check_small_slice(dev, report, min_dist_impl="separable", hidden=H):
    """The slice at a small size on the card (kernels) and on the CPU (plain
    versions), same weights and noise, with the map loss under
    `min_dist_impl` and an LSTM decoder of `hidden` units. Each comparison holds
    |card - cpu| <= 1e-4 |cpu| + floor * max |cpu|. The floor is 1e-6 for
    trajectories and unguided latents. It is 1e-4 for the guided latents:
    one Adam step from m = v = 0 moves a component by ~lr * sign(g), so a
    gradient component near zero can take the other sign and move by up to
    2 sigma. It is 1e-4 for the guidance gradient too, whose near-zero
    components carry the rounding of f32 sums over the bbox grid; it is taken
    on the decoded trajectories shifted to the road's edge
    (`road_edge_shift`)."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.guidance.perturbation import guidance_gradient

    Bs, steps = 8, 10
    g = torch.Generator().manual_seed(3)
    x_init = torch.randn((Bs, T, L), generator=g)
    noises = torch.randn((steps, Bs, T, L), generator=g)
    z = torch.randn((Bs, T, L), generator=g)
    side = road_edge_shift(g, Bs)  # the gradient is taken where the map loss has work
    res = {}
    for where in ("cpu", dev):
        m = pipeline.build_models(seed=5, device=where, n_diffusion_steps=steps,
                                  hidden_size=hidden, precision="fp32")
        b = synthetic_batch(seed=4, batch_size=Bs, raster_size=64, device=where)
        specs = pipeline.flagship_guidance_specs(AGENTS_PER_SCENE, min_dist_impl=min_dist_impl)
        outs = {gd: pipeline.guided_collect(m, b, guided=gd, agents_per_scene=AGENTS_PER_SCENE,
                                            x_init=x_init.to(where), step_noises=noises.to(where),
                                            specs=specs)
                for gd in (False, True)}
        aux = m.context(b)
        wfa, si = pipeline.scene_world_poses(Bs, AGENTS_PER_SCENE, where)
        ctx = gl.prepack_map_bbox(gl.prepack_drivable(gl.GuidanceContext(
            b.drivable_map, b.raster_from_agent, b.extent, b.curr_speed, wfa, si)))

        def decode_fn(v):
            acts = pipeline.decode_actions(m.decoder, v, aux["cond_feat"])
            return pipeline.convert_action_to_state_and_action(
                acts, aux["curr_states"], m.dyn, pipeline.TrajNormalizer(),
                descaled_output=True)[:, None] + side.to(where)

        grad = guidance_gradient(z.to(where), ctx, specs, decode_fn)
        res[str(where)] = (outs, grad.cpu(), outs[True]["launches"])
    (c_outs, c_grad, _), (g_outs, g_grad, g_launch) = res["cpu"], res[str(dev)]
    wide = "_wide" if hidden > H else ""
    want = counts(**{f"lstm2_fwd{wide}": steps, f"lstm2_bwd{wide}": steps - 1},
                  bit_gather=steps - 1, offroad_count=1)
    if min_dist_impl == "rigid_kernel":
        want.update(rigid_min=steps - 1, rigid_bwd=steps - 1)
    tag0 = f"small slice ({min_dist_impl}{f', H={hidden}' if wide else ''})"
    check(g_launch == want, f"{tag0} launches {g_launch}, expected {want}")

    def close(name, a, b, floor):
        a, b = a.detach().cpu(), b.detach().cpu()
        err = float((a - b).abs().max())
        tol = SLICE_RTOL * b.abs() + floor * float(b.abs().max())
        ok = bool(((a - b).abs() <= tol).all())
        log(f"{tag0} {name}: card vs CPU max abs diff {err:.3e} "
            f"(rtol {SLICE_RTOL:.0e}, floor {floor:.0e} of max {float(b.abs().max()):.3g})")
        check(ok, f"{tag0} {name} disagrees between card and CPU")
        return err

    summary = {}
    for gd in (False, True):
        tag = "guided" if gd else "unguided"
        summary[f"{tag}_traj"] = close(f"{tag} traj", g_outs[gd]["traj"], c_outs[gd]["traj"], 1e-6)
        summary[f"{tag}_latents"] = close(f"{tag} latents", g_outs[gd]["pred_traj"],
                                          c_outs[gd]["pred_traj"], 1e-4 if gd else 1e-6)
    check(float(c_grad.abs().max()) > 0.0, "small slice guidance gradient is zero")
    summary["guidance_grad"] = close("guidance gradient", g_grad, c_grad, 1e-4)
    key = "small_slice" if min_dist_impl == "separable" else f"small_slice_{min_dist_impl}"
    report[f"{key}_h{hidden}" if wide else key] = summary


def check_map_gathers(dev, report):
    """`value_gather` and `drivable_gather` against their plain versions at
    the closed loop's shapes, exactly; `value_gather` also at ragged shapes,
    with its registers and spills and its time from a CUDA graph beside one
    `torch.take`."""
    import torch

    from cld_tpu_torch.ops import gather_kernels as gk
    from cld_tpu_torch.ops.raster import _pick_band

    g = torch.Generator().manual_seed(6)
    BH, WIN = _pick_band(RASTER, 1.0)
    M, Qb, C = CL_B * (RASTER // BH), BH * RASTER, 3
    wins = torch.randint(-128, 128, (M, WIN, WIN, C), generator=g, dtype=torch.int8).to(dev)
    pix = gather_pix(g, M, Qb, WIN, WIN, dev)
    got = gk.value_gather(pix, wins)
    want = gk.value_gather_ref(pix, wins)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"value_gather [M={M}, Q={Qb}, {WIN}x{WIN}x{C}]: max abs err {err} (tolerance 0, exact); "
        f"values in [{float(want.min()):.0f}, {float(want.max()):.0f}]")
    check(err == 0.0, "value_gather disagrees with its plain version")
    check(float(want.min()) == -128.0 and float(want.max()) == 127.0,
          "value_gather fixture misses the byte range's ends")
    # ragged shapes: Q % 4 != 0 and pix 8 bytes off a 16-byte boundary (the
    # kernel's scalar path), C = 1, 4 and 5 (its runtime-C loop), one window
    held = {}
    for name, (Mn, Qn, Hn, Wn, Cn, shift) in {
            "q_ragged_c1": (5, 1027, 40, 48, 1, 0), "c4": (3, 4096, 64, 64, 4, 0),
            "m1_q_ragged_c4": (1, Qb - 1, WIN, WIN, 4, 0), "m1_c3": (1, 1029, 33, 17, 3, 0),
            "c5": (2, 300, 20, 30, 5, 0), "pix_off16": (4, 2048, 64, 64, 3, 1)}.items():
        w = torch.randint(-128, 128, (Mn, Hn, Wn, Cn), generator=g, dtype=torch.int8).to(dev)
        p = gather_pix(g, Mn, Qn, Wn, Hn, dev)
        if shift:
            p = torch.cat([torch.zeros(2, dtype=torch.int32, device=dev), p.reshape(-1)])[2:]
            p = p.view(Mn, Qn, 2)
            check(p.data_ptr() % 16 == 8, "value_gather fixture: pix not 8 bytes off")
        a, b = gk.value_gather(p, w), gk.value_gather_ref(p, w)
        torch.cuda.synchronize()
        held[name] = float((a - b).abs().max())
        log(f"value_gather [{name}: M={Mn}, Q={Qn}, {Hn}x{Wn}x{Cn}]: max abs err {held[name]} "
            "(exact)")
        check(held[name] == 0.0, f"value_gather ({name}) disagrees with its plain version")
    attrs = {name: gk.value_gather_attributes(Cn, v)
             for name, Cn, v in (("C=3,vector", 3, True), ("C=3,scalar", 3, False),
                                 ("any other C", 1, False))}
    for k, a in attrs.items():
        log(f"value_gather_kernel {k}: {a['registers']} registers, {a['local_bytes']} bytes of "
            f"local memory per thread{' (spills: reported, not failed)' if a['local_bytes'] else ''}")
    ms = cuda_ms(lambda: gk.value_gather(pix, wins), 100)
    plain_ms = cuda_ms(lambda: gk.value_gather_ref(pix, wins), 20)
    b_ms, b_by, needed = gather_bound(pix, WIN, WIN, C, 4 * C)
    # the same bound with the windows read in whole 32-byte sectors, as the
    # memory system moves them
    byte = (((torch.arange(M, device=dev)[:, None] * WIN + pix[..., 1].long()) * WIN
             + pix[..., 0].long()) * C)[..., None] + torch.arange(C, device=dev)
    sectors = int(torch.unique(byte // 32).numel())
    sector_ms = bound(8 * M * Qb + 32 * sectors + 4 * C * M * Qb, 0.0)[0]
    log(f"value_gather bound counts {needed} of {M * WIN * WIN * C} window bytes "
        f"(those under a query); in 32-byte sectors {32 * sectors} bytes, bound {sector_ms:.5f}")
    # yardstick: one torch.take on a flat index made outside the timed region
    flat = ((torch.arange(M, device=dev)[:, None] * WIN + pix[..., 1].long()) * WIN
            + pix[..., 0].long())[..., None] * C + torch.arange(C, device=dev)
    check(torch.equal(torch.take(wins, flat).float(), want), "torch.take misses value_gather")
    # `ms` and `library_ms` both from Python, the graph times beside them
    lib_ms = cuda_ms(lambda: torch.take(wins, flat), 100)
    lib_graph = graph_ms(lambda: torch.take(wins, flat))
    k_graph = graph_ms(lambda: gk.value_gather(pix, wins))
    log(f"value_gather {ms:.4f} ms from Python, {k_graph:.5f} from a graph; torch.take "
        f"{lib_ms:.4f} from Python, {lib_graph:.5f} from a graph; bound {b_ms:.5f} ({b_by})")
    report["value_gather"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=lib_ms, source_bytes_needed=needed,
                                  source_sector_bytes=32 * sectors, sector_bound_ms=sector_ms,
                                  graph_ms=k_graph, library_graph_ms=lib_graph, held=held,
                                  attributes=attrs)

    drv = (torch.rand((CL_B, RASTER, RASTER), generator=g) < 0.6)
    pix = gather_pix(g, CL_B, Q, RASTER, RASTER, dev)
    worst = 0.0
    for name, m in (("int8", (drv.to(torch.int8) * 3 - 1).to(dev)),
                    ("float32", torch.where(drv, torch.rand(drv.shape, generator=g) + 0.1,
                                            torch.zeros(())).to(dev))):
        got, want = gk.drivable_gather(pix, m), gk.drivable_gather_ref(pix, m)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        n_on = int((want > 0).sum())
        log(f"drivable_gather {name} [B={CL_B}, Q={Q}, {RASTER}x{RASTER}]: max abs err {err} "
            f"(tolerance 0, exact); {n_on} of {CL_B * Q} on-road")
        check(err == 0.0, f"drivable_gather ({name}) disagrees with its plain version")
        check(0 < n_on < CL_B * Q, "drivable_gather fixture is degenerate")
        worst = max(worst, err)
    held, attrs = check_drivable_gather_edges(g, dev), {}
    for dt, dtype in (("int8", torch.int8), ("float32", torch.float32)):
        for path in ("vector", "scalar"):
            a = attrs[f"{dt},{path}"] = gk.drivable_gather_attributes(dtype, path == "vector")
            spills = " (spills: reported, not failed)" if a["local_bytes"] else ""
            log(f"drivable_gather_kernel {dt} {path}: {a['registers']} registers, "
                f"{a['local_bytes']} bytes of local memory per thread{spills}")
    m8 = drv.to(torch.int8).to(dev)
    ms = cuda_ms(lambda: gk.drivable_gather(pix, m8), 200)
    plain_ms = cuda_ms(lambda: gk.drivable_gather_ref(pix, m8), 50)
    b_ms, b_by, needed = gather_bound(pix, RASTER, RASTER, 1, 4)
    log(f"drivable_gather bound counts {needed} of {CL_B * RASTER * RASTER} map bytes "
        "(those under a query)")
    flat = ((torch.arange(CL_B, device=dev)[:, None] * RASTER + pix[..., 1].long()) * RASTER
            + pix[..., 0].long())
    check(torch.equal(torch.take(m8, flat).float(), gk.drivable_gather_ref(pix, m8)),
          "torch.take misses drivable_gather")
    lib_ms = cuda_ms(lambda: torch.take(m8, flat), 200)
    lib_graph = graph_ms(lambda: torch.take(m8, flat))
    k_graph = graph_ms(lambda: gk.drivable_gather(pix, m8))
    log(f"drivable_gather {ms:.4f} ms from Python, {k_graph:.5f} from a graph; torch.take "
        f"{lib_ms:.4f} from Python, {lib_graph:.5f} from a graph; bound {b_ms:.6f} ({b_by})")
    report["drivable_gather"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms, source_bytes_needed=needed,
                                     graph_ms=k_graph, library_graph_ms=lib_graph, held=held,
                                     attributes=attrs)


# (B, Q) at which `drivable_gather` is held: one query, ragged groups of 3, 4
# and 5, the "px" replan's Q = 5,200 and its neighbours, B one past the
# replan's 32
DRIVABLE_GATHER_EDGES = ((1, 1), (1, 3), (1, 4), (1, 5), (32, 5199), (32, 5200), (32, 5201),
                         (33, 5), (33, 5200), (33, 5201))


def check_drivable_gather_edges(g, dev) -> dict:
    """`drivable_gather` on int8 and float32 maps at `DRIVABLE_GATHER_EDGES`,
    with coordinates up to 8 pixels outside the map (clamped), and at the
    replan's shape through a pix view 8 bytes off a 16-byte boundary: equal
    to its plain version (tolerance 0) and to a second launch bit for bit.
    Both the 16-byte and the scalar path are reached for both map types."""
    import torch

    from cld_tpu_torch.ops import gather_kernels as gk

    R, held, paths = RASTER, {}, set()
    maps = (torch.rand((33, R, R), generator=g) < 0.6)
    maps = {"int8": (maps.to(torch.int8) * 3 - 1).to(dev),
            "float32": torch.where(maps, torch.rand(maps.shape, generator=g) + 0.1,
                                   torch.zeros(())).to(dev)}
    for Bn, Qn, off16 in [(*e, False) for e in DRIVABLE_GATHER_EDGES] + [(CL_B, Q, True)]:
        pix = torch.stack([torch.randint(-8, R + 8, (Bn, Qn), generator=g),
                           torch.randint(-8, R + 8, (Bn, Qn), generator=g)], -1).to(torch.int32)
        pix = pix.to(dev).contiguous()
        if off16:  # the same queries in storage 8 bytes off a 16-byte boundary
            pix = torch.cat([torch.zeros(2, dtype=torch.int32, device=dev),
                             pix.reshape(-1)])[2:].view(Bn, Qn, 2)
            check(pix.data_ptr() % 16 == 8, "drivable_gather fixture: pix not 8 bytes off")
        for dt, m in maps.items():
            m = m[:Bn].contiguous()
            got, again = gk.drivable_gather(pix, m), gk.drivable_gather(pix, m)
            want = gk.drivable_gather_ref(pix, m)
            vec = gk.drivable_gather_vector(pix, got)
            torch.cuda.synchronize()
            key = f"{dt},B={Bn},Q={Qn}{',pix_off16' if off16 else ''}"
            held[key] = float((got - want).abs().max())
            paths.add((dt, vec))
            log(f"drivable_gather [{key}, {'vector' if vec else 'scalar'} path]: max abs err "
                f"{held[key]} (tolerance 0, exact)")
            check(held[key] == 0.0, f"drivable_gather ({key}) disagrees with its plain version")
            check(torch.equal(got, again), f"drivable_gather ({key}) differs between two launches")
    check(len(paths) == 4, f"drivable_gather edges reach only {sorted(paths)}")
    return held


def check_warp(pack, dev, report):
    """Banded vs exact `warp_scene_maps` on the card for the 32-agent pack,
    at the spawn poses and at the same positions under random yaws. The
    pack's drivable and lane layers are {0, 1}: identical. Its middle layer
    is 0.5, which the 8-bit windows store as 128/255: within 1/510."""
    import torch

    from cld_tpu_torch.ops.geometry import world_from_agent_matrix
    from cld_tpu_torch.ops.raster import warp_scene_maps

    g = torch.Generator().manual_seed(8)
    pos = pack.init_states[:, :2]
    worst = 0.0
    for yaw in (pack.init_states[:, 3], (torch.rand((CL_B,), generator=g) * 6.2 - 3.1).to(dev)):
        wfa = world_from_agent_matrix(pos, yaw)
        args = (pack.world_map, pack.map_origin, pack.map_resolution, wfa, pack.scene_index,
                RASTER, 0.5, (-0.5, 0.0))
        exact = warp_scene_maps(*args, impl="exact")
        banded = warp_scene_maps(*args, impl="banded")
        torch.cuda.synchronize()
        check(torch.equal(banded[..., 0], exact[..., 0]) and torch.equal(banded[..., 2],
                                                                         exact[..., 2]),
              "banded warp differs from the exact warp on a {0, 1} layer")
        err = float((banded[..., 1] - exact[..., 1]).abs().max())
        check(err <= 1.0 / 510 + 1e-6, f"banded warp is {err} off on the 0.5 layer")
        check(0.0 < float(exact[..., 0].mean()) < 1.0, "warp fixture is degenerate")
        worst = max(worst, err)
    ms = {impl: cuda_ms(lambda: warp_scene_maps(*args, impl=impl), 10) for impl in
          ("banded", "exact")}
    log(f"warp_scene_maps banded vs exact, {CL_B} agents: {{0,1}} layers identical, 0.5 layer "
        f"max abs diff {worst:.3e} (<= 1/510); banded {ms['banded']:.3f} ms, exact "
        f"{ms['exact']:.3f} ms per call")
    report["warp"] = dict(max_abs_diff_half_layer=worst, banded_ms=ms["banded"],
                          exact_ms=ms["exact"])


def run_closed_loop(models, pack, report):
    """The guided closed loop at full width, once; launch counts exact."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.metrics import summarize_metrics

    dev = pack.init_states.device
    cfg = env.SimConfig(num_simulation_steps=CL_STEPS, n_step_action=CL_N_STEP,
                        raster_size=RASTER)
    policy = pipeline.make_dm_policy(models, CL_AGENTS)
    marks = []

    def timed_policy(obs, rng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = policy(obs, rng)
        torch.cuda.synchronize()
        marks.append((t0, time.perf_counter()))
        return out

    g = torch.Generator(device=dev)
    # one replan first, so that the timed episode does not pay for first-call set-up
    warm = env.SimConfig(num_simulation_steps=CL_N_STEP, n_step_action=CL_N_STEP,
                         raster_size=RASTER)
    env.simulate(pack, policy, warm, generator=g.manual_seed(20))
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, traj = env.simulate(pack, timed_policy, cfg, generator=g.manual_seed(21))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = native.launch_counts()
    n = cfg.num_replans
    want = counts(lstm2_fwd=N_STEPS * n, lstm2_bwd=(N_STEPS - 1) * n,
                  bit_gather=(N_STEPS - 1) * n, value_gather=n)
    log(f"closed loop ({CL_SCENES} x {CL_AGENTS} agents, {CL_STEPS} frames, {n} replans, "
        f"{wall:.2f} s): launches {launches}")
    check(launches == want, f"closed-loop launches {launches}, expected {want}")
    check(tuple(traj.shape) == (CL_STEPS, CL_B, 4), f"trajectory log shape {tuple(traj.shape)}")
    check(bool(torch.isfinite(traj).all()) and bool(torch.isfinite(state.states).all()),
          "closed-loop states are not finite")
    check(state.step == CL_STEPS, f"closed loop stopped at frame {state.step}")
    moved = traj[-1, :, 0] - pack.init_states[:, 0]
    check(bool((moved.abs() > 0.1).all()), "an agent did not move in the closed loop")
    metrics = summarize_metrics(pack, state, cfg)
    log(f"closed-loop metrics: {json.dumps(metrics)}")

    policy_s = sum(b - a for a, b in marks) / n
    # render and step alone, on the episode's last state
    world_q8 = env.quantize_world_maps_q8(pack.world_map)
    last = state._replace(step=CL_STEPS - CL_N_STEP)

    def host_s(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters

    render_s = host_s(lambda: env.render_observation(pack, last, cfg, world_q8=world_q8))
    acts = torch.zeros((CL_B, T, 2), device=dev)
    step_s = host_s(lambda: env._consume_actions(pack, last, acts, cfg))
    rate = CL_B * CL_STEPS / wall
    report["launches_closed_loop"] = launches
    report["closed_loop"] = dict(
        wall_s=wall, agent_steps_per_s=rate, replans=n, s_per_replan=wall / n,
        policy_s_per_replan=policy_s, render_s_per_replan=render_s,
        step_s_per_replan=step_s, metrics=metrics)
    log(f"closed loop {rate:.1f} agent-steps/s ({wall / n:.3f} s per replan: policy "
        f"{policy_s:.3f} s, render {render_s * 1e3:.2f} ms, {CL_N_STEP} frames of stepping "
        f"{step_s * 1e3:.2f} ms) at {CL_SCENES} x {CL_AGENTS} agents, raster {RASTER}, "
        f"{N_STEPS} DDPM steps per replan, on {report['card']}")


def offroad_observation(pack, g):
    """The pack's first observation with agents off the road and on top of
    each other, so that both losses and the gathers have work: lateral
    offsets up to the road's edge."""
    import torch

    from cld_tpu_torch.sim import env

    dev = pack.init_states.device
    cfg = env.SimConfig(num_simulation_steps=CL_STEPS, n_step_action=CL_N_STEP,
                        raster_size=RASTER)
    init = pack.init_states.clone()
    init[:, 1] += (torch.rand((CL_B,), generator=g) * 10.0 - 5.0).to(dev)
    init[:, 3] += (torch.rand((CL_B,), generator=g) * 0.6 - 0.3).to(dev)
    init[1::2, 0] = init[0::2, 0] + 3.0
    moved = pack._replace(init_states=init)
    return env.render_observation(moved, env.init_sim_state(moved, cfg), cfg)


def run_px_replan(models, pack, report):
    """One replan with the unpacked drivable gather: same guidance gradient
    and same plan as with the bit gather, exactly."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.guidance.perturbation import guidance_gradient
    from cld_tpu_torch.ops import native

    dev = pack.init_states.device
    g = torch.Generator().manual_seed(9)
    obs = offroad_observation(pack, g)

    aux = models.context(obs)
    ctx = gl.prepack_map_bbox(gl.prepack_drivable(gl.GuidanceContext(
        obs.drivable_map, obs.raster_from_agent, obs.extent, obs.curr_speed,
        obs.world_from_agent, obs.scene_index)))

    def decode_fn(v):
        acts = pipeline.decode_actions(models.decoder, v, aux["cond_feat"])
        return pipeline.convert_action_to_state_and_action(
            acts, aux["curr_states"], models.dyn, pipeline.TrajNormalizer(),
            descaled_output=True)[:, None]

    z = torch.randn((CL_B, T, L), generator=g).to(dev)
    grads = {impl: guidance_gradient(z, ctx, pipeline.flagship_guidance_specs(CL_AGENTS, impl),
                                     decode_fn) for impl in ("bits", "px")}
    torch.cuda.synchronize()
    gmax = float(grads["bits"].abs().max())
    gdiff = float((grads["bits"] - grads["px"]).abs().max())
    log(f"guidance gradient, bits vs px gather: max abs diff {gdiff} (tolerance 0, exact); "
        f"max |g| {gmax:.3e}")
    check(gmax > 0.0, "px replan: the guidance gradient is zero")
    check(torch.equal(grads["bits"], grads["px"]), "px and bits guidance gradients differ")

    gen = torch.Generator(device=dev)
    plans, launched = {}, {}
    for impl in ("bits", "px"):
        policy = pipeline.make_dm_policy(
            models, CL_AGENTS, specs=pipeline.flagship_guidance_specs(CL_AGENTS, impl))
        native.reset_launch_counts()
        plans[impl] = policy(obs, gen.manual_seed(22)).controls
        torch.cuda.synchronize()
        launched[impl] = native.launch_counts()
    want = counts(lstm2_fwd=N_STEPS, lstm2_bwd=N_STEPS - 1, drivable_gather=N_STEPS - 1)
    log(f"px replan: launches {launched['px']}")
    check(launched["px"] == want, f"px replan launches {launched['px']}, expected {want}")
    check(bool(torch.isfinite(plans["px"]).all()), "px replan's plan is not finite")
    check(torch.equal(plans["px"], plans["bits"]), "px and bits plans differ")
    report["launches_px_replan"] = launched["px"]


def rigid_fixture(g, Bn, Qn, P, dev, d2=None, on=None):
    """(d2 [Bn, P, P], on [Bn, Qn, P] bool, pts, g_out) for the rigid kernels:
    a random point cloud's distances and random mask unless given; an
    all-off-road and an all-on-road step forced in; cotangents zero at
    on-road columns and in steps without an on-road row, as the loss has
    them."""
    import torch

    if d2 is None:
        local = torch.randn((Bn, P, 2), generator=g) * 2.0
        d2 = ((local[:, :, None] - local[:, None]) ** 2).sum(-1).to(dev).contiguous()
    if on is None:
        on = (torch.rand((Bn, Qn, P), generator=g) > 0.4).to(dev)
    on = on.clone()
    on[0, 0] = False
    on[1, 1] = True
    pts = (torch.randn((Bn, Qn, P, 2), generator=g) * 5.0).to(dev)
    gout = torch.randn((Bn, Qn, P), generator=g).to(dev)
    gout = torch.where(on | ~on.any(-1, keepdim=True), torch.zeros(()).to(dev), gout)
    return d2, on.contiguous(), pts, gout.contiguous()


def hold_rigid_min(name, outs, want_d, want_i, worst):
    """Both forward kernels' (dist, idx) equal to the plain version's bit for
    bit (compare-selects and one IEEE sqrt: no tolerance), and so to each
    other."""
    import torch

    for kname, (got_d, got_i) in outs.items():
        err = float((got_d - want_d).abs().max())
        rel_each = float(((got_d - want_d).abs() / want_d).max())
        exact = bool(torch.equal(got_d, want_d))
        Bn, Qn, Pn = want_d.shape
        log(f"{kname} [{name}: B={Bn}, Q={Qn}, P={Pn}]: dist max rel err {rel_each:.3e} "
            f"(bit for bit: {exact}), idx equal: {bool(torch.equal(got_i, want_i))}")
        check(exact, f"{kname} ({name}) dist differs from its plain version")
        check(torch.equal(got_i, want_i), f"{kname} ({name}) idx disagrees")
        worst[kname] = max(worst[kname], err)
    check(torch.equal(outs["rigid_min"][0], outs["rigid_min_fused"][0])
          and torch.equal(outs["rigid_min"][1], outs["rigid_min_fused"][1]),
          f"rigid_min_fused differs from rigid_min ({name})")


# (B, Q, P) where the forward kernels' bit-packed mask and step tiles are
# edge-prone: P at and around a mask word of 32 rows, up to 224's 7 words;
# Q at one step, around `rigid_min`'s tile of 4 and the fused tile of 8, past
# `rigid_min`'s block of 16 steps and the fused sweep of 64; B = 1 and past
# the card's 132 SMs
RIGID_MIN_EDGES = {
    "p1": (4, 5, 1), "p31": (3, 9, 31), "p32": (3, 7, 32), "p33": (3, 17, 33),
    "p65": (2, 65, 65), "max_p": (2, 53, 224), "q1": (3, 1, 100), "q3": (3, 3, 100),
    "q5": (3, 5, 100), "q7": (3, 7, 100), "q9": (3, 9, 100), "q53": (2, 53, 100),
    "b1": (1, 52, 100), "b133": (133, 52, 100),
}


def lattice_d2(g, Bn, P, dev):
    """[Bn, P, P] squared distances of an R x C bbox lattice (R * C = P, R the
    largest divisor up to sqrt(P)) scaled by random extents, as
    `prepack_map_bbox` builds the cache: full of exactly tied distances."""
    import torch

    from cld_tpu_torch.guidance import losses as gl

    R = max(r for r in range(1, int(P ** 0.5) + 1) if P % r == 0)
    ext = torch.rand((Bn, 1, 2), generator=g) * 3.0 + 1.0
    pts = gl.bbox_local_grid((R, P // R), "cpu")[None] * ext
    return ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1).to(dev).contiguous()


def check_rigid_min_edges(g, dev, worst):
    """`rigid_min` and `rigid_min_fused` at RIGID_MIN_EDGES on lattice caches,
    random masks (60% on-road) with an all-off-road and an all-on-road step
    forced in where there are two steps."""
    import torch

    from cld_tpu_torch.ops import rigid_kernels as rk

    for name, (Bn, Qn, Pn) in RIGID_MIN_EDGES.items():
        d2 = lattice_d2(g, Bn, Pn, dev)
        on = torch.rand((Bn, Qn, Pn), generator=g) < 0.6
        if Bn * Qn > 1:
            on.view(Bn * Qn, Pn)[0] = False
            on.view(Bn * Qn, Pn)[-1] = True
        on = on.to(dev)
        want_d, want_i = rk.rigid_min_ref(d2, on)
        outs = {"rigid_min": rk.rigid_min(d2, on), "rigid_min_fused": rk.rigid_min_fused(d2, on)}
        torch.cuda.synchronize()
        hold_rigid_min(name, outs, want_d, want_i, worst)
        if Bn * Qn > 1:
            check(bool((want_d[0, 0] == 1e6).all()) and bool((want_i[0, 0] == 0).all()),
                  "all-off-road step: expected dist 1e6, idx 0")
            check(torch.equal(want_i[-1, -1].long(), torch.arange(Pn, device=dev)),
                  "all-on-road step: every column should match itself")


# (B, Q, P) past the untiled kernels' 224 bbox points, on lattice caches at
# ragged B and Q: 225 (an eighth mask word, the whole cache still one block),
# 256 (a 16 x 16 grid: two column chunks of 128), 400 (four of 100), 1,024 (a
# 32 x 32 grid: 26 chunks, the last 24 wide; the backward's 32 chunks)
RIGID_TILED = {"p225": (3, 7, 225), "p256": (5, 17, 256), "p400": (3, 9, 400),
               "p1024": (2, 5, 1024)}


def hold_rigid_bwd(name, args, worst, row=None):
    """`rigid_bwd` within rtol 1e-4 / atol 1e-5 of its plain version and
    bit-equal to a relaunch; with `row`, every column routed to that row."""
    import torch

    from cld_tpu_torch.ops import rigid_kernels as rk

    got, again, ref = rk.rigid_bwd(*args), rk.rigid_bwd(*args), rk.rigid_bwd_ref(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    Bn, Qn, Pn, _ = args[0].shape
    log(f"rigid_bwd [{name}: B={Bn}, Q={Qn}, P={Pn}]: max abs err {err:.3e} (rtol 1e-4, "
        f"atol 1e-5; max |plain| {float(ref.abs().max()):.3g}); repeated launch "
        f"bit-identical: {bool(torch.equal(got, again))}")
    check(bool(((got - ref).abs() <= 1e-4 * ref.abs() + 1e-5).all()),
          f"rigid_bwd ({name}) disagrees with its plain version")
    check(torch.equal(got, again), f"rigid_bwd ({name}) differs between two launches")
    # one point can only route to itself: p a - a p, zero up to rounding
    check(Pn == 1 or float(ref.abs().max()) > 0.0, "rigid_bwd fixture routes nothing")
    if row is not None:
        check(not bool(torch.cat([got[:, :, :row], got[:, :, row + 1:]], 2).any()),
              f"rigid_bwd ({name}) routes to a row other than {row}")
    worst["rigid_bwd"] = max(worst["rigid_bwd"], err)


def check_rigid_tiled(g, dev, worst):
    """All three rigid kernels at `RIGID_TILED`: the forward kernels' dist
    and idx equal to the plain version's (and each other's) bit for bit, the
    backward on the argmin's routing (and at P = 256 with every column
    routed to one row), every relaunch bit-equal."""
    import torch

    from cld_tpu_torch.ops import rigid_kernels as rk

    for name, (Bn, Qn, Pn) in RIGID_TILED.items():
        d2 = lattice_d2(g, Bn, Pn, dev)
        on = torch.rand((Bn, Qn, Pn), generator=g) < 0.6
        on.view(Bn * Qn, Pn)[0] = False
        on.view(Bn * Qn, Pn)[-1] = True
        on = on.to(dev)
        want_d, want_i = rk.rigid_min_ref(d2, on)
        outs = {k: getattr(rk, k)(d2, on) for k in ("rigid_min", "rigid_min_fused")}
        again = {k: getattr(rk, k)(d2, on) for k in outs}
        torch.cuda.synchronize()
        qb, pc = rk.rigid_min_tiling(Pn)
        log(f"rigid min [{name}]: {-(-Pn // pc)} column chunk(s) of {min(pc, Pn)}, {qb} steps a "
            "block")
        hold_rigid_min(name, outs, want_d, want_i, worst)
        for k, (d, i) in outs.items():
            check(torch.equal(d, again[k][0]) and torch.equal(i, again[k][1]),
                  f"{k} ({name}) differs between two launches")
        check(bool((want_d[0, 0] == 1e6).all()) and bool((want_i[0, 0] == 0).all()),
              "all-off-road step: expected dist 1e6, idx 0")
        check(torch.equal(want_i[-1, -1].long(), torch.arange(Pn, device=dev)),
              "all-on-road step: every column should match itself")
        pts = (torch.randn((Bn, Qn, Pn, 2), generator=g) * 5.0).to(dev)
        gout = torch.randn((Bn, Qn, Pn), generator=g).to(dev)
        gout = torch.where(on | ~on.any(-1, keepdim=True), torch.zeros(()).to(dev), gout)
        hold_rigid_bwd(name, (pts, want_i, want_d, gout.contiguous()), worst)
    # every column routed to one row through the loop kernel, at the grid of
    # 16 x 16 (at larger P the sum of P products loses more than atol 1e-5 to
    # float32 rounding where the two terms of grad_i cancel, in the plain
    # version as in the kernel)
    Bn, Qn, Pn, row = 2, 3, 256, 85
    pts = (torch.randn((Bn, Qn, Pn, 2), generator=g) * 5.0).to(dev)
    idx = torch.full((Bn, Qn, Pn), row, dtype=torch.int32, device=dev)
    dist = (torch.rand((Bn, Qn, Pn), generator=g) * 1.5 + 0.5).to(dev)
    gout = torch.randn((Bn, Qn, Pn), generator=g).to(dev)
    hold_rigid_bwd("one_row_p256", (pts, idx, dist, gout), worst, row)


def rigid_bounds(Bn, Qn, Pn):
    """(forward, backward) bounds of the rigid kernels, each (ms, by):
    every input read once, every output written once; the min's one compare
    and one select per (b, q, i, j), the backward's division, two products
    and three sums per column and two products and two differences per
    row."""
    n = Bn * Qn * Pn
    return (bound(4 * Bn * Pn * Pn + n + 8 * n, 2.0 * n * Pn),
            bound(8 * n + 3 * 4 * n + 8 * n, 10.0 * n))


def check_rigid(batch, dev, report):
    """`rigid_min`, `rigid_min_fused` and `rigid_bwd` against their plain
    versions on the card."""
    import torch

    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.ops import gather_kernels as gk
    from cld_tpu_torch.ops import rigid_kernels as rk

    g = torch.Generator().manual_seed(14)
    P = 100
    wfa = torch.eye(3, device=dev).expand(B, 3, 3)
    ctx = gl.prepack_map_bbox(gl.GuidanceContext(
        batch.drivable_map, batch.raster_from_agent, batch.extent, batch.curr_speed, wfa,
        torch.zeros((B,), dtype=torch.long, device=dev)))
    # the mask: the batch's own on-road bits under random pixels, 10% random bits mixed in
    Hm, W = batch.drivable_map.shape[-2:]
    pix = gather_pix(g, B, T * P, W, Hm, dev)
    on_map = gk.drivable_bit_gather(pix, gk.pack_drivable_bits(batch.drivable_map)) > 0
    flip = (torch.rand((B, T * P), generator=g) < 0.1).to(dev)
    rand = (torch.rand((B, T * P), generator=g) < 0.5).to(dev)
    on_full = torch.where(flip, rand, on_map).reshape(B, T, P)

    shapes = {"open_loop": (B, T, P, ctx.bbox_d2, on_full), "ragged": (5, 7, 16, None, None),
              "max_p": (2, 3, 224, None, None)}
    worst = {"rigid_min": 0.0, "rigid_min_fused": 0.0, "rigid_bwd": 0.0}
    for name, (Bn, Qn, Pn, d2, on) in shapes.items():
        d2, on, pts, gout = rigid_fixture(g, Bn, Qn, Pn, dev, d2, on)
        want_d, want_i = rk.rigid_min_ref(d2, on)
        outs = {"rigid_min": rk.rigid_min(d2, on), "rigid_min_fused": rk.rigid_min_fused(d2, on)}
        torch.cuda.synchronize()
        hold_rigid_min(name, outs, want_d, want_i, worst)
        check(bool((want_d[0, 0] == 1e6).all()) and bool((want_i[0, 0] == 0).all()),
              "all-off-road step: expected dist 1e6, idx 0")
        check(torch.equal(want_i[1, 1].long(), torch.arange(Pn, device=dev)),
              "all-on-road step: every column should match itself")
        n_on = int(on.sum())
        check(0 < n_on < on.numel(), "rigid fixture mask is degenerate")

        hold_rigid_bwd(name, (pts, want_i, want_d, gout), worst)
        if name == "open_loop":
            full = (d2, on, pts, gout, want_d, want_i)

    check_rigid_min_edges(g, dev, worst)

    # the backward alone where its grouping of a warp's columns by row is
    # edge-prone: one column, one column past a chunk of 32, every column
    # routed to one row (groups of 32)
    for name, (Bn, Qn, Pn, row) in {"p1": (4, 5, 1, None), "p33": (4, 5, 33, None),
                                    "one_row": (4, 5, P, 37),
                                    "one_row_max_p": (2, 3, 224, 0)}.items():
        pts = (torch.randn((Bn, Qn, Pn, 2), generator=g) * 5.0).to(dev)
        idx = (torch.randint(0, Pn, (Bn, Qn, Pn), generator=g) if row is None
               else torch.full((Bn, Qn, Pn), row)).to(torch.int32).to(dev)
        dist = (torch.rand((Bn, Qn, Pn), generator=g) * 1.5 + 0.5).to(dev)
        gout = torch.randn((Bn, Qn, Pn), generator=g).to(dev)
        hold_rigid_bwd(name, (pts, idx, dist, gout), worst, row)

    check_rigid_tiled(g, dev, worst)

    d2, on, pts, gout, dist, idx = full
    ms = {
        "rigid_min": cuda_ms(lambda: rk.rigid_min(d2, on), 200),
        "rigid_min_fused": cuda_ms(lambda: rk.rigid_min_fused(d2, on), 200),
        "rigid_bwd": cuda_ms(lambda: rk.rigid_bwd(pts, idx, dist, gout), 200),
    }
    plain_min = cuda_ms(lambda: rk.rigid_min_ref(d2, on), 5)
    plain_bwd = cuda_ms(lambda: rk.rigid_bwd_ref(pts, idx, dist, gout), 5)
    # the closed loop's batch, for the schedule comparison
    d2s, ons = d2[:CL_B].contiguous(), on[:CL_B].contiguous()
    # device time from a CUDA graph, at both batch sizes: which schedule the card prefers
    gms = {
        "rigid_min": graph_ms(lambda: rk.rigid_min(d2, on)),
        "rigid_min_fused": graph_ms(lambda: rk.rigid_min_fused(d2, on)),
        "rigid_bwd": graph_ms(lambda: rk.rigid_bwd(pts, idx, dist, gout)),
    }
    gms32 = {k: graph_ms(lambda: getattr(rk, k)(d2s, ons))
             for k in ("rigid_min", "rigid_min_fused")}
    bwd32 = [t[:CL_B].contiguous() for t in (pts, idx, dist, gout)]
    gms32["rigid_bwd"] = graph_ms(lambda: rk.rigid_bwd(*bwd32))
    # a 16 x 16 grid at the open loop's B and Q, the plan the 16 x 16 paths
    # run (the forward kernels' step blocks at B = 128 and a ragged last one,
    # the backward's loop): held against the plain versions, then timed
    P16 = 256
    d2_16 = lattice_d2(g, B, P16, dev)
    on_16 = torch.rand((B, T, P16), generator=g) < 0.6
    on_16.view(B * T, P16)[0] = False
    on_16.view(B * T, P16)[-1] = True
    on_16 = on_16.to(dev)
    want_d16, want_i16 = rk.rigid_min_ref(d2_16, on_16)
    outs16 = {k: getattr(rk, k)(d2_16, on_16) for k in ("rigid_min", "rigid_min_fused")}
    again16 = {k: getattr(rk, k)(d2_16, on_16) for k in outs16}
    torch.cuda.synchronize()
    hold_rigid_min("p256_open_loop", outs16, want_d16, want_i16, worst)
    for k, (d, i) in outs16.items():
        check(torch.equal(d, again16[k][0]) and torch.equal(i, again16[k][1]),
              f"{k} (p256_open_loop) differs between two launches")
    check(bool((want_d16[0, 0] == 1e6).all()) and bool((want_i16[0, 0] == 0).all()),
          "all-off-road step: expected dist 1e6, idx 0")
    check(torch.equal(want_i16[-1, -1].long(), torch.arange(P16, device=dev)),
          "all-on-road step: every column should match itself")
    gout16 = torch.randn((B, T, P16), generator=g).to(dev)
    gout16 = torch.where(on_16 | ~on_16.any(-1, keepdim=True), torch.zeros(()).to(dev), gout16)
    bwd16 = ((torch.randn((B, T, P16, 2), generator=g) * 5.0).to(dev), want_i16, want_d16,
             gout16.contiguous())
    hold_rigid_bwd("p256_open_loop", bwd16, worst)
    del outs16, again16
    gms256 = {k: graph_ms(lambda: getattr(rk, k)(d2_16, on_16), 20, 10)
              for k in ("rigid_min", "rigid_min_fused")}
    gms256["rigid_bwd"] = graph_ms(lambda: rk.rigid_bwd(*bwd16), 20, 10)
    del d2_16, on_16, want_d16, want_i16, gout16, bwd16
    (min256_b, _), (bwd256_b, _) = rigid_bounds(B, T, P16)
    log(f"rigid kernels from a CUDA graph at B={B}, Q={T}, P={P16}: "
        + ", ".join(f"{k} {v:.5f} ms" for k, v in gms256.items())
        + f" (bounds {min256_b:.5f} / {bwd256_b:.5f})")
    min_attrs = {f"{k}{'_tiled' if tiled else ''}": rk.rigid_min_attributes(k, tiled)
                 for k in ("rigid_min", "rigid_min_fused") for tiled in (False, True)}
    for k, a in min_attrs.items():
        log(f"{k}_kernel: {a['registers']} registers, {a['local_bytes']} bytes of local memory "
            f"per thread{' (spills: reported, not failed)' if a['local_bytes'] else ''}")
    bwd_attrs = {Pn: rk.rigid_bwd_attributes(Pn) for Pn in (1, 33, P, 224, P16)}
    for Pn, a in bwd_attrs.items():
        log(f"rigid_bwd_kernel P={Pn}: {a['registers']} registers, {a['local_bytes']} bytes of "
            f"local memory per thread{' (spills: reported, not failed)' if a['local_bytes'] else ''}")
    log(f"rigid kernels at B={B}, back to back from Python: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
        + f"; plain min {plain_min:.3f} ms, plain bwd {plain_bwd:.3f} ms")
    log(f"rigid kernels from a CUDA graph: at B={B} "
        + ", ".join(f"{k} {v:.5f} ms" for k, v in gms.items()) + f"; at B={CL_B} "
        + ", ".join(f"{k} {v:.5f} ms" for k, v in gms32.items()))
    (min_b, min_by), (bwd_b, bwd_by) = rigid_bounds(B, T, P)
    (min32_b, _), (bwd32_b, _) = rigid_bounds(CL_B, T, P)
    log(f"rigid min from a graph: bound {min_b:.5f} ms at B={B} ({min_by}), {min32_b:.5f} at "
        f"B={CL_B}")
    for k in ("rigid_min", "rigid_min_fused"):
        report[k] = dict(max_abs_err=worst[k], ms=ms[k], plain_ms=plain_min, bound_ms=min_b,
                         bound_by=min_by, library_ms=None, graph_ms=gms[k],
                         graph_ms_at_b32=gms32[k], bound_ms_at_b32=min32_b,
                         graph_ms_at_p256=gms256[k], bound_ms_at_p256=min256_b,
                         attributes={"untiled": min_attrs[k], "tiled": min_attrs[f"{k}_tiled"]})
    log(f"rigid_bwd from a graph: {gms['rigid_bwd']:.5f} ms at B={B} (bound {bwd_b:.5f}), "
        f"{gms32['rigid_bwd']:.5f} at B={CL_B} (bound {bwd32_b:.5f})")
    report["rigid_bwd"] = dict(max_abs_err=worst["rigid_bwd"], ms=ms["rigid_bwd"],
                               plain_ms=plain_bwd, bound_ms=bwd_b, bound_by=bwd_by,
                               library_ms=None, graph_ms=gms["rigid_bwd"],
                               graph_ms_at_b32=gms32["rigid_bwd"], bound_ms_at_b32=bwd32_b,
                               graph_ms_at_p256=gms256["rigid_bwd"], bound_ms_at_p256=bwd256_b,
                               attributes={str(k): v for k, v in bwd_attrs.items()})


RIGID_SPECS = {"rigid_kernel": dict(min_dist_impl="rigid_kernel"),
               "fused": dict(min_dist_impl="rigid", min_fwd_impl="fused")}


def run_rigid_paths(models, batch, report):
    """The full-width guided call with the rigid map-distance kernels:
    "rigid_kernel" (forward and backward kernels), then "rigid" + "fused"
    (the fused forward kernel, plain routing backward). Counts exact."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.ops import native

    g = torch.Generator(device=batch.image.device)
    n = N_STEPS - 1
    base = dict(lstm2_fwd=N_STEPS, lstm2_bwd=n, bit_gather=n, offroad_count=1)
    wants = {"rigid_kernel": counts(rigid_min=n, rigid_bwd=n, **base),
             "fused": counts(rigid_min_fused=n, **base)}
    runs = [(name, kw, (10, 10)) for name, kw in RIGID_SPECS.items()]
    runs += [(f"{name}_16x16", kw, (16, 16)) for name, kw in RIGID_SPECS.items()]
    wants.update({f"{name}_16x16": wants[name] for name in RIGID_SPECS})
    budget = gl._FULL_HORIZON_BUDGET
    for name, kw, grid in runs:
        agent, bbox = pipeline.flagship_guidance_specs(AGENTS_PER_SCENE, **kw)
        specs = [agent, dataclasses.replace(bbox, loss=dataclasses.replace(
            bbox.loss, num_points_lw=grid))]
        # "rigid" + "fused" runs the whole horizon at once, which the loss
        # allows up to CLD_GUIDE_FULL_ELEMS (2^27) elements of T B P^2, as the
        # JAX package's does; 16 x 16 at B = 128 is 436 M: raised for that call,
        # as the loss's error asks
        gl._FULL_HORIZON_BUDGET = max(budget, T * B * (grid[0] * grid[1]) ** 2)
        native.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = pipeline.guided_collect(models, batch, guided=True, specs=specs,
                                          agents_per_scene=AGENTS_PER_SCENE,
                                          generator=g.manual_seed(10))
            torch.cuda.synchronize()
        finally:
            gl._FULL_HORIZON_BUDGET = budget
        secs = time.perf_counter() - t0
        launches = native.launch_counts()
        log(f"guided pipeline, {name} ({secs:.2f} s, {B * N_STEPS / secs:.1f} NFE/s; the "
            f"separable call: {report['pipeline']['guided_nfe_per_s']:.1f} NFE/s): "
            f"launches {launches}, reward {float(out['reward']):.4f}")
        check(launches == wants[name], f"{name} launches {launches}, expected {wants[name]}")
        for k in ("pred_traj", "traj", "reward_per_agent"):
            check(bool(torch.isfinite(out[k]).all()), f"{name} guided output {k} is not finite")
        check(tuple(out["traj"].shape) == (B, 1, T, 6), f"traj shape {tuple(out['traj'].shape)}")
        report[f"launches_{name}"] = launches
        report["pipeline"][f"{name}_guided_s"] = secs
        report["pipeline"][f"{name}_guided_nfe_per_s"] = B * N_STEPS / secs


def check_rigid_agreement(models, batch, dev, report):
    """One guidance gradient at full width under "rigid_kernel", "rigid" +
    "fused" and "separable", on the decoded trajectories shifted sideways to
    the road's edge (`road_edge_shift`), so that the map loss has work. The
    first two share the tie rule (the lowest
    on-road row takes a tied column's cotangent): |a - b| <= 1e-4 |b| + 1e-6
    max |b|. "separable" splits ties, so only its loss value is held (1e-5
    relative); the gradients' largest difference is printed."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.guidance import perturbation as gp

    g = torch.Generator().manual_seed(15)
    aux = models.context(batch)
    wfa, si = pipeline.scene_world_poses(B, AGENTS_PER_SCENE, dev)
    ctx = gl.prepack_map_bbox(gl.prepack_drivable(gl.GuidanceContext(
        batch.drivable_map, batch.raster_from_agent, batch.extent, batch.curr_speed, wfa, si)))

    side = road_edge_shift(g, B).to(dev)

    def decode_fn(v):
        acts = pipeline.decode_actions(models.decoder, v, aux["cond_feat"])
        return pipeline.convert_action_to_state_and_action(
            acts, aux["curr_states"], models.dyn, pipeline.TrajNormalizer(),
            descaled_output=True)[:, None] + side

    z = torch.randn((B, T, L), generator=g).to(dev)
    grads, totals = {}, {}
    for name, kw in {**RIGID_SPECS, "separable": {}}.items():
        specs = pipeline.flagship_guidance_specs(AGENTS_PER_SCENE, **kw)
        grads[name] = gp.guidance_gradient(z, ctx, specs, decode_fn)
        with torch.no_grad():
            totals[name] = float(gp.compute_guidance_loss(decode_fn(z), ctx, specs[1:])[0])
    torch.cuda.synchronize()
    a, b = grads["rigid_kernel"], grads["fused"]
    gmax = float(b.abs().max())
    err = float((a - b).abs().max())
    log(f"guidance gradient at B={B}: rigid_kernel vs rigid+fused max abs diff {err:.3e} "
        f"(rtol 1e-4, floor 1e-6 of max |g| {gmax:.3e}); vs separable "
        f"{float((a - grads['separable']).abs().max()):.3e} (printed only: other tie rule)")
    check(gmax > 0.0 and totals["separable"] > 0.0, "the map guidance is idle on this batch")
    check(bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-6 * gmax).all()),
          "rigid_kernel and rigid+fused guidance gradients disagree")
    for name in RIGID_SPECS:
        rel = abs(totals[name] - totals["separable"]) / totals["separable"]
        log(f"map loss value, {name} vs separable: {totals[name]:.6f} vs "
            f"{totals['separable']:.6f} (rel diff {rel:.2e}, tolerance 1e-5)")
        check(rel <= 1e-5, f"{name} map loss value differs from separable's")
    report["rigid_agreement"] = dict(
        kernel_vs_fused_grad=err, kernel_vs_separable_grad=float(
            (a - grads["separable"]).abs().max()), max_grad=gmax, map_loss=totals)


def run_rigid_replan(models, pack, report):
    """One closed-loop replan (4 x 8 agents) with "rigid_kernel" specs:
    exact launch counts and a finite plan."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.ops import native

    dev = pack.init_states.device
    obs = offroad_observation(pack, torch.Generator().manual_seed(9))
    gen = torch.Generator(device=dev)
    plans = {}
    for name in ("separable", "rigid_kernel"):
        policy = pipeline.make_dm_policy(models, CL_AGENTS, specs=pipeline.flagship_guidance_specs(
            CL_AGENTS, min_dist_impl=name))
        native.reset_launch_counts()
        plans[name] = policy(obs, gen.manual_seed(22)).controls
        torch.cuda.synchronize()
        launches = native.launch_counts()
    n = N_STEPS - 1
    want = counts(lstm2_fwd=N_STEPS, lstm2_bwd=n, bit_gather=n, rigid_min=n, rigid_bwd=n)
    diff = float((plans["rigid_kernel"] - plans["separable"]).abs().max())
    log(f"rigid replan: launches {launches}; plan vs the separable plan max abs diff {diff:.3e} "
        "(printed only: other tie rule)")
    check(launches == want, f"rigid replan launches {launches}, expected {want}")
    check(bool(torch.isfinite(plans["rigid_kernel"]).all()), "rigid replan's plan is not finite")
    check(tuple(plans["rigid_kernel"].shape) == (CL_B, T, 2), "rigid replan's plan shape")
    report["launches_rigid_replan"] = launches


def check_small_closed_loop(dev, report):
    """A small closed loop (2 x 3 agents, raster 64, 10 DDPM steps, 10
    frames) on the card and on the CPU, same weights and noise. The card
    takes the banded warp and the CPU the exact one, so the pack's map
    layers are first rounded to multiples of 1/255, where the two warps
    agree. Held as the small slice is: |card - cpu| <= 1e-4 |cpu| + 1e-6
    max |cpu| on the trajectory log; the accumulators' frame counts equal."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.scene import synthetic_scene_pack

    S, A, steps, frames = 2, 3, 10, 10
    cfg = env.SimConfig(num_simulation_steps=frames, n_step_action=5, raster_size=64)
    g = torch.Generator().manual_seed(13)
    noises = [{"x_init": torch.randn((S * A, T, L), generator=g),
               "step_noises": torch.randn((steps, S * A, T, L), generator=g)}
              for _ in range(cfg.num_replans)]
    res = {}
    for where in ("cpu", dev):
        m = pipeline.build_models(seed=5, device=where, n_diffusion_steps=steps,
                                  precision="fp32")
        pack = synthetic_scene_pack(seed=3, num_scenes=S, agents_per_scene=A, world_map_size=256,
                                    sim_steps=frames, device=where)
        pack = pack._replace(world_map=torch.round(pack.world_map * 255.0) * (1.0 / 255.0))
        native.reset_launch_counts()
        state, traj = env.simulate(
            pack, pipeline.make_dm_policy(m, A), cfg,
            replan_noises=[{k: v.to(where) for k, v in n.items()} for n in noises])
        res[str(where)] = (state, traj.cpu(), native.launch_counts())
    (c_state, c_traj, c_launch), (g_state, g_traj, g_launch) = res["cpu"], res[str(dev)]
    n = cfg.num_replans
    want = counts(lstm2_fwd=steps * n, lstm2_bwd=(steps - 1) * n, bit_gather=(steps - 1) * n,
                  value_gather=n)
    check(g_launch == want, f"small closed loop launches {g_launch}, expected {want}")
    check(c_launch == {k: 0 for k in want}, f"the CPU run counted launches: {c_launch}")
    err = float((g_traj - c_traj).abs().max())
    tol = SLICE_RTOL * c_traj.abs() + 1e-6 * float(c_traj.abs().max())
    log(f"small closed loop trajectory log: card vs CPU max abs diff {err:.3e} "
        f"(rtol {SLICE_RTOL:.0e}, floor 1e-06 of max {float(c_traj.abs().max()):.3g})")
    check(bool(((g_traj - c_traj).abs() <= tol).all()),
          "small closed loop disagrees between card and CPU")
    for name in ("offroad_steps", "collision_steps", "collision_type_steps"):
        check(torch.equal(getattr(g_state, name).cpu(), getattr(c_state, name)),
              f"small closed loop {name} differ between card and CPU")
    report["small_closed_loop"] = dict(traj=err)


# the rules path: --guidance configs and --heuristics that, together,
# instantiate every one of the 15 rule classes (the agent-indexed ones by
# config, since the heuristics' pair and group pickers may find none)
RULE_CONFIGS = json.dumps([
    {"name": "acc_limit", "params": {"acc_limit": 2.0}, "weight": 1.0},
    {"name": "keep_distance", "weight": 1.0,
     "params": {"target_ind": 0, "ref_ind": 1, "min_distance": 4.0, "max_distance": 12.0}},
    {"name": "collision_attack", "weight": 1.0,
     "params": {"attacker_ind": 2, "victim_ind": 3, "time_lo": 5, "time_hi": 40}},
    {"name": "social_group", "params": {"group": [4, 5]}, "weight": 1.0},
])
RULE_HEURISTICS = ("target_speed,agent_collision,map_collision,speed_limit,lane_following,"
                   "global_target_pos,stop_sign,social_group,target_pos,target_pos_at_time,"
                   "global_target_pos_at_time,global_stop_sign,gptcollision,gptkeepdistance")
RULE_CLASSES = 15
RULES_STEPS = 20  # frames of the rules path: 4 replans


def rules_argv(scenes, agents, frames, raster, steps, device, output):
    return ["--num-scenes", str(scenes), "--agents-per-scene", str(agents),
            "--num-sim-steps", str(frames), "--raster-size", str(raster),
            "--diffusion-steps", str(steps), "--device", str(device), "--output", str(output),
            "--editing-source", "config,heuristic", "--guidance", RULE_CONFIGS,
            "--heuristics", RULE_HEURISTICS, "--precision", "fp32"]


def run_rules_path(report):
    """The guidance rule library through the rollout CLI at the closed
    loop's width (4 scenes x 8 agents, raster 224, 100 DDPM steps), cut to
    20 frames (4 replans), with `--editing-source config,heuristic`: every
    rule class at least once; launch counts zeroed before and read after,
    exact (per replan 100 `lstm2_fwd`, 99 `lstm2_bwd`, 99 `bit_gather` for
    the one map-collision rule, 1 `value_gather`; 1 more `bit_gather` for the
    map-collision rule of the satisfaction report); a finite trajectory log
    and a finite satisfaction report."""
    import numpy as np

    from cld_tpu_torch import rollout
    from cld_tpu_torch.ops import native

    out = ROOT / "chiprun_out" / "rules_rollout"
    native.reset_launch_counts()
    t0 = time.perf_counter()
    rep = rollout.main(rules_argv(CL_SCENES, CL_AGENTS, RULES_STEPS, RASTER, N_STEPS, "cuda",
                                  out))
    wall = time.perf_counter() - t0
    launches = native.launch_counts()
    n = RULES_STEPS // CL_N_STEP
    episode = counts(lstm2_fwd=N_STEPS * n, lstm2_bwd=(N_STEPS - 1) * n,
                     bit_gather=(N_STEPS - 1) * n, value_gather=n)
    want = cli_launches(episode, bit_gather=1)  # the report's map rule
    classes = sorted(set(rep["rules"]))
    log(f"rules path ({CL_SCENES} x {CL_AGENTS} agents, {RULES_STEPS} frames, {n} replans, "
        f"{wall:.1f} s with the set-up): {len(rep['rules'])} rules of {len(classes)} classes; "
        f"launches {launches} (episode {rep['launches']})")
    log(f"guidance satisfaction: {json.dumps(rep['guidance_satisfaction'])}")
    check(len(classes) == RULE_CLASSES, f"the rules path built {classes}, not all 15 classes")
    check(rep["launches"] == episode, f"rules path episode launches {rep['launches']}, "
          f"expected {episode}")
    check(launches == want, f"rules path launches {launches}, expected {want}")
    with np.load(out / "trajectories.npz") as f:
        traj = f["trajectories"]
    check(traj.shape == (RULES_STEPS, CL_B, 4) and bool(np.isfinite(traj).all()),
          "the rules path's trajectory log is not finite or has the wrong shape")
    check(all(np.isfinite(v) for v in rep["guidance_satisfaction"].values()),
          "the guidance-satisfaction report is not finite")
    report["launches_rules"] = launches
    report["rules"] = dict(wall_s=wall, rules=rep["rules"], agent_steps_per_sec=rep[
        "agent_steps_per_sec"], satisfaction=rep["guidance_satisfaction"])


def check_rules_replan(dev, report):
    """One guided replan's guidance gradient under every rule class, on the
    card and on the CPU, at a small size (2 scenes x 4 agents, raster 64,
    the rules path's configs and heuristics on the first observation), same
    weights and latent; the pack's maps rounded to multiples of 1/255 (where
    the card's banded warp and the CPU's exact one agree). The total loss
    must be finite and equal within 1e-5 relative; the gradient within
    |card - cpu| <= 1e-4 |cpu| + 1e-5 max |cpu| (Adam's sign amplifies
    differences of the latents, not of the gradient)."""
    import torch

    from cld_tpu_torch import pipeline, rollout
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.guidance.perturbation import compute_guidance_loss, guidance_gradient
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.scene import synthetic_scene_pack

    S, A, R = 2, 4, 64
    argv = rules_argv(S, A, 10, R, 10, "cpu", ROOT / "chiprun_out" / "rules_small")
    g = torch.Generator().manual_seed(17)
    z = torch.randn((S * A, T, L), generator=g)
    res = {}
    for where in ("cpu", dev):
        args = rollout.parse_args(argv)
        hist = rollout.experiment_config(args).algo.history_num_frames
        cfg = env.SimConfig(num_simulation_steps=10, n_step_action=5, hist_frames=hist,
                            raster_size=R)
        pack = synthetic_scene_pack(seed=3, num_scenes=S, agents_per_scene=A,
                                    world_map_size=256, sim_steps=10, device=where)
        pack = pack._replace(world_map=torch.round(pack.world_map * 255.0) * (1.0 / 255.0))
        specs = rollout.build_guidance_specs(args, pack, cfg, pack.num_agents)
        m = pipeline.build_models(seed=5, device=where, n_diffusion_steps=10, precision="fp32",
                                  raster_channels=hist + 1 + pack.world_map.shape[-1])
        obs = env.render_observation(pack, env.init_sim_state(pack, cfg), cfg)
        aux = m.context(obs)
        ctx = gl.prepack_map_bbox(gl.prepack_drivable(gl.GuidanceContext(
            obs.drivable_map, obs.raster_from_agent, obs.extent, obs.curr_speed,
            obs.world_from_agent, obs.scene_index,
            **pipeline.observation_context_fields(obs))), with_d2=False)

        def decode_fn(v):
            acts = pipeline.decode_actions(m.decoder, v, aux["cond_feat"])
            return pipeline.convert_action_to_state_and_action(
                acts, aux["curr_states"], m.dyn, pipeline.TrajNormalizer(),
                descaled_output=True)[:, None]

        zz = z.to(where)
        with torch.no_grad():
            total, _ = compute_guidance_loss(decode_fn(zz), ctx, specs)
        grad = guidance_gradient(zz, ctx, specs, decode_fn)
        res[str(where)] = (float(total), grad.cpu(), len({type(s.loss) for s in specs}))
    (c_loss, c_grad, c_n), (g_loss, g_grad, g_n) = res["cpu"], res[str(dev)]
    err = float((g_grad - c_grad).abs().max())
    scale = float(c_grad.abs().max())
    log(f"rules replan ({S} x {A} agents, {c_n} rule classes): loss card {g_loss:.6g}, CPU "
        f"{c_loss:.6g}; guidance gradient card vs CPU max abs diff {err:.3e} (max |cpu| "
        f"{scale:.3g})")
    check(c_n == RULE_CLASSES and g_n == RULE_CLASSES, f"the small rules replan built {c_n} "
          "rule classes")
    check(all(map(lambda v: v == v and abs(v) < float("inf"), (c_loss, g_loss))),
          "the rules replan's guidance loss is not finite")
    check(bool(torch.isfinite(g_grad).all()) and bool(torch.isfinite(c_grad).all()),
          "the rules replan's guidance gradient is not finite")
    check(abs(g_loss - c_loss) <= 1e-5 * abs(c_loss), "the rules replan's loss differs between "
          "card and CPU")
    check(bool(((g_grad - c_grad).abs() <= 1e-4 * c_grad.abs() + 1e-5 * scale).all()),
          "the rules replan's guidance gradient differs between card and CPU")
    report["rules_replan"] = dict(loss_cpu=c_loss, loss_card=g_loss, grad_err=err,
                                  grad_max=scale)


CKPT_STEPS = 20  # frames of the checkpoint path's rollouts: 4 replans


def ckpt_rollout_argv(vae, dm, output):
    return ["--registered-name", "cld_dm_nusc", "--vae-ckpt", str(vae), "--dm-ckpt", str(dm),
            "--num-scenes", str(CL_SCENES), "--agents-per-scene", str(CL_AGENTS),
            "--num-sim-steps", str(CKPT_STEPS), "--cle-report", "--guidance", "flagship",
            "--device", "cuda", "--output", str(output), "--precision", "fp32"]


def first_plan(run, models=None):
    """The first replan's plan (the kept sample's [Na, T, 2] controls) of the
    CLI's policy, or of the same policy over other `models`, drawn from a
    generator seeded as the CLI seeds its own."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.sim import env

    policy = run.policy if models is None else pipeline.make_dm_policy(
        models, CL_AGENTS, guided=True, specs=run.specs, options=run.options)
    obs = env.render_observation(run.pack, env.init_sim_state(run.pack, run.sim_cfg),
                                 run.sim_cfg, world_q8=env.quantize_world_maps_q8(
                                     run.pack.world_map))
    return policy(obs, torch.Generator(device=run.device).manual_seed(0)).controls


def run_checkpoint_path(report):
    """Train, roll out and evaluate: the trainers' `ckpt_final` files through
    the rollout CLI and `--mode test`, and the same weights as a
    Lightning-style file (see step 18 of the module's docstring)."""
    import numpy as np
    import torch

    from cld_tpu_torch import pipeline, rollout, train
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.utils.torch_import import submap

    t_phase = time.perf_counter()
    out = ROOT / "chiprun_out" / "ckpt_path"
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps({"train": {"training": {"steps_per_epoch": 1}}}))
    base = ["--registered-name", "cld_vae_nusc", "--config", str(out / "config.json"),
            "--device", "cuda", "--output", str(out / "runs"), "--steps", "2",
            "--precision", "fp32"]
    vae_ckpt, dm_ckpt = out / "runs" / "vae" / "ckpt_final", out / "runs" / "dm" / "ckpt_final"
    native.reset_launch_counts()
    vae_state = train.main(base + ["--mode", "vae"])
    dm_state = train.main(base + ["--mode", "dm", "--vae-ckpt", str(vae_ckpt)])
    train_launches = native.launch_counts()
    check(train_launches == counts(), f"checkpoint training launches {train_launches}")
    check(vae_state.step == 2 and dm_state.step == 2, "the trainers did not take 2 steps")

    # (b) the trainers' checkpoints through the rollout CLI
    argv = ckpt_rollout_argv(vae_ckpt, dm_ckpt, out / "rollout")
    run = rollout.build(rollout.parse_args(argv))
    check(run.sim_cfg.raster_size == RASTER and run.models.schedule.n_timesteps == N_STEPS,
          "the checkpoint path is not at the config of record's raster and steps")
    direct = pipeline.build_models_from_config(run.cfg, device=run.device, seed=0)
    direct.context.load_state_dict(submap(vae_state.model.state_dict(), "context_encoder"))
    direct.decoder.load_state_dict(submap(vae_state.model.state_dict(), "lstmvae.lstm_dec"))
    direct.unet.load_state_dict(dm_state.model.state_dict())
    fresh = pipeline.build_models_from_config(run.cfg, device=run.device, seed=0)
    check(any(not torch.equal(a, b) for a, b in zip(fresh.unet.state_dict().values(),
                                                   run.models.unet.state_dict().values())),
          "the CLI's denoiser holds the random initial weights, not the trained ones")
    plan = first_plan(run)
    plan_direct = first_plan(run, direct)
    check(tuple(plan.shape) == (CL_B, T, 2) and bool(torch.isfinite(plan).all()),
          "the checkpoint path's first plan is not finite [Na, T, 2]")
    check(torch.equal(plan, plan_direct), "the CLI's first plan differs from the plan of the "
          "models loaded straight from the trainers' state dicts")
    del direct, fresh
    native.reset_launch_counts()
    t0 = time.perf_counter()
    rep = rollout.main(argv)
    wall = time.perf_counter() - t0
    launches = native.launch_counts()
    n = CKPT_STEPS // CL_N_STEP
    episode = counts(lstm2_fwd=N_STEPS * n, lstm2_bwd=(N_STEPS - 1) * n,
                     bit_gather=(N_STEPS - 1) * n, value_gather=n)
    want = cli_launches(episode, bit_gather=1)  # the report's map rule
    check(rep["launches"] == episode, f"checkpoint rollout episode launches {rep['launches']}, "
          f"expected {episode}")
    check(launches == want, f"checkpoint rollout launches {launches}, expected {want}")
    numbers = [v for k, v in rep.items() if isinstance(v, (int, float))]
    numbers += [v for sub in rep["cle"].values() if isinstance(sub, dict) for v in sub.values()]
    numbers += list(rep["guidance_satisfaction"].values())
    check(all(np.isfinite(v) for v in numbers) and "occupancy_coverage" in rep,
          "the checkpoint rollout's report is not finite")
    with np.load(out / "rollout" / "trajectories.npz") as f:
        traj = f["trajectories"]
    check(traj.shape == (CKPT_STEPS, CL_B, 4) and bool(np.isfinite(traj).all()),
          "the checkpoint rollout's trajectory log is not finite")
    # the eval layer's host time on this log: the occupancy report and the CLE summary
    from cld_tpu_torch.eval.cle import cle_report

    log_t = torch.from_numpy(traj).to(run.device)
    eval_layer_s = {}
    for name, fn in (("occupancy_report", lambda: rollout.occupancy_report(run.pack, log_t)),
                     ("cle_report", lambda: cle_report(run.pack, log_t, run.sim_cfg))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        eval_layer_s[name] = (time.perf_counter() - t0) / 5
    log(f"eval layer on the rollout's log ({CKPT_STEPS} frames x {CL_B} agents, host s per call, "
        f"mean of 5): {json.dumps(eval_layer_s)} on {report['card']}")
    del run
    log(f"checkpoint rollout ({CL_SCENES} x {CL_AGENTS} agents, {CKPT_STEPS} frames, {n} "
        f"replans): {rep['agent_steps_per_sec']:.2f} agent-steps/s ({rep['wall_clock_s']:.2f} s "
        f"the episode, {wall:.1f} s with the set-up and reports) on {report['card']}; metrics "
        f"{json.dumps({k: rep[k] for k in ('offroad_rate', 'collision_rate')})}, occupancy "
        f"{rep['occupancy_coverage']:.4f}, cle {json.dumps(rep['cle'])}; launches {launches}")

    # (c) the same weights as a Lightning-style file
    light = out / "reference.ckpt"
    sd = {f"vae.{k}": v for k, v in vae_state.model.state_dict().items()}
    sd.update({f"dm.model.{k}": v for k, v in dm_state.model.state_dict().items()})
    torch.save({"state_dict": sd, "epoch": 0, "global_step": 2}, light)
    largv = ckpt_rollout_argv(light, light, out / "rollout_lightning")
    check(torch.equal(first_plan(rollout.build(rollout.parse_args(largv))), plan),
          "the Lightning file's first plan differs from the trainers' checkpoints'")
    native.reset_launch_counts()
    rollout.main(largv)
    check(native.launch_counts() == want, "the Lightning rollout's launches differ")
    with np.load(out / "rollout_lightning" / "trajectories.npz") as f:
        check(np.array_equal(f["trajectories"], traj),
              "the Lightning file's trajectory log differs from the checkpoints'")
    log("Lightning-style .ckpt: the same first plan and trajectory log, bit for bit")

    # (d) --mode test on the checkpoints
    native.reset_launch_counts()
    t0 = time.perf_counter()
    res = train.main(["--registered-name", "cld_dm_nusc", "--mode", "test", "--steps", "2",
                      "--vae-ckpt", str(vae_ckpt), "--dm-ckpt", str(dm_ckpt), "--device", "cuda",
                      "--output", str(out / "runs"), "--precision", "fp32"])
    eval_s = time.perf_counter() - t0
    eval_launches = native.launch_counts()
    check(eval_launches == counts(lstm2_fwd=2), f"--mode test launches {eval_launches}, "
          "expected 2 lstm2_fwd")
    check(all(np.isfinite(v) for v in res.values()) and "realism_deviation" in res,
          f"--mode test result is not finite: {res}")
    # the report directory keeps the small outputs only: the checkpoints hold ~0.4 GB with
    # their optimizer states
    shutil.rmtree(out / "runs")
    light.unlink()
    secs = time.perf_counter() - t_phase
    log(f"--mode test (2 batches of 128): {json.dumps(res)} in {eval_s:.1f} s; checkpoint "
        f"phase {secs:.1f} s in all, on {report['card']}")
    report["launches_checkpoint_rollout"] = launches
    report["launches_evaluate"] = eval_launches
    report["checkpoint_path"] = dict(
        phase_s=secs, rollout_wall_clock_s=rep["wall_clock_s"],
        rollout_agent_steps_per_sec=rep["agent_steps_per_sec"], eval_s=eval_s,
        eval_layer_s=eval_layer_s,
        evaluate=res, occupancy={k: rep[k] for k in ("occupancy_coverage",
                                                     "offroad_occupancy_fraction",
                                                     "occupied_cells")},
        cle=rep["cle"])


DATA_BATCHES, DATA_BATCH = 2, 32  # shards of the data path: 64 samples at raster 224
DATA_STEPS = 20  # frames of the scene-data rollouts: 4 replans
MODEL_FREE = ("gt_replay", "lattice", "mpc", "contingency")
OCC_THRESH = 0.1  # occupancy_metrics' occupied_thresh


def planner_observation(Bn, dev):
    """The model-free planners' card-vs-CPU fixture: a synthetic batch at
    raster 224 with its road and lanes shifted 1.5 m to +y (3 pixel rows),
    so that the ego is off the road's center line and mirror-image
    candidates do not tie (as in `tests/test_torch_planners.py`)."""
    import torch

    from cld_tpu_torch.data.synthetic import synthetic_batch

    b = synthetic_batch(seed=5, batch_size=Bn, raster_size=RASTER, device="cpu")
    hist = b.history_positions.shape[1]
    image = b.image.clone()
    image[..., hist:] = torch.roll(image[..., hist:], 3, dims=1)
    lanes = b.lane_points.clone()
    lanes[..., 1] += 1.5
    b = b._replace(image=image, drivable_map=torch.roll(b.drivable_map, 3, dims=1),
                   lane_points=lanes)
    return b._replace(**{k: v.to(dev) for k, v in b._asdict().items() if torch.is_tensor(v)})


def check_planners_card_vs_cpu() -> dict:
    """One MPC and one contingency replan of `CL_B` agents on
    `planner_observation`, card against CPU. Both planners amplify
    last-bit differences by design, so each is held where it is continuous:
    float32 against float64 on the CPU already moves 14 of 32 agents' MPC
    controls by > 1e-3 after the record's 100 Adam iterations at a fixed
    rate (0.78 at most; 2.5e-4 after 20), and each agent's final FTOCP
    cost by 4.2e-2 of itself at most; and it picks another contingency
    branch for 5 agents (progress saturates, so branches tie to the last
    bits). Held: the MPC's controls after 20 iterations within 1e-3, and
    at the record's 100 iterations (`--policy mpc`) each agent's final cost
    within `MPC_COST_RTOL` of the CPU's (the controls' difference is
    reported; 20, 50 or 90 iterations, or a rate of 0.1 or 0.25, move
    8-22 agents' costs by more than 0.1 on the CPU); the contingency
    planner, on the fixture with every pixel drivable (the off-road cost is
    a pixel indicator), its root costs within 1e-4 of their largest
    magnitude, and the branch the card picks optimal within that under the CPU's costs;
    where both pick the same leaf, the plans within 1e-4 m."""
    import torch

    from cld_tpu_torch.policies import contingency, mpc

    out = {}
    for where in ("cpu", "cuda"):
        obs = planner_observation(CL_B, where)
        sols = {it: mpc.solve_from_observation(mpc.MPCConfig(iters=it), obs) for it in (20, 100)}
        ctrl = {it: torch.cat([sol["u0"][:, None], sol["ubr"][:, 0]], dim=1).cpu()
                for it, sol in sols.items()}
        ctrl["cost"] = sols[100]["cost"].cpu()
        plan = contingency.plan_from_observation(contingency.ContingencyConfig(), obs._replace(
            drivable_map=torch.ones_like(obs.drivable_map)))
        out[where] = (ctrl, {k: plan[k].cpu() for k in ("branch", "leaf", "plan", "root_cost")})
    (c_ctrl, c_plan), (g_ctrl, g_plan) = out["cpu"], out["cuda"]
    err20 = float((g_ctrl[20] - c_ctrl[20]).abs().max())
    err100 = (g_ctrl[100] - c_ctrl[100]).abs().amax(dim=(1, 2))
    cost_rel = float(((g_ctrl["cost"] - c_ctrl["cost"]).abs() / c_ctrl["cost"].abs()).max())
    log(f"one mpc replan ({CL_B} agents), controls card vs CPU: 20 iterations max |diff| "
        f"{err20:.3e} (tolerance 1e-3); the record's 100: final cost max relative |diff| "
        f"{cost_rel:.3e} (tolerance {MPC_COST_RTOL:g}), controls {float(err100.max()):.3e}, "
        f"{int((err100 > 1e-3).sum())} agents above 1e-3 (not held)")
    check(err20 <= 1e-3, "the mpc replan's controls differ between card and CPU")
    check(cost_rel <= MPC_COST_RTOL,
          "the mpc replan's final costs at 100 iterations differ between card and CPU")
    rc_c, rc_g = c_plan["root_cost"], g_plan["root_cost"]
    scale = float(rc_c.abs().max())
    rc_err = float((rc_g - rc_c).abs().max())
    rows = torch.arange(CL_B)
    regret = float((rc_c[rows, g_plan["branch"]] - rc_c.amin(dim=-1)).max())
    same = g_plan["leaf"] == c_plan["leaf"]
    plan_err = float((g_plan["plan"][same] - c_plan["plan"][same]).abs().max())
    log(f"one contingency replan ({CL_B} agents, every pixel drivable), card vs CPU: root costs "
        f"max |diff| {rc_err:.3e} (max |cost| {scale:.3g}), the card's branch {regret:.3e} above "
        f"the CPU's optimum, the same leaf for {int(same.sum())} agents, their plans max |diff| "
        f"{plan_err:.3e} m")
    check(rc_err <= 1e-4 * scale and regret <= 1e-4 * scale and plan_err <= 1e-4,
          "the contingency replan differs between card and CPU")
    return dict(mpc_card_vs_cpu_20=err20, mpc_card_vs_cpu_100=float(err100.max()),
                mpc_cost_rel_err_100=cost_rel,
                contingency_root_cost_err=rc_err, contingency_regret=regret,
                contingency_same_leaf=int(same.sum()), contingency_plan_err=plan_err)


def check_occupancy_twice(pack, traj, report):
    """The occupancy splat adds with atomics on the card: two runs on the
    same log give grids within rtol 1e-5 / atol 1e-7 (float32 sums in
    another order), every cell clear of the occupied threshold by more than
    that, so the metrics of the two runs are equal."""
    import torch

    from cld_tpu_torch import rollout
    from cld_tpu_torch.sim.occupancy import occupancy_init, occupancy_update

    Hw = pack.world_map.shape[1]
    worst, clear = 0.0, float("inf")
    for s in range(pack.world_map.shape[0]):
        pos = traj[:, pack.scene_index == s, :2].reshape(-1, 2)
        grids = []
        for _ in range(2):
            origin = (float(pack.map_origin[s, 0]), float(pack.map_origin[s, 1]))
            occ = occupancy_init(origin=origin, size=(Hw // 2, Hw // 2),
                                 step=2 * pack.map_resolution, sigma=1.0, device=traj.device)
            grids.append(occupancy_update(occ, pos).grid)
        a, b = grids
        check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-7)),
              f"scene {s}: two occupancy grids differ beyond rtol 1e-5 / atol 1e-7")
        worst = max(worst, float((a - b).abs().max()))
        clear = min(clear, float((a - OCC_THRESH).abs().min()))
    check(clear > 1e-5 * OCC_THRESH + 1e-7, f"a grid cell lies within the tolerance of the "
          f"occupied threshold ({clear:.3e}): the metrics' equality would not be meaningful")
    m1, m2 = rollout.occupancy_report(pack, traj), rollout.occupancy_report(pack, traj)
    check(m1 == m2, f"two occupancy reports of the same log differ: {m1} vs {m2}")
    log(f"occupancy grid on the card, twice on the scene-data log: max |diff| {worst:.3e}, "
        f"nearest cell to the threshold {clear:.3e} away, metrics equal {json.dumps(m1)}")
    report["occupancy_twice"] = dict(max_abs_diff=worst, clear_of_thresh=clear, metrics=m1)


def run_data_path(report):
    """The data stack and the model-free policies at full width (see step
    19 of the module's docstring). Writes the shards into a temporary
    directory outside the checkout and deletes it at the end."""
    import tempfile

    import numpy as np
    import torch

    from cld_tpu_torch import rollout, train
    from cld_tpu_torch.data import convert, packed
    from cld_tpu_torch.data.loader import make_loader
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.policies import contingency, hardcoded, mpc
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.scene import scene_pack_from_shards
    from cld_tpu_torch.training.vae import VAETrainer
    from cld_tpu_torch.utils.registry import config_from_flags

    t_phase = time.perf_counter()
    out = ROOT / "chiprun_out" / "data_path"
    out.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="cld_shards_"))
    res = {}
    try:
        shards = tmp / "shards"
        t0 = time.perf_counter()
        convert.convert_synthetic(str(shards), DATA_BATCHES, DATA_BATCH, RASTER, 0)
        res["write_s"] = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in shards.iterdir())
        log(f"wrote {DATA_BATCHES * DATA_BATCH} synthetic samples at raster {RASTER} "
            f"({nbytes / 1e9:.3f} GB) in {res['write_s']:.1f} s")

        # (a) the loader's order: the first batch on the card is the host's, bit for bit
        cfg_file = tmp / "config.json"
        cfg_file.write_text(json.dumps({
            "train": {"data_path": str(shards), "training": {"steps_per_epoch": 1,
                                                             "batch_size": B,
                                                             "precision": "fp32"}},
            "env": {"rasterizer": {"raster_size": RASTER}}}))
        cfg = config_from_flags("cld_vae_nusc", str(cfg_file))
        card_b = next(iter(make_loader(cfg, "train", device="cuda")))
        host_b = next(iter(make_loader(cfg, "train", device="cpu")))
        same = [k for k, v in host_b._asdict().items() if torch.is_tensor(v)]
        check(card_b.image.shape[0] == B and all(
            torch.equal(getattr(card_b, k).cpu(), getattr(host_b, k)) for k in same),
            "the loader's first batch on the card differs from the host's")
        log(f"loader: the first batch of {B} on the card equals the host's, {len(same)} fields "
            "bit for bit")
        del card_b, host_b

        # (b) the loader's time per batch of 128 (host gather, copy to the card) beside a
        # VAE step's
        ldr = packed.PackedShardLoader(str(shards), batch_size=B, device="cuda")
        rng = np.random.default_rng(1)
        trainer = VAETrainer(cfg, device="cuda")
        state = trainer.init_state(0)
        gen = torch.Generator(device="cuda").manual_seed(1)
        gather_s, copy_s, step_s = [], [], []
        for i in range(4):
            t0 = time.perf_counter()
            raw = ldr.ds.gather(rng.integers(0, ldr.ds.num_samples, B))
            t1 = time.perf_counter()
            batch = packed.to_traffic_batch(raw, "cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            trainer.train_step(state, batch, generator=gen)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if i:  # the first round warms up
                gather_s.append(t1 - t0)
                copy_s.append(t2 - t1)
                step_s.append(t3 - t2)
        batch_gb = sum(v.nbytes for v in raw.values()) / 1e9
        res["loader_ms"] = dict(gather=1e3 * float(np.mean(gather_s)),
                                copy=1e3 * float(np.mean(copy_s)),
                                vae_step=1e3 * float(np.mean(step_s)), batch_gb=batch_gb)
        log(f"loader per batch of {B} ({batch_gb:.3f} GB, mean of 3): host gather "
            f"{res['loader_ms']['gather']:.1f} ms + copy to the card "
            f"{res['loader_ms']['copy']:.1f} ms, beside a VAE step's "
            f"{res['loader_ms']['vae_step']:.1f} ms, on {report['card']}")
        ldr.ds.close()
        del trainer, state, batch, raw

        # (c) train the VAE and then the DM stage from the shards, 2 steps each
        base = ["--registered-name", "cld_vae_nusc", "--config", str(cfg_file), "--device",
                "cuda", "--output", str(tmp / "runs"), "--steps", "2"]
        native.reset_launch_counts()
        t0 = time.perf_counter()
        vae_state = train.main(base + ["--mode", "vae"])
        dm_state = train.main(base + ["--mode", "dm", "--vae-ckpt",
                                      str(tmp / "runs" / "vae" / "ckpt_final")])
        res["train_s"] = time.perf_counter() - t0
        train_launches = native.launch_counts()
        check(train_launches == counts(), f"training from shards launched {train_launches}")
        check(vae_state.step == 2 and dm_state.step == 2, "the trainers did not take 2 steps")
        losses = {}
        for stage in ("vae", "dm"):
            recs = [json.loads(line) for line in
                    (tmp / "runs" / stage / "metrics.jsonl").read_text().splitlines()]
            losses[stage] = [r["train/loss"] for r in recs]
            check(len(recs) == 2 and all(np.isfinite(v) for r in recs for v in r.values()),
                  f"the {stage} stage's metrics from the shards are not finite")
        del vae_state, dm_state
        log(f"trained from the shards, 2 VAE + 2 DM steps in {res['train_s']:.1f} s: losses "
            f"{json.dumps(losses)}")
        report["launches_data_train"] = train_launches

        # (d) the guided rollout on the scene data
        n = DATA_STEPS // CL_N_STEP
        scene = ["--scene-data", str(shards), "--num-scenes", str(CL_SCENES),
                 "--agents-per-scene", str(CL_AGENTS), "--num-sim-steps", str(DATA_STEPS),
                 "--raster-size", str(RASTER), "--diffusion-steps", str(N_STEPS),
                 "--device", "cuda", "--precision", "fp32"]
        argv = scene + ["--policy", "dm", "--agents-policy", "gt_replay", "--guidance",
                        "flagship", "--num-action-samples", "2", "--guide-with-gt",
                        "--cle-report", "--output", str(out / "scene_rollout")]
        native.reset_launch_counts()
        t0 = time.perf_counter()
        rep = rollout.main(argv)
        wall = time.perf_counter() - t0
        launches = native.launch_counts()
        episode = counts(lstm2_fwd=N_STEPS * n, lstm2_bwd=(N_STEPS - 1) * n,
                         bit_gather=(N_STEPS - 1) * n, value_gather=n)
        want = cli_launches(episode, bit_gather=1)  # the report's map rule
        check(rep["launches"] == episode, f"scene-data rollout episode launches "
              f"{rep['launches']}, expected {episode}")
        check(launches == want, f"scene-data rollout launches {launches}, expected {want}")
        numbers = [v for v in rep.values() if isinstance(v, (int, float))]
        numbers += [v for sub in rep["cle"].values() if isinstance(sub, dict)
                    for v in sub.values()]
        numbers += list(rep["guidance_satisfaction"].values())
        check(all(np.isfinite(v) for v in numbers) and "compile_and_first_run_s" in rep,
              "the scene-data rollout's report is not finite or lacks compile_and_first_run_s")
        with np.load(out / "scene_rollout" / "trajectories.npz") as f:
            traj = f["trajectories"]
        check(traj.shape == (DATA_STEPS, CL_B, 4) and bool(np.isfinite(traj).all()),
              "the scene-data rollout's trajectory log is not finite")
        log(f"scene-data rollout (dm ego + gt_replay agents, flagship rules, 2 samples, "
            f"--guide-with-gt; {CL_SCENES} x {CL_AGENTS} agents, {DATA_STEPS} frames, {n} "
            f"replans): {rep['agent_steps_per_sec']:.2f} agent-steps/s ({rep['wall_clock_s']:.2f} "
            f"s the timed episode, {rep['compile_and_first_run_s']:.2f} s the first, {wall:.1f} s "
            f"with the set-up and reports) on {report['card']}; launches {launches}")
        report["launches_scene_data_rollout"] = launches
        res["scene_rollout"] = dict(
            wall_clock_s=rep["wall_clock_s"], agent_steps_per_sec=rep["agent_steps_per_sec"],
            compile_and_first_run_s=rep["compile_and_first_run_s"],
            metrics={k: rep[k] for k in ("offroad_rate", "collision_rate", "occupancy_coverage")})
        pack = scene_pack_from_shards(str(shards), num_scenes=CL_SCENES,
                                      agents_per_scene=CL_AGENTS, sim_steps=DATA_STEPS,
                                      device="cuda")
        check_occupancy_twice(pack, torch.from_numpy(traj).cuda(), res)

        # (e) the model-free policies at the same width: no LSTM launch, one warp a replan
        res["policies"] = {}
        for name in MODEL_FREE:
            native.reset_launch_counts()
            rep = rollout.main(scene + ["--policy", name, "--output", str(out / name)])
            launches = native.launch_counts()
            check(rep["launches"] == counts(value_gather=n) and
                  launches == cli_launches(counts(value_gather=n)),
                  f"--policy {name} launched {rep['launches']} in its timed episode, {launches} "
                  f"in all, expected {counts(value_gather=n)} per episode")
            with np.load(out / name / "trajectories.npz") as f:
                check(bool(np.isfinite(f["trajectories"]).all()),
                      f"--policy {name}'s trajectory log is not finite")
            per_replan = rep["wall_clock_s"] / n
            res["policies"][name] = dict(s_per_replan=per_replan,
                                         first_episode_s=rep["compile_and_first_run_s"],
                                         offroad_rate=rep["offroad_rate"],
                                         collision_rate=rep["collision_rate"])
            report[f"launches_{name}"] = launches
            log(f"--policy {name}: {per_replan:.3f} s per replan ({CL_B} agents, timed episode), "
                f"offroad {rep['offroad_rate']:.3f}, collision {rep['collision_rate']:.3f}")

        # (f) card against CPU: the uncontrolled replay follows the dataset, and one MPC and
        # one contingency replan agree
        sim_cfg = env.SimConfig(num_simulation_steps=DATA_STEPS, n_step_action=CL_N_STEP,
                                raster_size=RASTER)
        for where in ("cpu", "cuda"):
            p = scene_pack_from_shards(str(shards), num_scenes=CL_SCENES,
                                       agents_per_scene=CL_AGENTS, sim_steps=DATA_STEPS,
                                       controlled_mask=np.zeros(CL_B, bool), device=where)
            _, log_r = env.simulate(p, hardcoded.replay_policy(p.replay_actions), sim_cfg)
            gt = p.gt_states[:, 1:DATA_STEPS + 1].transpose(0, 1)
            err = float((log_r[..., :2] - gt[..., :2]).abs().max())
            scale = float(gt[..., :2].abs().max())
            log(f"uncontrolled gt_replay on the {where}: log vs gt_states max |diff| {err:.3e} m "
                f"(coordinates up to {scale:.1f} m; tolerance 1e-5 m)")
            check(err <= 1e-5, f"the uncontrolled replay on the {where} leaves the dataset by "
                  f"{err:.3e} m")
            res[f"replay_err_{where}"] = err
        # the planners are argmin and fixed-rate Adam: held where they are continuous (see
        # `planner_observation`)
        res.update(check_planners_card_vs_cpu())
        res["phase_s"] = time.perf_counter() - t_phase
        log(f"data path phase {res['phase_s']:.1f} s in all, on {report['card']}")
        report["data_path"] = res
        run_zoo_path(report, shards, tmp)  # the zoo trains from the same shards
        run_learned_path(report, shards, tmp)  # so do the EBM and the GANs
        run_composer_path(report, tmp)  # `--composer-ckpt` reads the zoo's nusc_bc
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the zoo path: the eleven baseline algos by their nuScenes registry names
ZOO_ALGOS = {"nusc_bc": "bc", "nusc_bc_gc": "bc_gc", "nusc_vae": "vae",
             "nusc_discrete_vae": "discrete_vae", "nusc_transformer": "TransformerPred",
             "nusc_tree_vae": "tree_vae", "nusc_agent_predictor": "agent_predictor",
             "nusc_bc_ec": "bc_ec", "nusc_spatial_planner": "spatial_planner",
             "nusc_occupancy": "occupancy", "nusc_diff": "diff"}
ZOO_STEPS = 3  # steps 2 and 3 are timed
ZOO_SMALL_B, ZOO_SMALL_RASTER = 4, 64  # the card-vs-CPU check's width
ZOO_REL_TOL = 1e-4  # card vs CPU: the loss (relative) and each gradient (of its largest entry)


def to_device(batch, dev):
    import torch

    return batch._replace(**{k: v.to(dev) for k, v in batch._asdict().items()
                             if torch.is_tensor(v)})


def check_zoo_card_vs_cpu() -> dict:
    """Each algo's loss and gradients with `train=False` (running BatchNorm
    statistics; the discrete CVAE's argmax mode) on the card and on the CPU
    from the same weights and the same explicit draws, at B=4, raster 64.
    Gradients whose exact value is 0 (attention key biases: softmax ignores
    a shift of all logits) are held against the model's largest gradient."""
    import copy

    import torch

    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.training import zoo
    from cld_tpu_torch.utils.registry import get_registered_experiment_config

    dev = torch.device("cuda", 0)
    b_cpu = synthetic_batch(seed=2, batch_size=ZOO_SMALL_B, raster_size=ZOO_SMALL_RASTER,
                            device="cpu")
    b_dev = to_device(b_cpu, dev)
    worst = {}
    for reg, algo in ZOO_ALGOS.items():
        spec = zoo.algo_factory(get_registered_experiment_config(reg), algo)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            cpu_model = spec.build()
        dev_model = copy.deepcopy(cpu_model).to(dev)
        noise = spec.draw(b_cpu, torch.Generator().manual_seed(3))
        loss_c = spec.loss_call(cpu_model, b_cpu, False, noise)[0]
        loss_c.backward()
        noise_d = {k: v.to(dev) for k, v in noise.items()}
        loss_d = spec.loss_call(dev_model, b_dev, False, noise_d)[0]
        loss_d.backward()
        loss_c, loss_d = loss_c.item(), loss_d.item()
        loss_err = abs(loss_d - loss_c) / abs(loss_c)
        grads_c = {k: p.grad for k, p in cpu_model.named_parameters()}
        scale = max(float(g.abs().max()) for g in grads_c.values())
        grad_err = 0.0
        for k, p in dev_model.named_parameters():
            ref = grads_c[k]
            denom = scale if k.endswith(ZERO_IN_EXACT) else float(ref.abs().max())
            grad_err = max(grad_err, float((p.grad.cpu() - ref).abs().max()) / max(denom, 1e-30))
        worst[algo] = {"loss_rel_err": loss_err, "grad_err": grad_err}
        log(f"zoo card vs CPU {algo}: loss {loss_c:.6g}, relative error {loss_err:.2e}; "
            f"worst gradient error {grad_err:.2e} of its largest entry (tolerance {ZOO_REL_TOL})")
        check(loss_err <= ZOO_REL_TOL and grad_err <= ZOO_REL_TOL,
              f"zoo {algo}: card and CPU disagree (loss {loss_err:.2e}, gradients {grad_err:.2e})")
    return worst


def run_zoo_path(report, shards, tmp):
    """The model zoo at full width (the config of record: batch 128, raster
    224x224x34, horizon 52, ResNet-18, cond_feat 256) from the data phase's
    shards: each of the eleven algos through `python -m cld_tpu_torch.train
    --registered-name nusc_<algo> --mode zoo --steps 3`, with its ms per step
    (steps 2 and 3, synchronized around `ZooTrainer.train_step`), peak device
    memory, final loss, `ckpt_final`, and no kernel launch; one VAE step with
    ResNet-50 and with the spatial-softmax head and one DM step with the
    residual-MLP denoiser; then each algo's loss and gradients card vs CPU."""
    import numpy as np
    import torch

    from cld_tpu_torch import train
    from cld_tpu_torch.data.loader import make_loader
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.training import zoo
    from cld_tpu_torch.training.dm import DMTrainer
    from cld_tpu_torch.training.vae import VAETrainer
    from cld_tpu_torch.utils.registry import config_from_flags

    t_phase = time.perf_counter()
    cfg_file = tmp / "zoo_config.json"
    cfg_file.write_text(json.dumps({
        "train": {"data_path": str(shards), "training": {"batch_size": B, "steps_per_epoch": 1,
                                                         "precision": "fp32"}},
        "env": {"rasterizer": {"raster_size": RASTER}}}))
    res, total = {}, counts()
    step_s = []
    with timed_method(zoo.ZooTrainer, "train_step", step_s):
        for reg, algo in ZOO_ALGOS.items():
            step_s.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            native.reset_launch_counts()
            t0 = time.perf_counter()
            state = train.main(["--registered-name", reg, "--mode", "zoo", "--config",
                                str(cfg_file), "--device", "cuda", "--output",
                                str(tmp / "zoo_runs"), "--steps", str(ZOO_STEPS)])
            call_s = time.perf_counter() - t0
            launched = native.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            out = tmp / "zoo_runs" / f"zoo_{algo}"
            recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
            loss = recs[-1]["train/loss"]
            r = dict(ms_per_step=1e3 * float(np.mean(step_s[1:])), peak_gb=peak / 1e9,
                     final_loss=loss, call_s=call_s, ckpt_final=(out / "ckpt_final").exists())
            res[algo] = r
            log(f"zoo {reg} ({algo}): {r['ms_per_step']:.2f} ms per step (steps 2-3), peak "
                f"{r['peak_gb']:.3f} GB, final loss {loss:.6g}, ckpt_final written: "
                f"{r['ckpt_final']}, the CLI call {call_s:.1f} s, on {report['card']}")
            check(state.step == ZOO_STEPS and len(step_s) == ZOO_STEPS,
                  f"zoo {algo} did not take {ZOO_STEPS} steps")
            check(all(np.isfinite(v) for rec in recs for v in rec.values()),
                  f"zoo {algo}: non-finite metrics")
            check(r["ckpt_final"] and (out / "ckpt_final_full").exists(),
                  f"zoo {algo}: no ckpt_final")
            check(launched == counts(), f"zoo {algo} launched kernels: {launched}")
            total = {k: total[k] + n for k, n in launched.items()}
            del state
    report["launches_zoo"] = total

    # the other map encoders and the residual-MLP denoiser, one step each
    base = config_from_flags("cld_vae_nusc", str(cfg_file))
    batch = next(iter(make_loader(base, "train", device="cuda")))
    gen = torch.Generator(device="cuda").manual_seed(5)
    vae_model = None
    for label, over in (("vae_resnet50", {"map_encoder_model_arch": "resnet50"}),
                        ("vae_resnet18_spatial_softmax",
                         {"map_encoder_model_arch": "resnet18_spatial_softmax"}),
                        ("dm_mlp_res_network", {"diffuser_model_arch": "MLPResNetwork"})):
        cfg = config_from_flags("cld_vae_nusc", str(cfg_file)).unlock()
        for k, v in over.items():
            cfg.algo[k] = v
        cfg.lock()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launch_counts()
        if label.startswith("vae"):
            trainer = VAETrainer(cfg, device="cuda")
            state = trainer.init_state(0)
            vae_model = state.model
        else:
            trainer = DMTrainer(cfg, vae_model, device="cuda")
            state = trainer.init_state(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = trainer.train_step(state, batch, generator=gen)
        torch.cuda.synchronize()
        r = dict(ms=1e3 * (time.perf_counter() - t0), loss=float(m["loss"]),
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        res[label] = r
        log(f"{label}: one step {r['ms']:.1f} ms (the first, not warmed up), peak "
            f"{r['peak_gb']:.3f} GB, loss {r['loss']:.6g}, on {report['card']}")
        check(np.isfinite(r["loss"]) and state.step == 1, f"{label}: no finite step")
        check(native.launch_counts() == counts(), f"{label} launched kernels")
        del trainer, state
    del vae_model, batch

    res["card_vs_cpu"] = check_zoo_card_vs_cpu()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"zoo phase {res['phase_s']:.1f} s in all, on {report['card']}")
    report["zoo"] = res


# the learned path (step 21): the GAN, the EBM learned metric, scene
# diffusion and the latent attack
LEARNED_RUNS = (("nusc_ebm", "ebm", "ebm"), ("nusc_gan", "gan", "gan"),
                ("nusc_transformer_gan", "gan", "transformer_gan"),
                ("trajdata_nusc_scene_diff", "scene_dm", "scene_dm"))
LEARNED_STEPS = 3  # steps 2 and 3 are timed
EBM_STRIDE = 10  # the rollout CLI's anchor stride (`sim.learned_metrics`)
ATTACK_STEPS = 50
LEARNED_REL_TOL = 1e-4  # card vs CPU: losses (relative), gradients (of their largest entry)


def run_learned_trainers(report, shards, tmp) -> tuple:
    """The EBM, both GANs and scene diffusion through `train.main` at the
    config of record's width, 3 steps each: the EBM and the GANs from step
    19's shards at batch 128, raster 224x224x34, the scene model on 16
    synthetic scenes x 8 agents (the CLI's `batch_size // 8`), horizon 52,
    width 128, 4 layers; ms per step (steps 2-3), peak memory, finite
    metrics, `ckpt_final`, no kernel launch. Returns (results, the
    `ckpt_final` of each run by label)."""
    import numpy as np
    import torch

    from cld_tpu_torch import train
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.training.ebm import EBMTrainer
    from cld_tpu_torch.training.gan import GANTrainer
    from cld_tpu_torch.training.scene_dm import SceneDMTrainer

    cfg_file = tmp / "learned_config.json"
    cfg_file.write_text(json.dumps({
        "train": {"data_path": str(shards), "training": {"batch_size": B, "steps_per_epoch": 1,
                                                         "precision": "fp32"}},
        "env": {"rasterizer": {"raster_size": RASTER}}}))
    trainers = {"ebm": EBMTrainer, "gan": GANTrainer, "scene_dm": SceneDMTrainer}
    res, ckpts = {}, {}
    for reg, mode, label in LEARNED_RUNS:
        step_s = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launch_counts()
        t0 = time.perf_counter()
        with timed_method(trainers[mode], "train_step", step_s):
            state = train.main(["--registered-name", reg, "--mode", mode, "--config",
                                str(cfg_file), "--device", "cuda", "--output",
                                str(tmp / "learned" / label), "--steps", str(LEARNED_STEPS)])
        call_s = time.perf_counter() - t0
        launched = native.launch_counts()
        out = tmp / "learned" / label / mode
        recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
        r = dict(ms_per_step=1e3 * float(np.mean(step_s[1:])),
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9, call_s=call_s,
                 final={k: v for k, v in recs[-1].items() if k != "step"})
        res[label] = r
        log(f"{label} ({reg} --mode {mode}): {r['ms_per_step']:.2f} ms per step (steps 2-3), "
            f"peak {r['peak_gb']:.3f} GB, final {json.dumps(r['final'])}, the CLI call "
            f"{call_s:.1f} s, on {report['card']}")
        check(state.step == LEARNED_STEPS and len(step_s) == LEARNED_STEPS,
              f"{label} did not take {LEARNED_STEPS} steps")
        check(len(recs) == LEARNED_STEPS and all(np.isfinite(v) for rec in recs
                                                 for v in rec.values()),
              f"{label}: non-finite metrics")
        check((out / "ckpt_final").exists(), f"{label}: no ckpt_final")
        check(launched == counts(), f"{label} launched kernels: {launched}")
        report[f"launches_{label}_train"] = launched
        ckpts[label] = out / "ckpt_final"
        del state
    return res, ckpts


def run_ebm_rollout(report, ebm_ckpt) -> dict:
    """The rollout CLI with `--ebm-ckpt` (the EBM just trained) at the
    closed loop's width (4 scenes x 8 agents, raster 224, 100 DDPM steps),
    cut to 20 frames, the flagship rules: the launches of the rules path
    (per replan of each episode 100 `lstm2_fwd`, 99 `lstm2_bwd`, 99
    `bit_gather`, 1 `value_gather`; 1 `bit_gather` for the satisfaction
    report) plus one `value_gather` per anchor of the scored log (frames 0,
    10, ... below its length - 1); finite `ebm_score_mean` /
    `ebm_score_min`."""
    import numpy as np

    from cld_tpu_torch import rollout
    from cld_tpu_torch.ops import native

    out = ROOT / "chiprun_out" / "ebm_rollout"
    score_s = []
    native.reset_launch_counts()
    t0 = time.perf_counter()
    with timed_method(rollout, "ebm_report", score_s):
        rep = rollout.main(["--num-scenes", str(CL_SCENES), "--agents-per-scene", str(CL_AGENTS),
                            "--num-sim-steps", str(RULES_STEPS), "--raster-size", str(RASTER),
                            "--diffusion-steps", str(N_STEPS), "--guidance", "flagship",
                            "--ebm-ckpt", str(ebm_ckpt), "--device", "cuda", "--output",
                            str(out), "--precision", "fp32"])
    wall = time.perf_counter() - t0
    launches = native.launch_counts()
    n = RULES_STEPS // CL_N_STEP
    anchors = len(range(0, max(RULES_STEPS - 1, 1), EBM_STRIDE))
    episode = counts(lstm2_fwd=N_STEPS * n, lstm2_bwd=(N_STEPS - 1) * n,
                     bit_gather=(N_STEPS - 1) * n, value_gather=n)
    want = cli_launches(episode, bit_gather=1, value_gather=anchors)
    r = dict(ebm_score_mean=rep["ebm_score_mean"], ebm_score_min=rep["ebm_score_min"],
             anchors=anchors, score_s=score_s[0], wall_s=wall,
             agent_steps_per_sec=rep["agent_steps_per_sec"])
    log(f"--ebm-ckpt rollout ({CL_SCENES} x {CL_AGENTS} agents, {RULES_STEPS} frames, {n} "
        f"replans, flagship rules): ebm_score_mean {r['ebm_score_mean']:.6g}, ebm_score_min "
        f"{r['ebm_score_min']:.6g} over {anchors} anchors, the scoring {r['score_s']:.3f} s, "
        f"{wall:.1f} s the call, on {report['card']}; launches {launches}")
    check(rep["launches"] == episode, f"--ebm-ckpt rollout episode launches {rep['launches']}, "
          f"expected {episode}")
    check(launches == want, f"--ebm-ckpt rollout launches {launches}, expected {want}")
    check(np.isfinite(r["ebm_score_mean"]) and np.isfinite(r["ebm_score_min"]),
          "the learned metric is not finite")
    with np.load(out / "trajectories.npz") as f:
        check(f["trajectories"].shape == (RULES_STEPS, CL_B, 4) and
              bool(np.isfinite(f["trajectories"]).all()), "the --ebm-ckpt log is not finite")
    report["launches_ebm_rollout"] = launches
    return r


def run_scene_policy(report, scene_ckpt) -> dict:
    """`sim.env.simulate` with `scene_dm_policy` of the scene model just
    trained: 4 scenes x 8 agents, world maps 512x512x3, raster 224, 20
    frames (4 replans), 100 diffusion steps a replan; after a warm-up
    episode, counts zeroed and the timed episode: one `value_gather` a
    replan and nothing else; a finite log."""
    import torch

    from cld_tpu_torch.ops import native
    from cld_tpu_torch.policies.scene_policy import scene_dm_policy
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.metrics import summarize_metrics
    from cld_tpu_torch.sim.scene import synthetic_scene_pack
    from cld_tpu_torch.training.checkpoints import restore_pytree
    from cld_tpu_torch.training.scene_dm import SceneDMTrainer

    cfg = fp32_config("trajdata_nusc_scene_diff")
    trainer = SceneDMTrainer(cfg, device="cuda")
    state = trainer.init_state(0)
    state.model.load_state_dict(restore_pytree(str(scene_ckpt), device="cuda")["params"],
                                strict=True)
    pack = synthetic_scene_pack(seed=0, num_scenes=CL_SCENES, agents_per_scene=CL_AGENTS,
                                world_map_size=WORLD_MAP, sim_steps=RULES_STEPS, device="cuda")
    sim_cfg = env.SimConfig(num_simulation_steps=RULES_STEPS, n_step_action=CL_N_STEP,
                            raster_size=RASTER, hist_frames=cfg.algo.history_num_frames)
    policy = scene_dm_policy(trainer, state, CL_SCENES, CL_AGENTS,
                             horizon=cfg.algo.future_num_frames)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    env.simulate(pack, policy, sim_cfg, generator=gen)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    native.reset_launch_counts()
    t0 = time.perf_counter()
    st, traj = env.simulate(pack, policy, sim_cfg, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = native.launch_counts()
    n = sim_cfg.num_replans
    metrics = summarize_metrics(pack, st, sim_cfg)
    r = dict(s_per_replan=wall / n, first_episode_s=first_s,
             agent_steps_per_sec=CL_B * RULES_STEPS / wall,
             offroad_rate=metrics["offroad_rate"], collision_rate=metrics["collision_rate"])
    log(f"scene policy ({CL_SCENES} x {CL_AGENTS} agents, {RULES_STEPS} frames, {n} replans of "
        f"{cfg.algo.n_diffusion_steps} steps): {r['s_per_replan']:.3f} s per replan, "
        f"{r['agent_steps_per_sec']:.2f} agent-steps/s ({first_s:.2f} s the first episode), "
        f"offroad {r['offroad_rate']:.3f}, collision {r['collision_rate']:.3f}, on "
        f"{report['card']}; launches {launched}")
    check(launched == counts(value_gather=n),
          f"scene policy launches {launched}, expected {counts(value_gather=n)}")
    check(traj.shape == (RULES_STEPS, CL_B, 4) and bool(torch.isfinite(traj).all()),
          "the scene policy's log is not finite")
    report["launches_scene_policy"] = launched
    return r


def attack_problem(models, Bn, raster, dev):
    """The latent attack's decode and objective at Bn agents (scenes of 4)
    through the frozen VAE decoder (`decode_actions`, the kernel-backed core)
    and the unicycle: cond from the context encoder on a synthetic batch;
    world poses where each scene's victim (agent 1) crosses its attacker's
    (agent 0) path 25 m ahead; the objective is the rule library's
    `CollisionAttackLoss` of each scene's pair, summed."""
    import math

    import torch

    from cld_tpu_torch.data.batch import get_current_states
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.guidance.losses import CollisionAttackLoss, GuidanceContext
    from cld_tpu_torch.models.vae import convert_action_to_state_and_action, decode_actions
    from cld_tpu_torch.ops.geometry import world_from_agent_matrix
    from cld_tpu_torch.ops.normalization import TrajNormalizer

    batch = synthetic_batch(seed=4, batch_size=Bn, raster_size=raster, device="cpu")
    batch = to_device(batch, dev)
    with torch.no_grad():
        cond = models.context(batch)["cond_feat"]
    curr = get_current_states(batch)
    role = [(0.0, 0.0, 0.0), (25.0, -15.0, math.pi / 2), (0.0, 20.0, 0.0), (0.0, 40.0, 0.0)]
    poses = torch.tensor([(x, y + 60.0 * (i // 4), yaw) for i in range(Bn)
                          for x, y, yaw in [role[i % 4]]], dtype=torch.float32, device=dev)
    ctx = GuidanceContext(None, None, None, None,
                          world_from_agent=world_from_agent_matrix(poses[:, :2], poses[:, 2]),
                          scene_index=torch.arange(Bn, device=dev) // 4)
    attacks = [CollisionAttackLoss(s, s + 1) for s in range(0, Bn, 4)]

    def decode(z):
        return convert_action_to_state_and_action(decode_actions(models.decoder, z, cond), curr,
                                                  models.dyn, TrajNormalizer(),
                                                  descaled_output=True)

    def objective(traj):
        return sum(torch.sum(a(traj[:, None], ctx)) for a in attacks)

    return decode, objective


def run_latent_attack(report) -> dict:
    """`latent_attack` at full width: B=128, latent [52, 4], the frozen
    H=64 decoder and the unicycle, 50 Adam steps on the collision-attack
    objective: one `lstm2_fwd` and one `lstm2_bwd` per step and one
    `lstm2_fwd` for the objective at the optimum; the objective goes
    down."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.algos.latent_attack import latent_attack
    from cld_tpu_torch.ops import native

    dev = torch.device("cuda", 0)
    decode, objective = attack_problem(pipeline.build_models(seed=0, device=dev, precision="fp32"),
                                       B, RASTER, dev)
    g = torch.Generator(device="cpu").manual_seed(6)
    z0 = (0.1 * torch.randn((B, T, L), generator=g)).to(dev)
    with torch.no_grad():
        obj0 = float(objective(decode(z0)))
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, info = latent_attack(decode, objective, z0, prior_weight=0.1, lr=0.1, steps=ATTACK_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = native.launch_counts()
    r = dict(objective_start=obj0, objective=float(info["objective"]),
             prior_penalty=float(info["prior_penalty"]), wall_s=wall,
             ms_per_step=1e3 * wall / ATTACK_STEPS)
    log(f"latent attack (B={B}, z [{T}, {L}], H={H}, {ATTACK_STEPS} Adam steps): objective "
        f"{obj0:.6g} -> {r['objective']:.6g}, prior penalty {r['prior_penalty']:.6g}, "
        f"{r['ms_per_step']:.2f} ms per step, on {report['card']}; launches {launched}")
    want = counts(lstm2_fwd=ATTACK_STEPS + 1, lstm2_bwd=ATTACK_STEPS)
    check(launched == want, f"latent attack launches {launched}, expected {want}")
    check(bool(torch.isfinite(z).all()) and r["objective"] < obj0,
          "the latent attack did not lower its objective")
    report["launches_latent_attack"] = launched
    return r


def _grad_err(cpu_grads: dict, dev_grads: dict) -> tuple:
    """(worst |card - cpu| of a gradient over its largest |cpu| entry (over
    the model's largest for `ZERO_IN_EXACT`), the parameter it is of)."""
    scale = max(float(g.abs().max()) for g in cpu_grads.values())
    worst = (-1.0, "")
    for k, ref in cpu_grads.items():
        denom = scale if k.endswith(ZERO_IN_EXACT) else max(float(ref.abs().max()), 1e-30)
        worst = max(worst, (float((dev_grads[k].cpu() - ref).abs().max()) / denom, k))
    return worst


def check_learned_card_vs_cpu() -> dict:
    """The learned path's functions on the card and on the CPU from the same
    weights and explicit draws, at the `cld_smoke` widths (B=4, raster 64):
    the EBM's InfoNCE loss and gradients, each GAN update's loss and
    gradients (both generators; the other side frozen as the trainer does),
    the scene model's loss and gradients (2 scenes x 8 agents) and 10 steps
    of `scene_sample`, `ebm_rollout_scores` on a log of a pack whose maps
    are multiples of 1/255 (the card's banded warp and the CPU's exact one
    agree there), and one attack step's gradient through the full-width
    decoder (the card's LSTM kernels against the CPU's plain sweep). Losses
    within 1e-4 relative, gradients within 1e-4 of their largest entry,
    sampled trajectories and scores within 1e-4 relative plus 1e-5 of
    their largest. Eval mode throughout (train-mode BatchNorm on 4 samples
    is ill-conditioned in float32)."""
    import copy

    import numpy as np
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.algos.scene_dm import scene_dm_loss, scene_sample
    from cld_tpu_torch.data.scene_batch import synthetic_scene_batch
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.models.learned_metric import ebm_infonce_loss
    from cld_tpu_torch.ops.diffusion import make_schedule
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.learned_metrics import ebm_rollout_scores
    from cld_tpu_torch.sim.scene import synthetic_scene_pack
    from cld_tpu_torch.training import gan
    from cld_tpu_torch.training.ebm import EBMTrainer
    from cld_tpu_torch.training.scene_dm import SceneDMTrainer, scene_gt_trajectories

    dev = torch.device("cuda", 0)
    cfg = fp32_config("cld_smoke")
    hist = cfg.algo.history_num_frames
    b_cpu = synthetic_batch(seed=2, batch_size=4, raster_size=64, hist_frames=hist, device="cpu")
    # a dense Gaussian raster, as the CPU parity tests take: on the mostly-zero
    # synthetic raster a fresh encoder gives every sample nearly the same map
    # feature, the InfoNCE gradient is a difference of near-equal terms, and
    # the port's own float32 gradients lie up to 7e-5 from float64 on the CPU
    image = np.random.default_rng(5).normal(size=tuple(b_cpu.image.shape)).astype(np.float32)
    b_cpu = b_cpu._replace(image=torch.from_numpy(image))
    b_dev = to_device(b_cpu, dev)
    res = {}

    def pair(build, seed):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            m = build()
        return m, copy.deepcopy(m).to(dev)

    def held(label, losses, grads):
        (lc, ld), (gc, gd) = losses, grads
        loss_err = abs(ld - lc) / abs(lc)
        grad_err, key = _grad_err(gc, gd)
        res[label] = dict(loss=lc, loss_rel_err=loss_err, grad_err=grad_err, worst=key)
        log(f"card vs CPU {label}: loss {lc:.6g}, relative error {loss_err:.2e}; worst gradient "
            f"error {grad_err:.2e} of its largest entry ({key}; tolerance {LEARNED_REL_TOL})")
        check(loss_err <= LEARNED_REL_TOL and grad_err <= LEARNED_REL_TOL,
              f"{label}: card and CPU disagree (loss {loss_err:.2e}, gradients {grad_err:.2e})")

    def grads_of(loss, params):
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    # the EBM, its score head scaled so that the scores spread over O(1), as a
    # trained metric's do: at a fresh head's spread of ~1e-2 the InfoNCE
    # gradient is second order in the spread, and its float32 error alone
    # reaches 2e-5 of the largest entry on the CPU (1.8e-6 with the scaled head)
    def spread_ebm():
        m = EBMTrainer(cfg, device="cpu").build()
        with torch.no_grad():
            m.score_net.weight.mul_(30.0)
        return m

    ebm_c, ebm_d = pair(spread_ebm, 0)
    out = []
    for m, b in ((ebm_c, b_cpu), (ebm_d, b_dev)):
        loss = ebm_infonce_loss(m(b)["scores"])
        out.append((loss.item(), grads_of(loss, dict(m.named_parameters()))))
    held("ebm", (out[0][0], out[1][0]), (out[0][1], out[1][1]))

    # each GAN update, both generators
    z = torch.randn((4, 16), generator=torch.Generator().manual_seed(3))
    for arch in ("mlp", "transformer"):
        gcfg = fp32_config("cld_smoke").unlock()
        gcfg.algo.gan_generator_arch = arch
        trainer = gan.GANTrainer(gcfg.lock(), device="cpu")
        gan_c, gan_d = pair(trainer.build, 1)
        for side, name in ((1, "d_loss"), (0, "g_loss")):
            out = []
            for m, b, zz in ((gan_c, b_cpu, z), (gan_d, b_dev, z.to(dev))):
                params = gan.split_params(m)[side]
                named = {k: p for k, p in m.named_parameters() if any(p is q for q in params)}
                loss = m(b, zz)[name]
                out.append((loss.item(), grads_of(loss, named)))
            held(f"gan_{arch}_{name}", (out[0][0], out[1][0]), (out[0][1], out[1][1]))

    # the scene model: loss and gradients, then 10 sampler steps
    strainer = SceneDMTrainer(cfg, device="cpu")
    sdm_c, sdm_d = pair(strainer.build, 2)
    sb = {w: synthetic_scene_batch(seed=0, batch_size=2, num_agents=8, hist_frames=hist,
                                   horizon=cfg.algo.future_num_frames, device=w)
          for w in ("cpu", dev)}
    shape = (2, 8, cfg.algo.future_num_frames, 6)
    g = torch.Generator().manual_seed(4)
    tt, eps = torch.randint(0, 5, (2,), generator=g), torch.randn(shape, generator=g)
    x_init, step_noises = torch.randn(shape, generator=g), torch.randn((10, *shape), generator=g)
    out, samples = [], []
    for m, w in ((sdm_c, "cpu"), (sdm_d, dev)):
        b = sb[w]
        loss = scene_dm_loss(m.denoise, make_schedule(5, device=w), scene_gt_trajectories(b),
                             m.encode_cond(b), b.agent_mask, tt.to(w), eps.to(w))
        out.append((loss.item(), grads_of(loss, dict(m.named_parameters()))))
        with torch.no_grad():
            samples.append(scene_sample(m.denoise, make_schedule(10, device=w), m.encode_cond(b),
                                        b.agent_mask, x_init.to(w), step_noises.to(w))
                           ["pred_traj"].cpu())
    held("scene_dm", (out[0][0], out[1][0]), (out[0][1], out[1][1]))
    err = float((samples[1] - samples[0]).abs().max())
    tol = LEARNED_REL_TOL * samples[0].abs() + 1e-5 * float(samples[0].abs().max())
    res["scene_sample"] = err
    log(f"card vs CPU scene_sample (10 steps): max abs diff {err:.3e}")
    check(bool(((samples[1] - samples[0]).abs() <= tol).all()),
          "scene_sample disagrees between card and CPU")

    # the learned metric on a k/255 log
    sim_cfg = env.SimConfig(num_simulation_steps=20, n_step_action=5, raster_size=64,
                            hist_frames=hist)

    def turning(obs, rng):
        u = torch.zeros((obs.curr_speed.shape[0], T, 2), device=obs.curr_speed.device)
        u[..., 0], u[..., 1] = 1.0, 0.3
        return u

    scores = []
    for m, w in ((ebm_c, "cpu"), (ebm_d, dev)):
        pack = synthetic_scene_pack(seed=3, num_scenes=2, agents_per_scene=3, world_map_size=256,
                                    sim_steps=20, device=w)
        pack = pack._replace(world_map=torch.round(pack.world_map * 255.0) * (1.0 / 255.0))
        if w == "cpu":
            log_cpu = env.simulate(pack, turning, sim_cfg)[1]
        with torch.no_grad():
            scores.append(ebm_rollout_scores(pack, log_cpu.to(w), m.get_scores, sim_cfg,
                                             horizon=8, stride=5).cpu())
    err = float((scores[1] - scores[0]).abs().max())
    tol = LEARNED_REL_TOL * scores[0].abs() + 1e-5 * float(scores[0].abs().max())
    res["ebm_rollout_scores"] = err
    log(f"card vs CPU ebm_rollout_scores ({tuple(scores[0].shape)} anchors x agents): max abs "
        f"diff {err:.3e}")
    check(bool(((scores[1] - scores[0]).abs() <= tol).all()),
          "ebm_rollout_scores disagree between card and CPU")

    # one attack step's gradient through the full-width decoder, B=8
    zc = 0.1 * torch.randn((8, T, L), generator=torch.Generator().manual_seed(5))
    out = []
    for w in ("cpu", dev):
        decode, objective = attack_problem(
            pipeline.build_models(seed=0, device=w, precision="fp32"), 8, 64, w)
        zr = zc.to(w).requires_grad_(True)
        total = objective(decode(zr)) + 0.1 * torch.mean(
            0.5 * torch.sum(zr.reshape(8, -1) ** 2, dim=-1))
        out.append((total.item(), {"z": torch.autograd.grad(total, zr)[0]}))
    held("latent_attack_step", (out[0][0], out[1][0]), (out[0][1], out[1][1]))
    return res


def run_learned_path(report, shards, tmp) -> None:
    """Step 21 of the module's docstring: the GAN, EBM and scene-diffusion
    trainers, the rollout CLI's `--ebm-ckpt`, the scene policy, the latent
    attack, and the card-vs-CPU checks."""
    t_phase = time.perf_counter()
    res, ckpts = run_learned_trainers(report, shards, tmp)
    res["ebm_rollout"] = run_ebm_rollout(report, ckpts["ebm"])
    res["scene_policy"] = run_scene_policy(report, ckpts["scene_dm"])
    res["latent_attack"] = run_latent_attack(report)
    res["card_vs_cpu"] = check_learned_card_vs_cpu()
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"learned path phase {res['phase_s']:.1f} s in all, on {report['card']}")
    report["learned"] = res


# the composer path (step 22): the 24 policy composers through the rollout CLI
COMPOSER_STEPS = 20  # frames: 4 replans
# the composers that render a sample observation when they are built (one
# `value_gather` each): the model-based ones, as the JAX composers do
COMPOSER_BUILD_RENDERS = ("BC", "TrafficSim", "TrafficSimplan", "TPP", "TPPplan", "GAN",
                          "GANplan", "HierAgentAwareCVAE", "STRIVE", "Diffuser", "DSPolicy")
# the ground truth has no controls: the simulator refuses it, as the JAX one does
COMPOSERS_WITHOUT_CONTROLS = ("GroundTruth", "GroundTruthNaN")
# one of each model-based family, held card vs CPU
COMPOSER_FAMILIES = ("BC", "TrafficSimplan", "TPPplan", "GANplan", "Diffuser", "DSPolicy",
                     "SceneDiffuser")
DP_F64_TOL = 1e-9  # float64 gradients through the collectives, of each tensor's largest entry
COMPOSER_REL_TOL = 1e-4  # card vs CPU, of each field's largest entry (the zoo's tolerance)


def composer_argv(name, out, *extra):
    return ["--composer", name, "--num-scenes", str(CL_SCENES), "--agents-per-scene",
            str(CL_AGENTS), "--num-sim-steps", str(COMPOSER_STEPS), "--raster-size", str(RASTER),
            "--device", "cuda", "--output", str(out), "--precision", "fp32", *extra]


def run_composers(report) -> dict:
    """Each of the 24 composers through `rollout.main` at the closed loop's
    width (4 scenes x 8 agents, raster 224, the config of record: ResNet-18,
    `cond_feat` 256, horizon 52, 100 diffusion steps), 20 frames: s per
    replan of the timed episode, a finite log, and the launches exactly: the
    timed episode one `value_gather` a replan and nothing else; the whole
    call that twice, plus one for the sample observation of a model-based
    composer. The ground truth's actions have no controls: the CLI raises
    `TypeError` at the first replan (one `value_gather`), as the JAX CLI
    does."""
    import numpy as np

    from cld_tpu_torch import rollout
    from cld_tpu_torch.eval.composers import COMPOSER_REGISTRY
    from cld_tpu_torch.ops import native

    out = ROOT / "chiprun_out" / "composers"
    n = COMPOSER_STEPS // CL_N_STEP
    res = {}
    check(len(COMPOSER_REGISTRY) == 24, f"{len(COMPOSER_REGISTRY)} composers registered")
    for name in sorted(COMPOSER_REGISTRY):
        native.reset_launch_counts()
        t0 = time.perf_counter()
        if name in COMPOSERS_WITHOUT_CONTROLS:
            try:
                rollout.main(composer_argv(name, out / name))
                raised = None
            except TypeError as e:
                raised = str(e)
            launches = native.launch_counts()
            check(raised is not None and "no controls" in raised,
                  f"--composer {name}: the simulator took actions without controls")
            check(launches == counts(value_gather=1), f"--composer {name} launches {launches}")
            res[name] = dict(refused=raised, call_s=time.perf_counter() - t0)
            report[f"launches_composer_{name}"] = launches
            log(f"--composer {name}: refused at the first replan as the JAX CLI does "
                f"({raised[:60]}...); launches {launches}")
            continue
        rep = rollout.main(composer_argv(name, out / name))
        call_s = time.perf_counter() - t0
        launches = native.launch_counts()
        builds = int(name in COMPOSER_BUILD_RENDERS)
        check(rep["launches"] == counts(value_gather=n),
              f"--composer {name} episode launches {rep['launches']}")
        check(launches == counts(value_gather=2 * n + builds),
              f"--composer {name} launches {launches}, expected {2 * n + builds} value_gather")
        with np.load(out / name / "trajectories.npz") as f:
            check(f["trajectories"].shape == (COMPOSER_STEPS, CL_B, 4) and
                  bool(np.isfinite(f["trajectories"]).all()),
                  f"--composer {name}'s trajectory log is not finite")
        r = dict(s_per_replan=rep["wall_clock_s"] / n, first_episode_s=rep["compile_and_first_run_s"],
                 call_s=call_s, offroad_rate=rep["offroad_rate"],
                 collision_rate=rep["collision_rate"])
        res[name] = r
        report[f"launches_composer_{name}"] = launches
        log(f"--composer {name}: {r['s_per_replan']:.4f} s per replan ({CL_B} agents, timed "
            f"episode; the first {r['first_episode_s']:.2f} s), the call {call_s:.1f} s, offroad "
            f"{r['offroad_rate']:.3f}, collision {r['collision_rate']:.3f}, on {report['card']}")
    return res


def run_composer_ckpt(report, bc_ckpt) -> dict:
    """`--composer BC --composer-ckpt` on the zoo path's `nusc_bc`
    `ckpt_final` (the `bc` algo's `BCPlanner`, the composer's module), at
    the same width with `--registered-name nusc_bc`: it loads strictly, and
    the log differs from the fresh weights' of the same seed."""
    import numpy as np

    from cld_tpu_torch import rollout
    from cld_tpu_torch.ops import native

    out = ROOT / "chiprun_out" / "composer_ckpt"
    logs = {}
    for label, extra in (("fresh", []), ("ckpt", ["--composer-ckpt", str(bc_ckpt)])):
        native.reset_launch_counts()
        rep = rollout.main(composer_argv("BC", out / label, "--registered-name", "nusc_bc",
                                         *extra))
        if label == "ckpt":
            launches = native.launch_counts()
        with np.load(out / label / "trajectories.npz") as f:
            logs[label] = f["trajectories"]
    n = COMPOSER_STEPS // CL_N_STEP
    check(launches == counts(value_gather=2 * n + 1), f"--composer-ckpt launches {launches}")
    check(bool(np.isfinite(logs["ckpt"]).all()), "the --composer-ckpt log is not finite")
    diff = float(np.abs(logs["ckpt"] - logs["fresh"]).max())
    check(diff > 1e-3, f"--composer-ckpt gives the fresh weights' log (max |diff| {diff:.2e})")
    report["launches_composer_ckpt"] = launches
    log(f"--composer BC --composer-ckpt (the zoo's nusc_bc ckpt_final): loaded strictly, its "
        f"log {diff:.3f} m from the fresh weights' at most; s per replan "
        f"{rep['wall_clock_s'] / n:.4f}; launches {launches}")
    return dict(max_log_diff_m=diff, s_per_replan=rep["wall_clock_s"] / n)


def check_composers_card_vs_cpu() -> dict:
    """One replan of each model-based family on the card and on the CPU at
    the `cld_smoke` widths (1 scene x 2 agents, raster 64): the same weights
    (built on the CPU from one seed), the same observation (rendered on the
    CPU) and the same draws; each action field within `COMPOSER_REL_TOL` of
    its largest entry, the '*plan' composers' selection equal."""
    import torch

    from cld_tpu_torch.eval import composers
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.scene import synthetic_scene_pack

    cfg = fp32_config("cld_smoke")
    algo = cfg.algo
    sim_cfg = env.SimConfig(num_simulation_steps=COMPOSER_STEPS, n_step_action=CL_N_STEP,
                            raster_size=64, hist_frames=algo.history_num_frames)
    packs = {d: synthetic_scene_pack(seed=0, num_scenes=1, agents_per_scene=2,
                                     sim_steps=COMPOSER_STEPS, device=d) for d in ("cpu", "cuda")}
    obs_c = env.render_observation(packs["cpu"], env.init_sim_state(packs["cpu"], sim_cfg),
                                   sim_cfg)
    obs = {"cpu": obs_c, "cuda": to_device(obs_c, torch.device("cuda", 0))}
    g = torch.Generator().manual_seed(4)
    n, T = algo.n_diffusion_steps, algo.horizon
    draws = {"TrafficSimplan": torch.randn((2 * 4, 16), generator=g),
             "GANplan": torch.randn((2 * 4, 16), generator=g),
             "Diffuser": (torch.randn((2, T, 2), generator=g),
                          torch.randn((n, 2, T, 2), generator=g)),
             "SceneDiffuser": (torch.randn((1, 2, algo.future_num_frames, 6), generator=g),
                               torch.randn((n, 1, 2, algo.future_num_frames, 6), generator=g))}
    draws["DSPolicy"] = draws["Diffuser"]
    select = composers.select_sample
    picks = []
    composers.select_sample = lambda *a: picks.append(select(*a).cpu()) or picks[-1].to(a[0].device)
    worst = {}
    try:
        for name in COMPOSER_FAMILIES:
            acts = {}
            for d in ("cpu", "cuda"):
                policy = composers.get_composer(name)(
                    cfg, packs[d], sim_cfg, generator=torch.Generator().manual_seed(0), device=d)
                dr = draws.get(name)
                dr = (None if dr is None else dr.to(d) if torch.is_tensor(dr)
                      else tuple(x.to(d) for x in dr))
                acts[d] = policy(obs[d], dr if dr is not None else torch.Generator(d))
            err = 0.0
            for field in ("positions", "yaws", "controls"):
                want = getattr(acts["cpu"], field)
                got = getattr(acts["cuda"], field).cpu()
                err = max(err, float((got - want).abs().max()) / max(float(want.abs().max()),
                                                                       1e-30))
            same_pick = None
            if name.endswith("plan"):
                same_pick = bool(torch.equal(picks[-2], picks[-1]))
                check(same_pick, f"{name}: the card picks samples {picks[-1].tolist()}, the CPU "
                      f"{picks[-2].tolist()}")
            worst[name] = {"rel_err": err, "same_selection": same_pick}
            log(f"composer {name} card vs CPU: actions within {err:.2e} of their largest entry "
                f"(tolerance {COMPOSER_REL_TOL})" + ("" if same_pick is None else
                                                     ", the same samples selected"))
            check(err <= COMPOSER_REL_TOL, f"composer {name}: card and CPU disagree ({err:.2e})")
    finally:
        composers.select_sample = select
    return worst


def run_composer_trace(report) -> dict:
    """One composer replan (BC at the closed loop's width) under
    `utils.timer.device_trace`: the Chrome trace names the `value_gather`
    kernel of the replan's render."""
    import torch

    from cld_tpu_torch.eval.composers import get_composer
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.scene import synthetic_scene_pack
    from cld_tpu_torch.utils.timer import device_trace

    cfg = fp32_config("cld_dm_nusc")
    pack = synthetic_scene_pack(seed=0, num_scenes=CL_SCENES, agents_per_scene=CL_AGENTS,
                                world_map_size=WORLD_MAP, sim_steps=COMPOSER_STEPS, device="cuda")
    sim_cfg = env.SimConfig(num_simulation_steps=COMPOSER_STEPS, n_step_action=CL_N_STEP,
                            raster_size=RASTER, hist_frames=cfg.algo.history_num_frames)
    policy = get_composer("BC")(cfg, pack, sim_cfg, device="cuda")
    state = env.init_sim_state(pack, sim_cfg)
    policy(env.render_observation(pack, state, sim_cfg), None)  # warm
    torch.cuda.synchronize()
    native.reset_launch_counts()
    t0 = time.perf_counter()
    with device_trace(str(ROOT / "chiprun_out" / "composer_trace"), device="cuda") as prof:
        act = policy(env.render_observation(pack, state, sim_cfg), None)
    traced_s = time.perf_counter() - t0
    launches = native.launch_counts()
    trace = Path(prof.trace_path).read_text()
    cuda_ms = sum(e.device_time_total for e in prof.key_averages()) / 1e3
    check(launches == counts(value_gather=1), f"traced replan launches {launches}")
    check("value_gather_kernel" in trace, "the trace does not name the value_gather kernel")
    check(bool(torch.isfinite(act.controls).all()), "the traced replan's plan is not finite")
    report["launches_composer_trace"] = launches
    log(f"traced BC replan: {traced_s:.3f} s under the profiler, device time {cuda_ms:.3f} ms, "
        f"trace {Path(prof.trace_path).stat().st_size / 1e6:.2f} MB naming value_gather_kernel")
    return dict(traced_s=traced_s, device_ms=cuda_ms)


def check_data_parallel_world_one(dev) -> dict:
    """Data parallelism on one card: a NCCL process group of world size 1
    from a localhost TCP store. `make_mesh` gives world size 1 there, and 2
    VAE steps through the train CLI's wrapping (`replicate`, `state.mesh`)
    equal the plain steps bit for bit (within 1e-6 relative asked); then the
    collectives themselves on NCCL (a mesh forced active: `GlobalBatchNorm2d`
    and the gradient all-reduce) give one float64 step's gradients within
    1e-9 of each tensor's largest entry, and PPO's (the buffer's all-gather,
    the minibatches' broadcast, `ratio_max`'s all-reduce) a collection and
    an update phase within 1e-6 of the plain ones. Full width: batch 128, raster 224, a
    dense Gaussian raster, cuDNN in its deterministic mode."""
    import socket

    import torch
    import torch.distributed as dist

    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.parallel import mesh as pm
    from cld_tpu_torch.training.vae import VAETrainer

    cfg = record_config()
    batch = synthetic_batch(seed=4, batch_size=B, raster_size=RASTER, device=dev)
    # a dense raster: train-mode BatchNorm over the mostly-zero synthetic one is ill-conditioned
    batch = batch._replace(image=torch.randn(batch.image.shape, device=dev,
                                             generator=torch.Generator(device=dev).manual_seed(8)))
    gen = lambda: torch.Generator(device=dev).manual_seed(9)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    # cuDNN's default convolution backward adds in no fixed order: two plain runs differ in
    # the last bits, which Adam's first steps amplify
    cudnn = torch.backends.cudnn
    was = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        mesh = pm.make_mesh(device=dev)
        check((mesh.world_size, mesh.active) == (1, False), f"world-1 mesh {mesh}")

        def run(m, steps, grads=None, dtype=torch.float32):
            trainer = VAETrainer(cfg, device=dev)
            state = trainer.init_state(0)
            state.model.to(dtype)
            b = batch._replace(**{k: v.to(dtype) for k, v in batch._asdict().items()
                                  if torch.is_tensor(v) and v.is_floating_point()})
            if m is not None:
                pm.replicate(state.model, m)
                state.mesh = m
            if grads is not None:
                step = state.optimizer.step

                def recorded(*a, **k):
                    grads.update({n: p.grad.clone() for n, p in state.model.named_parameters()})
                    return step(*a, **k)

                state.optimizer.step = recorded
            g = gen()
            for _ in range(steps):
                trainer.train_step(state, b, generator=g)
            return {k: v.clone() for k, v in state.model.state_dict().items()}

        native.reset_launch_counts()
        plain = run(None, 2)
        plain_launches = native.launch_counts()
        native.reset_launch_counts()
        wrapped = run(mesh, 2)
        check(native.launch_counts() == plain_launches, "the wrapped steps launch otherwise")
        param_err = max(float((wrapped[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                        for k, v in plain.items() if v.is_floating_point())
        check(param_err <= 1e-6, f"world-1 data-parallel steps differ: {param_err:.2e}")

        class Forced(pm.Mesh):
            active = True  # the collectives run at world size 1

        # float64: in float32 train-mode BatchNorm's backward puts two forms of one step's
        # gradients up to ~2e-2 of a tensor's largest entry apart (as far as float32 is
        # from float64 there, on the CPU too)
        g_plain, g_nccl = {}, {}
        run(None, 1, g_plain, torch.float64)
        run(Forced(0, 1, dev), 1, g_nccl, torch.float64)
        grad_err = max(float((g_nccl[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                       for k, v in g_plain.items())
        check(grad_err <= DP_F64_TOL, f"NCCL data-parallel gradients differ: {grad_err:.2e}")

        def ppo_run(m):
            """One PPO collection into the global buffer and a 2-iteration
            update phase on minibatches that rank 0 draws: the buffer, the
            denoiser after the phase and the phase's metrics."""
            from cld_tpu_torch.training.dm import DMTrainer
            from cld_tpu_torch.training.ppo import PPOTrainer, buffer_init

            dm = DMTrainer(cfg, VAETrainer(cfg, device=dev).init_state(0).model, device=dev)
            state = dm.init_state(2)
            state.lr_schedule = lambda step: 1e-4  # the record's first epoch has rate 0
            if m is not None:
                pm.replicate(state.model, m)
                state.mesh = m
            ppo = PPOTrainer(cfg, dm)
            ppo.ppo_epochs, ppo.update_times = 1, 2
            a = cfg.algo
            buf = buffer_init(a.buffer_max, a.horizon, a.vae.latent_size, a.cond_feat_dim,
                              device=dev)
            g = gen()
            ppo.collect_step(state, buf, batch, generator=g)
            _, metrics = ppo.ppo_update(state, buf, generator=g)
            out = {f"buf.{k}": getattr(buf, k) for k in ("x0", "x1", "log_p", "reward",
                                                          "cond_feat", "baseline")}
            out.update({f"metric.{k}": v for k, v in metrics.items()})
            return {**out, **state.model.state_dict()}

        ppo_plain, ppo_nccl = ppo_run(None), ppo_run(Forced(0, 1, dev))
        ppo_err = max(float((ppo_nccl[k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                      for k, v in ppo_plain.items() if v.is_floating_point())
        check(ppo_err <= 1e-6, f"NCCL data-parallel PPO differs: {ppo_err:.2e}")
    finally:
        cudnn.deterministic, cudnn.benchmark = was
        dist.destroy_process_group()
    log(f"data parallelism, NCCL world 1 (localhost store): 2 VAE steps at B={B}, raster "
        f"{RASTER} through the wrapping within {param_err:.2e} (relative) of the plain ones; the "
        f"collectives forced on: one float64 step's gradients within {grad_err:.2e} of their "
        f"largest entry, a PPO collection and 2-iteration update within {ppo_err:.2e}")
    return dict(param_rel_err=param_err, nccl_grad_err=grad_err, nccl_ppo_err=ppo_err)


def run_composer_path(report, tmp) -> None:
    """Step 22 of the module's docstring: the 24 composers through the
    rollout CLI, `--composer-ckpt` on the zoo's `nusc_bc` checkpoint, card
    vs CPU per family, a traced replan, and data parallelism at world size
    1 on NCCL."""
    import torch

    t_phase = time.perf_counter()
    res = {"composers": run_composers(report)}
    res["composer_ckpt"] = run_composer_ckpt(report,
                                             tmp / "zoo_runs" / "zoo_bc" / "ckpt_final")
    res["card_vs_cpu"] = check_composers_card_vs_cpu()
    res["trace"] = run_composer_trace(report)
    res["data_parallel"] = check_data_parallel_world_one(torch.device("cuda", 0))
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"composer path phase {res['phase_s']:.1f} s in all, on {report['card']}")
    report["composer_path"] = res


def max_param_change(before, module) -> float:
    """Largest absolute change of a module's parameters since `before`."""
    return max(float((p.detach() - b).abs().max()) for p, b in zip(module.parameters(), before))


def snapshot(module):
    return [p.detach().clone() for p in module.parameters()]


def scene_pair_mask(Bn, agents_per_scene, dev):
    """[Bn, Bn] bool: pairs of different agents of one scene."""
    import torch

    scene = torch.arange(Bn, device=dev) // agents_per_scene
    return (scene[:, None] == scene[None, :]) & ~torch.eye(Bn, dtype=torch.bool, device=dev)


# P, G and B at which `offroad_count` is held, every combination: one point,
# a warp's 32 lanes, 64 and a pass of 128 (4 points a lane) and one point
# either side, the reward's 52, two passes; the reward's one group and the
# samples' several; one map, the reward's 128 and one past a block of 4 warps
OFFROAD_EDGES = dict(P=(1, 31, 32, 33, 52, 64, 65, 127, 128, 129, 200), G=(1, 3, 5),
                     B=(1, 128, 129))


def check_offroad_edges(g, dev) -> dict:
    """`offroad_count` at every combination of `OFFROAD_EDGES` on 224 x 224
    f32 maps (a fifth of them exact zeros, which count as off-road), with
    coordinates up to 8 pixels outside the map (clamped): equal to its plain
    version (tolerance 0) and to a second launch bit for bit."""
    import torch

    from cld_tpu_torch.ops import reward_kernels as rk

    R, held = RASTER, {}
    maps = torch.rand((max(OFFROAD_EDGES["B"]), R, R), generator=g) - 0.4
    maps = torch.where(maps > 0.4, torch.zeros(()), maps).to(dev)
    for Bn in OFFROAD_EDGES["B"]:
        m = maps[:Bn].contiguous()
        for Gn in OFFROAD_EDGES["G"]:
            for Pn in OFFROAD_EDGES["P"]:
                shape = (Bn, Gn, Pn) if Gn > 1 else (Bn, Pn)
                pix = torch.stack([torch.randint(-8, R + 8, shape, generator=g),
                                   torch.randint(-8, R + 8, shape, generator=g)], -1)
                pix = pix.to(torch.int32).to(dev).contiguous()
                got, again = rk.offroad_count(pix, m), rk.offroad_count(pix, m)
                want = rk.offroad_count_ref(pix, m)
                torch.cuda.synchronize()
                key = f"B={Bn},G={Gn},P={Pn}"
                held[key] = float((got - want).abs().max())
                check(torch.equal(got, want), f"offroad_count ({key}) disagrees with its plain "
                      "version")
                check(torch.equal(got, again), f"offroad_count ({key}) differs between two "
                      "launches")
    log(f"offroad_count at {len(held)} edge shapes (P {OFFROAD_EDGES['P']}, G "
        f"{OFFROAD_EDGES['G']}, B {OFFROAD_EDGES['B']}): equal to its plain version and to a "
        "second launch (tolerance 0, exact)")
    return held


def disk_fixture(g, Tn, Bn, Dn, mask, dev):
    """(centroids [Tn, Bn, Dn, 2], penalty distances [Bn, Bn], mask, decay
    [Tn]) of the disk-collision kernel: random disk centres; at Bn = B,
    scenes of 4 agents on top of each other (a scene centre 50 m scale, a
    spread of 2 m), so that same-scene pairs collide and others do not."""
    import torch

    cent = (torch.randn((Tn, Bn, Dn, 2), generator=g) * 2.0).to(dev)
    if Bn == B:
        centre = torch.randn((1, Bn // AGENTS_PER_SCENE, 1, 1, 2), generator=g) * 50.0
        spread = torch.randn((Tn, Bn // AGENTS_PER_SCENE, AGENTS_PER_SCENE, Dn, 2),
                             generator=g) * 2.0
        cent = (centre + spread).reshape(Tn, Bn, Dn, 2).to(dev).contiguous()
    rad = torch.rand((Bn,), generator=g) * 0.4 + 0.8
    pen = (rad[:, None] + rad[None, :] + 0.2).to(dev)
    decay = 0.9 ** torch.arange(Tn, dtype=torch.float32)
    return cent, pen, mask, (decay / decay.sum()).to(dev)


def check_reward_kernels(batch, dev, report):
    """`offroad_count` and `disk_collision` against their plain versions on
    the card."""
    import torch

    from cld_tpu_torch.ops import reward_kernels as rk

    g = torch.Generator().manual_seed(16)
    drv = batch.drivable_map
    Hm, W = drv.shape[-2:]
    maps = {"reward": (drv, (B, T)), "five_samples": (drv, (B, 5, T)),
            "odd": ((torch.rand((5, 64, 64), generator=g) > 0.4).float().to(dev), (5, 7)),
            "odd_groups": ((torch.rand((3, 33, 47), generator=g) - 0.4).to(dev), (3, 4, 9))}
    worst = 0.0
    for name, (m, shape) in maps.items():
        hm, w = m.shape[-2:]
        pix = torch.stack([torch.randint(0, w, shape, generator=g),
                           torch.randint(0, hm, shape, generator=g)], dim=-1)
        pix = pix.to(torch.int32).to(dev).contiguous()
        got, again, want = rk.offroad_count(pix, m), rk.offroad_count(pix, m), \
            rk.offroad_count_ref(pix, m)
        torch.cuda.synchronize()
        n_off = int(want.sum())
        log(f"offroad_count [{name}: pix {tuple(pix.shape)}, map {hm}x{w}]: equal to its plain "
            f"version: {bool(torch.equal(got, want))} (tolerance 0, exact); {n_off} of "
            f"{pix[..., 0].numel()} points off-road")
        check(torch.equal(got, want), f"offroad_count ({name}) disagrees with its plain version")
        check(torch.equal(got, again), f"offroad_count ({name}) differs between two launches")
        check(tuple(got.shape) == tuple(shape[:-1]), f"offroad_count ({name}) output shape")
        check(0 < n_off < pix[..., 0].numel(), "offroad_count fixture is degenerate")
        worst = max(worst, float((got - want).abs().max()))
        if name == "reward":
            full = (pix, m)
    held = check_offroad_edges(g, dev)
    attrs = rk.offroad_count_attributes()
    spills = " (spills: reported, not failed)" if attrs["local_bytes"] else ""
    log(f"offroad_count_kernel: {attrs['registers']} registers, {attrs['local_bytes']} bytes of "
        f"local memory per thread{spills}")
    pix, m = full
    ms = cuda_ms(lambda: rk.offroad_count(pix, m), 200)
    g_ms = graph_ms(lambda: rk.offroad_count(pix, m))
    plain_ms = cuda_ms(lambda: rk.offroad_count_ref(pix, m), 50)
    # bytes: the coordinates, the map values under them (distinct ones), one f32 per map
    flat = (torch.arange(B, device=dev)[:, None] * Hm + pix[..., 1].long()) * W + pix[..., 0].long()
    needed = 4 * int(torch.unique(flat).numel())
    b_ms, b_by = bound(8 * B * T + needed + 4 * B, float(B * T))
    log(f"offroad_count at B={B}, P={T}: {ms:.4f} ms from Python, {g_ms:.5f} ms from a CUDA "
        f"graph, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by} ({needed} map bytes)")
    report["offroad_count"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None, graph_ms=g_ms,
                                   source_bytes_needed=needed, held=held, attributes=attrs)

    off_diag = lambda n: ~torch.eye(n, dtype=torch.bool, device=dev)
    cases = {"ppo": (T, B, 5, scene_pair_mask(B, AGENTS_PER_SCENE, dev)),
             "all_pairs": (T, B, 5, off_diag(B)), "odd": (8, 6, 4, off_diag(6)),
             "one_disk": (3, 5, 1, off_diag(5)), "nine_disks": (6, 7, 9, off_diag(7)),
             "one_agent": (T, 1, 5, torch.ones((1, 1), dtype=torch.bool, device=dev)),
             "b33": (T, 33, 5, off_diag(33)),
             "empty_mask": (T, B, 5, torch.zeros((B, B), dtype=torch.bool, device=dev)),
             "nine_disks_ppo": (T, B, 9, scene_pair_mask(B, AGENTS_PER_SCENE, dev))}
    worst, timed = 0.0, {}
    for name, (Tn, Bn, Dn, mask) in cases.items():
        args = disk_fixture(g, Tn, Bn, Dn, mask, dev)
        got, again = rk.disk_collision_penalty(*args), rk.disk_collision_penalty(*args)
        want = rk.disk_collision_penalty_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-6).all())
        log(f"disk_collision [{name}: T={Tn}, B={Bn}, D={Dn}, {int(mask.sum())} pairs]: max abs "
            f"err {err:.3e} (rtol 1e-5, atol 1e-6; max |plain| {float(want.max()):.3g}, "
            f"{int((want > 0).sum())} agents penalized); repeated launch bit-identical: "
            f"{bool(torch.equal(got, again))}")
        check(ok, f"disk_collision ({name}) disagrees with its plain version")
        check(torch.equal(got, again), f"disk_collision ({name}) differs between two launches")
        if name == "empty_mask":
            check(float(got.abs().max()) == 0.0, "disk_collision with an empty mask is not 0")
        else:
            check(float(want.max()) > 0.0, f"disk_collision fixture ({name}) has no collision")
        worst = max(worst, err)
        timed[name] = args
        if name == "ppo":  # the runtime-D loop (what D > 8 takes) at the timed shape
            looped = rk.disk_collision_penalty(*args, unrolled=False)
            err = float((looped - want).abs().max())
            log(f"disk_collision [{name}, runtime-D loop]: max abs err {err:.3e}")
            check(bool(((looped - want).abs() <= 1e-5 * want.abs() + 1e-6).all()),
                  "disk_collision (runtime-D loop) disagrees with its plain version")
            worst = max(worst, err)
    args = timed["ppo"]
    ms = cuda_ms(lambda: rk.disk_collision_penalty(*args), 200)
    g_ms = graph_ms(lambda: rk.disk_collision_penalty(*args))
    g_all = graph_ms(lambda: rk.disk_collision_penalty(*timed["all_pairs"]))
    g_loop = graph_ms(lambda: rk.disk_collision_penalty(*args, unrolled=False))
    g_all_loop = graph_ms(lambda: rk.disk_collision_penalty(*timed["all_pairs"], unrolled=False))
    plain_ms = cuda_ms(lambda: rk.disk_collision_penalty_ref(*args), 5)
    # bytes: every input once, the output once. operations: the 25 disk pairs (2
    # subtractions, 2 products, a sum, a min) once per step and unordered pair {i, j}
    # that either direction's mask holds, since pair[t, i, j] = pair[t, j, i]; ~6 for the
    # penalty per step and ordered pair in the mask; a masked pair needs none
    D = 5
    nbytes = 4 * T * B * D * 2 + 4 * B * B + B * B + 4 * T + 4 * B

    def disk_ops(mask):
        either = mask | mask.T
        unordered = (int(either.sum()) + int(either.diagonal().sum())) // 2
        return T * (6.0 * D * D * unordered + 6.0 * int(mask.sum()))

    b_ms, b_by = bound(nbytes, disk_ops(args[2]))
    ball_ms, ball_by = bound(nbytes, disk_ops(timed["all_pairs"][2]))
    disk_attrs = {str(Dn): rk.disk_collision_attributes(Dn) for Dn in range(1, 10)}
    for Dn, a in disk_attrs.items():
        log(f"disk_collision_kernel<{Dn if Dn != '9' else '0 (runtime-D loop)'}>: "
            f"{a['registers']} registers, {a['local_bytes']} bytes of local memory per thread "
            "(spills: reported, not failed)")
    log(f"disk_collision at T={T}, B={B}, D={D}, same-scene pairs: {ms:.4f} ms from Python, "
        f"{g_ms:.5f} ms from a CUDA graph, plain {plain_ms:.3f} ms, bound {b_ms:.6f} ms by {b_by}; "
        f"every off-diagonal pair: {g_all:.5f} ms from a graph, bound {ball_ms:.6f} ms by "
        f"{ball_by}; with the runtime-D loop in place of the unrolled D x D: {g_loop:.5f} ms "
        f"and {g_all_loop:.5f} ms from a graph")
    report["disk_collision"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None, graph_ms=g_ms,
                                    graph_ms_all_pairs=g_all, graph_ms_looped=g_loop,
                                    graph_ms_all_pairs_looped=g_all_loop,
                                    bound_ms_all_pairs=ball_ms,
                                    bound_by_all_pairs=ball_by, attributes=disk_attrs)


def record_config(precision="fp32"):
    """The config of record, with epochs of one step (the warm-up rate is 0
    for the whole first epoch, so with the record's 1,000-step epochs a short
    run would move nothing), at `precision`: fp32 for every step before 23,
    whose checks and tolerances are float32's ("auto" is bf16 on the card)."""
    from cld_tpu_torch.utils.config import default_config

    cfg = default_config()
    cfg.train.training.steps_per_epoch = 1
    cfg.train.training.precision = precision
    return cfg.lock()


def fp32_config(name):
    """A registered config at precision fp32 (card-vs-CPU comparisons)."""
    from cld_tpu_torch.utils.registry import get_registered_experiment_config

    cfg = get_registered_experiment_config(name).unlock()
    cfg.train.training.precision = "fp32"
    return cfg.lock()


def run_training(batch, dev, report):
    """The VAE and DM stages at full width: 2 warm-up + 5 timed train steps
    each and one eval step. Returns (config, VAE state, DM trainer, DM state)
    for the PPO phase."""
    import torch

    from cld_tpu_torch.ops import native
    from cld_tpu_torch.training.dm import DMTrainer
    from cld_tpu_torch.training.vae import VAETrainer

    cfg = record_config()
    gen = torch.Generator(device=dev)
    WARM, STEPS = 2, 5

    def drive(name, state, step, evaluate, seed):
        gen.manual_seed(seed)
        before = snapshot(state.model)
        native.reset_launch_counts()
        losses = []
        for k in range(WARM + STEPS):
            if k == WARM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            _, m = step(state, batch, generator=gen)
            losses.append(m["loss"])
            check(m["skipped_nonfinite"] == 0.0, f"{name} step {k} skipped a non-finite loss")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ev = float(evaluate(state)["loss"])
        launches = native.launch_counts()
        losses = [float(v) for v in losses]
        delta = max_param_change(before, state.model)
        rate = STEPS / secs
        log(f"{name}: {rate:.2f} train steps/s ({secs / STEPS * 1e3:.1f} ms/step) at B={B}, "
            f"raster {RASTER}, on {report['card']}; losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"eval {ev:.4f}; parameters moved by up to {delta:.3e}; launches {launches}")
        check(all(v == v and abs(v) != float("inf") for v in losses + [ev]),
              f"{name}: a loss is not finite")
        check(delta > 0.0, f"{name}: no parameter moved")
        check(state.step == WARM + STEPS, f"{name}: step count {state.step}")
        return rate, launches, losses, ev

    vae_tr = VAETrainer(cfg, device=dev)
    vae_state = vae_tr.init_state(seed=0)
    rate, launches, losses, ev = drive("vae_train", vae_state, vae_tr.train_step,
                                       lambda s: vae_tr.eval_step(s, batch), 30)
    want = counts(lstm2_fwd=1)  # the eval step's deterministic decoder
    check(launches == want, f"vae_train launches {launches}, expected {want}")
    report["launches_vae_train"] = launches
    report["training"] = dict(vae_train_steps_per_sec=rate, vae_losses=losses, vae_eval_loss=ev)

    # the two LSTM stacks of a train step alone (encoder and train-mode decoder run layer by
    # layer through PyTorch's LSTM operator, cuDNN here, not through the fused kernel)
    lstmvae = vae_state.model.lstmvae
    g = torch.Generator().manual_seed(33)
    cond_dim, hid, lat = (lstmvae.lstm_enc.cond2hidden.in_features, lstmvae.hidden_size,
                          lstmvae.mu.out_features)
    x = torch.randn((B, T, 6), generator=g).to(dev)
    cond = torch.randn((B, cond_dim), generator=g).to(dev)
    noise = torch.randn((B, T, lat), generator=g).to(dev)
    masks = tuple((torch.rand((B, T, hid), generator=g) >= 0.2).float().to(dev) for _ in range(2))

    def stacks_fwd_bwd():
        acts, mu, logvar = lstmvae(x, cond, train=True, noise=noise, keep_masks=masks)
        (acts.sum() + mu.sum() + logvar.sum()).backward()

    stacks_ms = cuda_ms(stacks_fwd_bwd, 20)
    vae_state.optimizer.zero_grad(set_to_none=True)
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: lstmvae.traj2z(x, cond, noise=noise), 20)
    log(f"LSTM stacks through PyTorch's LSTM operator at B={B}: encoder + train-mode decoder "
        f"forward and backward {stacks_ms:.3f} ms; encoder forward alone {enc_ms:.3f} ms")
    report["training"].update(lstm_stacks_train_fwd_bwd_ms=stacks_ms, lstm_encoder_fwd_ms=enc_ms)

    dm_tr = DMTrainer(cfg, vae_state.model, device=dev)
    dm_state = dm_tr.init_state(seed=2)
    rate, launches, losses, ev = drive(
        "dm_train", dm_state, dm_tr.train_step,
        lambda s: dm_tr.eval_step(s, batch, generator=gen), 31)
    check(launches == counts(), f"dm_train launches {launches}, expected none")
    report["launches_dm_train"] = launches
    report["training"].update(dm_train_steps_per_sec=rate, dm_losses=losses, dm_eval_loss=ev)
    return cfg, dm_tr, dm_state


def run_ppo(cfg, dm_tr, dm_state, batch, dev, report):
    """The PPO stage at full width: 3 collections into a buffer of 3,000, a
    30-iteration update phase at mini-batch 128, one test step. Returns the
    last collection's trajectories."""
    import torch

    from cld_tpu_torch.ops import native
    from cld_tpu_torch.training.ppo import PPOTrainer, buffer_init

    COLLECTS, ITERS = 3, 30
    algo = cfg.algo
    ppo = PPOTrainer(cfg, dm_tr)
    buf = buffer_init(algo.buffer_max, algo.horizon, algo.vae.latent_size, algo.cond_feat_dim,
                      device=dev)
    check(buf.capacity == 3000 and ppo.mini_batch == 128, "PPO is not at the record's sizes")
    gen = torch.Generator(device=dev).manual_seed(32)
    native.reset_launch_counts()
    secs = []
    for k in range(COLLECTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf, out = ppo.collect_step(dm_state, buf, batch, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(out["reward"])), f"collect step {k}: reward is not finite")
    traj = out["traj"]
    check(buf.size == COLLECTS * B and buf.ptr == COLLECTS * B, f"buffer fill {buf.size}")
    check(tuple(traj.shape) == (B, 1, T, 6) and bool(torch.isfinite(traj).all()),
          "collected trajectories are not finite [B, 1, T, 6]")
    for name in ("x0", "x1", "log_p", "reward", "cond_feat"):
        check(bool(torch.isfinite(getattr(buf, name)[:buf.size]).all()),
              f"buffer field {name} is not finite")
    collect_rate = (COLLECTS - 1) / sum(secs[1:])
    launches = native.launch_counts()
    want = counts(lstm2_fwd=COLLECTS, offroad_count=COLLECTS)
    check(launches == want, f"collect launches {launches}, expected {want}")

    before = snapshot(dm_state.model)
    step0 = dm_state.step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    indices = torch.randint(0, buf.size, (ITERS, ppo.mini_batch), generator=gen, device=dev)
    _, pm = ppo.ppo_update(dm_state, buf, indices=indices)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    pm = {k: float(v) for k, v in pm.items()}
    delta = max_param_change(before, dm_state.model)
    check(all(v == v for v in pm.values()), f"PPO metrics hold a NaN: {pm}")
    check(0.0 <= pm["clip_fraction"] <= 1.0, f"clip_fraction {pm['clip_fraction']}")
    check(dm_state.step == step0 + ITERS, f"PPO update took {dm_state.step - step0} steps")
    check(delta > 0.0, "the PPO update moved no parameter")

    rates, stats = ppo.test_step(dm_state, batch, generator=gen)
    torch.cuda.synchronize()
    rates = {k: float(v) for k, v in rates.items()}
    check(all(0.0 <= v <= 1.0 for v in rates.values()), f"failure rates {rates}")
    check(tuple(stats["long_acc_pred"].shape) == (B, T)
          and all(bool(torch.isfinite(v).all()) for v in stats.values()),
          "test step statistics are not finite [B, T]")
    launches = native.launch_counts()
    want = counts(lstm2_fwd=COLLECTS + 1, offroad_count=COLLECTS)
    check(launches == want, f"PPO launches {launches}, expected {want}")
    report["launches_ppo"] = launches
    report["ppo"] = dict(ppo_collect_steps_per_sec=collect_rate, collect_s=secs,
                         ppo_update_iters_per_sec=ITERS / update_s, update_iters=ITERS,
                         update_metrics=pm, failure_rates=rates,
                         mean_reward=float(out["reward"]))
    log(f"ppo: {collect_rate:.3f} collect steps/s ({', '.join(f'{v:.2f}' for v in secs)} s), "
        f"{ITERS / update_s:.2f} update iterations/s at mini-batch {ppo.mini_batch} ({ITERS} "
        f"iterations, {update_s:.2f} s; parameters moved by up to {delta:.3e}), on "
        f"{report['card']}; update metrics {json.dumps(pm)}; failure rates {json.dumps(rates)}; "
        f"launches {launches}")
    return traj


def run_ppo_disk_penalty(traj, batch, dev, report, kernels):
    """The disk-collision penalty of the trajectories that the PPO stage
    collected. No entry point of the trainer calls this op (it has no
    gradient and the PPO reward does not use it), so its launch is counted as
    a path of its own, `ppo_disk_penalty`, and the `ppo` path launches it 0
    times. The scene poses are this script's: scenes of 4 agents parked 3 m
    apart in one lane, so that neighbours' disks overlap from the start."""
    import torch

    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.ops import reward_kernels as rk
    from cld_tpu_torch.ops.geometry import world_from_agent_matrix

    native.reset_launch_counts()
    lane = (torch.arange(B, device=dev) % AGENTS_PER_SCENE).float()
    wfa = world_from_agent_matrix(torch.stack([lane * 3.0, torch.zeros_like(lane)], -1),
                                  torch.zeros_like(lane))
    scene = torch.arange(B, device=dev) // AGENTS_PER_SCENE
    ctx = gl.GuidanceContext(batch.drivable_map, batch.raster_from_agent, batch.extent,
                             batch.curr_speed, wfa, scene)
    rule = gl.AgentCollisionLoss(num_disks=5, buffer_dist=0.2)
    cent = gl.disk_centres_world(traj, ctx, rule.num_disks)[:, 0].permute(1, 0, 2, 3).contiguous()
    rad = batch.extent[:, 1] / 2.0
    pen_d = rad[:, None] + rad[None, :] + rule.buffer_dist
    mask = scene_pair_mask(B, AGENTS_PER_SCENE, dev)
    decay = gl._decay_weights(T, rule.decay_rate, dev)
    got = rk.disk_collision_penalty(cent, pen_d, mask, decay)
    torch.cuda.synchronize()
    ref = rk.disk_collision_penalty_ref(cent, pen_d, mask, decay)
    flat_rule = rule(traj, ctx)[:, 0]  # the rule's flat path; 0 for agents that stand still
    moving = batch.curr_speed.abs() > rule.guide_moving_speed_th
    err = float((got - ref).abs().max())
    err_rule = float((torch.where(moving, got, torch.zeros(()).to(dev)) - flat_rule).abs().max())
    log(f"disk_collision on the collected trajectories: max abs err vs plain {err:.3e}, vs "
        f"AgentCollisionLoss {err_rule:.3e} (rtol 1e-5, atol 1e-6; max penalty "
        f"{float(ref.max()):.4f}, {int((ref > 0).sum())} of {B} agents penalized)")
    check(bool(((got - ref).abs() <= 1e-5 * ref.abs() + 1e-6).all()),
          "disk_collision disagrees with its plain version on the collected trajectories")
    check(bool(((torch.where(moving, got, torch.zeros(()).to(dev)) - flat_rule).abs()
                <= 1e-5 * flat_rule.abs() + 1e-6).all()),
          "disk_collision disagrees with AgentCollisionLoss on the collected trajectories")
    check(float(ref.max()) > 0.0, "the collected trajectories have no collision")
    kernels["disk_collision"]["max_abs_err"] = max(kernels["disk_collision"]["max_abs_err"], err)
    launches = native.launch_counts()
    check(launches == counts(disk_collision=1), f"disk penalty launches {launches}, expected 1")
    report["launches_ppo_disk_penalty"] = launches
    report["ppo"]["disk_penalty_max"] = float(ref.max())


def check_small_training(dev, report):
    """One VAE step's and one DM step's gradients, and one collection's
    trajectories and rewards, on the card against the CPU at the `cld_smoke`
    widths (B=8, raster 64, 5 diffusion steps): same weights, same explicit
    noise and dropout masks. Gradients are held over each stage's whole
    gradient vector: |card - cpu| <= 1e-4 |cpu| + 1e-4 max |cpu| (f32
    convolutions, BatchNorm over a batch of 8 and two LSTM implementations on
    two backends); trajectories as the small slice's; rewards within 1e-3."""
    import torch

    from cld_tpu_torch.algos.dm import dm_loss
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.training.dm import DMTrainer
    from cld_tpu_torch.training.ppo import PPOTrainer, buffer_init
    from cld_tpu_torch.training.vae import VAETrainer

    cfg = fp32_config("cld_smoke")
    algo = cfg.algo
    Bs, Hs, Ls, steps = 8, algo.vae.hidden_size, algo.vae.latent_size, algo.n_diffusion_steps
    g = torch.Generator().manual_seed(17)
    noise = torch.randn((Bs, T, Ls), generator=g)
    masks = tuple((torch.rand((Bs, T, Hs), generator=g) >= 0.2).float() for _ in range(2))
    t = torch.randint(0, steps, (Bs,), generator=g)
    eps = torch.randn((Bs, T, Ls), generator=g)
    x_init = torch.randn((Bs, T, Ls), generator=g)
    step_noises = torch.randn((steps, Bs, T, Ls), generator=g)
    res, weights = {}, None
    for where in ("cpu", dev):
        batch = synthetic_batch(seed=4, batch_size=Bs, raster_size=64,
                                hist_frames=algo.history_num_frames, device=where)
        vs = VAETrainer(cfg, device=where).init_state(seed=5)
        if weights is None:  # copied now: the train-mode forward moves BatchNorm's statistics
            vae_weights = {k: v.clone() for k, v in vs.model.state_dict().items()}
        else:
            vs.model.load_state_dict(weights[0])
        mv = lambda v: v.to(where)
        out = vs.model(batch, 0.05, train=True, noise=mv(noise), keep_masks=tuple(map(mv, masks)))
        out["loss"].backward()
        vae_grad = torch.cat([p.grad.flatten().cpu() for p in vs.model.parameters()])
        dm_tr = DMTrainer(cfg, vs.model, device=where)  # freezes the VAE
        ds = dm_tr.init_state(seed=6)
        if weights is None:
            weights = (vae_weights, ds.model.state_dict())
        else:
            ds.model.load_state_dict(weights[1])
        z0, aux = dm_tr.encode(batch, mv(noise))
        loss = dm_loss(ds.model, dm_tr.schedule, z0, aux["cond_feat"], mv(t), mv(eps))
        loss.backward()
        dm_grad = torch.cat([p.grad.flatten().cpu() for p in ds.model.parameters()])
        ds.optimizer.zero_grad(set_to_none=True)
        ppo = PPOTrainer(cfg, dm_tr)
        buf = buffer_init(algo.buffer_max, algo.horizon, Ls, algo.cond_feat_dim, device=where)
        buf, col = ppo.collect_step(ds, buf, batch, x_init=mv(x_init), step_noises=mv(step_noises))
        res[str(where)] = dict(vae_loss=float(out["loss"].detach()), vae_grad=vae_grad,
                               dm_loss=float(loss.detach()), dm_grad=dm_grad, traj=col["traj"].cpu(),
                               reward=buf.reward[:Bs].cpu())
    c, k = res["cpu"], res[str(dev)]
    summary = {}
    for name in ("vae_grad", "dm_grad"):
        a, b = k[name], c[name]
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        log(f"small training {name}: card vs CPU max abs diff {err:.3e} (rtol 1e-4, floor 1e-4 "
            f"of max {scale:.3g}); losses {k[name[:-4] + 'loss']:.6f} vs "
            f"{c[name[:-4] + 'loss']:.6f}")
        check(scale > 0.0, f"small training {name} is zero")
        check(bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-4 * scale).all()),
              f"small training {name} disagrees between card and CPU")
        summary[name] = err
    a, b = k["traj"], c["traj"]
    err = float((a - b).abs().max())
    check(bool(((a - b).abs() <= SLICE_RTOL * b.abs() + 1e-6 * float(b.abs().max())).all()),
          "small collection trajectories disagree between card and CPU")
    r_err = float((k["reward"] - c["reward"]).abs().max())
    log(f"small collection: trajectories card vs CPU max abs diff {err:.3e}, rewards {r_err:.3e} "
        f"(tolerance 1e-3; CPU rewards {[round(v, 3) for v in c['reward'].tolist()]})")
    check(r_err <= 1e-3, "small collection rewards disagree between card and CPU")
    summary.update(traj=err, reward=r_err)
    report["small_training"] = summary


# ---------------------------------------------------------------------------
# step 23: bf16 mixed precision
# ---------------------------------------------------------------------------

BF16_PATHS = ("vae_eval", "dm_train", "ppo", "cli", "guided", "rollout", "trainers",
              "ebm_scoring", "scene_diffuser")


def hold_lstm_bf16(args, dy):
    """Both LSTM kernels on bf16 inputs against their bf16 plain versions,
    and each against a second launch of itself. Returns (the reverse sweep's
    inputs, {fwd_abs, fwd_rel, fwd_unequal, bwd_abs, bwd_rel, bwd_unequal}):
    max abs and relative (of max |plain|) errors and the share of elements
    that are not bit-equal."""
    import torch

    from cld_tpu_torch.ops import lstm_kernels as lk

    Bn, Tn, Hn = dy.shape
    got, again = lk.lstm2_fwd(*args), lk.lstm2_fwd(*args)
    want = lk.lstm2_core_ref(*args)
    y, h1s, c1s, c2s = want
    bargs = (dy, *args, h1s, c1s, y, c2s)
    dg_k, dg_k2 = lk.lstm2_bwd(*bargs), lk.lstm2_bwd(*bargs)
    dg_p = lk.lstm2_bwd_ref(*bargs)
    torch.cuda.synchronize()
    check(all(a.dtype == torch.bfloat16 for a in (*got, *dg_k)), "a bf16 kernel stored f32")

    def errs(outs, refs):
        e = [rel_err(a.float(), b.float()) for a, b in zip(outs, refs)]
        unequal = sum(int((a != b).sum()) for a, b in zip(outs, refs))
        return max(x[0] for x in e), max(x[1] for x in e), unequal / sum(a.numel() for a in outs)

    e = dict(zip(("fwd_abs", "fwd_rel", "fwd_unequal"), errs(got, want)))
    e.update(zip(("bwd_abs", "bwd_rel", "bwd_unequal"), errs(dg_k, dg_p)))
    shape = f"B/T/H {Bn}/{Tn}/{Hn}"
    log(f"lstm2_fwd bf16 {shape}: max abs err {e['fwd_abs']:.3e}, rel {e['fwd_rel']:.3e}, "
        f"{100 * e['fwd_unequal']:.2f}% of elements not bit-equal; lstm2_bwd bf16: max abs err "
        f"{e['bwd_abs']:.3e}, rel {e['bwd_rel']:.3e}, {100 * e['bwd_unequal']:.2f}% not "
        f"bit-equal (tolerance 2^-7 of max |plain|)")
    for k in ("fwd", "bwd"):
        check(e[f"{k}_rel"] <= BF16_REL_TOL,
              f"bf16 lstm2_{k} disagrees with its plain version at {shape}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"two bf16 lstm2_fwd launches differ at {shape}")
    check(all(torch.equal(a, b) for a, b in zip(dg_k, dg_k2)),
          f"two bf16 lstm2_bwd launches differ at {shape}")
    return bargs, e


def check_lstm_bf16(kernels):
    """The bf16 LSTM kernels (`csrc/lstm_bf16.cu`, on the tensor cores) at B
    = 32, 128, 512 (T = 52, H = 64) and at `BF16_LSTM_EDGES`: held against
    the bf16 plain versions, registers, spills and shared memory, times from
    Python and from a CUDA graph beside the f32 kernels' (step 3), the plain
    versions' and cuDNN's bf16 `nn.LSTM` (forward; backward beside the bf16
    `Lstm2Core` VJP)."""
    import torch

    from cld_tpu_torch.ops import lstm_kernels as lk

    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(23)
    held, errs = {}, {}
    for Bn in BF16_LSTM_BATCHES:
        a, d = lstm_inputs(g, Bn, T, H, dev)
        a, d = tuple(x.to(bf) for x in a), d.to(bf)
        bargs, errs[str(Bn)] = hold_lstm_bf16(a, d)
        held[Bn] = (a, bargs)
    for shape in BF16_LSTM_EDGES:
        a, d = lstm_inputs(g, *shape, dev)
        _, errs["/".join(map(str, shape))] = hold_lstm_bf16(tuple(x.to(bf) for x in a), d.to(bf))
    attrs = {}
    for which, kname in enumerate(("lstm2_fwd_mma_kernel", "lstm2_gates_mma_kernel",
                                   "lstm2_chain_mma_kernel")):
        at = lk.kernel_attributes(which, H, dtype=bf)
        attrs[f"{kname}<{H}>"] = at
        log(f"{kname} H={H} ({lk.ROWS_PER_CTA_BF16} rows a CTA): {at['registers']} registers, "
            f"{at['local_bytes']} bytes of local memory per thread, {at['shared_bytes']} bytes "
            f"of shared memory, max {at['max_threads']} threads per block")

    args, bargs = held[B]
    fwd_ms = cuda_ms(lambda: lk.lstm2_fwd(*args), 50)
    fwd_plain_ms = cuda_ms(lambda: lk.lstm2_core_ref(*args), 5)
    bwd_ms = cuda_ms(lambda: lk.lstm2_bwd(*bargs), 50)
    bwd_plain_ms = cuda_ms(lambda: lk.lstm2_bwd_ref(*bargs), 5)
    fwd_graph, bwd_graph = {}, {}
    for Bn, (a, ba) in held.items():
        fwd_graph[Bn] = graph_ms(lambda: lk.lstm2_fwd(*a), launches=20)
        bwd_graph[Bn] = graph_ms(lambda: lk.lstm2_bwd(*ba), launches=20)
    # the per-launch weight pack inside those times (ROADMAP B 5): the forward's
    # one layout, the reverse sweep's two
    _, _, Wh1, W2, _ = args
    pack_ms = {"fwd": graph_ms(lambda: lk.pack_weights("fwd_bf16", Wh1, W2), launches=20),
               "bwd": graph_ms(lambda: lk.pack_layouts(Wh1, W2, "fwd_bf16", "bwd_bf16"),
                               launches=20)}
    log(f"bf16 weight pack from a CUDA graph: forward {pack_ms['fwd']:.4f} ms, reverse sweep "
        f"{pack_ms['bwd']:.4f} ms")
    f32_fwd, f32_bwd = kernels["lstm2_fwd"]["graph_ms"], kernels["lstm2_bwd"]["graph_ms"]
    log("bf16 beside f32 from a CUDA graph, ms at B=" + ", ".join(
        f"{Bn}: lstm2_fwd {fwd_graph[Bn]:.4f} (f32 {f32_fwd[str(Bn)]:.4f}), lstm2_bwd "
        f"{bwd_graph[Bn]:.4f} (f32 {f32_bwd[str(Bn)]:.4f})" for Bn in fwd_graph))

    # cuDNN's bf16 LSTM from z (its own random weights at the decoder's sizes)
    cudnn = torch.nn.LSTM(L, H, num_layers=2, batch_first=True).to(dev).to(bf)
    z = torch.randn((B, T, L), generator=g).to(dev).to(bf)
    hc = (args[1][None].expand(2, B, H).contiguous(), torch.zeros((2, B, H), device=dev, dtype=bf))
    with torch.no_grad():
        fwd_lib_ms = cuda_ms(lambda: cudnn(z, hc), 50)
        fwd_lib_graph = graph_ms(lambda: cudnn(z, hc), launches=20)
    zr = z.clone().requires_grad_(True)
    h0r = hc[0].clone().requires_grad_(True)
    dy = bargs[0]
    lib_in = (zr, h0r, *cudnn.parameters())
    lib_fwd = lambda: cudnn(zr, (h0r, hc[1]))[0]
    lib_train_fwd_ms = cuda_ms(lib_fwd, 50)
    bwd_lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_fwd(), lib_in, dy), 50) - lib_train_fwd_ms
    core_in = [a.detach().clone().requires_grad_(True) for a in args]
    core_fwd = lambda: lk.lstm2_core(*core_in)
    core_fwd_ms = cuda_ms(core_fwd, 50)
    vjp_ms = cuda_ms(lambda: torch.autograd.grad(core_fwd(), core_in, dy), 50) - core_fwd_ms
    log(f"bf16 lstm2_fwd {fwd_ms:.4f} ms from Python ({fwd_graph[B]:.4f} from a graph) vs cuDNN "
        f"bf16 nn.LSTM forward {fwd_lib_ms:.4f} ({fwd_lib_graph:.4f}); bf16 lstm2_bwd "
        f"{bwd_ms:.4f} ms, Lstm2Core VJP {vjp_ms:.4f} vs cuDNN bf16 backward {bwd_lib_ms:.4f} "
        f"(B={B})")

    (fwd_b, fwd_by), (bwd_b, bwd_by) = lstm_bounds(B, T, H, 2, BF16_FLOPS_PER_S)
    e = errs[str(B)]
    common = dict(held=errs)
    kernels["lstm2_fwd_bf16"] = dict(
        max_abs_err=e["fwd_abs"], max_rel_err=e["fwd_rel"], unequal_share=e["fwd_unequal"],
        ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=fwd_b, bound_by=fwd_by, library_ms=fwd_lib_ms,
        library_graph_ms=fwd_lib_graph, graph_ms={str(k): v for k, v in fwd_graph.items()},
        f32_graph_ms=f32_fwd, pack_graph_ms=pack_ms["fwd"],
        attributes={k: v for k, v in attrs.items() if "fwd" in k}, **common)
    kernels["lstm2_bwd_bf16"] = dict(
        max_abs_err=e["bwd_abs"], max_rel_err=e["bwd_rel"], unequal_share=e["bwd_unequal"],
        ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bwd_b, bound_by=bwd_by, library_ms=bwd_lib_ms,
        library_train_fwd_ms=lib_train_fwd_ms, lstm2core_vjp_ms=vjp_ms,
        graph_ms={str(k): v for k, v in bwd_graph.items()}, f32_graph_ms=f32_bwd,
        pack_graph_ms=pack_ms["bwd"],
        attributes={k: v for k, v in attrs.items() if "fwd" not in k}, **common)


def twin(what, bf16_loss, f32_loss, rtol=TWIN_RTOL):
    """Hold a bf16 loss against the f32 one (ROADMAP "bf16 twins")."""
    ok = abs(bf16_loss - f32_loss) <= TWIN_ATOL + rtol * abs(f32_loss)
    check(ok, f"{what}: bf16 loss {bf16_loss!r} vs f32 {f32_loss!r} beyond rtol "
          f"{rtol} / atol {TWIN_ATOL}")


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def run_bf16_stages(report):
    """The VAE, DM and PPO stages at the config of record (batch 128, raster
    224) under "auto" (bf16 on the card) beside fp32, from the same weights,
    batch and draws: ms per step (the first of 3 warms up), peak memory, the
    first step's loss (taken before any update) held as bf16 twins, and the
    launches (a VAE eval step: 1 bf16 `lstm2_fwd`; a DM step: none; a PPO
    collection: 1 bf16 `lstm2_fwd` and 1 `offroad_count`).

    PPO: each precision collects its own batch from the same noise (time,
    launches and mean reward reported; 100 denoise steps of random weights
    carry bf16's rounding into the rewards, so the two collections are not
    twins), and its first update iteration's loss is held on the same
    transitions: the f32 collection's, with the old log-prob of each
    minibatch row the precision's own. At t = 0 sigma is 1e-10, so the
    ratio is exactly 1 only when old and new log-prob come from one
    computation (the design of the JAX package's PPO)."""
    import torch

    from cld_tpu_torch.algos.dm import transition_log_prob
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.training.dm import DMTrainer
    from cld_tpu_torch.training.ppo import PPOTrainer, ReplayBuffer, buffer_init
    from cld_tpu_torch.training.vae import VAETrainer

    dev = torch.device("cuda", 0)
    batch = synthetic_batch(seed=0, batch_size=B, raster_size=RASTER, device=dev)
    STEPS = 3
    res, shared = {}, None

    def steps(step, state, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        losses, secs = [], []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step(state, batch, generator=gen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        return dict(ms=1e3 * sum(secs[1:]) / (STEPS - 1), losses=losses)

    for prec in ("fp32", "auto"):
        cfg = record_config(prec)
        r = res[prec] = {}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        vae_tr = VAETrainer(cfg, device=dev)
        check(vae_tr.compute_dtype == (torch.bfloat16 if prec == "auto" else torch.float32),
              f"precision {prec} resolved to {vae_tr.compute_dtype}")
        vs = vae_tr.init_state(seed=0)
        r["vae"] = steps(vae_tr.train_step, vs, 40)
        native.reset_launch_counts()
        ev = vae_tr.eval_step(vs, batch)
        r["vae"]["eval_launches"] = native.launch_counts()
        r["vae"]["eval_loss"] = float(ev["loss"])
        r["vae"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del vae_tr, vs

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dm_tr = DMTrainer(cfg, VAETrainer(cfg, device=dev).init_state(0).model, device=dev)
        ds = dm_tr.init_state(seed=2)
        native.reset_launch_counts()
        r["dm"] = steps(dm_tr.train_step, ds, 41)
        r["dm"]["launches"] = native.launch_counts()
        r["dm"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ds = dm_tr.init_state(seed=2)
        ppo = PPOTrainer(cfg, dm_tr)
        algo = cfg.algo
        buf = buffer_init(algo.buffer_max, algo.horizon, algo.vae.latent_size, algo.cond_feat_dim,
                          device=dev)
        gen = torch.Generator(device=dev).manual_seed(42)
        native.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf, out = ppo.collect_step(ds, buf, batch, generator=gen)
        torch.cuda.synchronize()
        collect_s = time.perf_counter() - t0
        launches = native.launch_counts()
        if shared is None:  # the f32 collection's transitions
            shared = {k: getattr(buf, k).clone() for k in ("x0", "x1", "log_p", "reward",
                                                           "cond_feat", "baseline")}
            shared.update(ptr=buf.ptr, size=buf.size, initialized=True)
        sb = ReplayBuffer(**{k: v.clone() if torch.is_tensor(v) else v for k, v in shared.items()})
        indices = torch.randint(0, sb.size, (STEPS, ppo.mini_batch), generator=gen, device=dev)
        idx = indices[0]
        with torch.no_grad():
            sb.log_p[idx] = transition_log_prob(ds.model, dm_tr.schedule, sb.x1[idx], sb.x0[idx],
                                                sb.cond_feat[idx],
                                                torch.zeros_like(idx))
        _, first = ppo.ppo_update(ds, sb, indices=indices[:1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppo.ppo_update(ds, sb, indices=indices[1:])
        torch.cuda.synchronize()
        update_ms = 1e3 * (time.perf_counter() - t0) / (STEPS - 1)
        r["ppo"] = dict(collect_s=collect_s, update_ms=update_ms,
                        launches=launches, first_update_loss=float(first["loss"]),
                        first_ratio_mean=float(first["ratio_mean"]), reward=float(out["reward"]),
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                        f32_state=bool(buf.log_p.dtype == torch.float32 and all(
                            p.dtype == torch.float32 for p in ds.model.parameters())))
        del dm_tr, ds, ppo, buf, sb, out

    f32, b16 = res["fp32"], res["auto"]
    for stage in ("vae", "dm"):
        log(f"{stage} step at B={B}, raster {RASTER}: bf16 {b16[stage]['ms']:.1f} ms "
            f"(f32 {f32[stage]['ms']:.1f}), peak {b16[stage]['peak_gb']:.2f} GB (f32 "
            f"{f32[stage]['peak_gb']:.2f}), losses {b16[stage]['losses']} (f32 "
            f"{f32[stage]['losses']}), on {report['card']}")
    log(f"ppo at B={B}: collection bf16 {b16['ppo']['collect_s']:.3f} s (f32 "
        f"{f32['ppo']['collect_s']:.3f}), update iteration bf16 {b16['ppo']['update_ms']:.1f} ms "
        f"(f32 {f32['ppo']['update_ms']:.1f}), peak {b16['ppo']['peak_gb']:.2f} GB (f32 "
        f"{f32['ppo']['peak_gb']:.2f}); on the same transitions first update loss "
        f"{b16['ppo']['first_update_loss']:.6f} (f32 {f32['ppo']['first_update_loss']:.6f}), "
        f"ratio {b16['ppo']['first_ratio_mean']} (f32 {f32['ppo']['first_ratio_mean']}); own "
        f"collections' mean reward {b16['ppo']['reward']:.4f} (f32 {f32['ppo']['reward']:.4f})")
    for prec, r in res.items():
        for stage in ("vae", "dm"):
            check(all(v == v and abs(v) != float("inf") for v in r[stage]["losses"]),
                  f"{prec} {stage}: a loss is not finite")
        check(r["ppo"]["f32_state"], f"{prec} PPO: the buffer or the parameters are not float32")
    bf = dict(lstm2_fwd_bf16=1)
    check(b16["vae"]["eval_launches"] == counts(**bf), f"bf16 VAE eval launches "
          f"{b16['vae']['eval_launches']}")
    check(f32["vae"]["eval_launches"] == counts(lstm2_fwd=1), "f32 VAE eval launches "
          f"{f32['vae']['eval_launches']}")
    check(b16["dm"]["launches"] == counts(), f"bf16 DM launches {b16['dm']['launches']}")
    check(b16["ppo"]["launches"] == counts(offroad_count=1, **bf),
          f"bf16 PPO collection launches {b16['ppo']['launches']}")
    twin("VAE step", b16["vae"]["losses"][0], f32["vae"]["losses"][0])
    twin("DM step", b16["dm"]["losses"][0], f32["dm"]["losses"][0])
    twin("PPO first update iteration", b16["ppo"]["first_update_loss"],
         f32["ppo"]["first_update_loss"])
    report["launches_bf16_vae_eval"] = b16["vae"]["eval_launches"]
    report["launches_bf16_dm_train"] = b16["dm"]["launches"]
    report["launches_bf16_ppo"] = b16["ppo"]["launches"]
    report["bf16_stages"] = res


def run_bf16_cli(report):
    """The train CLI at its default precision ("auto": bf16 on the card) and
    the config of record (batch 128, raster 224, one-step epochs from a JSON
    `--config`), one step each of `--mode vae`, `dm` and `ppo`: every
    network at bf16, every parameter f32, finite metrics; launches: vae and
    dm none, ppo's collection 1 bf16 `lstm2_fwd` and 1 `offroad_count` (its
    update comes every `update_interval` = 10 steps)."""
    import numpy as np
    import torch

    from cld_tpu_torch import train
    from cld_tpu_torch.ops import native

    out = ROOT / "chiprun_out" / "bf16_cli"
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps({"train": {"training": {"steps_per_epoch": 1}}}))
    base = ["--registered-name", "cld_vae_nusc", "--config", str(out / "config.json"),
            "--device", "cuda", "--output", str(out / "runs"), "--steps", "1"]
    ckpt = ["--vae-ckpt", str(out / "runs" / "vae" / "ckpt_final")]
    runs, total = {}, counts()
    for mode, extra, want in (("vae", [], counts()), ("dm", ckpt, counts()),
                              ("ppo", ckpt, counts(lstm2_fwd_bf16=1, offroad_count=1))):
        native.reset_launch_counts()
        t0 = time.perf_counter()
        state = train.main(base + ["--mode", mode] + extra)
        secs = time.perf_counter() - t0
        launches = native.launch_counts()
        dtypes = {m.compute_dtype for m in state.model.modules() if hasattr(m, "compute_dtype")}
        recs = [json.loads(line) for line in
                (out / "runs" / mode / "metrics.jsonl").read_text().splitlines()]
        check(dtypes == {torch.bfloat16}, f"--mode {mode} under auto computes at {dtypes}")
        check(all(p.dtype == torch.float32 for p in state.model.parameters()),
              f"--mode {mode}: a parameter is not float32")
        check(launches == want, f"--mode {mode} launches {launches}, expected {want}")
        check(len(recs) == 1 and all(np.isfinite(v) for v in recs[0].values()),
              f"--mode {mode}: the metrics are not finite")
        runs[mode] = dict(s=secs, metrics=recs[0])
        total = {k: total[k] + launches[k] for k in total}
    log("train CLI under auto (bf16), one step each at batch 128, raster 224: " + ", ".join(
        f"--mode {m} {r['s']:.1f} s with its set-up" for m, r in runs.items()))
    report["launches_bf16_cli"] = total
    report["bf16_cli"] = runs


def run_bf16_guided(models32, report):
    """The guided call at B=128 under "auto" (bf16), from the f32 models'
    weights: exact launches (100 bf16 `lstm2_fwd`, 99 bf16 `lstm2_bwd`, 99
    `bit_gather`, 1 `offroad_count`), NFE/s beside f32's (timed in turns,
    f32, bf16, bf16, f32: the host's load moves a call's time between the
    steps of this script), one step's guidance gradient through the bf16
    decoder against the f32 decoder's (cosine > 0.999; the same latent and
    conditioning), and the decoded trajectories beside f32's from the same
    noise (reported: Adam's sign amplifies rounding)."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.guidance import perturbation as gp
    from cld_tpu_torch.models.vae import convert_action_to_state_and_action, decode_actions
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.ops.normalization import TrajNormalizer

    dev = torch.device("cuda", 0)
    batch = synthetic_batch(seed=0, batch_size=B, raster_size=RASTER, device=dev)
    models = pipeline.build_models(seed=0, device=dev)  # "auto"
    check(models.compute_dtype == torch.bfloat16,
          f"auto resolved to {models.compute_dtype} on the card")
    g = torch.Generator(device=dev)
    native.reset_launch_counts()
    out = pipeline.guided_collect(models, batch, agents_per_scene=AGENTS_PER_SCENE,
                                  generator=g.manual_seed(10))
    torch.cuda.synchronize()
    launches = native.launch_counts()
    want = counts(lstm2_fwd_bf16=N_STEPS, lstm2_bwd_bf16=N_STEPS - 1, bit_gather=N_STEPS - 1,
                  offroad_count=1)
    check(launches == want, f"bf16 guided launches {launches}, expected {want}")
    check(out["traj"].dtype == torch.float32 and bool(torch.isfinite(out["traj"]).all()),
          "bf16 guided trajectories are not finite float32")
    out32 = pipeline.guided_collect(models32, batch, agents_per_scene=AGENTS_PER_SCENE,
                                    generator=g.manual_seed(10))
    traj_diff = float((out["traj"] - out32["traj"]).abs().max())

    def call_s(m, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.guided_collect(m, batch, agents_per_scene=AGENTS_PER_SCENE,
                                generator=g.manual_seed(seed))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    turns = [(m, call_s(m, seed)) for m, seed in ((models32, 11), (models, 11), (models, 12),
                                                  (models32, 12))]
    secs = sum(t for m, t in turns if m is models) / 2
    secs32 = sum(t for m, t in turns if m is models32) / 2
    nfe, nfe32 = B * N_STEPS / secs, B * N_STEPS / secs32

    # one guided step's gradient: the same latent and conditioning through each decoder
    wfa, scene = pipeline.scene_world_poses(B, AGENTS_PER_SCENE, dev)
    ctx = gl.prepack_drivable(gl.GuidanceContext(
        drivable_map=batch.drivable_map, raster_from_agent=batch.raster_from_agent,
        extent=batch.extent, curr_speed=batch.curr_speed, world_from_agent=wfa,
        scene_index=scene))
    specs = pipeline.flagship_guidance_specs(AGENTS_PER_SCENE)
    with torch.no_grad():
        aux = models32.context(batch)
    z = torch.randn((B, T, L), generator=torch.Generator(device=dev).manual_seed(12), device=dev)

    def gradient(m):
        def decode_fn(v):
            acts = decode_actions(m.decoder, v, aux["cond_feat"])
            traj = convert_action_to_state_and_action(acts, aux["curr_states"], m.dyn,
                                                      TrajNormalizer(), descaled_output=True)
            return traj[:, None]

        return gp.guidance_gradient(z, ctx, specs, decode_fn)

    g16, g32 = gradient(models), gradient(models32)
    cos = cosine(g16, g32)
    log(f"bf16 guided call at B={B}: {nfe:.1f} NFE/s (f32 {nfe32:.1f} in turns with it; step 4 "
        f"{report['pipeline']['guided_nfe_per_s']:.1f}), launches {launches}; one "
        f"step's guidance gradient bf16 vs f32 cosine {cos:.6f}; "
        f"decoded trajectories max |bf16 - f32| {traj_diff:.4f} m of max "
        f"{float(out32['traj'].abs().max()):.2f}; reward {float(out['reward']):.4f} (f32 "
        f"{float(out32['reward']):.4f}), on {report['card']}")
    check(cos > TWIN_COSINE, f"bf16 guidance gradient cosine {cos} against f32")
    report["launches_bf16_guided"] = launches
    report["bf16_guided"] = dict(nfe_per_s=nfe, guided_s=secs, f32_nfe_per_s=nfe32,
                                 turns_s=[t for _, t in turns],
                                 step4_f32_nfe_per_s=report["pipeline"]["guided_nfe_per_s"],
                                 gradient_cosine=cos, traj_max_abs_diff=traj_diff,
                                 reward=float(out["reward"]), f32_reward=float(out32["reward"]))


def run_bf16_rollout(report):
    """The rollout CLI under "auto" (bf16) at the closed loop's width, the
    rules path's argv (step 15) cut to 20 frames: 400 / 396 / 396 / 4
    launches in the timed episode, of bf16 `lstm2_fwd`, bf16 `lstm2_bwd`,
    `bit_gather`, `value_gather` (1 more `bit_gather` for the satisfaction
    report), agent-steps/s beside the f32 rules path's."""
    from cld_tpu_torch import rollout
    from cld_tpu_torch.ops import native

    out = ROOT / "chiprun_out" / "bf16_rollout"
    native.reset_launch_counts()
    rep = rollout.main(rules_argv(CL_SCENES, CL_AGENTS, RULES_STEPS, RASTER, N_STEPS, "cuda", out)
                       + ["--precision", "auto"])
    launches = native.launch_counts()
    n = RULES_STEPS // CL_N_STEP
    episode = counts(lstm2_fwd_bf16=N_STEPS * n, lstm2_bwd_bf16=(N_STEPS - 1) * n,
                     bit_gather=(N_STEPS - 1) * n, value_gather=n)
    check(rep["launches"] == episode, f"bf16 rollout episode launches {rep['launches']}")
    check(launches == cli_launches(episode, bit_gather=1), f"bf16 rollout launches {launches}")
    check(all(v == v for v in rep["guidance_satisfaction"].values()),
          "the bf16 rollout's satisfaction report is not finite")
    log(f"rollout CLI under auto (bf16), {CL_SCENES} x {CL_AGENTS} agents, {RULES_STEPS} frames: "
        f"{rep['agent_steps_per_sec']:.2f} agent-steps/s (f32: step 15's "
        f"{report['rules']['agent_steps_per_sec']:.2f}, earlier in the run); episode launches "
        f"{rep['launches']}")
    report["launches_bf16_rollout"] = launches
    report["bf16_rollout"] = dict(agent_steps_per_sec=rep["agent_steps_per_sec"],
                                  f32_agent_steps_per_sec=report["rules"]["agent_steps_per_sec"])


# step 23's trainers beyond the main paths: every zoo algo, both GANs and the
# EBM at batch 128, raster 224, and scene diffusion at 16 scenes x 8 agents
BF16_TRAINER_RUNS = (*((algo, reg) for reg, algo in ZOO_ALGOS.items()),
                     ("ebm", "nusc_ebm"), ("gan", "nusc_gan"),
                     ("transformer_gan", "nusc_transformer_gan"),
                     ("scene_dm", "trajdata_nusc_scene_diff"))
BF16_TRAINER_STEPS = 3  # steps 2 and 3 are timed
BF16_TURNS = ("fp32", "auto", "auto", "fp32")  # the order of the timed blocks
# the parameters the JAX modules create in their compute dtype (bf16 under bf16)
BF16_STORED = {"TransformerPred": ("hist_pos_emb", "future_queries"),
               "scene_dm": ("denoiser.time_pos_emb",)}


def step_config(name, precision):
    """A registered config at `precision`, epochs of one step, raster 224."""
    from cld_tpu_torch.utils.registry import get_registered_experiment_config

    cfg = get_registered_experiment_config(name).unlock()
    cfg.train.training.precision = precision
    cfg.train.training.steps_per_epoch = 1
    cfg.env.rasterizer.raster_size = RASTER
    return cfg.lock()


def bf16_trainer(label, cfg, dev):
    """The trainer of a `BF16_TRAINER_RUNS` label and the loss it reports."""
    from cld_tpu_torch.training import zoo
    from cld_tpu_torch.training.ebm import EBMTrainer
    from cld_tpu_torch.training.gan import GANTrainer
    from cld_tpu_torch.training.scene_dm import SceneDMTrainer

    if label in ("gan", "transformer_gan"):
        return GANTrainer(cfg, device=dev), "d_loss"
    if label == "ebm":
        return EBMTrainer(cfg, device=dev), "loss"
    if label == "scene_dm":
        return SceneDMTrainer(cfg, device=dev), "loss"
    return zoo.ZooTrainer(cfg, label, device=dev), "loss"


def run_bf16_trainers(report):
    """The zoo's eleven algos, both GANs and the EBM at batch 128, raster 224
    (synthetic batch), and scene diffusion at 16 scenes x 8 agents, each
    under "auto" (bf16 on the card) beside fp32 from the same weights,
    batch and draws: 3 train steps a block, blocks in turns fp32, bf16,
    bf16, fp32 (the host's load moves a block's time); ms per step (steps
    2-3, the mean of each precision's two blocks), peak memory of each
    block, the first step's loss (before any update; the GANs' d_loss)
    within `TRAINER_TWIN_RTOL` / atol 1e-2 of f32's, no kernel launch,
    finite losses. Under "auto"
    every network computes in bf16 except `diff`'s (float32, as the JAX
    factory builds it), and every parameter is float32 except those the JAX
    modules create in their compute dtype (`BF16_STORED`)."""
    import math

    import torch

    from cld_tpu_torch.data.scene_batch import synthetic_scene_batch
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.ops import native

    dev = torch.device("cuda", 0)
    batch = synthetic_batch(seed=0, batch_size=B, raster_size=RASTER, device=dev)
    res, total = {}, counts()
    for label, reg in BF16_TRAINER_RUNS:
        cfgs = {p: step_config(reg, p) for p in ("fp32", "auto")}
        trainers = {p: bf16_trainer(label, cfg, dev) for p, cfg in cfgs.items()}
        key = trainers["fp32"][1]
        algo = cfgs["fp32"].algo
        b = batch
        if label == "scene_dm":
            b = synthetic_scene_batch(seed=0, batch_size=B // 8, num_agents=8,
                                      hist_frames=algo.history_num_frames,
                                      horizon=algo.future_num_frames, device=dev)
        want_dtype = torch.float32 if label == "diff" else torch.bfloat16
        check(trainers["auto"][0].compute_dtype == want_dtype,
              f"{label}: auto resolved to {trainers['auto'][0].compute_dtype}")
        weights = {k: v.detach().cpu() for k, v in
                   trainers["fp32"][0].init_state(0).model.state_dict().items()}
        blocks = {"fp32": [], "auto": []}
        for p in BF16_TURNS:
            trainer = trainers[p][0]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state = trainer.init_state(0)
            state.model.load_state_dict(weights)
            if p == "auto":
                nets = {m.compute_dtype for m in state.model.modules()
                        if hasattr(m, "compute_dtype")}
                stored = BF16_STORED.get(label, ())
                check(nets == {want_dtype}, f"{label} under auto computes at {nets}")
                check(all(t.dtype == (torch.bfloat16 if k in stored else torch.float32)
                          for k, t in state.model.named_parameters()),
                      f"{label} under auto: a parameter in the wrong dtype")
            kw = {} if label == "ebm" else {
                "generator": torch.Generator(device=dev).manual_seed(7)}
            native.reset_launch_counts()
            losses, secs = [], []
            for _ in range(BF16_TRAINER_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, m = trainer.train_step(state, b, **kw)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(m[key]))
            launched = native.launch_counts()
            blocks[p].append(dict(ms=1e3 * sum(secs[1:]) / (BF16_TRAINER_STEPS - 1),
                                  losses=losses, launches=launched,
                                  peak_gb=torch.cuda.max_memory_allocated() / 1e9))
            check(all(math.isfinite(v) for v in losses), f"{label} {p}: a loss is not finite")
            check(launched == counts(), f"{label} {p} launched kernels: {launched}")
            total = {k: total[k] + launched[k] for k in total}
            del state
        r = {p: dict(ms_per_step=sum(bl["ms"] for bl in blocks[p]) / len(blocks[p]),
                     block_ms=[bl["ms"] for bl in blocks[p]],
                     peak_gb=max(bl["peak_gb"] for bl in blocks[p]),
                     first_loss=blocks[p][0]["losses"][0], losses=blocks[p][0]["losses"])
             for p in blocks}
        r["ms_ratio"] = r["auto"]["ms_per_step"] / r["fp32"]["ms_per_step"]
        r["peak_ratio"] = r["auto"]["peak_gb"] / r["fp32"]["peak_gb"]
        r["compute_dtype"] = str(want_dtype)
        res[label] = r
        log(f"{label} ({reg}) under auto ({want_dtype}): {r['auto']['ms_per_step']:.2f} ms per "
            f"step (fp32 {r['fp32']['ms_per_step']:.2f}, x{r['ms_ratio']:.3f}; blocks "
            f"{r['fp32']['block_ms'][0]:.2f} / {r['auto']['block_ms'][0]:.2f} / "
            f"{r['auto']['block_ms'][1]:.2f} / {r['fp32']['block_ms'][1]:.2f} ms), peak "
            f"{r['auto']['peak_gb']:.3f} GB (fp32 {r['fp32']['peak_gb']:.3f}, "
            f"x{r['peak_ratio']:.3f}), first {key} {r['auto']['first_loss']!r} (fp32 "
            f"{r['fp32']['first_loss']!r}), on {report['card']}")
        twin(f"{label} first step", r["auto"]["first_loss"], r["fp32"]["first_loss"],
             TRAINER_TWIN_RTOL)
        del trainers, weights
    report["launches_bf16_trainers"] = total
    report["bf16_trainers"] = res


def constant_control_policy(obs, rng):
    """Every agent at acceleration 1 and yaw rate 0.3 over the horizon."""
    import torch

    u = torch.zeros((obs.curr_speed.shape[0], 52, 2), device=obs.curr_speed.device)
    u[..., 0], u[..., 1] = 1.0, 0.3
    return u


def run_bf16_ebm_scoring(report):
    """`--ebm-ckpt`'s scoring (`sim.learned_metrics.ebm_rollout_metric`, what
    `rollout.ebm_report` runs) of a 20-frame log of 4 scenes x 8 agents at
    raster 224 under "auto" beside fp32, from the same EBM weights, timed in
    turns fp32, bf16, bf16, fp32: one render (`value_gather`) per anchor and
    nothing else per call; the bf16 scores finite, their mean beside
    f32's."""
    import math

    import torch

    from cld_tpu_torch.ops import native
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.learned_metrics import ebm_rollout_metric
    from cld_tpu_torch.sim.scene import synthetic_scene_pack
    from cld_tpu_torch.training.ebm import EBMTrainer

    dev = torch.device("cuda", 0)
    pack = synthetic_scene_pack(seed=0, num_scenes=CL_SCENES, agents_per_scene=CL_AGENTS,
                                world_map_size=WORLD_MAP, sim_steps=RULES_STEPS, device=dev)
    algo = record_config().algo
    sim_cfg = env.SimConfig(num_simulation_steps=RULES_STEPS, n_step_action=CL_N_STEP,
                            raster_size=RASTER, hist_frames=algo.history_num_frames)
    _, traj = env.simulate(pack, constant_control_policy, sim_cfg)
    scorers = {}
    weights = None
    for p in ("fp32", "auto"):
        trainer = EBMTrainer(record_config(p), device=dev)
        state = trainer.init_state(0)
        if weights is None:
            weights = state.model.state_dict()
        state.model.load_state_dict(weights)
        scorers[p] = trainer.score_fn(state)
    check(trainer.compute_dtype == torch.bfloat16, "the EBM under auto is not bf16")
    horizon = algo.horizon
    anchors = len(range(0, max(RULES_STEPS - 1, 1), EBM_STRIDE))
    secs, out, launches = {"fp32": [], "auto": []}, {}, None
    for p in BF16_TURNS:
        native.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            em = ebm_rollout_metric(pack, traj, scorers[p], sim_cfg, horizon=horizon)
        torch.cuda.synchronize()
        secs[p].append(time.perf_counter() - t0)
        out.setdefault(p, {k: float(em[k]) for k in ("ebm_score_mean", "ebm_score_min")})
        if p == "auto" and launches is None:
            launches = native.launch_counts()
    check(launches == counts(value_gather=anchors),
          f"bf16 EBM scoring launches {launches}, expected {anchors} value_gather")
    check(all(math.isfinite(v) for v in out["auto"].values()), "bf16 EBM scores not finite")
    r = dict(score_ms={p: 1e3 * sum(t) / len(t) for p, t in secs.items()}, anchors=anchors,
             scores=out)
    log(f"--ebm-ckpt scoring of a {RULES_STEPS}-frame log ({CL_B} agents, {anchors} anchors) "
        f"under auto (bf16): {r['score_ms']['auto']:.2f} ms (fp32 {r['score_ms']['fp32']:.2f}), "
        f"ebm_score_mean {out['auto']['ebm_score_mean']:.6g} (fp32 "
        f"{out['fp32']['ebm_score_mean']:.6g}); launches {launches}, on {report['card']}")
    report["launches_bf16_ebm_scoring"] = launches
    report["bf16_ebm_scoring"] = r


def run_bf16_scene_diffuser(report):
    """One `SceneDiffuser` composer replan at the closed loop's width (4
    scenes x 8 agents, raster 224, 100 diffusion steps) under "auto" beside
    fp32, from the same weights, observation and draws, timed in turns fp32,
    bf16, bf16, fp32: the composer's denoiser follows its trainer to bf16;
    the replan launches no kernel (its observation is rendered before);
    finite float32 actions, max |bf16 - f32| reported."""
    import torch

    from cld_tpu_torch.eval.composers import get_composer
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.scene import synthetic_scene_pack
    from cld_tpu_torch.training.scene_dm import SceneDMTrainer

    dev = torch.device("cuda", 0)
    cfg32 = record_config()
    pack = synthetic_scene_pack(seed=0, num_scenes=CL_SCENES, agents_per_scene=CL_AGENTS,
                                world_map_size=WORLD_MAP, sim_steps=COMPOSER_STEPS, device=dev)
    sim_cfg = env.SimConfig(num_simulation_steps=COMPOSER_STEPS, n_step_action=CL_N_STEP,
                            raster_size=RASTER, hist_frames=cfg32.algo.history_num_frames)
    obs = env.render_observation(pack, env.init_sim_state(pack, sim_cfg), sim_cfg)
    check(SceneDMTrainer(record_config("auto"), device=dev).compute_dtype == torch.bfloat16,
          "the scene trainer under auto is not bf16")
    policies = {p: get_composer("SceneDiffuser")(
        record_config(p), pack, sim_cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev) for p in ("fp32", "auto")}
    secs, actions, launches = {"fp32": [], "auto": []}, {}, None
    for p in BF16_TURNS:
        native.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        act = policies[p](obs, torch.Generator(device=dev).manual_seed(3))
        torch.cuda.synchronize()
        secs[p].append(time.perf_counter() - t0)
        actions.setdefault(p, act)
        if p == "auto" and launches is None:
            launches = native.launch_counts()
    a16, a32 = actions["auto"], actions["fp32"]
    check(launches == counts(), f"bf16 SceneDiffuser replan launches {launches}")
    check(a16.positions.dtype == torch.float32 and bool(torch.isfinite(a16.positions).all()),
          "the bf16 SceneDiffuser actions are not finite float32")
    diff = float((a16.positions - a32.positions).abs().max())
    scale = float(a32.positions.abs().max())
    r = dict(replan_s={p: sum(t) / len(t) for p, t in secs.items()}, positions_max_diff_m=diff,
             positions_max_abs_m=scale)
    log(f"SceneDiffuser replan ({CL_SCENES} x {CL_AGENTS} agents, "
        f"{cfg32.algo.n_diffusion_steps} steps) under auto (bf16): {r['replan_s']['auto']:.3f} s "
        f"(fp32 {r['replan_s']['fp32']:.3f}); positions max |bf16 - f32| {diff:.4f} m of a "
        f"largest |f32| {scale:.4f} m (random weights); launches {launches}, on "
        f"{report['card']}")
    report["launches_bf16_scene_diffuser"] = launches
    report["bf16_scene_diffuser"] = r


def run_bf16(models32, kernels, report):
    """Step 23: the bf16 LSTM kernels, the three stages, the guided call,
    the rollout CLI, the other trainers, the EBM's scoring and the
    SceneDiffuser composer under bf16 mixed precision."""
    t0 = time.perf_counter()
    check_lstm_bf16(kernels)
    run_bf16_stages(report)
    run_bf16_cli(report)
    run_bf16_guided(models32, report)
    run_bf16_rollout(report)
    run_bf16_trainers(report)
    run_bf16_ebm_scoring(report)
    run_bf16_scene_diffuser(report)
    report["bf16_s"] = time.perf_counter() - t0
    log(f"step 23 (bf16) in {report['bf16_s']:.1f} s")


# ---------------------------------------------------------------------------
# step 24: the LSTM decoder kernels at every hidden size (H 1-320)
# ---------------------------------------------------------------------------

WIDE_H = 128  # the decoder width of step 24's guided calls
# (H, B, T) at which both sweeps are held in f32 and bf16: padded onto the H <= 64
# kernels (1, 5, 50) and onto `lstm_wide.cu` (72 ... 320), B ragged against the
# cluster's 8 rows; cluster 8 and 16 in both dtypes, f32's weights read from
# global memory at 256 and 320
WIDE_HELD = ((1, 5, 7), (5, 9, 6), (50, 13, 5), (72, 5, 7), (96, 17, 4), (128, 3, 9),
             (200, 11, 5), (256, 9, 4), (320, 13, 6))
WIDE_TIMED_H = (128, 320)


def cudnn_lstm_ms(Hn, dt, args, dy, g, dev):
    """cuDNN's two-layer `nn.LSTM` at hidden Hn in dtype dt from random z
    [B, T, L] (its own weights; it also does the input projection): forward
    ms, and backward ms (train mode, grads of input, h0 and weights; forward
    + backward - forward) beside the port's whole `Lstm2Core` VJP timed the
    same way."""
    import torch

    from cld_tpu_torch.ops import lstm_kernels as lk

    Bn = args[0].shape[0]
    cudnn = torch.nn.LSTM(L, Hn, num_layers=2, batch_first=True).to(dev).to(dt)
    z = torch.randn((Bn, T, L), generator=g).to(dev).to(dt)
    hc = (args[1][None].expand(2, Bn, Hn).contiguous(), torch.zeros((2, Bn, Hn), device=dev,
                                                                     dtype=dt))
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: cudnn(z, hc), 10)
    zr = z.clone().requires_grad_(True)
    h0r = hc[0].clone().requires_grad_(True)
    lib_in = (zr, h0r, *cudnn.parameters())
    lib_fwd = lambda: cudnn(zr, (h0r, hc[1]))[0]
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_fwd(), lib_in, dy), 10)
    core_in = [a.detach().clone().requires_grad_(True) for a in args]
    core_fwd = lambda: lk.lstm2_core(*core_in)
    vjp_ms = cuda_ms(lambda: torch.autograd.grad(core_fwd(), core_in, dy), 10)
    return fwd_ms, bwd_ms - cuda_ms(lib_fwd, 10), vjp_ms - cuda_ms(core_fwd, 10)


def cudnn_graph_ms(Hn, args, dy, g, dev) -> dict:
    """cuDNN's two-layer `nn.LSTM` at hidden Hn from random z [B, T, L] in
    the inputs' dtype (its own weights; it also does the input projection),
    from a CUDA graph: in f32 with TF32 on (PyTorch's default for cuDNN) and
    off, {"tf32_on" | "tf32_off": {"fwd_ms", "bwd_ms"}}; in bf16 {"bf16":
    {...}}; the backward as (train-mode forward + backward, grads of z, h0
    and the weights) - train-mode forward."""
    import torch

    Bn, dt = args[0].shape[0], args[0].dtype
    cudnn = torch.nn.LSTM(L, Hn, num_layers=2, batch_first=True).to(dev).to(dt)
    z = torch.randn((Bn, T, L), generator=g).to(dev).to(dt)
    h0 = args[1][None].expand(2, Bn, Hn).contiguous()
    c0 = torch.zeros_like(h0)
    zr, h0r = z.clone().requires_grad_(True), h0.clone().requires_grad_(True)
    wrt = (zr, h0r, *cudnn.parameters())
    train = lambda: cudnn(zr, (h0r, c0))[0]
    out = {}
    kept = torch.backends.cudnn.allow_tf32
    modes = (("tf32_on", True), ("tf32_off", False)) if dt == torch.float32 else (("bf16", kept),)
    try:
        for key, tf32 in modes:
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.no_grad():
                fwd = graph_ms(lambda: cudnn(z, (h0, c0)), 5, 10)
            both = graph_ms(lambda: torch.autograd.grad(train(), wrt, dy), 5, 10)
            out[key] = dict(fwd_ms=fwd, bwd_ms=both - graph_ms(train, 5, 10))
    finally:
        torch.backends.cudnn.allow_tf32 = kept
    return out


def hold_wide_fwd(args) -> float:
    """The f32 forward against its plain version (within `LSTM_REL_TOL` of
    max |plain|) and a relaunch (bit-equal); returns the relative error."""
    import torch

    from cld_tpu_torch.ops import lstm_kernels as lk

    got, again, want = lk.lstm2_fwd(*args), lk.lstm2_fwd(*args), lk.lstm2_core_ref(*args)
    torch.cuda.synchronize()
    rel = max(rel_err(a, b)[1] for a, b in zip(got, want))
    shape = "B/T/H {}/{}/{}".format(*args[0].shape[:2], args[1].shape[-1])
    check(rel <= LSTM_REL_TOL, f"lstm2_fwd disagrees with its plain version at {shape}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"two lstm2_fwd launches differ at {shape}")
    return rel


def hold_wide_bwd(bargs, tol) -> float:
    """The wide reverse sweep against its plain version (within `tol` of max
    |plain|) and a relaunch (bit-equal), at the rows a cluster its chain
    chose; returns the relative error."""
    import torch

    from cld_tpu_torch.ops import lstm_kernels as lk

    got, again, want = lk.lstm2_bwd(*bargs), lk.lstm2_bwd(*bargs), lk.lstm2_bwd_ref(*bargs)
    torch.cuda.synchronize()
    rel = max(rel_err(a.float(), b.float())[1] for a, b in zip(got, want))
    shape = "B/T/H {}/{}/{} {}".format(*bargs[0].shape, bargs[0].dtype)
    check(rel <= tol, f"lstm2_bwd disagrees with its plain version at {shape}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"two lstm2_bwd launches differ at {shape}")
    return rel


def check_wide_kernels(kernels):
    """Both sweeps in both storage types at `WIDE_HELD`, then the wide
    kernels' attributes and times at H = 128 and 320 (B = 32, 128, 512, T =
    52) beside the plain versions and cuDNN (the f32 forward and both
    reverse sweeps held again at each B, where their rows a cluster change;
    the reverse sweep's gates / chain split from graph replays at B = 128;
    cuDNN also from a graph, f32 with TF32 on and off, and bf16); fills
    kernels[<wide name>]."""
    import torch

    from cld_tpu_torch.ops import lstm_kernels as lk

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(24)
    for dt in (torch.float32, torch.bfloat16):
        sfx = "" if dt == torch.float32 else "_bf16"
        hold = hold_lstm if dt == torch.float32 else hold_lstm_bf16
        elem, peak = (4, F32_FLOPS_PER_S) if dt == torch.float32 else (2, BF16_FLOPS_PER_S)
        held = {}
        for Hn, Bn, Tn in WIDE_HELD:
            a, d = lstm_inputs(g, Bn, Tn, Hn, dev)
            _, held[f"{Bn}/{Tn}/{Hn}"] = hold(tuple(x.to(dt) for x in a), d.to(dt))
        attrs = {}
        for Hn in WIDE_TIMED_H:
            gates = ("lstm2_wide_gates_mma_kernel" if dt == torch.bfloat16
                     else "lstm2_wide_gates_f32_kernel")
            for which, kname in enumerate(("lstm2_wide_fwd_kernel", gates,
                                           "lstm2_wide_chain_kernel")):
                f32_fwd = which == 0 and dt == torch.float32
                rows = (lk.WIDE_ROWS if f32_fwd or which == 2 else (1,))
                for R in rows:
                    if which == 2 and lk.wide_chain_plan(dev, Hn, R, dt) is None:
                        log(f"{kname} H={Hn} {dt}: no plan at {R} rows a cluster")
                        continue
                    at = lk.kernel_attributes(which, Hn, R, dtype=dt)
                    name = f"lstm2_wide_fwd_f32_kernel<{R}> H={Hn}" if f32_fwd else (
                        f"{kname}<{R}> H={Hn}" if which == 2 else f"{kname} H={Hn}")
                    attrs[name] = at
                    where = ("in registers" if which == 2 and dt == torch.bfloat16 else
                             f"{at['resident_rows']} of {4 * Hn // at['cluster']} rows in shared "
                             "memory" if which == 2 else "in shared memory" if at["resident"]
                             else "read from global memory")
                    grid = (f"cluster {at['cluster']} (weights {where}, "
                            f"{at['max_active_clusters']} clusters at once)" if which != 1
                            else "no cluster")
                    log(f"{name} {dt}: {at['registers']} registers, {at['local_bytes']} "
                        f"bytes of local memory per thread, {at['shared_bytes']} bytes of "
                        f"shared memory, {at['threads']} threads, {grid}")
        timed = {}
        for Hn in WIDE_TIMED_H:
            for Bn in (CL_B, B, 512):
                a, d = lstm_inputs(g, Bn, T, Hn, dev)
                a, d = tuple(x.to(dt) for x in a), d.to(dt)
                y, h1s, c1s, c2s = lk.lstm2_fwd(*a)
                ba = (d, *a, h1s, c1s, y, c2s)
                row = dict(fwd_graph_ms=graph_ms(lambda: lk.lstm2_fwd(*a), 5, 4),
                           bwd_graph_ms=graph_ms(lambda: lk.lstm2_bwd(*ba), 5, 4),
                           bwd_rows=lk.wide_bwd_plan(Bn, Hn, dt, dev).rows,
                           bwd_rel_err=hold_wide_bwd(ba, LSTM_REL_TOL if dt == torch.float32
                                                     else BF16_REL_TOL))
                if dt == torch.float32:  # the redesigned forward: its plan, held at each B
                    plan = lk.wide_f32_plan(Bn, Hn, dev)
                    row.update(fwd_rows=plan.rows, fwd_chunks=plan.chunks,
                               fwd_resident=plan.resident, fwd_rel_err=hold_wide_fwd(a))
                if Bn == B:  # the main path's shape: held, timed beside the plain versions
                    bargs, e = hold(a, d)
                    row.update(err=e, fwd_ms=cuda_ms(lambda: lk.lstm2_fwd(*a), 10),
                               bwd_ms=cuda_ms(lambda: lk.lstm2_bwd(*ba), 10),
                               fwd_plain_ms=cuda_ms(lambda: lk.lstm2_core_ref(*a), 2),
                               bwd_plain_ms=cuda_ms(lambda: lk.lstm2_bwd_ref(*bargs), 2))
                    row["cudnn_fwd_ms"], row["cudnn_bwd_ms"], row["vjp_ms"] = cudnn_lstm_ms(
                        Hn, dt, a, d, g, dev)
                    row["cudnn_graph"] = cudnn_graph_ms(Hn, a, d, g, dev)
                    row["bwd_split"] = sweep_split(graph_kernel_ms(lambda: lk.lstm2_bwd(*ba)))
                    (row["fwd_bound_ms"], row["fwd_bound_by"]), (
                        row["bwd_bound_ms"], row["bwd_bound_by"]) = lstm_bounds(B, T, Hn, elem,
                                                                                peak)
                timed[(Hn, Bn)] = row
            r = timed[(Hn, B)]
            graphs = ", ".join(f"{Bn}: fwd {timed[(Hn, Bn)]['fwd_graph_ms']:.4f}, bwd "
                               f"{timed[(Hn, Bn)]['bwd_graph_ms']:.4f}" for Bn in (CL_B, B, 512))
            log(f"wide LSTM {dt} H={Hn}, T={T}, from a CUDA graph (weight pack included), ms "
                f"at B={graphs}; at B={B} from Python fwd {r['fwd_ms']:.4f} / bwd "
                f"{r['bwd_ms']:.4f}, plain {r['fwd_plain_ms']:.3f} / {r['bwd_plain_ms']:.3f}, "
                f"cuDNN nn.LSTM forward "
                f"{r['cudnn_fwd_ms']:.4f} / backward {r['cudnn_bwd_ms']:.4f} (the Lstm2Core VJP "
                f"{r['vjp_ms']:.4f}), bound {r['fwd_bound_ms']:.5f} ({r['fwd_bound_by']}) / "
                f"{r['bwd_bound_ms']:.5f} ({r['bwd_bound_by']})")
            cg = r["cudnn_graph"]
            split = ", ".join(f"{k} {v:.4f}" for k, v in r["bwd_split"].items()) or "not measured"
            log(f"cuDNN nn.LSTM {dt} H={Hn} B={B} from a CUDA graph (fwd / bwd ms): " + ", ".join(
                f"{k} {v['fwd_ms']:.4f} / {v['bwd_ms']:.4f}" for k, v in cg.items()) +
                f"; the reverse sweep's split (graph replays, ms): {split}; its chain's rows a "
                "cluster at B=" + ", ".join(f"{Bn}: {timed[(Hn, Bn)]['bwd_rows']} (held at "
                                            f"{timed[(Hn, Bn)]['bwd_rel_err']:.2e})"
                                            for Bn in (CL_B, B, 512)))
            if dt == torch.float32:
                log("the f32 forward's rows a cluster at B=" + ", ".join(
                    f"{Bn}: {timed[(Hn, Bn)]['fwd_rows']}" for Bn in (CL_B, B, 512)))
        for k in ("fwd", "bwd"):
            r = timed[(WIDE_H, B)]
            kernels[f"lstm2_{k}_wide{sfx}"] = dict(
                max_abs_err=r["err"][f"{k}_abs"], max_rel_err=r["err"][f"{k}_rel"],
                ms=r[f"{k}_ms"], plain_ms=r[f"{k}_plain_ms"], bound_ms=r[f"{k}_bound_ms"],
                bound_by=r[f"{k}_bound_by"], library_ms=r[f"cudnn_{k}_ms"],
                library_graph_ms=({t: v[f"{k}_ms"] for t, v in r["cudnn_graph"].items()}
                                  if "cudnn_graph" in r else None),
                graph_ms={str(Bn): timed[(WIDE_H, Bn)][f"{k}_graph_ms"]
                          for Bn in (CL_B, B, 512)},
                split=(timed[(WIDE_H, B)].get("bwd_split") if k == "bwd" else None),
                by_hidden={str(Hn): {str(Bn): {kk: v for kk, v in timed[(Hn, Bn)].items()
                                               if kk.startswith(k) or kk in ("err", "vjp_ms")
                                               or kk.startswith("cudnn_")}
                                     for Bn in (CL_B, B, 512)} for Hn in WIDE_TIMED_H},
                held={s: {kk: v for kk, v in e.items() if kk.startswith(k)}
                      for s, e in held.items()},
                attributes={kk: v for kk, v in attrs.items()
                            if ("fwd" in kk) == (k == "fwd")})


def run_wide_guided(report):
    """The guided call with a hidden-128 decoder under "auto" (bf16) and
    fp32, fresh weights from seed 0: exact launches, finite outputs, NFE/s
    (the counted call's second run), and one guidance step's gradient bf16
    against fp32 (the same latent and conditioning)."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.guidance import perturbation as gp
    from cld_tpu_torch.models.vae import convert_action_to_state_and_action, decode_actions
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.ops.normalization import TrajNormalizer

    dev = torch.device("cuda", 0)
    batch = synthetic_batch(seed=0, batch_size=B, raster_size=RASTER, device=dev)
    g = torch.Generator(device=dev)
    models, nfe = {}, {}
    for precision, sfx in (("auto", "_bf16"), ("fp32", "")):
        m = pipeline.build_models(seed=0, device=dev, hidden_size=WIDE_H, precision=precision)
        want_dt = torch.bfloat16 if precision == "auto" else torch.float32
        check(m.compute_dtype == want_dt, f"{precision} resolved to {m.compute_dtype}")
        native.reset_launch_counts()
        out = pipeline.guided_collect(m, batch, agents_per_scene=AGENTS_PER_SCENE,
                                      generator=g.manual_seed(10))
        torch.cuda.synchronize()
        launches = native.launch_counts()
        want = counts(**{f"lstm2_fwd_wide{sfx}": N_STEPS, f"lstm2_bwd_wide{sfx}": N_STEPS - 1},
                      bit_gather=N_STEPS - 1, offroad_count=1)
        check(launches == want, f"hidden-{WIDE_H} guided ({precision}) launches {launches}, "
              f"expected {want}")
        for k in ("pred_traj", "traj", "reward_per_agent"):
            check(bool(torch.isfinite(out[k]).all()), f"hidden-{WIDE_H} guided {k} not finite")
        check(tuple(out["traj"].shape) == (B, 1, T, 6), f"traj shape {tuple(out['traj'].shape)}")
        report[f"launches_wide_guided{sfx or '_fp32'}"] = launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.guided_collect(m, batch, agents_per_scene=AGENTS_PER_SCENE,
                                generator=g.manual_seed(11))
        torch.cuda.synchronize()
        nfe[precision] = B * N_STEPS / (time.perf_counter() - t0)
        models[precision] = m

    wfa, scene = pipeline.scene_world_poses(B, AGENTS_PER_SCENE, dev)
    ctx = gl.prepack_drivable(gl.GuidanceContext(
        drivable_map=batch.drivable_map, raster_from_agent=batch.raster_from_agent,
        extent=batch.extent, curr_speed=batch.curr_speed, world_from_agent=wfa,
        scene_index=scene))
    specs = pipeline.flagship_guidance_specs(AGENTS_PER_SCENE)
    with torch.no_grad():
        aux = models["fp32"].context(batch)
    z = torch.randn((B, T, L), generator=torch.Generator(device=dev).manual_seed(12), device=dev)

    def gradient(m):
        def decode_fn(v):
            acts = decode_actions(m.decoder, v, aux["cond_feat"])
            traj = convert_action_to_state_and_action(acts, aux["curr_states"], m.dyn,
                                                      TrajNormalizer(), descaled_output=True)
            return traj[:, None]

        return gp.guidance_gradient(z, ctx, specs, decode_fn)

    cos = cosine(gradient(models["auto"]), gradient(models["fp32"]))
    h64 = report.get("bf16_guided", {})
    nan = float("nan")
    log(f"hidden-{WIDE_H} guided call at B={B}: bf16 {nfe['auto']:.1f} NFE/s, fp32 "
        f"{nfe['fp32']:.1f} NFE/s (H={H}: step 23's bf16 {h64.get('nfe_per_s', nan):.1f}, "
        f"f32 {h64.get('f32_nfe_per_s', nan):.1f}; no claim), one step's guidance "
        f"gradient bf16 vs fp32 cosine {cos:.6f}, on {report['card']}")
    check(cos > TWIN_COSINE, f"hidden-{WIDE_H} bf16 guidance gradient cosine {cos} against fp32")
    report["wide_guided"] = dict(hidden=WIDE_H, bf16_nfe_per_s=nfe["auto"],
                                 fp32_nfe_per_s=nfe["fp32"], gradient_cosine=cos,
                                 h64_bf16_nfe_per_s=h64.get("nfe_per_s"),
                                 h64_fp32_nfe_per_s=h64.get("f32_nfe_per_s"))


def run_dma_probe(kernels, report):
    """The bulk-copy probe through its entry point: its four cases equal to
    2 x bit for bit (4 launches), then its time from a CUDA graph at the
    batch-slice case of minor 128 beside `2 * x` and its bound."""
    import torch

    from cld_tpu_torch import dma_probe
    from cld_tpu_torch.ops import native

    native.reset_launch_counts()
    rc = dma_probe.main([])
    torch.cuda.synchronize()
    launches = native.launch_counts()
    check(rc == 0, "the bulk-copy probe's output is not 2 x bit for bit")
    check(launches == counts(dma_probe=len(dma_probe.CASES)), f"dma probe launches {launches}")
    report["launches_dma_probe"] = launches
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape = dma_probe.copy_shape(128, True, sms)
    check(shape["ctas"] > sms, f"dma probe at [{T}, {dma_probe.B}, 128]: {shape['ctas']} CTAs "
          f"on {sms} SMs")
    x = dma_probe.probe_input(128, True, torch.device("cuda", 0))
    out = dma_probe.bulk_double(x)
    err = float((out.float() - 2 * x.float()).abs().max())
    regs, local, threads, smem = native.attributes(native.library().cld_dma_probe_attributes,
                                                   n=4)
    nbytes = 2 * x.numel() * x.element_size()
    b_ms, b_by = bound(nbytes, float(x.numel()))
    kernels["dma_probe"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: dma_probe.bulk_double(x), 50),
        plain_ms=cuda_ms(lambda: 2 * x, 50), bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.mul(x, 2), 50),
        graph_ms=graph_ms(lambda: dma_probe.bulk_double(x)),
        plain_graph_ms=graph_ms(lambda: 2 * x), cases=dma_probe.run_cases(x.device),
        attributes=dict(registers=regs, local_bytes=local, max_threads=threads,
                        static_shared_bytes=smem))
    k = kernels["dma_probe"]
    log(f"dma probe [{T}, {dma_probe.B}, 128] bf16 (the batch-slice case): "
        f"{k['graph_ms']:.5f} ms from a CUDA graph ({k['ms']:.4f} from Python) beside 2 * x "
        f"{k['plain_graph_ms']:.5f} ({k['plain_ms']:.4f}), bound {b_ms:.5f} ({b_by}; target "
        f"2x the bound, {2 * b_ms:.5f}); {shape['ctas']} CTAs x {shape['copies_per_cta']} bulk "
        f"copies of {shape['bytes_per_copy']} B on {sms} SMs; {regs} registers, {local} bytes "
        "of local memory")


def run_wide(kernels, report):
    """Step 24: the LSTM kernels at H 1-320, the hidden-128 guided calls, the
    small slice at H = 128, the bulk-copy probe."""
    import torch

    t0 = time.perf_counter()
    check_wide_kernels(kernels)
    run_wide_guided(report)
    check_small_slice(torch.device("cuda", 0), report, hidden=WIDE_H)
    run_dma_probe(kernels, report)
    report["wide_s"] = time.perf_counter() - t0
    log(f"step 24 (hidden sizes 1-320, the bulk-copy probe) in {report['wide_s']:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke test needs a CUDA card")
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from cld_tpu_torch import pipeline
        from cld_tpu_torch.data.synthetic import synthetic_batch
        from cld_tpu_torch.eval.composers import COMPOSER_REGISTRY
        from cld_tpu_torch.ops import native
        from cld_tpu_torch.sim.scene import synthetic_scene_pack
    except ImportError as e:
        log(f"FAIL: the cld_tpu_torch package is not beside this script: {e}")
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    native.library()
    report["build_s"] = time.perf_counter() - t0
    t_start = t0
    log(f"kernels built and loaded in {report['build_s']:.1f} s: {native.library_path().name}")

    t0 = time.perf_counter()
    models = pipeline.build_models(seed=0, device=dev, precision="fp32")
    batch = synthetic_batch(seed=0, batch_size=B, raster_size=RASTER, device=dev)
    torch.cuda.synchronize()
    log(f"models + synthetic batch (B={B}, {RASTER}x{RASTER}x{batch.image.shape[-1]}) "
        f"in {time.perf_counter() - t0:.1f} s")

    kernels = {}
    check_lstm(models, dev, kernels)
    check_gather(batch, dev, kernels)
    check_rigid(batch, dev, kernels)
    check_reward_kernels(batch, dev, kernels)
    run_main_path(models, batch, report)
    run_rigid_paths(models, batch, report)
    check_rigid_agreement(models, batch, dev, report)
    check_small_slice(dev, report)
    check_small_slice(dev, report, min_dist_impl="rigid_kernel")
    cfg, dm_tr, dm_state = run_training(batch, dev, report)
    traj = run_ppo(cfg, dm_tr, dm_state, batch, dev, report)
    run_ppo_disk_penalty(traj, batch, dev, report, kernels)
    check_small_training(dev, report)
    del batch, dm_tr, dm_state
    torch.cuda.empty_cache()

    pack = synthetic_scene_pack(seed=0, num_scenes=CL_SCENES, agents_per_scene=CL_AGENTS,
                                world_map_size=WORLD_MAP, sim_steps=CL_STEPS, device=dev)
    check_map_gathers(dev, kernels)
    check_warp(pack, dev, report)
    run_closed_loop(models, pack, report)
    run_px_replan(models, pack, report)
    run_rigid_replan(models, pack, report)
    check_small_closed_loop(dev, report)
    del pack
    run_rules_path(report)
    check_rules_replan(dev, report)
    run_checkpoint_path(report)
    run_data_path(report)
    run_bf16(models, kernels, report)
    run_wide(kernels, report)

    replaces = {
        "lstm2_fwd": ("cld_tpu_torch/csrc/lstm.cu", "cld_tpu/ops/lstm_pallas.py:169"),
        "lstm2_bwd": ("cld_tpu_torch/csrc/lstm.cu", "cld_tpu/ops/lstm_pallas.py:312"),
        "lstm2_fwd_bf16": ("cld_tpu_torch/csrc/lstm_bf16.cu", "cld_tpu/ops/lstm_pallas.py:169"),
        "lstm2_bwd_bf16": ("cld_tpu_torch/csrc/lstm_bf16.cu",
                           "cld_tpu/ops/lstm_pallas.py:312"),
        "bit_gather": ("cld_tpu_torch/csrc/bit_gather.cu", "cld_tpu/ops/pallas_kernels.py:179"),
        "value_gather": ("cld_tpu_torch/csrc/value_gather.cu",
                         "cld_tpu/ops/pallas_kernels.py:291"),
        "drivable_gather": ("cld_tpu_torch/csrc/drivable_gather.cu",
                            "cld_tpu/ops/pallas_kernels.py:102"),
        "rigid_min": ("cld_tpu_torch/csrc/rigid_min.cu", "cld_tpu/ops/pallas_kernels.py:471"),
        "rigid_min_fused": ("cld_tpu_torch/csrc/rigid_min.cu",
                            "cld_tpu/ops/pallas_kernels.py:404"),
        "rigid_bwd": ("cld_tpu_torch/csrc/rigid_bwd.cu", "cld_tpu/ops/pallas_kernels.py:541"),
        "offroad_count": ("cld_tpu_torch/csrc/offroad_count.cu",
                          "cld_tpu/ops/pallas_kernels.py:41"),
        "disk_collision": ("cld_tpu_torch/csrc/disk_collision.cu",
                           "cld_tpu/ops/pallas_kernels.py:617"),
        **{f"lstm2_{k}_wide{sfx}": ("cld_tpu_torch/csrc/lstm_wide.cu",
                                    f"cld_tpu/ops/lstm_pallas.py:{line}")
           for k, line in (("fwd", 169), ("bwd", 312)) for sfx in ("", "_bf16")},
        "dma_probe": ("cld_tpu_torch/csrc/dma_probe.cu", "scripts/micro_dma_probe.py:38"),
    }
    paths = {"open_loop": "launches", "closed_loop": "launches_closed_loop",
             "px_replan": "launches_px_replan", "rigid_open_loop": "launches_rigid_kernel",
             "fused_open_loop": "launches_fused",
             "rigid_open_loop_16x16": "launches_rigid_kernel_16x16",
             "fused_open_loop_16x16": "launches_fused_16x16",
             "rigid_replan": "launches_rigid_replan",
             "vae_train": "launches_vae_train", "dm_train": "launches_dm_train",
             "ppo": "launches_ppo", "ppo_disk_penalty": "launches_ppo_disk_penalty",
             "rules": "launches_rules", "checkpoint_rollout": "launches_checkpoint_rollout",
             "evaluate": "launches_evaluate", "data_train": "launches_data_train",
             "scene_data_rollout": "launches_scene_data_rollout", "zoo": "launches_zoo",
             **{f"policy_{p}": f"launches_{p}" for p in MODEL_FREE},
             **{f"{label}_train": f"launches_{label}_train" for _, _, label in LEARNED_RUNS},
             "ebm_rollout": "launches_ebm_rollout", "scene_policy": "launches_scene_policy",
             "latent_attack": "launches_latent_attack",
             **{f"composer_{c}": f"launches_composer_{c}" for c in sorted(COMPOSER_REGISTRY)},
             "composer_ckpt": "launches_composer_ckpt",
             "composer_trace": "launches_composer_trace",
             **{f"bf16_{p}": f"launches_bf16_{p}" for p in BF16_PATHS},
             "wide_guided_bf16": "launches_wide_guided_bf16",
             "wide_guided_fp32": "launches_wide_guided_fp32", "dma_probe": "launches_dma_probe"}
    # the launch floor: one kernel node of a graph that does nothing (one
    # thread that exits at once), timed as every kernel's graph_ms is
    floor_ms = graph_ms(lambda: torch.cuda._sleep(0))
    report["launch_floor_ms"] = floor_ms
    log(f"launch floor (torch.cuda._sleep(0) from a CUDA graph): {floor_ms:.5f} ms")
    line = []
    for name, (src, rep) in replaces.items():
        k = kernels[name]
        k_graph = k["graph_ms"][str(B)] if isinstance(k["graph_ms"], dict) else k["graph_ms"]
        line.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(report[p][name] for p in paths.values()),
            "launches_by_path": {path: report[p][name] for path, p in paths.items()},
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "graph_ms": k_graph, "launch_floor_ms": floor_ms,
        })
    report["kernels"] = kernels
    check(len(line) == len(native.KERNELS), "a kernel is missing from the kernels line")
    for k in line:
        check(k["launches"] > 0, f"kernel {k['name']} was launched by no main-path run")
    report["total_s"] = time.perf_counter() - t_start
    log(f"all checks passed in {report['total_s']:.1f} s (build included)")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
