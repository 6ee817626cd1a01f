#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

Run from the root of a checkout. It drives only the port
(vae_posterior_consistency_tpu_torch), never JAX, in these phases:

1. environment: the card's name and power limit, torch and CUDA versions,
   the number of cards visible; TF32 off for every comparison;
2. build: every kernel in vae_posterior_consistency_tpu_torch/csrc/ with
   nvcc (plain C interface, loaded with ctypes), all sources at once;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the serving and training paths give it and beyond them (three masks, 64
   features; and at the wine width, D=13, S=1 and 2, B=64 and 17, and the
   active-learning episode's S=1, B=10200): B2f
   (embed+pool forward), B2b (its backward, with and without the dmasks
   output), B1 (the posterior tail's forward, one launch of one
   block at every size) and B1's backward (strided
   statistics, dense and expanded cotangents, with and without the eps
   gradients); the same bits on two calls for each; and each autograd
   Function's gradients against autograd through the plain forward;
4. serving: the trained MNIST reg_EDDI1 checkpoint in the repo (reference
   state_dict, mapped by the port) behind ImputationServer(device="cuda"),
   imputing the 179 MNIST test rows in requests of 1, 8, 64 and 179 rows.
   Observed cells must come back unchanged and every output finite; B2f's
   launch count must rise by one per request; a CPU server (the kernels'
   plain versions) fed the same noise must agree; the trained model must
   beat filling each missing cell with its column's observed mean;
5. one HTTP round trip to the server on a free port;
6. training, MNIST reg_EDDI1 / kl_reg at full width on the 1618 training
   rows, batch 64: (a) the first step's loss and gradients on the card
   against the CPU (plain versions) from the same parameters, batch and
   recorded noise; (b) engine/train.train for 3 epochs (78 steps), each of
   B1, its backward, B2f and B2b launched exactly once a step and no plain
   version run on a CUDA tensor, every loss finite, the loss falling; (c)
   the saved checkpoint loaded back and served;
7. training on Data/wine split 1, batch 64, 30 epochs each, no plain
   version on a CUDA tensor, every loss finite, the loss falling: (a) the
   flagship reg_vae1 / kl_reg, B1 and its backward once a step, the
   embed+pool kernels never; (b) the flow posterior reg_flow1 / kl_reg at
   its records' width (hid_dim 500, latent 10, missing_rate 30): its first
   step's loss and gradients on the card against the CPU from the same
   parameters, batch and recorded noise, then 30 epochs, no kernel
   launched; (c) vanilla_EDDI1_with_drop (missing_rate 30): the EDDI drop
   mask drawn on the card once a step, B2f and B2b each launched once a
   step at S=1, D=13, B1 never; (d) the importance-weighted record 1,
   reg_MIWAE1 / kl_reg, at its widths (encoder 13-128-128-20, Student-t
   decoder 10-128-128-39) and train_k=20: its first step's loss and
   gradients on the card against the CPU, then 30 epochs, no kernel
   launched; (e) the first steps of notMIWAE, card against CPU:
   vanilla_notMIWAE1 ('changed' and 'author') and reg_notMIWAE1 ('v2',
   'both_s', 'sampled_mask');
8. evaluation, engine/evaluate.eval_vae over both splits: (a) the MNIST
   reg_EDDI1 checkpoint in the repo at full width, M=1, batch 64 (26 train
   and 3 test batches, the last 51 rows padded to 64): B2f launched once a
   batch at S=1, nothing else, no plain version on a CUDA tensor; the
   metrics against a CPU eval_vae (plain versions) fed the card's recorded
   noise; the test RMSE below the column-mean fill, printed beside the
   committed artifact's; (b) the wine reg_vae1 of phase 7 at M=50 (50 reps
   of 3 train and 1 test batches): no kernel launched, the metrics against
   the CPU's in the same way; (c) the wall-clock of each split on the host
   clock, with a sync at each end, and the device operations of one split
   of one batch from torch.profiler ("not measured" where no trace was
   whole); (d) the reg_flow1 of phase 7 at record 12's M=50: no kernel,
   the metrics against the CPU's in the same way, the wall-clock of each
   split; (e) the reg_MIWAE1 of phase 7 (d) at record 1's valid_k=5000
   importance samples and M=1: no kernel, the metrics on the 17-row test
   split against the CPU's in the same way, the wall-clock of each split,
   the peak device memory of the train split's evaluation, and the device's
   busy share and top operations over one batch of 64 rows under
   torch.profiler ("not measured" where the trace holds no device event);
9. timings with CUDA events and the host clock: B2f and B2b as the serving
   and training paths launch them (`EmbedPool.forward` on A and C [D, K],
   `EmbedPool.backward` for A and C only), the standalone `embed_pool_bwd`,
   B2f at the evaluation shape (S=1, B=64), B2f and B2b at the wine
   `_with_drop` training shape (S=1, B=64, D=13), one shape where the bytes
   and not the launch set the time (S=2, B=4096), B1
   (`fused_posterior_kernel`) and its backward as the step calls it
   (`FusedPosterior.backward` for the four statistics, through autograd),
   at [64, 10] and at a diagnostic [4096, 10]; IW1 at record 4's
   evaluation batches [64, 5000] and [17, 5000], and IW2 at the MNAR
   records' [178, 10000] and an eval_vae batch's [64, 10000], each against
   its plain version first; each figure with
   the number of device operations one call makes, counted in a CUDA graph
   captured from one call, which must be 1 for each B1 kernel and 2 for
   IW1 and IW2;
10. serving (b), every family at the wine width (D=13) from seeded
   parameters, buckets 1, 8 and 64: vanilla_MIWAE1 and record 1's
   reg_MIWAE1 at its valid_k=5000 importance samples a row,
   vanilla_notMIWAE1 at the same valid_k, and record 10's reg_flow1 with
   ActNorm (non-identity affines): observed cells unchanged, every output
   finite, IW1 once a request of a MIWAE type and IW2 of the notMIWAE one
   and no other kernel launched, no plain version on a CUDA tensor; a CPU
   server fed the card's recorded noise must agree; the p50 latency of a
   request of 64 rows and the peak device memory of each;
11. MNAR evaluation (a): engine/evaluate.eval_vae_mnar on the 178 rows of
   the MNAR wine table (data_loader_mnar: rows permuted, target column
   dropped) for both records of Data/imputation_args_mnar.json
   (vanilla_notMIWAE1, reg_notMIWAE1) from seeded parameters, at M=2 and
   valid_k cut from 10000 to 500: IW2 once a rep and no other kernel, the
   RMSE against a CPU eval_vae_mnar fed the card's recorded noise;
12. MNAR grid (b): the entry point experiment_main/imputation_mnar.py in a
   temporary directory with Data linked in, over both records as they
   stand (epoch 1, batch 128, valid_k 10000, M=1, p_missingness 50): both
   run, IW2 once a record's evaluation and no other kernel, each RMSE finite and equal to its artifact at its
   eval_mnar_paths name, each checkpoint at its reference name; each
   record's wall-clock, and of its valid_k=10000 evaluation (1.78 M
   decoder rows in one eval_step) the peak device memory and, under
   torch.profiler, the device's busy share and top operations;
13. active learning (a): engine/active_learning.al_step on the CPU against
   the card, step by step from the card episode's masks and its recorded
   noise, for grid records 34 (reg_vae1), 37 (reg_EDDI1, with the
   `_with_drop` run's parameters: one pointnet model), 10 (reg_flow1) and
   1 (reg_MIWAE1, valid_k 5000) with the parameters phase 7 trained, on
   the 17 wine test rows, M cut to 5: rewards, imputations and the
   predictive-MSE curve within their tolerances, the reveals equal
   wherever a row's top two rewards clear the tolerance, B2f launched
   1 + 6 (D-1) = 73 times on the EDDI episode and no other kernel;
14. active learning (b): the entry point experiment_main/active_learning.py
   in a temporary directory holding those records as they stand (M=50;
   valid_k 5000 and M=1 for reg_MIWAE1) and their checkpoints: every
   artifact at its reference name with the JAX package's shape and dtype,
   each row revealing each feature once; B2f exactly 73 times on the
   reg_EDDI1 episode (its largest call over M (D-1) 17 = 10200 rows), no
   kernel on the others, no plain version on a CUDA tensor; each episode's
   wall-clock, launches and, under torch.profiler, busy share and top
   device operations; then B2f timed at its episode's largest shape;
15. resume and early stopping (a): the entry point
   experiment_main/imputation.py on record 34 (reg_vae1) in a temporary
   directory, -epoch 20 -checkpoint_every 5 straight through, and stopped
   at 10 then resumed with -resume true: the two checkpoints equal bit for
   bit, each resume file at epoch 20 holding the final parameters, B1 and
   its backward once a step; then -early_stop true -patience 1 with a check
   every 5 epochs (train's chunk_epochs): it stops before its 300 epochs,
   and the checkpoint saved is the best check's parameters;
16. AIS (b): engine/ais.ais_step on the CPU against the card, one
   temperature at a time from the card chain's states and draws, for
   records 34 (reg_vae1), 10 (reg_flow1) and 1 (reg_MIWAE1) with the
   parameters phase 7 trained and vanilla_notMIWAE1 from seeded
   parameters, on the 17 wine test rows at the records' linear T=50 and 40
   chains: z, eps and logw within their tolerances, a decision flipped
   only within the rounding of its Hamiltonians and in at most 1% of
   them, no kernel;
17. AIS (c): the entry point experiment_main/ais_eval.py over those three
   records as they stand, with their checkpoints, -bdmc true on record
   34: every artifact at its reference name, shape and dtype and finite,
   the printed lines the artifacts', the flow's warning printed, no kernel
   and no plain version on a CUDA tensor; each split's wall-clock, peak
   device memory and, under torch.profiler over its first 4
   temperatures, device operations and busy share;
18. AIS (d): engine/ais.eval_ais on the committed MNIST reg_EDDI1
   checkpoint, both splits (1618 x 40 = 64,720 and 179 x 40 = 7,160
   chains), linear T=50: no kernel; each split's wall-clock, peak device
   memory and decoder-matmul rate, and the test split's busy share and top
   device operations under torch.profiler over its first 4 temperatures.
19. ensembles (slice 9): (a) each kernel's replica form (B1 at [R, 64,
   10] with the noise shared, B2f and B2b at S=2, B=64, D=13 and 784)
   against its plain version at R = 1, 3 and 128, one launch a call, the
   R=1 form equal to the one-run call bit for bit, timed with CUDA
   events; (b) train_seed_ensemble of record 34 (reg_vae1) on wine at
   batch 64 with 128 replicas: the first step's per-replica losses on the
   card against the CPU from the same parameters and recorded draws, then
   10 epochs (B1 and its backward once a step for all replicas, the mean
   loss falling), a step's time and, over one epoch under torch.profiler,
   the card's busy share, beside the serial step's; (c) imputation.py
   -ensemble true -seeds 2 over records 37-39 (reg_EDDI1-3, 6 replicas
   through B2f and B2b), its 6 checkpoints and the seed-0 artifacts at
   their reference names; (d) -ensemble true -alphas 0.5,1.0 over records
   34-36, -ensemble true -early_stop true with a check every 5 epochs (a
   per-replica tracker), and imputation_mnar.py -ensemble true -seeds 2
   (checkpoints, `.seed1` siblings and RMSE artifacts at their names); (e)
   -ensemble true -seeds 2 over records 37-39 to 10 epochs straight and
   stopped at 5 then resumed: the checkpoints equal bit for bit;
20. AL and AIS ensembles (slice 9 part 2) and the entry points' start-up:
   (a) experiment_main/active_learning.py -ensemble true -seeds 2 over the
   records 37-39 checkpoints of phase 19 (c), M cut to 5: every artifact
   and its `.seed1` sibling at its reference name, shape and dtype, B2f
   exactly 1 + 6 (D-1) = 73 times a record for both replicas and no other
   kernel, no plain version on a CUDA tensor, each replica's episode
   against `al_step` on the CPU from its masks and draws at the AL (a)
   tolerances; (b) 128-replica episodes (M=50) of record 34 (the trained
   seed ensemble of phase 19 (b)) and record 37 (seeded parameters; B2f
   73 times for all replicas): the host-clock wall-clock beside the serial
   episode's, peak device memory, and under torch.profiler device
   operations and busy share; (c) experiment_main/ais_eval.py -seeds 2 on
   record 34 (replicas 0 and 1 of phase 19 (b)): both estimates and their
   `.seed1` files, no kernel, replica 0 against the serial AIS step from
   the ensemble's states at the AIS (b) tolerances; then a 128-replica
   test split (87,040 chains): wall-clock beside the serial split's, peak
   memory, busy share over its first 4 temperatures; (d) a 2-epoch record
   34 run through experiment_main/imputation.py with -profile DIR: a
   Chrome trace naming B1's kernel; and with VPC_DEBUG_NANS=1: the run
   finishes with the NaN tripwire (a dispatch mode checking every
   operator's output) and anomaly detection on.
21. the mesh (slice 10 part 1): (a) a world-size-1 NCCL process group in
   this process (a file store, destroyed at the phase's end) and a 1x1
   (dp, tp) mesh; for records 34 (reg_vae1) and 37 (reg_EDDI1) at their
   full widths on wine: the first `make_parallel_train_step` step's loss
   and gradients on the card against the serial step's on the CPU from the
   same parameters, batch and recorded draws (the training (a)
   tolerances), the step's device operations under torch.profiler with
   any NCCL kernel named, then `train_sharded` for 10 epochs, B1 and its
   backward (and on record 37 B2f and B2b) exactly once a step, no plain
   version on a CUDA tensor, every loss finite, the step's host-clock p50
   beside the serial engine's; (b) `torchrun --standalone --nproc_per_node
   1 -m ...experiment_main.imputation -mesh 1,1 -epoch 2` over records 34
   and 37 in a temporary directory: exit 0, JAX's `mesh={'dp': 1, 'tp':
   1}` tag, each checkpoint and artifact at its reference name and finite;
   (c) `-mesh auto` in this process resolves to no mesh: no process group,
   no tag, and its record-34 checkpoint equal bit for bit to a `-mesh ''`
   run's; then `-mesh 1,1` in this process (its own world-size-1 NCCL
   group, no torchrun) under VPC_DEBUG_NANS=1 finishes.
22. the mesh (slice 10 part 2), each on a world-size-1 NCCL group in this
   process (no torchrun): (i) `train_seed_ensemble` of record 37
   (reg_EDDI1) with 2 seeds on a 1x1 mesh for 3 epochs against the same
   call without one: B1, its backward, B2f and B2b each launched once a
   step for both replicas, histories within rtol 1e-6; (ii)
   experiment_main/active_learning.py -mesh 1,1 on record 37 (seeded
   parameters at its checkpoint name, M cut to 5): B2f exactly 1 + 6 (D-1)
   = 73 times and no other kernel, every artifact equal to the -mesh ''
   run's within the AL (a) bounds; (iii) experiment_main/ais_eval.py
   -mesh 1,1 on record 34 (the wine reg_vae1 of phase 7) against -mesh
   '': both splits' estimates and latents, no kernel; (iv)
   ImputationServer(mesh=...) answering 4 requests of the wine reg_vae1
   against the plain server.
23. mixed precision and the data plane (slice 11, parts a and b): (a)
   the first compute_dtype 'bfloat16' step of MNIST reg_EDDI1 at full
   width and of wine reg_vae1, card against CPU from the same parameters,
   batch and recorded noise (loss within BF16_LOSS_RTOL, each gradient
   leaf within BF16_GRAD_ULPS bf16 ulps of its largest magnitude, the EDDI
   tables so against a CPU step holding the embed in float32 as the
   card's kernels do), each kernel of the path launched once,
   no plain version on a CUDA tensor, and under torch.profiler every dense
   product a bf16 GEMM kernel; (b) record 37 (reg_EDDI1) through
   experiment_main/imputation.py for 20 epochs in float32 and in bfloat16:
   each kernel once a step, every loss finite and falling, the bf16 curve
   within 5% of the float32 one, the checkpoint and artifacts at their
   names, each run's step p50 and, from engine/profile_train over MNIST
   reg_EDDI1, the step's device busy time in both dtypes; (c) eval_vae of
   (b)'s bf16 model card against CPU fed the card's noise, and one
   active-learning step under bf16 whose rewards equal the float32 rewards
   of its (narrowed) completions bit for bit; (d) data/native_io built
   from csrc/vpc_io.cpp and used: every index CSV of Data/ read equal to
   np.loadtxt, the loaders' reads through it, mcar_mask's bits those of
   the numpy fallback, the mask codec round trip.
24. completeness (slice 11 part c): (a) for MNIST-width reg_EDDI1 and
   wine-width reg_MIWAE1 (record 1), vanilla_notMIWAE1 ('changed' and
   'author') and reg_flow1 from seeded parameters: export_state_dict then
   convert_state_dict gives the parameters back bit for bit, and the
   converted model served on the card (requests of 1 and 8 rows) agrees
   with a CPU server fed the card's recorded noise (B2f once a request on
   the EDDI model, no other kernel); (b) examples/impute_csv.main on the
   178-row wine table with about 30% of its cells blanked
   (native_io.mcar_mask), reg_vae1 and reg_EDDI1 for 20 epochs each: the
   observed cells written back unchanged, every imputation finite and
   inside its column's observed range, B1 and its backward once a step,
   B2f and B2b once a step on reg_EDDI1 and B2f once more at its serving
   call, no plain version on a CUDA tensor; the RMSE on the blanked cells
   beside the column-mean fill's, and each run's wall-clock; (c) a
   synthetic IDX pair through tools/convert_mnist_idx and
   data_loader_mnist onto the card.

It prints a JSON line of the kernels (launches on the MNIST training run,
launches per call, error against the plain version, times, bound; for B2f
and B2b also their launches on the `_with_drop` run and their times at its
shape; for every kernel its launches on the active-learning grid,
`al_launches`, and for B2f its time at the episode's largest shape; and
its launches on the AIS phases, `ais_launches`, 0; and the four replica
forms, their launches on the ensemble phases, their times at R=128 and
by R; and for every kernel its launches on the AL ensemble entry point's
run, `al_ensemble_launches`, and on the 128-replica reg_EDDI1 episode,
`al_ensemble_128_launches`; and its launches on the mesh phase's
`train_sharded` runs (a), `mesh_launches`, and on the slice 10 part 2
mesh runs, `mesh_ensemble_launches` (i) and `mesh_al_launches` (ii); and
on the bf16 training run of phase 23 (b), `bf16_launches`; and on the
completeness phase's serving (a) and CSV imputer (b) runs,
`completeness_launches`),
then, as its last line,
{"ok": true, "device": {...}}. Without CUDA, outside a checkout, or when any
phase fails, it exits nonzero and prints no result. A watchdog ends the run
after 600 s. It writes nothing in the checkout but the kernels' build
directory; checkpoints go to a temporary directory.
"""

import faulthandler

faulthandler.dump_traceback_later(600, exit=True)

import collections  # noqa: E402
import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import urllib.request  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parent
SEED = 0
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s outside
#: the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
#: B2f and B1 against their plain versions: the sums (over d; over the B*L
#: cells) run in another order in the kernel
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)
#: B2b against its plain version: dx and dmasks sum K=10 terms, so float32
#: rounding in another order stays near 1e-6 of their size; dA and dC sum B
#: terms (each warp over its rows, then the warps in order), so the absolute
#: tolerance grows with B
BWD_RTOL = 1e-5
BWD_ATOL_PER_TERM = 1e-5
#: the card's server against the CPU server (plain versions), same noise.
#: Imputed cells: atol 1e-4. A row score sums 784 cells, and its running sum
#: is ~1e3 whatever the score (the constant terms alone are 784*log(sqrt(2pi))
#: and 0.5*log(0.02) per observed cell), so float32 rounding in another
#: summation order moves it by about 1e3 * 2**-24 * sqrt(784) ~ 2e-3 whatever
#: its value: atol 5e-3.
SERVE_ATOL = 1e-4
SERVE_SCORE_ATOL = 5e-3
#: the card's first training step against the CPU's, same parameters, batch
#: and noise. The loss sums 2 * 64 * 784 reconstruction cells and the KL
#: terms after 500-wide matmuls that cuBLAS and the CPU accumulate in other
#: orders; float32 rounding moves it by ~1e-6 relative: rtol 1e-4. Each
#: gradient leaf is a sum over the batch's rows of products through the same
#: layers; its rounding is ~1e-6 of its largest entry: atol 1e-4 * max|leaf|.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_REL = 1e-4
#: eval_vae on the card against eval_vae on the CPU, same parameters and
#: recorded noise. RMSE: a mean of per-batch square roots of sums over the
#: holes of one batch (at most 64 x 784 cells of values in [0, 1]); float32
#: rounding in another order stays near 1e-7 of it: atol 1e-5. The loss,
#: negl and negl_imp are row means of row sums over 784 cells, whose running
#: sums reach about 1e3 whatever the value (serving's SERVE_SCORE_ATOL):
#: rtol 1e-4 on values of 1e2-1e3.
EVAL_RMSE_ATOL = 1e-5
EVAL_LOSS_RTOL = 1e-4
#: the wine reg_vae1 evaluation runs record 34's M, the flow record 12's
WINE_EVAL_M = 50
FLOW_EVAL_M = 50
EVAL_TIMING_RUNS = 5
#: serving (b): the buckets, and the card's row scores against the CPU's.
#: A row score is a logsumexp over valid_k=5000 importance weights (MIWAE,
#: notMIWAE) or a flow's sums, each a sum over 13 cells after 128- to
#: 500-term dot products that cuBLAS and the CPU accumulate in other
#: orders: about 1e-6 of its size, so rtol 1e-4; atol 1e-5 for a score
#: near 0, where its terms of about 1 still round at about 1e-6
SERVE_B_BUCKETS = (1, 8, 64)
SERVE_B_SCORE_RTOL = 1e-4
SERVE_B_SCORE_ATOL = 1e-5
#: MNAR evaluation (a): the records' valid_k (10000) cut to 500 and M
#: raised to 2 for the CPU run that checks the card's
MNAR_CHECK_K = 500
MNAR_CHECK_M = 2
MNAR_RMSE_ATOL = 1e-5
#: active learning: the grid records the AL phases run (reg_vae1, reg_EDDI1,
#: reg_flow1 at M=50; reg_MIWAE1 at M=1, valid_k 5000), the records' M, and
#: the M of the card-vs-CPU steps (a), cut for the CPU's sake
AL_RECORDS = (34, 37, 10, 1)
AL_M = 50
#: the rows of the wine test split, where an episode runs
AL_ROWS = 17
AL_CHECK_M = 5
#: al_step on the card against the CPU, same mask and noise. A Gaussian-KL
#: reward cancels ten O(1) terms of the chaini 'KL' (variance ratios, -1,
#: log-variances) computed from statistics after 50- to 100-wide layers
#: that cuBLAS and the CPU accumulate in other orders (about 1e-6 of each):
#: atol 1e-5; a reward of size R keeps about 1e-5 R more through exp:
#: rtol 1e-4. A flow reward sums twenty |log q| differences of O(1-10)
#: log-densities after 500-wide layers: atol 1e-4, except where a z lies
#: within rounding of a spline knot and takes the adjacent bin on one side
#: (ROADMAP C.4.6), which moves its reward by the log-ratio of the two bins'
#: densities over M: at most 1% of the rewards, each by at most 1.
#: Imputations and the predictive-MSE curve: SERVE_ATOL and EVAL_LOSS_RTOL's
#: reasons.
AL_REWARD_ATOL = 1e-5
AL_REWARD_RTOL = 1e-4
AL_FLOW_ATOL = 1e-4
AL_FLOW_KNOT_SHARE = 0.01
AL_FLOW_KNOT_ATOL = 1.0
AL_IM_ATOL = 1e-4
AL_CURVE_RTOL = 1e-4
#: a marker kernel's busy-wait (clock cycles) around a profiled call, and
#: the host time (s) that pads the profiler's window on each side
MARK_CYCLES = 1000
MARK_PAD_S = 0.02
#: CUgraphNodeType of the graph nodes that are device operations: a kernel,
#: a copy, a fill
GRAPH_OP_NODES = (0, 1, 2)
#: resume and early stopping (a): record 34 through the imputation entry
#: point, straight to RESUME_EPOCHS and stopped at RESUME_STOP then resumed,
#: a resume file every RESUME_EVERY epochs; early stopping at patience 1
#: with a check every STOP_CHUNK epochs, at most STOP_EPOCHS
RESUME_RECORD = 34
RESUME_EPOCHS = 20
RESUME_STOP = 10
RESUME_EVERY = 5
STOP_EPOCHS = 300
STOP_CHUNK = 5
#: AIS: the grid records of phases (b) and (c) (reg_vae1, reg_flow1,
#: reg_MIWAE1; all at linear T=50, 40 chains a row)
AIS_RECORDS = (34, 10, 1)
#: ais_step on the card against the CPU from the same state and draws. z
#: and eps after ten leapfrog steps through decoders of 50-500 wide layers,
#: whose sums cuBLAS and the CPU run in other orders (about 1e-6 of each,
#: amplified along the trajectory): atol 1e-4 on |z| of O(1). The weight
#: increment (t1 - t0) log p(x|z) of size up to 1e3 (the flow's obs_logvar
#: -8): atol 1e-4 plus rtol 1e-5 on logw. An accept decision may flip where
#: |log prob - log u| lies within the rounding of the Hamiltonians, about
#: 1e-5 of the chain's energy -log f(z) plus 1e-4: at most 1% of the
#: decisions, each within that gap.
AIS_Z_ATOL = 1e-4
AIS_LOGW_ATOL = 1e-4
AIS_LOGW_RTOL = 1e-5
AIS_FLIP_GAP_RTOL = 1e-5
AIS_FLIP_GAP_ATOL = 1e-4
AIS_FLIP_SHARE = 0.01
#: the temperatures of a split traced under torch.profiler (AIS (c), (d))
AIS_PROFILE_TEMPS = 4
REQUEST_ROWS = (1, 8, 64, 179)
TIMING_RUNS = 100
MNIST_EPOCHS = 3
WINE_EPOCHS = 30
LATENT = 10
#: the wine records' width (Data/wine: 13 features)
WINE_D = 13
#: ensembles (slice 9): the replica counts each replica kernel is held to
#: its plain version at, the width of the full-width seed ensemble of record
#: 34 and its epochs, the epochs the entry-point ensembles are cut to, and
#: the EDDI and reg_vae records they run
REPLICAS = (1, 3, 128)
ENS_S = 128
ENS_EPOCHS = 10
ENS_ENTRY_EPOCHS = 10
ENS_EDDI_RECORDS = (37, 38, 39)
ENS_VAE_RECORDS = (34, 35, 36)
#: the ensemble killed at a chunk boundary and resumed
ENS_RESUME_STOP = 5
#: CUDA-event runs a replica kernel's time is the median of
ENS_RUNS = 20
#: the mesh phase: its records (the flagship reg_vae1 and reg_EDDI1, at
#: wine width), epochs of its train_sharded runs, and of its entry-point
#: runs
MESH_RECORDS = (34, 37)
MESH_EPOCHS = 10
MESH_ENTRY_EPOCHS = 2
#: the part-2 mesh phase (d): record 34 (AIS, serving) and record 37 (the
#: seed ensemble, the AL episode), the ensemble's seeds and epochs
MESH_D_RECORDS = (34, 37)
MESH_D_SEEDS = 2
MESH_D_EPOCHS = 3
#: mixed precision (compute_dtype 'bfloat16'): a first step on the card
#: against the CPU from the same parameters, batch and recorded noise. Both
#: round the same operands to bf16 and sum them in float32 in other orders;
#: the card rounds each gradient's cotangent to bf16 before its products
#: (ROADMAP C.4.33), the CPU keeps it float32, so a layer input or a
#: gradient may land on the neighbouring bf16 value, 2^-7 of its magnitude
#: at most. Measured in a CPU emulation of the card's products (MNIST
#: reg_EDDI1 and wine reg_vae1): losses 8.7e-7 apart, dense leaves within
#: 2.7 * 2^-7 of their largest magnitude, held at BF16_GRAD_ULPS. The EDDI
#: per-feature tables (BF16_TABLES) get their gradients through the embed,
#: which the CPU holds in bf16 and the card's kernels in float32 (C.4.32):
#: they are held at BF16_GRAD_ULPS against a CPU step that keeps the embed
#: in float32 as the card does (the kernels' plain versions), and their
#: distance from the CPU's bf16 embed is printed
BF16_ULP = 2.0 ** -7
BF16_LOSS_RTOL = 2e-5
BF16_GRAD_ULPS = 4
BF16_TABLES = ("encoder/type_pars", "encoder/type_bias")
#: the record trained through the entry point in both dtypes, its epochs
#: and M, and the bound between its two loss curves (the JAX package's
#: tests/test_models.py:316-347)
BF16_RECORD = 37
BF16_EPOCHS = 20
BF16_M = 5
BF16_CURVE_RTOL = 0.05
#: eval_vae under bf16, card against CPU fed the card's noise: the same
#: rounding as the first step's through the trained model, on imputations
#: in [0, 1] and row sums of 13 cells
BF16_EVAL_RTOL = 1e-3
BF16_EVAL_RMSE_ATOL = 1e-3
BF16_PROFILE_STEPS = 10
#: completeness (b): the CSV imputer's vae_types and epochs on the blanked
#: wine table (178 rows, 3 steps an epoch at batch 64)
CSV_TYPES = ("reg_vae1", "reg_EDDI1")
CSV_EPOCHS = 20
#: IW1 against its plain version on the card (tests/test_torch_iw_fused.py's
#: limits): both compute in float32 from the same inputs and differ only in
#: the order of their sums, so x_imputed (in [0, 1]) lies within
#: IW1_X_MEAN_ATOL and every other output within IW1_TERMS_RTOL of its size
#: or IW1_TERMS_ATOL near zero
IW1_X_MEAN_ATOL = 2e-6
IW1_TERMS_RTOL = 2e-5
IW1_TERMS_ATOL = 5e-5
#: IW2 against its plain version on the card, the MNAR cell's limits
#: (tests/test_torch_notmiwae_fused.py): x_imputed within IW2_IMPUTED_ATOL,
#: the bound and the mean of RE within IW2_ROW_RTOL of max(1, their size)
IW2_IMPUTED_ATOL = 1e-6
IW2_ROW_RTOL = 1e-6
#: the MNAR records' importance samples a row (Data/imputation_args_mnar.json)
MNAR_VALID_K = 10000


def runs_iw1(cfg) -> bool:
    """Whether `cfg`'s evaluation launches IW1: a MIWAE type (notMIWAE has
    its own path) computing in float32, as models/miwae chooses it; once an
    `eval_step` without gradients."""
    return ("MIWAE" in cfg.vae_type and "notMIWAE" not in cfg.vae_type
            and cfg.compute_dtype == "float32")


def runs_iw2(cfg) -> bool:
    """Whether `cfg`'s evaluation launches IW2: a notMIWAE type computing in
    float32 under the default missingness process, as models/notmiwae
    chooses it; once an `eval_step` without gradients."""
    return "notMIWAE" in cfg.vae_type and cfg.compute_dtype == "float32"


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def event_ms(fn, runs=TIMING_RUNS, per_run=10):
    """Median device time of one call of `fn`, from CUDA events around
    `per_run` back-to-back calls, `runs` times. A busy-wait kernel queued
    first keeps the host's launch cost out of the interval."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def _bound(nbytes, ops):
    """Least time for a function on the card (ms): its bytes over the memory
    rate or its float32 operations over the float32 rate, whichever is
    larger, and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def embed_pool_bound_ms(S, B, D, K):
    """B2f: reads x, masks, A, C and writes the output once; (3+2S)*B*D*K
    operations."""
    nbytes = 4 * (B * D + S * B * D + 2 * D * K + S * B * K)
    return _bound(nbytes, (3 + 2 * S) * B * D * K)


def embed_pool_bwd_bound_ms(S, B, D, K, dx=True, dmasks=True):
    """B2b: reads x, masks, A, C, g and writes dx and dmasks (each if asked),
    dA, dC once; (6+2S)*B*D*K operations for dA and dC (the affine
    recomputed, gsum, its gate, dA, dC), 2 more a cell for dx and 1+2S for
    dmasks: (9+4S) with all four."""
    nbytes = 4 * (B * D + S * B * D + 2 * D * K + S * B * K
                  + (B * D if dx else 0) + (S * B * D if dmasks else 0)
                  + 2 * D * K)
    ops = (6 + 2 * S + (2 if dx else 0) + (1 + 2 * S if dmasks else 0))
    return _bound(nbytes, ops * B * D * K)


def fused_posterior_bound_ms(B, L):
    """B1: reads six [B,L] inputs, writes z_q, z_p and three sums once;
    about 31 operations a cell (8 for the two samples, 7 for each KL to
    N(0,I), 9 for KL(q||p), counting an exponential as one)."""
    return _bound(4 * (8 * B * L + 3), 31 * B * L)


def fused_posterior_bwd_bound_ms(B, L, eps=False):
    """B1's backward: reads six [B,L] inputs, dz_q, dz_p and the three KL
    cotangents, writes the four statistics' gradients (and the two eps
    gradients with `eps`) once; about 44 operations a cell (8 for five
    exponentials, 2 for dm and its scaled form, 4 each for the means', 12
    and 14 for the logvars' gradients), 1 more for each eps gradient."""
    n_out = 6 if eps else 4
    return _bound(4 * ((8 + n_out) * B * L + 3), (46 if eps else 44) * B * L)


def iw_fused_bound_ms(B, K, D, L):
    """IW1: 2 (L*128 + 128*128 + 128*3D) FLOP of dense products a sample
    and 2 (D*128 + 128*128 + 128*2L) a row for the encoder (the density's
    and the reductions' elementwise work not counted); reads eps a sample,
    x and mask a row and both networks once, writes x_imputed, three row
    values, mean and scale a row."""
    n = B * K
    ops = 2 * n * (L * 128 + 128 * 128 + 128 * 3 * D) + 2 * B * (
        D * 128 + 128 * 128 + 128 * 2 * L)
    nbytes = 4 * (n * L + B * (3 * D + 3 + 2 * L)
                  + L * 128 + 128 * 128 + 128 * 3 * D + 256 + 3 * D
                  + D * 128 + 128 * 128 + 128 * 2 * L + 256 + 2 * L)
    return _bound(nbytes, ops)


def iw_mnar_bound_ms(B, K, D, L):
    """IW2: 2 (L*128 + 128*128 + 128*2D) FLOP of dense products a sample
    and 2 (D*128 + 128*128 + 128*2L) a row for the encoder (the ELUs', the
    per-feature terms' and the reductions' elementwise work not counted);
    reads eps a sample, x and mask a row and the parameters once, writes
    x_imputed, two row values, mean and logvar a row."""
    n = B * K
    ops = 2 * n * (L * 128 + 128 * 128 + 128 * 2 * D) + 2 * B * (
        D * 128 + 128 * 128 + 128 * 2 * L)
    nbytes = 4 * (n * L + B * (3 * D + 2 + 2 * L)
                  + L * 128 + 128 * 128 + 128 * 2 * D + 256 + 2 * D
                  + D * 128 + 128 * 128 + 128 * 2 * L + 256 + 2 * L + 2 * D)
    return _bound(nbytes, ops)


def fused_posterior_replicas_bound_ms(R, B, L, shared_eps=True):
    """B1 over R replicas: reads four [R,B,L] statistics and the two eps
    (one [B,L] each when the replicas share them), writes z_q, z_p [R,B,L]
    and the [R,3] sums once; 31 operations a cell."""
    eps = 2 * B * L if shared_eps else 2 * R * B * L
    return _bound(4 * (6 * R * B * L + eps + 3 * R), 31 * R * B * L)


def fused_posterior_bwd_replicas_bound_ms(R, B, L, shared_eps=True):
    """B1's backward over R replicas for the four statistics: reads them,
    the two eps (shared: one [B,L] each), dz_q, dz_p and the [R,3]
    cotangents, writes four [R,B,L] gradients once; 44 operations a
    cell."""
    eps = 2 * B * L if shared_eps else 2 * R * B * L
    return _bound(4 * (10 * R * B * L + eps + 3 * R), 44 * R * B * L)


def device_ops(build):
    """Device operations (kernels, copies, fills) one call puts on the card:
    the kernel, copy and fill nodes of a CUDA graph captured from one call
    of the function that `build()` returns. `build` runs on the capturing
    stream before the capture begins, because autograd runs a backward on
    the stream of its forward. The count needs no trace: torch.profiler's
    traces of one-kernel calls on the H100 at times held no device event at
    all, in one run not in ten tries."""
    import ctypes

    import torch

    cuda = ctypes.CDLL("libcuda.so.1")

    def check(code, what):
        if code != 0:
            raise RuntimeError(f"{what}: CUresult {code}")

    stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        fn = build()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kinds = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)),
              "cuGraphNodeGetType")
        kinds.append(kind.value)
    graph.reset()
    return sum(k in GRAPH_OP_NODES for k in kinds)


def traced_ops(fn, want=3, tries=10):
    """Device operations (kernels, copies, fills) one call of `fn` puts on
    the card, from torch.profiler, for a call that waits on the host and so
    cannot be captured in a graph: those between two marker kernels
    (`torch.cuda._sleep`, named spin_kernel) queued just before and just
    after the call, in a window padded with MARK_PAD_S of host time on each
    side. A count is read only from a trace that holds both markers, and
    the largest of the first `want` such counts in at most `tries` traces
    is returned; None where no trace held both (traces on the H100 at
    times held no device event at all)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(MARK_PAD_S)
            torch.cuda._sleep(MARK_CYCLES)
            fn()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            time.sleep(MARK_PAD_S)
        names = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)),
            key=lambda e: e.time_range.start)]
        marks = [i for i, n in enumerate(names) if "spin_kernel" in n]
        if len(marks) == 2:
            counts.append(marks[1] - marks[0] - 1)
            if len(counts) == want:
                break
    return max(counts) if counts else None


def max_abs(a, b):
    return (a - b).abs().max().item()


def al_tol(cfg, R):
    """The AL (a) tolerance of rewards R."""
    from vae_posterior_consistency_tpu_torch.models import get_model

    return (AL_FLOW_ATOL if get_model(cfg).encode_stats is None
            else AL_REWARD_ATOL + AL_REWARD_RTOL * R.abs())


def reveal_mask(actions, t, D):
    """The mask before step t of an episode whose reveals are
    `actions` [n, D-1]."""
    import torch

    return torch.nn.functional.one_hot(actions[:, :t].long(), D).sum(
        1).float()


def al_card_vs_cpu(acfg, ep, card_p, x, replay):
    """An episode on the card, `ep` (run_episode's dict), against
    `al_step` on the CPU step by step from its masks and the draws
    `replay` (a noise source handing out the card's, on the CPU), at
    the AL (a) tolerances; raises where they fail. Returns (worst
    errors, rewards at a spline knot, rewards compared, (row, step)
    pairs whose reveals were compared)."""
    import torch

    from vae_posterior_consistency_tpu_torch.engine import (
        active_learning as al,
    )
    from vae_posterior_consistency_tpu_torch.engine import checkpoint
    from vae_posterior_consistency_tpu_torch.models import get_model

    model = get_model(acfg)
    n, D = x.shape
    cpu_p = checkpoint.unflatten(
        {k: v.cpu() for k, v in checkpoint.flatten(card_p).items()})
    xc = x.cpu()
    curve = ep["information_curve"][0].cpu()
    actions = ep["action"].cpu()
    shape = (acfg.M, *al.eps_shape(acfg, n, D))
    with torch.no_grad():
        mse0 = al.predictive_mse(acfg, cpu_p, xc, torch.zeros_like(xc),
                                 replay("init", 0, 0, shape))
    worst = {"R": 0.0, "im": 0.0, "mse": abs(mse0.item()
                                             - curve[0].item())}
    knot, compared, n_R = 0, 0, 0
    for t in range(D - 1):
        mask = reveal_mask(actions, t, D)
        with torch.no_grad():
            out = al.al_step(model, cpu_p, acfg, xc, mask, replay, 0, t)
        R_card = ep["R_hist"][t].cpu()
        hidden = mask[:, :D - 1] == 0
        err = (out["R"] - R_card).abs()[hidden]
        tol = al_tol(acfg, out["R"])
        tol = tol[hidden] if isinstance(tol, torch.Tensor) else tol
        off = err > tol
        if model.encode_stats is None:
            knot += int(off.sum())
            if err.max() > AL_FLOW_KNOT_ATOL:
                raise AssertionError(f"{acfg.vae_type} step {t}: a "
                                     f"reward {err.max().item()} from "
                                     "the card's")
        elif off.any():
            raise AssertionError(f"{acfg.vae_type} step {t}: rewards "
                                 f"{err.max().item()} from the card's")
        n_R += int(hidden.sum())
        worst["R"] = max(worst["R"], err.max().item())
        worst["im"] = max(worst["im"], max_abs(out["im"],
                                               ep["im"][t].cpu()))
        # the card's MSE follows its own reveal, which the CPU's may not
        # match on a row whose top two rewards tie within rounding
        with torch.no_grad():
            mse = al.predictive_mse(acfg, cpu_p, xc,
                                    reveal_mask(actions, t + 1, D),
                                    replay("mse", 0, t, shape))
        worst["mse"] = max(worst["mse"], abs(mse.item()
                                             - curve[t + 1].item()))
        # the reveal must agree wherever the top two hidden rewards of
        # a row stand further apart than the tolerance
        top = torch.where(hidden, out["R"], -math.inf).topk(
            min(2, D - 1 - t), dim=1).values
        clear = (torch.ones(n, dtype=torch.bool) if top.shape[1] < 2
                 else top[:, 0] - top[:, 1] > al_tol(acfg, top[:, 0]))
        if not torch.equal(out["action"][clear], actions[clear, t]):
            raise AssertionError(f"{acfg.vae_type} step {t}: the CPU "
                                 "reveals other features")
        compared += int(clear.sum())
    if (worst["im"] > AL_IM_ATOL or worst["mse"] > AL_CURVE_RTOL
            * curve.abs().max().item()
            or knot > AL_FLOW_KNOT_SHARE * n_R):
        raise AssertionError(f"{acfg.vae_type}: card against CPU "
                             f"{worst}, {knot} rewards off")
    return worst, knot, n_R, compared


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs one CUDA card",
              file=sys.stderr)
        return 1
    if not (REPO / "vae_posterior_consistency_tpu_torch").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repo (no "
              "vae_posterior_consistency_tpu_torch/)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()

    with phase("environment"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
        print(card, flush=True)
        card = card.splitlines()[0]
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, device 0: "
              f"{torch.cuda.get_device_name(0)}; cards visible: "
              f"{torch.cuda.device_count()}, cards used: 1", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from vae_posterior_consistency_tpu_torch.config import (
        RunConfig,
        iter_jsonl_configs,
    )
    from vae_posterior_consistency_tpu_torch.data import loaders
    from vae_posterior_consistency_tpu_torch.engine import (
        artifacts,
        checkpoint,
        evaluate,
        serve,
    )
    from vae_posterior_consistency_tpu_torch.engine import profile_train
    from vae_posterior_consistency_tpu_torch.engine import train as trainer
    from vae_posterior_consistency_tpu_torch.models import (
        get_model,
        layers,
        miwae,
        notmiwae,
    )
    from vae_posterior_consistency_tpu_torch.ops import _build, _kernel
    from vae_posterior_consistency_tpu_torch.ops import fused_embed_pool as fep
    from vae_posterior_consistency_tpu_torch.ops import fused_posterior as fp
    from vae_posterior_consistency_tpu_torch.ops import fused_iw as fiw
    from vae_posterior_consistency_tpu_torch.ops import fused_iw_mnar as fim

    reset_counts = _kernel.launches.clear

    def counts():
        """Each kernel's launches since the last `reset_counts()`."""
        return {k: _kernel.launches[k] for k in _kernel.PLAIN}

    # a phase's expected launches name the kernels it launches; every other
    # kernel is expected at 0
    no_kernel = dict.fromkeys(_kernel.PLAIN, 0)
    #: the kernels of an EDDI training step: B1, its backward, B2f, B2b
    step_kernels = ("embed_pool_fwd", "embed_pool_bwd", "fused_posterior_fwd",
                    "fused_posterior_bwd")

    @contextlib.contextmanager
    def no_plain_on_card():
        """Makes each kernel's plain version (`_kernel.PLAIN`) raise if it
        is handed a CUDA tensor while the block runs: the Functions look
        them up in their modules at each call, so the guard patches the
        modules."""
        saved = []
        for plain in _kernel.PLAIN.values():
            mod, name = sys.modules[plain.__module__], plain.__name__

            def guarded(*args, _plain=plain, _name=name):
                flat = [a for arg in args for a in (
                    arg if isinstance(arg, (tuple, list)) else (arg,))]
                if any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in flat):
                    raise AssertionError(f"{_name} ran on a CUDA tensor")
                return _plain(*args)

            saved.append((mod, name, plain))
            setattr(mod, name, guarded)
        try:
            yield
        finally:
            for mod, name, plain in saved:
                setattr(mod, name, plain)

    with phase("build"):
        t0 = time.perf_counter()
        libs, log = _build.build_all()
        build_s = time.perf_counter() - t0
        print(log, end="", flush=True)
        for stem, path in libs.items():
            print(f"built {stem}: {path.relative_to(REPO)}", flush=True)
        print(f"build time {build_s:.3f} s", flush=True)

    D, K = 784, 10
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(S, B, K=K, D=D):
        x = torch.rand(B, D, device="cuda", generator=gen)
        masks = (torch.rand(S, B, D, device="cuda", generator=gen)
                 < 0.7).float()
        A = torch.randn(D, K, device="cuda", generator=gen) * 0.3
        C = torch.randn(D, K, device="cuda", generator=gen) * 0.3
        return x, masks, A, C

    def stats(B, L, strided=False):
        """B1's six inputs; with `strided` the four statistics are the row
        and column halves of one [2B, 2L] encoder output, as a training
        step hands them over (row stride 2L)."""
        mq, mp, eq, ep = torch.randn(4, B, L, device="cuda", generator=gen)
        lq, lp = torch.rand(2, B, L, device="cuda", generator=gen) * 3 - 2
        if strided:
            h = torch.cat([torch.cat([mq, lq], 1), torch.cat([mp, lp], 1)])
            mean_all, logvar_all = h.chunk(2, dim=1)
            mq, lq = mean_all[:B], logvar_all[:B]
            mp, lp = mean_all[B:], logvar_all[B:]
        return mq, lq, mp, lp, eq, ep

    def b1_cotangents(B, L, expanded=False):
        """dz_q, dz_p [B, L] and dkl [3]; `expanded` gives them stride 0, as
        a `.sum()` upstream does."""
        if expanded:
            dz_q, dz_p = torch.randn(2, 1, 1, device="cuda", generator=gen)
            dkl = torch.randn(1, device="cuda", generator=gen)
            return dz_q.expand(B, L), dz_p.expand(B, L), dkl.expand(3)
        dz_q, dz_p = torch.randn(2, B, L, device="cuda", generator=gen)
        return dz_q, dz_p, torch.randn(3, device="cuda", generator=gen)

    max_err = {"embed_pool_fwd": 0.0, "embed_pool_bwd": 0.0,
               "fused_posterior_fwd": 0.0, "fused_posterior_bwd": 0.0}
    with phase("kernels against their plain versions"):
        for S, B, k in [(1, 1, K), (1, 8, K), (1, 64, K), (1, 179, K),
                        (1, 512, K), (2, 64, K), (2, 4096, K), (3, 64, K),
                        (2, 64, 64)]:
            args = inputs(S, B, k)
            got = fep.embed_pool(*args)
            torch.cuda.synchronize()
            want = fep.embed_pool_reference(*args)
            err = max_abs(got, want)
            max_err["embed_pool_fwd"] = max(max_err["embed_pool_fwd"], err)
            torch.testing.assert_close(got, want, **KERNEL_TOL)
            print(f"B2f embed_pool S={S} B={B} D={D} K={k}: max abs diff "
                  f"{err:.3e}", flush=True)
        bwd_cases = [(S, B, K) for S in (1, 2) for B in (1, 7, 64, 179)]
        for S, B, k in bwd_cases + [(3, 64, K), (2, 64, 64)]:
            args = inputs(S, B, k)
            g = torch.randn(S, B, k, device="cuda", generator=gen)
            want = fep.embed_pool_bwd_reference(*args, g)
            for dmasks in (True, False):
                got = fep.embed_pool_bwd(*args, g, dmasks=dmasks)
                torch.cuda.synchronize()
                errs = []
                for i, name in enumerate(("dx", "dmasks", "dA", "dC")):
                    if name == "dmasks" and not dmasks:
                        if got[1] is not None:
                            raise AssertionError("dmasks=False gave dm")
                        continue
                    atol = BWD_ATOL_PER_TERM * (B if i >= 2 else k)
                    torch.testing.assert_close(got[i], want[i],
                                               rtol=BWD_RTOL, atol=atol)
                    errs.append(f"{name} {max_abs(got[i], want[i]):.3e}")
                    max_err["embed_pool_bwd"] = max(
                        max_err["embed_pool_bwd"],
                        max_abs(got[i], want[i]))
                print(f"B2b embed_pool_bwd S={S} B={B} D={D} K={k} "
                      f"dmasks={dmasks}: max abs diff "
                      f"{', '.join(errs)}", flush=True)
        args = inputs(2, 64)
        g = torch.randn(2, 64, K, device="cuda", generator=gen)
        for name, fn in (("B2f", lambda: [fep.embed_pool(*args)]),
                         ("B2b", lambda: fep.embed_pool_bwd(*args, g))):
            if not all(torch.equal(u, v) for u, v in zip(fn(), fn())):
                raise AssertionError(f"{name} gave other bits on a second "
                                     "call")
        print("B2f and B2b at S=2, B=64: the same bits on two calls",
              flush=True)
        # the wine width (D=13) of the EDDI records 25-27 and 37-39: S=1
        # training a `_with_drop` type, S=2 a regularized one; B=64 a full
        # batch, B=17 the wine test split's one batch
        for S, B in [(S, B) for S in (1, 2) for B in (64, 17)]:
            args = inputs(S, B, D=WINE_D)
            got = fep.embed_pool(*args)
            torch.cuda.synchronize()
            want = fep.embed_pool_reference(*args)
            torch.testing.assert_close(got, want, **KERNEL_TOL)
            err = max_abs(got, want)
            max_err["embed_pool_fwd"] = max(max_err["embed_pool_fwd"], err)
            g = torch.randn(S, B, K, device="cuda", generator=gen)
            want_b = fep.embed_pool_bwd_reference(*args, g)
            errs = [f"fwd {err:.3e}"]
            for dmasks in (True, False):
                got_b = fep.embed_pool_bwd(*args, g, dmasks=dmasks)
                torch.cuda.synchronize()
                for i, name in enumerate(("dx", "dmasks", "dA", "dC")):
                    if name == "dmasks" and not dmasks:
                        if got_b[1] is not None:
                            raise AssertionError("dmasks=False gave dm")
                        continue
                    atol = BWD_ATOL_PER_TERM * (B if i >= 2 else K)
                    torch.testing.assert_close(got_b[i], want_b[i],
                                               rtol=BWD_RTOL, atol=atol)
                    e = max_abs(got_b[i], want_b[i])
                    max_err["embed_pool_bwd"] = max(
                        max_err["embed_pool_bwd"], e)
                    errs.append(f"{name}{'' if dmasks else ' (no dm)'} "
                                f"{e:.3e}")
            for name, fn in (("B2f", lambda: [fep.embed_pool(*args)]),
                             ("B2b", lambda: fep.embed_pool_bwd(*args, g))):
                if not all(torch.equal(u, v) for u, v in zip(fn(), fn())):
                    raise AssertionError(f"{name} S={S} B={B} D={WINE_D} "
                                         "gave other bits on a second call")
            print(f"B2f/B2b S={S} B={B} D={WINE_D} K={K}: max abs diff "
                  f"{', '.join(errs)}; the same bits on two calls",
                  flush=True)
        # the active-learning episode's largest B2f call: the candidate
        # posteriors of a wine EDDI record at M=50, over M x (D-1) x 17 rows
        B = AL_M * (WINE_D - 1) * AL_ROWS
        args = inputs(1, B, D=WINE_D)
        got = fep.embed_pool(*args)
        torch.cuda.synchronize()
        want = fep.embed_pool_reference(*args)
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        err = max_abs(got, want)
        max_err["embed_pool_fwd"] = max(max_err["embed_pool_fwd"], err)
        if not torch.equal(got, fep.embed_pool(*args)):
            raise AssertionError(f"B2f S=1 B={B} D={WINE_D} gave other bits "
                                 "on a second call")
        print(f"B2f S=1 B={B} D={WINE_D} K={K} (active learning): max abs "
              f"diff {err:.3e}; the same bits on two calls", flush=True)
        # B1: one launch of one block at every size
        for B, L in [(64, 10), (7, 3), (4096, 10), (1, 1)]:
            args = stats(B, L, strided=B == 64)
            got = fp.fused_posterior_kernel(*args)
            got = (*got[:2], *got[2])
            torch.cuda.synchronize()
            want = fp.fused_posterior_reference(*args)
            errs = []
            for name, u, v in zip(("z_q", "z_p", "KL_q", "KL_p", "KL_reg"),
                                  got, want):
                torch.testing.assert_close(u, v, **KERNEL_TOL)
                errs.append(f"{name} {max_abs(u, v):.3e}")
                max_err["fused_posterior_fwd"] = max(
                    max_err["fused_posterior_fwd"], max_abs(u, v))
            print(f"B1 fused_posterior [{B},{L}]: max abs diff "
                  f"{', '.join(errs)}", flush=True)
        needs_forms = {"statistics": (True,) * 4 + (False,) * 2,
                       "all six": (True,) * 6}
        for B, L in [(64, 10), (7, 3), (4096, 10), (1, 1)]:
            args = stats(B, L, strided=True)
            for expanded in (False, True):
                cts = b1_cotangents(B, L, expanded)
                want = fp.fused_posterior_backward(args, *cts)
                for form, needs in needs_forms.items():
                    got = fp.fused_posterior_backward_kernel(args, *cts,
                                                             needs=needs)
                    torch.cuda.synchronize()
                    errs = []
                    for name, u, v, n in zip(
                            ("mq", "lq", "mp", "lp", "eq", "ep"), got, want,
                            needs):
                        if not n:
                            if u is not None:
                                raise AssertionError(f"unasked g_{name}")
                            continue
                        torch.testing.assert_close(u, v, **KERNEL_TOL)
                        errs.append(f"g_{name} {max_abs(u, v):.3e}")
                        max_err["fused_posterior_bwd"] = max(
                            max_err["fused_posterior_bwd"], max_abs(u, v))
                    print(f"B1 backward [{B},{L}] strided statistics, "
                          f"{'expanded' if expanded else 'dense'} dz, "
                          f"{form}: max abs diff {', '.join(errs)}",
                          flush=True)
        for B, L in [(64, 10), (4096, 10)]:
            args = stats(B, L, strided=True)
            cts = b1_cotangents(B, L)
            for name, fn in (
                    ("B1", lambda: fp.fused_posterior_kernel(*args)),
                    ("B1 backward", lambda: fp.fused_posterior_backward_kernel(
                        args, *cts))):
                if not all(torch.equal(u, v) for u, v in zip(fn(), fn())):
                    raise AssertionError(f"{name} [{B},{L}] gave other bits "
                                         "on a second call")
            print(f"B1 and its backward at [{B},{L}]: the same bits on two "
                  "calls", flush=True)

        # the autograd Functions against autograd through the plain forward
        args = stats(64, 10)
        cts = [*stats(64, 10)[:2], *torch.randn(3, device="cuda",
                                                generator=gen)]
        a = [t.clone().requires_grad_() for t in args]
        b = [t.clone().requires_grad_() for t in args]
        got = torch.autograd.grad(fp.fused_posterior(*a), a, cts)
        want = torch.autograd.grad(fp.fused_posterior_reference(*b), b, cts)
        for u, v in zip(got, want):
            torch.testing.assert_close(u, v, **KERNEL_TOL)
        print("FusedPosterior gradients (6 inputs) vs autograd of the plain "
              f"forward: max abs diff "
              f"{max(max_abs(u, v) for u, v in zip(got, want)):.3e}",
              flush=True)
        args = inputs(2, 64)
        g = torch.randn(2, 64, K, device="cuda", generator=gen)
        a = [t.clone().requires_grad_() for t in args]
        b = [t.clone().requires_grad_() for t in args]
        got = torch.autograd.grad(fep.embed_pool(*a), a, g)
        want = torch.autograd.grad(fep.embed_pool_reference(*b), b, g)
        errs = []
        for i, (name, u, v) in enumerate(zip(("dx", "dmasks", "dA", "dC"),
                                             got, want)):
            torch.testing.assert_close(
                u, v, rtol=BWD_RTOL,
                atol=BWD_ATOL_PER_TERM * (64 if i >= 2 else K))
            errs.append(f"{name} {max_abs(u, v):.3e}")
        print(f"EmbedPool gradients vs autograd of the plain forward: max abs "
              f"diff {', '.join(errs)}", flush=True)

    cfg = RunConfig(vae_type="reg_EDDI1", data_type="mnist", missing_rate=30,
                    seed=SEED)
    with phase("serving"):
        path = checkpoint.checkpoint_path(cfg, root=str(REPO / "experiments"))
        params = checkpoint.load_reference(path, cfg, 784, device="cuda")
        test = loaders.data_loader_mnist(str(REPO / "Data"), cfg.vae_type,
                                         cfg.missing_rate, 64,
                                         device="cpu").test
        data, mask = test.x.numpy(), test.mask.numpy()
        x = data * mask  # the server never sees the missing cells

        card_noise = serve.GeneratorNoise(cfg.seed + 9, "cuda")
        drawn = []

        def recording_noise(kind, ctr, shape):
            eps = card_noise(kind, ctr, shape)
            drawn.append(eps)
            return eps

        srv = serve.ImputationServer(params, cfg, 784, device="cuda",
                                     noise=recording_noise).warmup()
        drawn.clear()
        reset_counts()
        outs = [srv.impute(x[:n], mask[:n]) for n in REQUEST_ROWS]
        serve_counts = counts()
        print(f"launches while serving {len(REQUEST_ROWS)} requests: "
              f"{serve_counts}", flush=True)
        if serve_counts != {**no_kernel, "embed_pool_fwd": len(REQUEST_ROWS)}:
            raise AssertionError(f"serving {len(REQUEST_ROWS)} requests "
                                 f"launched {serve_counts}")

        replay = iter([e.cpu() for e in drawn])
        cpu_srv = serve.ImputationServer(
            params, cfg, 784, device="cpu",
            noise=lambda kind, ctr, shape: next(replay))
        for n, (filled, score) in zip(REQUEST_ROWS, outs):
            if filled.shape != (n, 784) or score.shape != (n,):
                raise AssertionError(f"bad shapes {filled.shape} "
                                     f"{score.shape}")
            if not (np.isfinite(filled).all() and np.isfinite(score).all()):
                raise AssertionError(f"non-finite output for {n} rows")
            np.testing.assert_array_equal(filled * mask[:n], x[:n])
            c_filled, c_score = cpu_srv.impute(x[:n], mask[:n])
            np.testing.assert_allclose(filled, c_filled, rtol=0,
                                       atol=SERVE_ATOL)
            np.testing.assert_allclose(score, c_score, rtol=0,
                                       atol=SERVE_SCORE_ATOL)
            print(f"{n} rows: card vs CPU max abs diff imputed "
                  f"{np.abs(filled - c_filled).max():.3e}, row score "
                  f"{np.abs(score - c_score).max():.3e}", flush=True)
        hole = 1.0 - mask
        filled = outs[-1][0]
        rmse = float(np.sqrt((np.square(filled - data) * hole).sum()
                             / hole.sum()))
        col_mean = x.sum(0) / np.maximum(mask.sum(0), 1.0)
        rmse_mean = float(np.sqrt((np.square(col_mean - data) * hole).sum()
                                  / hole.sum()))
        print(f"RMSE on the {int(hole.sum())} missing cells of the 179 MNIST "
              f"test rows: {rmse:.6f} (column-mean fill: {rmse_mean:.6f})",
              flush=True)
        if not rmse < rmse_mean:
            raise AssertionError("the trained model does not beat the "
                                 "column-mean fill")

    with phase("http"):
        httpd = serve.make_http_server(srv, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        before = _kernel.launches["embed_pool_fwd"]
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/impute",
                data=json.dumps({"x": x[:2].tolist(),
                                 "mask": mask[:2].tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                body = json.loads(resp.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
        thread.join(timeout=30)
        if thread.is_alive():
            raise AssertionError("the HTTP server thread did not stop")
        got = np.asarray(body["imputed"], np.float32)
        if got.shape != (2, 784) or len(body["row_score"]) != 2:
            raise AssertionError("bad HTTP response shape")
        np.testing.assert_array_equal(got * mask[:2], x[:2])
        if _kernel.launches["embed_pool_fwd"] != before + 1:
            raise AssertionError("the HTTP request did not run embed_pool")
        print("POST /impute: 2 rows back", flush=True)

    def step_timer():
        """on_step hook of train(): a CUDA event and the host clock at the
        end of each step's enqueue."""
        marks = []

        def on_step(epoch, step, loss):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((epoch, ev, time.perf_counter()))

        def medians():
            """Median step time after the first epoch (ms): CUDA events
            between consecutive step ends, and the host clock."""
            torch.cuda.synchronize()
            later = [(e, ev, t) for e, ev, t in marks if e >= 1]
            dev = [a[1].elapsed_time(b[1]) for a, b in zip(later, later[1:])]
            host = [(b[2] - a[2]) * 1e3 for a, b in zip(later, later[1:])]
            return statistics.median(dev), statistics.median(host)

        return on_step, medians

    def first_step_card_vs_cpu(cfg, xb, mb, obs_dim):
        """The first training step's loss and gradients on the card against
        the CPU's (plain versions) from the same seeded parameters, batch
        and recorded noise; returns the card step's launches. A leaf no
        loss term reaches (the flow decoder's dead logvar head) must get
        no gradient on either."""
        model = get_model(cfg)
        cpu_params = model.init(torch.Generator().manual_seed(SEED), cfg,
                                obs_dim, device="cpu")
        recorded = []
        card_gen_noise = trainer.GeneratorNoise(SEED + 1, "cuda")

        def recording(kind, epoch, step, shape):
            t = card_gen_noise(kind, epoch, step, shape)
            recorded.append(t)
            return t

        def first_step(params, x, m, noise):
            leaves = {k: v.clone().requires_grad_()
                      for k, v in checkpoint.flatten(params).items()}
            eff, mask_p, eps, extra = trainer.draw_step(cfg, noise, m, 0, 0)
            loss, _ = model.train_loss(checkpoint.unflatten(leaves), x, eff,
                                       mask_p, eps, 1.0, cfg, **extra)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            return loss.detach(), dict(zip(leaves, grads))

        card_params = {k: v.cuda() for k, v in
                       checkpoint.flatten(cpu_params).items()}
        reset_counts()
        card_loss, card_grads = first_step(checkpoint.unflatten(card_params),
                                           xb.cuda(), mb.cuda(), recording)
        step_counts = counts()
        replay = iter([t.cpu() for t in recorded])
        cpu_loss, cpu_grads = first_step(
            cpu_params, xb.cpu(), mb.cpu(),
            lambda kind, epoch, step, shape: next(replay))
        torch.testing.assert_close(card_loss.cpu(), cpu_loss,
                                   rtol=STEP_LOSS_RTOL, atol=0)
        worst, unused = 0.0, 0
        for key, g in cpu_grads.items():
            if g is None or card_grads[key] is None:
                if not (g is None and card_grads[key] is None):
                    raise AssertionError(f"gradient {key}: on one device "
                                         "only")
                unused += 1
                continue
            scale = g.abs().max().item()
            diff = max_abs(card_grads[key].cpu(), g)
            if diff > STEP_GRAD_REL * scale:
                raise AssertionError(f"gradient {key}: card vs CPU max abs "
                                     f"diff {diff:.3e} > {STEP_GRAD_REL} * "
                                     f"{scale:.3e}")
            worst = max(worst, diff / scale if scale else 0.0)
        print(f"first step: loss card {card_loss.item():.6f} CPU "
              f"{cpu_loss.item():.6f}; {len(cpu_grads) - unused} gradient "
              f"leaves ({unused} unused on both), worst max|diff| / "
              f"max|leaf| {worst:.3e}; launches {step_counts}", flush=True)
        return step_counts

    train_cfg = RunConfig(vae_type="reg_EDDI1", data_type="mnist",
                          missing_rate=30, seed=SEED, epoch=MNIST_EPOCHS,
                          batch_size=64)
    with phase("training MNIST reg_EDDI1 / kl_reg (a): first step, card vs "
               "CPU"):
        mnist = loaders.data_loader_mnist(str(REPO / "Data"),
                                          train_cfg.vae_type,
                                          train_cfg.missing_rate, 64,
                                          device="cuda")
        step_counts = first_step_card_vs_cpu(
            train_cfg, mnist.train.x[:64], mnist.train.mask[:64], 784)
        if step_counts != {**no_kernel, **dict.fromkeys(step_kernels, 1)}:
            raise AssertionError(f"one step launched {step_counts}")

    with tempfile.TemporaryDirectory() as ckpt_root:
        with phase(f"training MNIST reg_EDDI1 / kl_reg (b): {MNIST_EPOCHS} "
                   "epochs"):
            on_step, mnist_medians = step_timer()
            steps_per_epoch = -(-mnist.train.n // 64)
            reset_counts()
            t0 = time.perf_counter()
            with no_plain_on_card():
                trained, hist = trainer.train(mnist, train_cfg,
                                              experiments_root=ckpt_root,
                                              device="cuda", on_step=on_step)
            mnist_s = time.perf_counter() - t0
            mnist_counts = counts()
            n_steps = MNIST_EPOCHS * steps_per_epoch
            print(f"{mnist.train.n} rows, {n_steps} steps in {mnist_s:.3f} s; "
                  f"launches {mnist_counts}", flush=True)
            if mnist_counts != {**no_kernel,
                                **dict.fromkeys(step_kernels, n_steps)}:
                raise AssertionError(f"{n_steps} steps launched "
                                     f"{mnist_counts}")
            means = [h / steps_per_epoch for h in hist]
            print(f"mean loss per epoch: {means}", flush=True)
            if not (np.isfinite(hist).all() and means[-1] < means[0]):
                raise AssertionError(f"the MNIST loss did not fall: {means}")
            mnist_dev_ms, mnist_host_ms = mnist_medians()
            print(f"MNIST step p50 after the first epoch: {mnist_dev_ms:.6f} "
                  f"ms (CUDA events), {mnist_host_ms:.6f} ms (host clock) "
                  f"[{card}]", flush=True)

        with phase("training MNIST reg_EDDI1 / kl_reg (c): checkpoint round "
                   "trip, served"):
            loaded = trainer.load_trained(mnist, train_cfg,
                                          experiments_root=ckpt_root,
                                          device="cuda")
            got, want = checkpoint.flatten(loaded), checkpoint.flatten(trained)
            if sorted(got) != sorted(want) or any(
                    not torch.equal(got[k], want[k]) for k in want):
                raise AssertionError("the reloaded checkpoint differs")
            srv2 = serve.ImputationServer(loaded, train_cfg, 784,
                                          device="cuda")
            filled, score = srv2.impute(x, mask)
            if not (np.isfinite(filled).all() and np.isfinite(score).all()):
                raise AssertionError("non-finite output from the trained "
                                     "model")
            np.testing.assert_array_equal(filled * mask, x)
            print(f"{checkpoint.checkpoint_path(train_cfg, '<tmp>')} reloaded "
                  f"({len(got)} leaves); served {len(x)} rows, row score "
                  f"mean {float(score.mean()):.6f}", flush=True)

    wine_cfg = RunConfig(seed=SEED, epoch=WINE_EPOCHS, batch_size=64)
    with phase(f"training flagship {wine_cfg.vae_type} / {wine_cfg.reg_type} "
               f"on {wine_cfg.data_type}: {WINE_EPOCHS} epochs"):
        wine = loaders.data_loader(str(REPO / "Data"), wine_cfg.vae_type,
                                   wine_cfg.missing_rate, 64,
                                   wine_cfg.data_type, device="cuda")
        on_step, wine_medians = step_timer()
        wine_steps = -(-wine.train.n // 64)
        reset_counts()
        with no_plain_on_card():
            wine_params, wine_hist = trainer.train(
                wine, wine_cfg, save=False, device="cuda", on_step=on_step)
        wine_counts = counts()
        n_steps = WINE_EPOCHS * wine_steps
        print(f"{wine.train.n} rows x {wine.obs_dim}, {n_steps} steps; "
              f"launches {wine_counts}", flush=True)
        if wine_counts != {**no_kernel, "fused_posterior_fwd": n_steps,
                           "fused_posterior_bwd": n_steps}:
            raise AssertionError(f"{n_steps} steps launched {wine_counts}")
        means = [h / wine_steps for h in wine_hist]
        print(f"mean loss, first and last epoch: {means[0]:.6f} -> "
              f"{means[-1]:.6f}", flush=True)
        if not (np.isfinite(wine_hist).all() and means[-1] < means[0]):
            raise AssertionError(f"the wine loss did not fall: {means}")
        wine_dev_ms, wine_host_ms = wine_medians()
        print(f"wine step p50 after the first epoch: {wine_dev_ms:.6f} ms "
              f"(CUDA events), {wine_host_ms:.6f} ms (host clock) [{card}]",
              flush=True)

    flow_cfg = RunConfig(vae_type="reg_flow1", missing_rate=30, seed=SEED,
                         epoch=WINE_EPOCHS, batch_size=64)
    with phase(f"training {flow_cfg.vae_type} / {flow_cfg.reg_type} on "
               f"{flow_cfg.data_type} (a): first step, card vs CPU"):
        flow_data = loaders.data_loader(str(REPO / "Data"),
                                        flow_cfg.vae_type,
                                        flow_cfg.missing_rate, 64,
                                        flow_cfg.data_type, device="cuda")
        step_counts = first_step_card_vs_cpu(
            flow_cfg, flow_data.train.x[:64], flow_data.train.mask[:64],
            flow_data.obs_dim)
        if step_counts != no_kernel:
            raise AssertionError(f"a flow step launched {step_counts}")

    with phase(f"training {flow_cfg.vae_type} / {flow_cfg.reg_type} on "
               f"{flow_cfg.data_type} (b): {WINE_EPOCHS} epochs"):
        on_step, flow_medians = step_timer()
        flow_steps = -(-flow_data.train.n // 64)
        reset_counts()
        t0 = time.perf_counter()
        with no_plain_on_card():
            flow_params, flow_hist = trainer.train(
                flow_data, flow_cfg, save=False, device="cuda",
                on_step=on_step)
        flow_s = time.perf_counter() - t0
        flow_counts = counts()
        n_steps = WINE_EPOCHS * flow_steps
        print(f"{flow_data.train.n} rows x {flow_data.obs_dim}, hid_dim "
              f"{flow_cfg.hid_dim}, {n_steps} steps in {flow_s:.3f} s; "
              f"launches {flow_counts}", flush=True)
        if flow_counts != no_kernel:
            raise AssertionError(f"{n_steps} flow steps launched "
                                 f"{flow_counts}")
        means = [h / flow_steps for h in flow_hist]
        print(f"mean loss, first and last epoch: {means[0]:.6f} -> "
              f"{means[-1]:.6f}", flush=True)
        if not (np.isfinite(flow_hist).all() and means[-1] < means[0]):
            raise AssertionError(f"the flow loss did not fall: {means}")
        flow_dev_ms, flow_host_ms = flow_medians()
        print(f"{flow_cfg.vae_type} step p50 after the first epoch: "
              f"{flow_dev_ms:.6f} ms (CUDA events), {flow_host_ms:.6f} ms "
              f"(host clock) [{card}]", flush=True)

    drop_cfg = RunConfig(vae_type="vanilla_EDDI1_with_drop", missing_rate=30,
                         seed=SEED, epoch=WINE_EPOCHS, batch_size=64)
    with phase(f"training {drop_cfg.vae_type} on {drop_cfg.data_type}: "
               f"{WINE_EPOCHS} epochs"):
        drop_data = loaders.data_loader(str(REPO / "Data"),
                                        drop_cfg.vae_type,
                                        drop_cfg.missing_rate, 64,
                                        drop_cfg.data_type, device="cuda")
        src = trainer.GeneratorNoise(drop_cfg.seed + 1, "cuda")
        drawn = collections.Counter()

        def drop_noise(kind, epoch, step, shape):
            t = src(kind, epoch, step, shape)
            drawn[(kind, t.device.type)] += 1
            return t

        on_step, drop_medians = step_timer()
        drop_steps = -(-drop_data.train.n // 64)
        reset_counts()
        with no_plain_on_card():
            drop_params, drop_hist = trainer.train(
                drop_data, drop_cfg, save=False, device="cuda",
                noise=drop_noise, on_step=on_step)
        drop_counts = counts()
        n_steps = WINE_EPOCHS * drop_steps
        print(f"{drop_data.train.n} rows x {drop_data.obs_dim}, {n_steps} "
              f"steps; launches {drop_counts}; draws {dict(drawn)}",
              flush=True)
        if drop_counts != {**no_kernel, "embed_pool_fwd": n_steps,
                           "embed_pool_bwd": n_steps}:
            raise AssertionError(f"{n_steps} steps launched {drop_counts}")
        if drawn[("drop", "cuda")] != n_steps or any(
                dev != "cuda" for _, dev in drawn):
            raise AssertionError(f"the drop mask was not drawn on the card "
                                 f"once a step: {dict(drawn)}")
        means = [h / drop_steps for h in drop_hist]
        print(f"mean loss, first and last epoch: {means[0]:.6f} -> "
              f"{means[-1]:.6f}", flush=True)
        if not (np.isfinite(drop_hist).all() and means[-1] < means[0]):
            raise AssertionError(f"the with_drop loss did not fall: {means}")
        drop_dev_ms, drop_host_ms = drop_medians()
        print(f"{drop_cfg.vae_type} step p50 after the first epoch: "
              f"{drop_dev_ms:.6f} ms (CUDA events), {drop_host_ms:.6f} ms "
              f"(host clock) [{card}]", flush=True)

    records = list(iter_jsonl_configs(str(REPO / "Data"
                                          / "imputation_args.json")))
    # record 1 as the entry point runs it (alpha 1.0, p_missingness 30)
    miwae_cfg = RunConfig.from_jsonl_record(records[0], seed=SEED,
                                            epoch=WINE_EPOCHS, alpha=1.0,
                                            p_missingness=30)
    if (miwae_cfg.vae_type, miwae_cfg.train_k, miwae_cfg.valid_k,
            miwae_cfg.M) != ("reg_MIWAE1", 20, 5000, 1):
        raise AssertionError(f"record 1 is not reg_MIWAE1 at train_k 20, "
                             f"valid_k 5000, M=1: {miwae_cfg}")
    with phase(f"training {miwae_cfg.vae_type} / {miwae_cfg.reg_type} on "
               f"{miwae_cfg.data_type} (d): first step, card vs CPU, "
               f"train_k={miwae_cfg.train_k}"):
        miwae_data = loaders.data_loader(str(REPO / "Data"),
                                         miwae_cfg.vae_type,
                                         miwae_cfg.missing_rate, 64,
                                         miwae_cfg.data_type, device="cuda")
        xb, mb = miwae_data.train.x[:64], miwae_data.train.mask[:64]
        step_counts = first_step_card_vs_cpu(miwae_cfg, xb, mb,
                                             miwae_data.obs_dim)
        if step_counts != no_kernel:
            raise AssertionError(f"a MIWAE step launched {step_counts}")

    with phase(f"training {miwae_cfg.vae_type} / {miwae_cfg.reg_type} on "
               f"{miwae_cfg.data_type} (d): {WINE_EPOCHS} epochs"):
        on_step, miwae_medians = step_timer()
        miwae_steps = -(-miwae_data.train.n // 64)
        reset_counts()
        with no_plain_on_card():
            miwae_params, miwae_hist = trainer.train(
                miwae_data, miwae_cfg, save=False, device="cuda",
                on_step=on_step)
        miwae_counts = counts()
        n_steps = WINE_EPOCHS * miwae_steps
        print(f"{miwae_data.train.n} rows x {miwae_data.obs_dim}, "
              f"missing_rate {miwae_cfg.missing_rate}, {n_steps} steps; "
              f"launches {miwae_counts}", flush=True)
        if miwae_counts != no_kernel:
            raise AssertionError(f"{n_steps} MIWAE steps launched "
                                 f"{miwae_counts}")
        means = [h / miwae_steps for h in miwae_hist]
        print(f"mean loss, first and last epoch: {means[0]:.6f} -> "
              f"{means[-1]:.6f}", flush=True)
        if not (np.isfinite(miwae_hist).all() and means[-1] < means[0]):
            raise AssertionError(f"the MIWAE loss did not fall: {means}")
        miwae_dev_ms, miwae_host_ms = miwae_medians()
        print(f"{miwae_cfg.vae_type} step p50 after the first epoch: "
              f"{miwae_dev_ms:.6f} ms (CUDA events), {miwae_host_ms:.6f} ms "
              f"(host clock) [{card}]", flush=True)

    with phase("training notMIWAE (e): first steps, card vs CPU"):
        for vae_type, variant in (
                ("vanilla_notMIWAE1", {"not_miwae_type": "changed"}),
                ("vanilla_notMIWAE1", {"not_miwae_type": "author"}),
                ("reg_notMIWAE1", {"reg_notmiwae_variant": "v2"}),
                ("reg_notMIWAE1", {"reg_notmiwae_variant": "both_s"}),
                ("reg_notMIWAE1", {"reg_notmiwae_variant": "sampled_mask"})):
            print(f"{vae_type} {variant}:", flush=True)
            step_counts = first_step_card_vs_cpu(
                miwae_cfg.replace(vae_type=vae_type, **variant), xb, mb,
                miwae_data.obs_dim)
            if step_counts != no_kernel:
                raise AssertionError(f"a notMIWAE step launched "
                                     f"{step_counts}")

    def recording_noise(seed):
        """The default eval noise on the card, each draw kept for replay."""
        src, kept = trainer.GeneratorNoise(seed, "cuda"), []

        def noise(kind, rep, step, shape):
            t = src(kind, rep, step, shape)
            kept.append(t)
            return t

        return noise, kept

    def eval_card_vs_cpu(label, dataset, cfg, card_params, cpu_params,
                         want_counts):
        """eval_vae on the card (counts reset just before, read just after,
        no plain version on a CUDA tensor), then on the CPU from the same
        parameters and the card's noise replayed; returns the card's
        results and its launches."""
        noise, kept = recording_noise(cfg.seed + 1)
        reset_counts()
        with no_plain_on_card():
            got = evaluate.eval_vae(dataset, cfg, params=card_params,
                                    noise=noise, save=False, device="cuda")
        launched = counts()
        print(f"{label}: launches {launched}", flush=True)
        if launched != want_counts:
            raise AssertionError(f"{label} launched {launched}, want "
                                 f"{want_counts}")
        replay = iter([t.cpu() for t in kept])
        cpu_ds = loaders.Dataset(
            *(None if sp is None else loaders.Split(sp.x.cpu(), sp.mask.cpu(),
                                                    sp.stage)
              for sp in (dataset.train, dataset.test)), dataset.obs_dim)
        want = evaluate.eval_vae(
            cpu_ds, cfg, params=cpu_params, save=False, device="cpu",
            noise=lambda kind, rep, step, shape: next(replay))
        if next(replay, None) is not None:
            raise AssertionError(f"{label}: the CPU drew less noise")
        for stage in want:
            diffs = []
            for name, value in want[stage].items():
                g = got[stage][name]
                tol = (EVAL_RMSE_ATOL if name == "rmse"
                       else EVAL_LOSS_RTOL * abs(value))
                if not (np.isfinite(g) and abs(g - value) <= tol):
                    raise AssertionError(
                        f"{label} [{stage}] {name}: card {g!r}, CPU "
                        f"{value!r}, tolerance {tol:.3e}")
                diffs.append(f"{name} {g:.6f} (CPU {value:.6f})")
            print(f"{label} [{stage}] card: {', '.join(diffs)}", flush=True)
        return got, launched

    def split_seconds(dataset, cfg, card_params):
        """Median host-clock seconds of eval_vae over each split alone, a
        sync at each end (eval_vae reads its metrics back: the other)."""
        out = {}
        for sp in (dataset.train, dataset.test):
            one = loaders.Dataset(sp, None, dataset.obs_dim)
            runs = []
            for _ in range(EVAL_TIMING_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                evaluate.eval_vae(one, cfg, params=card_params, save=False,
                                  device="cuda")
                runs.append(time.perf_counter() - t0)
            out[sp.stage] = statistics.median(runs)
        return out

    eval_cfg = RunConfig(vae_type="reg_EDDI1", data_type="mnist",
                         missing_rate=30, seed=SEED, M=1, batch_size=64)
    with phase("evaluation (a): MNIST reg_EDDI1, the committed checkpoint, "
               "M=1"):
        n_batches = eval_cfg.M * sum(-(-sp.n // 64)
                                     for sp in (mnist.train, mnist.test))
        # a split of at least _GRAPH_MIN_STEPS batches replays one captured
        # graph of its batch shape, which the splits share: the host
        # launches B2f twice for each shape (the warm-up batch and the
        # capture) and the graph once in each other batch; a shorter split
        # launches B2f once a batch
        want_b2f, captured = 0, set()
        for sp in (mnist.train, mnist.test):
            steps = eval_cfg.M * -(-sp.n // 64)
            if not evaluate._use_graph(torch.device("cuda"), steps):
                want_b2f += steps
            elif min(64, sp.n) not in captured:
                captured.add(min(64, sp.n))
                want_b2f += 2
        cpu_ref = checkpoint.load_reference(path, eval_cfg, 784, device="cpu")
        mnist_eval, mnist_eval_counts = eval_card_vs_cpu(
            "MNIST reg_EDDI1 eval", mnist, eval_cfg, params, cpu_ref,
            {**no_kernel, "embed_pool_fwd": want_b2f})
        committed = float(torch.load(
            artifacts.eval_vae_paths(eval_cfg, "test",
                                     str(REPO / "experiments"))["rmse"],
            weights_only=False))
        test_rmse = mnist_eval["test"]["rmse"]
        print(f"MNIST test RMSE {test_rmse:.6f} over {mnist.test.n} rows "
              f"(column-mean fill on the same cells {rmse_mean:.6f}; the "
              f"committed artifact reads {committed:.6f}, other noise); "
              f"B2f once a batch: {n_batches} batches", flush=True)
        if not test_rmse < rmse_mean:
            raise AssertionError("the evaluated model does not beat the "
                                 "column-mean fill")

    wine_eval_cfg = wine_cfg.replace(M=WINE_EVAL_M)
    with phase(f"evaluation (b): wine {wine_eval_cfg.vae_type} of phase 7, "
               f"M={WINE_EVAL_M}"):
        cpu_wine = {k: v.cpu() for k, v in
                    checkpoint.flatten(wine_params).items()}
        eval_card_vs_cpu(
            "wine reg_vae1 eval", wine, wine_eval_cfg, wine_params,
            checkpoint.unflatten(cpu_wine), no_kernel)

    with phase("evaluation (c): wall-clock per split, device operations"):
        eval_times = {}
        for label, ds, ecfg, prm in (
                ("MNIST reg_EDDI1 M=1", mnist, eval_cfg, params),
                (f"wine reg_vae1 M={WINE_EVAL_M}", wine, wine_eval_cfg,
                 wine_params)):
            secs = split_seconds(ds, ecfg, prm)
            eval_times[label] = secs
            steps = {sp.stage: -(-sp.n // min(64, sp.n))
                     for sp in (ds.train, ds.test)}
            print(f"{label} eval, median of {EVAL_TIMING_RUNS}, host clock: "
                  + ", ".join(f"{st} {secs[st]:.6f} s ({ecfg.M} x "
                              f"{steps[st]} batches, "
                              f"{secs[st] / (ecfg.M * steps[st]) * 1e3:.6f}"
                              f" ms a batch)" for st in secs)
                  + f" [{card}]", flush=True)
            one = loaders.Dataset(loaders.Split(ds.train.x[:64],
                                                ds.train.mask[:64], "train"),
                                  None, ds.obs_dim)
            n_ops = traced_ops(lambda: evaluate.eval_vae(
                one, ecfg.replace(M=1), params=prm, save=False,
                device="cuda"))
            print(f"{label}: the device operations one split of one batch "
                  "of 64 rows puts on the card: "
                  + ("not measured, no trace was whole" if n_ops is None
                     else str(n_ops)), flush=True)

    flow_eval_cfg = flow_cfg.replace(M=FLOW_EVAL_M)
    with phase(f"evaluation (d): {flow_cfg.vae_type} of its training phase, "
               f"M={FLOW_EVAL_M}"):
        cpu_flow = {k: v.cpu() for k, v in
                    checkpoint.flatten(flow_params).items()}
        eval_card_vs_cpu(f"{flow_cfg.vae_type} eval", flow_data,
                         flow_eval_cfg, flow_params,
                         checkpoint.unflatten(cpu_flow), no_kernel)
        secs = split_seconds(flow_data, flow_eval_cfg, flow_params)
        steps = {sp.stage: -(-sp.n // min(64, sp.n))
                 for sp in (flow_data.train, flow_data.test)}
        print(f"{flow_cfg.vae_type} M={FLOW_EVAL_M} eval, median of "
              f"{EVAL_TIMING_RUNS}, host clock: "
              + ", ".join(f"{st} {secs[st]:.6f} s ({FLOW_EVAL_M} x "
                          f"{steps[st]} batches, "
                          f"{secs[st] / (FLOW_EVAL_M * steps[st]) * 1e3:.6f}"
                          f" ms a batch)" for st in secs)
              + f" [{card}]", flush=True)

    # reg_MIWAE1's evaluation at valid_k=5000 on the card against the CPU.
    # Its loss, negl and negl_imp are one row value, at alpha 1 KL_reg +
    # nb_p - reg_like: two logsumexps over 5000 weights and a mean over 5000
    # samples of sums over 13 cells. A weight sums 13 Student-t
    # log-densities (an lgamma that CUDA and the CPU round an ulp or two
    # apart) and two 10-term Gaussian sums, after 128-term dot products
    # that cuBLAS and the CPU accumulate in other orders: about 1e-6 of its
    # size. A logsumexp keeps the relative error of its largest weights and
    # the mean over 5000 samples averages it, so EVAL_LOSS_RTOL (1e-4)
    # holds; the RMSE weighs the x_means by a softmax of the same weights:
    # EVAL_RMSE_ATOL (1e-5).
    with phase(f"evaluation (e): {miwae_cfg.vae_type} of phase 7 (d), "
               f"valid_k={miwae_cfg.valid_k}, M={miwae_cfg.M}"):
        cpu_miwae = checkpoint.unflatten(
            {k: v.cpu() for k, v in checkpoint.flatten(miwae_params).items()})
        test_only = loaders.Dataset(None, miwae_data.test, miwae_data.obs_dim)
        # IW1 once a batch (both branches are one stacked stream), counted
        # from 0: eval_card_vs_cpu resets the counts just before
        iw_launches = miwae_cfg.M * -(-miwae_data.test.n // min(
            64, miwae_data.test.n))
        eval_card_vs_cpu(f"{miwae_cfg.vae_type} eval, the test split",
                         test_only, miwae_cfg, miwae_params, cpu_miwae,
                         {**no_kernel, "iw_fused": iw_launches})
        secs = split_seconds(miwae_data, miwae_cfg, miwae_params)
        steps = {sp.stage: -(-sp.n // min(64, sp.n))
                 for sp in (miwae_data.train, miwae_data.test)}
        print(f"{miwae_cfg.vae_type} valid_k={miwae_cfg.valid_k} eval, "
              f"median of {EVAL_TIMING_RUNS}, host clock: "
              + ", ".join(f"{st} {secs[st]:.6f} s ({miwae_cfg.M} x "
                          f"{steps[st]} batches, "
                          f"{secs[st] / (miwae_cfg.M * steps[st]) * 1e3:.6f}"
                          f" ms a batch)" for st in secs)
              + f" [{card}]", flush=True)
        train_only = loaders.Dataset(miwae_data.train, None,
                                     miwae_data.obs_dim)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        evaluate.eval_vae(train_only, miwae_cfg, params=miwae_params,
                          save=False, device="cuda")
        peak = torch.cuda.max_memory_allocated()
        print(f"{miwae_cfg.vae_type} valid_k={miwae_cfg.valid_k} eval of the "
              f"train split: peak device memory {peak / 2**20:.3f} MiB "
              f"({(peak - base) / 2**20:.3f} MiB above the "
              f"{base / 2**20:.3f} MiB held before) [{card}]", flush=True)
        one = loaders.Dataset(loaders.Split(miwae_data.train.x[:64],
                                            miwae_data.train.mask[:64],
                                            "train"), None, miwae_data.obs_dim)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate.eval_vae(one, miwae_cfg, params=miwae_params,
                              save=False, device="cuda")
            torch.cuda.synchronize()
            batch_ms = (time.perf_counter() - t0) * 1e3
        on_card = profile_train.device_events(prof)
        if on_card:
            busy = profile_train.busy_ms(on_card)
            top = profile_train.top_device_ms(on_card).most_common(8)
            print(f"one batch of 64 rows x {miwae_cfg.valid_k} samples: "
                  f"{batch_ms:.6f} ms (host clock), device busy {busy:.6f} "
                  f"ms ({busy / batch_ms:.1%}), {len(on_card)} device "
                  f"operations; top device ms: "
                  + "; ".join(f"{n} {t:.6f}" for n, t in top)
                  + f" [{card}]", flush=True)
        else:
            print(f"one batch of 64 rows x {miwae_cfg.valid_k} samples: "
                  f"{batch_ms:.6f} ms (host clock); device busy share not "
                  "measured, the trace held no device event", flush=True)

    times = {}

    def timed(label, fn, plain, bound, build=None, runs=TIMING_RUNS):
        """Time `fn` and its plain version `plain` (CUDA events, the median
        of `runs`), count the device operations of one call of `fn` (for a
        backward, of the one `build()` makes, see device_ops), print them
        beside `bound` ((ms, 'bytes' or 'operations')) and return (ms,
        plain ms, bound ms, bound by, operations a call)."""
        k_ms = event_ms(fn, runs=runs)
        p_ms = event_ms(plain, runs=runs)
        n_ops = device_ops(build or (lambda: fn))
        print(f"{label}: kernel {k_ms:.6f} ms ({n_ops} device operations a "
              f"call), plain {p_ms:.6f} ms, bound {bound[0]:.6f} ms "
              f"({bound[1]}) [{card}]", flush=True)
        return k_ms, p_ms, bound[0], bound[1], n_ops

    def backward_of(forward, sources, cts):
        """A builder of one call of autograd's backward: it makes leaves of
        `sources` (detached, so each keeps its strides), runs `forward` on
        them on the current stream and returns the call that takes their
        gradients under the cotangents `cts`. Autograd runs a backward on
        its forward's stream, and hands a leaf its gradient on the stream
        where the leaf was first used."""
        def build():
            leaves = [t.detach().requires_grad_() for t in sources]
            outs = forward(*leaves)
            return lambda: torch.autograd.grad(outs, leaves, cts,
                                               retain_graph=True)
        return build

    with phase("timings"):
        # what one launch of a trivial PyTorch kernel costs on this timing
        one = torch.zeros(1, device="cuda")
        floor_ms = event_ms(lambda: one.add_(1.0))
        print(f"launch floor: a 1-element torch add_ {floor_ms:.6f} ms "
              f"[{card}]", flush=True)
        # B2f at the serving shape, as ImputationServer launches it
        S, B = 1, 512
        A, C = layers._pointnet_affine(params["encoder"])
        xt = torch.from_numpy(np.concatenate(
            [x, np.zeros((B - len(x), 784), np.float32)])).cuda()
        mt = torch.from_numpy(np.concatenate(
            [mask, np.ones((B - len(x), 784), np.float32)]))[None].cuda()
        with torch.no_grad():
            timed(f"B2f EmbedPool.forward S={S} B={B} (serving)",
                  lambda: fep.embed_pool(xt, mt, A, C),
                  lambda: fep.embed_pool_reference(xt, mt, A, C),
                  embed_pool_bound_ms(S, B, D, K))

        # B2f as an evaluation batch launches it (S=1, B=64)
        xe = torch.from_numpy(x[:64]).cuda()
        me = torch.from_numpy(mask[:64])[None].cuda()
        with torch.no_grad():
            times["embed_pool_fwd_eval"] = timed(
                "B2f EmbedPool.forward S=1 B=64 (evaluation)",
                lambda: fep.embed_pool(xe, me, A, C),
                lambda: fep.embed_pool_reference(xe, me, A, C),
                embed_pool_bound_ms(1, 64, D, K))

        # B2f and B2b as a training step launches them (S=2, B=64), then
        # at S=2, B=4096, where the bytes and not the launch set the time
        for S, B in ((2, 64), (2, 4096)):
            tag = ("training" if B == 64 else
                   "diagnostic: bytes, not the launch, set the time")
            x2, m2, A2, C2 = inputs(S, B)
            g2 = torch.randn(S, B, K, device="cuda", generator=gen)
            with torch.no_grad():
                fwd = timed(f"B2f EmbedPool.forward S={S} B={B} ({tag})",
                            lambda: fep.embed_pool(x2, m2, A2, C2),
                            lambda: fep.embed_pool_reference(x2, m2, A2, C2),
                            embed_pool_bound_ms(S, B, D, K))
            # the step's backward: A and C need a gradient, x and masks not
            build = backward_of(lambda A, C: fep.embed_pool(x2, m2, A, C),
                                (A2, C2), g2)
            bwd = timed(
                f"B2b EmbedPool.backward S={S} B={B}, dA and dC only ({tag})",
                build(),
                lambda: fep.embed_pool_bwd_reference(x2, m2, A2, C2, g2),
                embed_pool_bwd_bound_ms(S, B, D, K, dx=False, dmasks=False),
                build=build)
            if B == 64:
                times["embed_pool_fwd"], times["embed_pool_bwd"] = fwd, bwd
            timed(f"B2b embed_pool_bwd standalone S={S} B={B}, all four "
                  f"outputs ({tag})",
                  lambda: fep.embed_pool_bwd(x2, m2, A2, C2, g2),
                  lambda: fep.embed_pool_bwd_reference(x2, m2, A2, C2, g2),
                  embed_pool_bwd_bound_ms(S, B, D, K))

        # B2f and B2b as a `_with_drop` wine step launches them (S=1,
        # B=64, D=13): the forward, and the backward for A and C only
        xw, mw, Aw, Cw = inputs(1, 64, D=WINE_D)
        gw = torch.randn(1, 64, K, device="cuda", generator=gen)
        with torch.no_grad():
            times["embed_pool_fwd_wine"] = timed(
                f"B2f EmbedPool.forward S=1 B=64 D={WINE_D} (wine training)",
                lambda: fep.embed_pool(xw, mw, Aw, Cw),
                lambda: fep.embed_pool_reference(xw, mw, Aw, Cw),
                embed_pool_bound_ms(1, 64, WINE_D, K))
        build = backward_of(lambda A, C: fep.embed_pool(xw, mw, A, C),
                            (Aw, Cw), gw)
        times["embed_pool_bwd_wine"] = timed(
            f"B2b EmbedPool.backward S=1 B=64 D={WINE_D}, dA and dC only "
            "(wine training)",
            build(),
            lambda: fep.embed_pool_bwd_reference(xw, mw, Aw, Cw, gw),
            embed_pool_bwd_bound_ms(1, 64, WINE_D, K, dx=False,
                                    dmasks=False),
            build=build)

        # B1 and its backward as a training step launches them, then at
        # [4096, 10]: the statistics strided (the leaves are detached views,
        # which keep the row stride 2L), the backward for the four
        # statistics through autograd
        for Bq, L in ((64, LATENT), (4096, LATENT)):
            tag = "training" if Bq == 64 else "diagnostic"
            st = stats(Bq, L, strided=True)
            cells = -(-Bq * L // 1024)
            fwd = timed(f"B1 fused_posterior [{Bq},{L}] ({tag}: one block, "
                        f"{cells} cell{'s' * (cells > 1)} a thread at most)",
                        lambda: fp.fused_posterior_kernel(*st),
                        lambda: fp.fused_posterior_reference(*st),
                        fused_posterior_bound_ms(Bq, L))
            if any(t.detach().stride() != (2 * L, 1) for t in st[:4]):
                raise AssertionError("B1 timing: the statistics lost their "
                                     "row stride 2L")
            cts = b1_cotangents(Bq, L)
            build = backward_of(
                lambda *lv: fp.FusedPosterior.apply(*lv, *st[4:]), st[:4],
                cts)
            bwd = timed(
                f"B1 FusedPosterior.backward [{Bq},{L}], the four statistics' "
                f"gradients ({tag})",
                build(),
                lambda: fp.fused_posterior_backward(st, *cts),
                fused_posterior_bwd_bound_ms(Bq, L), build=build)
            if Bq == 64:
                times["fused_posterior_fwd"] = fwd
                times["fused_posterior_bwd"] = bwd
        for name in ("fused_posterior_fwd", "fused_posterior_bwd"):
            if times[name][4] != 1:
                raise AssertionError(f"{name}: {times[name][4]} device "
                                     "operations a call, not 1")
        # the count sees each operation of a call that makes many: B1's
        # plain backward, eager PyTorch
        n_plain = device_ops(
            lambda: lambda: fp.fused_posterior_backward(st, *cts))
        print(f"B1 plain backward [{Bq},{L}]: {n_plain} device operations a "
              "call", flush=True)
        if n_plain < 2:
            raise AssertionError(f"the graph count gives B1's plain backward "
                                 f"{n_plain} device operations")

        # IW1 as an evaluation batch of record 4 (vanilla_MIWAE1, valid_k
        # 5000) calls it: a stream of 64 rows, then the 17-row test batch,
        # on the parameters of phase 7 (d); each held against its plain
        # version on the same inputs first. A call is two device operations:
        # the encoder, then the body with its reductions over K
        iw_cfg = miwae_cfg.replace(vae_type="vanilla_MIWAE1")
        iw_err = {}
        enc, dec = miwae_params["encoder"], miwae_params["decoder"]
        leaves = (*fiw.mlp_leaves(enc), *fiw.mlp_leaves(dec))
        for Bi in (64, 17):
            xi = miwae_data.train.x[:Bi]
            mi = miwae_data.train.mask[:Bi]
            ei = torch.randn(Bi, iw_cfg.valid_k, LATENT, device="cuda",
                             generator=gen)
            with torch.no_grad():
                got = fiw.iw_fused(xi, mi, None, ei, enc, dec,
                                   miwae.NEGL_DIVISOR)
                want = fiw.iw_fused_reference(xi, mi, None, ei,
                                              miwae.NEGL_DIVISOR, *leaves)
                gaps = [max_abs(g, w) for g, w in zip(got, want)]
                iw_err[Bi] = max(gaps)
                print(f"IW1 iw_fused [{Bi}, {iw_cfg.valid_k}] against its "
                      f"plain version: max abs diff x_imputed {gaps[0]:.3e}, "
                      f"per_row {gaps[1]:.3e}, mean {gaps[2]:.3e}, scale "
                      f"{gaps[3]:.3e}", flush=True)
                torch.testing.assert_close(got[0], want[0], rtol=0,
                                           atol=IW1_X_MEAN_ATOL)
                for g, w in zip(got[1:], want[1:]):
                    torch.testing.assert_close(g, w, rtol=IW1_TERMS_RTOL,
                                               atol=IW1_TERMS_ATOL)
                times[f"iw_fused_{Bi}"] = timed(
                    f"IW1 iw_fused [{Bi}, {iw_cfg.valid_k}], D={WINE_D}, "
                    f"L={LATENT} (record 4's evaluation batch)",
                    lambda: fiw.iw_fused(xi, mi, None, ei, enc, dec,
                                         miwae.NEGL_DIVISOR),
                    lambda: fiw.iw_fused_reference(
                        xi, mi, None, ei, miwae.NEGL_DIVISOR, *leaves),
                    iw_fused_bound_ms(Bi, iw_cfg.valid_k, WINE_D, LATENT))
            if times[f"iw_fused_{Bi}"][4] != 2:
                raise AssertionError(f"IW1 [{Bi}]: {times[f'iw_fused_{Bi}'][4]}"
                                     " device operations a call, not 2")
            if Bi == 64:
                # the model's whole step: IW1's two operations, nothing else
                with torch.no_grad():
                    n_step = device_ops(lambda: lambda: miwae.eval_step(
                        miwae_params, xi, mi, None, ei, iw_cfg))
                print(f"vanilla_MIWAE1 eval_step [64, {iw_cfg.valid_k}]: "
                      f"{n_step} device operations a call", flush=True)
                if n_step != 2:
                    raise AssertionError(f"a vanilla MIWAE eval_step is "
                                         f"{n_step} device operations, not 2")
        # IW2 as eval_vae_mnar calls it for the MNAR grid's records (all
        # 178 rows of the MNAR wine table at valid_k 10000), then as an
        # eval_vae batch of 64 of them at that valid_k, on seeded
        # parameters of the grid's 'changed' network; each held against its
        # plain version first. A call is two device operations: the
        # encoder, then the body with its reductions over K
        iw2_cfg = RunConfig(vae_type="reg_notMIWAE1", latent_dim=LATENT,
                            valid_k=MNAR_VALID_K, not_miwae_type="changed")
        iw2_data = loaders.data_loader_mnar(str(REPO / "Data"),
                                            iw2_cfg.vae_type, 50, 128,
                                            "wine", device="cuda")
        iw2_D = iw2_data.obs_dim
        iw2_p = get_model(iw2_cfg).init(
            torch.Generator(device="cuda").manual_seed(SEED), iw2_cfg,
            iw2_D, device="cuda")
        iw2_leaves = fim.leaves_of(iw2_p)
        iw2_err = {}
        for Bi in (iw2_data.train.n, 64):
            xi = iw2_data.train.x[:Bi]
            mi = iw2_data.train.mask[:Bi]
            ei = torch.randn(Bi, iw2_cfg.valid_k, LATENT, device="cuda",
                             generator=gen)
            with torch.no_grad():
                got = fim.iw_mnar(xi, mi, ei, iw2_p, iw2_cfg)
                want = fim.iw_mnar_reference(xi, mi, ei, iw2_cfg,
                                             *iw2_leaves)
                x_gap = max_abs(got[0], want[0])
                row_gap = float(((got[1] - want[1]).abs()
                                 / want[1].abs().clamp(min=1.0)).max())
                iw2_err[Bi] = max(x_gap, row_gap)
                print(f"IW2 iw_mnar [{Bi}, {iw2_cfg.valid_k}] against its "
                      f"plain version: max abs diff x_imputed {x_gap:.3e}, "
                      f"per_row (relative) {row_gap:.3e}, mean "
                      f"{max_abs(got[2], want[2]):.3e}, logvar "
                      f"{max_abs(got[3], want[3]):.3e}", flush=True)
                if not (x_gap <= IW2_IMPUTED_ATOL and row_gap <= IW2_ROW_RTOL):
                    raise AssertionError(f"IW2 [{Bi}]: x_imputed {x_gap}, "
                                         f"per_row {row_gap}")
                times[f"iw_mnar_{Bi}"] = timed(
                    f"IW2 iw_mnar [{Bi}, {iw2_cfg.valid_k}], D={iw2_D}, "
                    f"L={LATENT} (the MNAR records' evaluation)" if Bi != 64
                    else f"IW2 iw_mnar [64, {iw2_cfg.valid_k}], D={iw2_D}, "
                    f"L={LATENT} (an eval_vae batch)",
                    lambda: fim.iw_mnar(xi, mi, ei, iw2_p, iw2_cfg),
                    lambda: fim.iw_mnar_reference(xi, mi, ei, iw2_cfg,
                                                  *iw2_leaves),
                    iw_mnar_bound_ms(Bi, iw2_cfg.valid_k, iw2_D, LATENT))
            if times[f"iw_mnar_{Bi}"][4] != 2:
                raise AssertionError(f"IW2 [{Bi}]: {times[f'iw_mnar_{Bi}'][4]}"
                                     " device operations a call, not 2")
            if Bi != 64:
                # the model's whole step: IW2's two operations, nothing else
                with torch.no_grad():
                    n_step = device_ops(lambda: lambda: notmiwae.eval_step(
                        iw2_p, xi, mi, None, ei, iw2_cfg))
                print(f"reg_notMIWAE1 eval_step [{Bi}, {iw2_cfg.valid_k}]: "
                      f"{n_step} device operations a call", flush=True)
                if n_step != 2:
                    raise AssertionError(f"a notMIWAE eval_step is {n_step} "
                                         "device operations, not 2")
        # one eval_vae call of miwae_wine's shape (record 4, both splits,
        # 3 + 1 batches): its device operations, from a trace of the call
        evaluate.eval_vae(miwae_data, iw_cfg, params=miwae_params,
                          save=False, device="cuda")
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            evaluate.eval_vae(miwae_data, iw_cfg, params=miwae_params,
                              save=False, device="cuda")
            torch.cuda.synchronize()
        on_card = profile_train.device_events(prof)
        iw_names = sum("iw_" in e.name for e in on_card)
        print(f"vanilla_MIWAE1 eval_vae on the wine splits "
              f"({miwae_data.train.n} + {miwae_data.test.n} rows, valid_k "
              f"{iw_cfg.valid_k}): "
              + (f"{len(on_card)} device operations a call, {iw_names} of "
                 f"them IW1's" if on_card else
                 "device operations not measured (the trace held none)")
              + f" [{card}]", flush=True)

        timed_srv = serve.ImputationServer(params, cfg, 784,
                                           device="cuda").warmup()
        for n, bucket in ((64, 64), (179, 512)):
            lat = []
            for _ in range(TIMING_RUNS):
                t0 = time.perf_counter()
                timed_srv.impute(x[:n], mask[:n])
                lat.append((time.perf_counter() - t0) * 1e3)
            print(f"request of {n} rows (bucket {bucket}): p50 "
                  f"{statistics.median(lat):.6f} ms over {TIMING_RUNS} "
                  f"[{card}]", flush=True)

    def seeded(cfg, obs_dim, seed=SEED):
        """Seeded parameters of `cfg`'s model on the CPU and their copy on
        the card; an ActNorm's affines made non-identity, so the layers do
        something."""
        cpu_p = get_model(cfg).init(torch.Generator().manual_seed(seed), cfg,
                                    obs_dim, device="cpu")
        if cfg.flow_actnorm:
            g = torch.Generator().manual_seed(SEED + 3)
            cpu_p["actnorm"] = [
                {k: 0.1 * torch.randn(v.shape, generator=g)
                 for k, v in layer.items()} for layer in cpu_p["actnorm"]]
        card_p = checkpoint.unflatten(
            {k: v.cuda() for k, v in checkpoint.flatten(cpu_p).items()})
        return cpu_p, card_p

    # the families that serve K = valid_k importance samples a row, and the
    # flow with its list of ActNorm parameters, at the wine width
    serve_cfgs = (miwae_cfg.replace(vae_type="vanilla_MIWAE1"), miwae_cfg,
                  miwae_cfg.replace(vae_type="vanilla_notMIWAE1"),
                  flow_cfg.replace(flow_actnorm=True))
    serve_b = {}
    with phase(f"serving (b): every family at the wine width, valid_k="
               f"{miwae_cfg.valid_k}, card vs CPU"):
        wm = miwae_data.train.mask[:64].cpu().numpy()
        wx = miwae_data.train.x[:64].cpu().numpy() * wm
        for scfg in serve_cfgs:
            label = scfg.vae_type + (" (ActNorm)" if scfg.flow_actnorm
                                     else "")
            cpu_p, card_p = seeded(scfg, WINE_D)
            src, kept = serve.GeneratorNoise(scfg.seed + 9, "cuda"), []

            def rec(kind, ctr, shape, _src=src, _kept=kept):
                t = _src(kind, ctr, shape)
                _kept.append(t)
                return t

            srv = serve.ImputationServer(card_p, scfg, WINE_D,
                                         buckets=SERVE_B_BUCKETS,
                                         device="cuda", noise=rec)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            with no_plain_on_card():
                outs = [srv.impute(wx[:n], wm[:n]) for n in SERVE_B_BUCKETS]
            launched = counts()
            peak = torch.cuda.max_memory_allocated()
            # IW1 once a request for the MIWAE types, IW2 for notMIWAE
            want = {**no_kernel, "iw_fused": len(SERVE_B_BUCKETS)
                    if runs_iw1(scfg) else 0,
                    "iw_mnar": len(SERVE_B_BUCKETS)
                    if runs_iw2(scfg) else 0}
            if launched != want:
                raise AssertionError(f"serving {label} launched {launched}, "
                                     f"want {want}")
            replay = iter([t.cpu() for t in kept])
            cpu_srv = serve.ImputationServer(
                cpu_p, scfg, WINE_D, buckets=SERVE_B_BUCKETS, device="cpu",
                noise=lambda kind, ctr, shape: next(replay))
            worst_f = worst_s = 0.0
            for n, (filled, score) in zip(SERVE_B_BUCKETS, outs):
                if filled.shape != (n, WINE_D) or score.shape != (n,):
                    raise AssertionError(f"{label}: bad shapes "
                                         f"{filled.shape} {score.shape}")
                if not (np.isfinite(filled).all()
                        and np.isfinite(score).all()):
                    raise AssertionError(f"{label}: non-finite output for "
                                         f"{n} rows")
                np.testing.assert_array_equal(filled * wm[:n], wx[:n])
                c_filled, c_score = cpu_srv.impute(wx[:n], wm[:n])
                np.testing.assert_allclose(filled, c_filled, rtol=0,
                                           atol=SERVE_ATOL)
                np.testing.assert_allclose(score, c_score,
                                           rtol=SERVE_B_SCORE_RTOL,
                                           atol=SERVE_B_SCORE_ATOL)
                worst_f = max(worst_f, float(np.abs(filled - c_filled).max()))
                worst_s = max(worst_s, float(
                    (np.abs(score - c_score) / np.abs(c_score)).max()))
            if next(replay, None) is not None:
                raise AssertionError(f"{label}: the CPU drew less noise")
            timed_b = serve.ImputationServer(card_p, scfg, WINE_D,
                                             buckets=SERVE_B_BUCKETS,
                                             device="cuda").warmup()
            lat = []
            for _ in range(TIMING_RUNS):
                t0 = time.perf_counter()
                timed_b.impute(wx, wm)
                lat.append((time.perf_counter() - t0) * 1e3)
            serve_b[label] = dict(p50_ms=statistics.median(lat),
                                  peak_mib=peak / 2**20,
                                  above_mib=(peak - base) / 2**20)
            print(f"{label}: requests of {SERVE_B_BUCKETS} rows, card vs CPU "
                  f"max abs diff imputed {worst_f:.3e}, max relative diff "
                  f"row score {worst_s:.3e}; launches {launched}; peak device "
                  f"memory {peak / 2**20:.3f} MiB ({(peak - base) / 2**20:.3f}"
                  f" MiB above the {base / 2**20:.3f} MiB held before); "
                  f"request of 64 rows (bucket 64): p50 "
                  f"{serve_b[label]['p50_ms']:.6f} ms over {TIMING_RUNS} "
                  f"[{card}]", flush=True)

    mnar_records = list(iter_jsonl_configs(str(
        REPO / "Data" / "imputation_args_mnar.json")))
    # the records as the MNAR entry point runs them: its sweep's
    # p_missingness 50 and alpha 1.0, its pinned transform and notMIWAE type
    mnar_cfgs = [RunConfig.from_jsonl_record(
        r, seed=SEED, alpha=1.0, p_missingness=50, data_transform="minmax",
        not_miwae_type="changed") for r in mnar_records]
    if [(c.vae_type, c.epoch, c.batch_size, c.valid_k, c.M)
            for c in mnar_cfgs] != [(v, 1, 128, 10000, 1) for v in (
                "vanilla_notMIWAE1", "reg_notMIWAE1")]:
        raise AssertionError(f"Data/imputation_args_mnar.json is not "
                             f"vanilla_notMIWAE1 and reg_notMIWAE1 at epoch "
                             f"1, batch 128, valid_k 10000, M=1: {mnar_cfgs}")
    # MNAR_RMSE_ATOL: a sum over the 178 x 12 cells (1043 holes) of squared
    # errors of values in [0, 1], each imputation a softmax-weighted mean
    # over valid_k samples of decoder outputs after 128-term dot products
    # that cuBLAS and the CPU accumulate in other orders (about 1e-6 of
    # each); its square root keeps that relative error: atol 1e-5 on an
    # RMSE of about 0.2
    with phase(f"MNAR evaluation (a): eval_vae_mnar on the 178 wine rows, "
               f"M={MNAR_CHECK_M}, valid_k={MNAR_CHECK_K}, card vs CPU"):
        mnar = loaders.data_loader_mnar(str(REPO / "Data"),
                                        mnar_cfgs[0].vae_type, 50, 128,
                                        "wine", device="cuda")
        for i, mcfg in enumerate(mnar_cfgs):
            ecfg = mcfg.replace(M=MNAR_CHECK_M, valid_k=MNAR_CHECK_K)
            # both records evaluate the same q branch: other parameters
            # for each, so the two checks differ
            cpu_p, card_p = seeded(ecfg, mnar.obs_dim, seed=SEED + i)
            noise, kept = recording_noise(ecfg.seed + 2)
            reset_counts()
            with no_plain_on_card():
                got = evaluate.eval_vae_mnar(
                    mnar.train.x, mnar.train.mask, ecfg, params=card_p,
                    noise=noise, save=False, device="cuda")
            launched = counts()
            if launched != {**no_kernel, "iw_mnar": ecfg.M}:
                raise AssertionError(f"MNAR eval of {ecfg.vae_type} "
                                     f"launched {launched}, not IW2 once a "
                                     "rep")
            replay = iter([t.cpu() for t in kept])
            want = evaluate.eval_vae_mnar(
                mnar.train.x.cpu(), mnar.train.mask.cpu(), ecfg,
                params=cpu_p, save=False, device="cpu",
                noise=lambda kind, rep, step, shape: next(replay))
            if next(replay, None) is not None:
                raise AssertionError(f"MNAR eval of {ecfg.vae_type}: the "
                                     "CPU drew less noise")
            if not (np.isfinite(got) and abs(got - want) <= MNAR_RMSE_ATOL):
                raise AssertionError(f"MNAR eval of {ecfg.vae_type}: card "
                                     f"{got!r}, CPU {want!r}, tolerance "
                                     f"{MNAR_RMSE_ATOL}")
            print(f"{ecfg.vae_type} MNAR RMSE over {mnar.train.n} rows x "
                  f"{mnar.obs_dim}: card {got:.6f}, CPU {want:.6f} (diff "
                  f"{abs(got - want):.3e}); launches {launched}", flush=True)

    from vae_posterior_consistency_tpu_torch.experiment_main import (
        imputation_mnar,
    )
    with phase("MNAR grid (b): experiment_main/imputation_mnar.py over both "
               "records of Data/imputation_args_mnar.json as they stand"):
        real_train, real_eval = trainer.train, evaluate.eval_vae_mnar
        per_record = []

        def timed_train(dataset, cfg, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_train(dataset, cfg, *args, **kw)
            torch.cuda.synchronize()
            per_record.append({"cfg": cfg,
                               "train_s": time.perf_counter() - t0})
            return out

        def measured_eval(*args, **kw):
            """The entry point's evaluation, its peak device memory and a
            trace of it under torch.profiler."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                rmse = real_eval(*args, **kw)
                torch.cuda.synchronize()
                eval_s = time.perf_counter() - t0
            per_record[-1].update(
                eval_s=eval_s, rmse=rmse, base=base,
                peak=torch.cuda.max_memory_allocated(),
                on_card=profile_train.device_events(prof))
            return rmse

        with tempfile.TemporaryDirectory() as tmp:
            os.symlink(REPO / "Data", Path(tmp) / "Data")
            cwd = os.getcwd()
            os.chdir(tmp)
            trainer.train, evaluate.eval_vae_mnar = timed_train, measured_eval
            reset_counts()
            try:
                with no_plain_on_card():
                    rc = imputation_mnar.main([])
            finally:
                trainer.train, evaluate.eval_vae_mnar = real_train, real_eval
                os.chdir(cwd)
            grid_counts = counts()
            # IW2 once a record's evaluation rep; training runs no kernel
            if rc != 0 or grid_counts != {
                    **no_kernel, "iw_mnar": sum(c.M for c in mnar_cfgs)}:
                raise AssertionError(f"the MNAR grid returned {rc}, launched "
                                     f"{grid_counts}")
            if [r["cfg"].vae_type for r in per_record] != [
                    c.vae_type for c in mnar_cfgs]:
                raise AssertionError(f"the MNAR grid ran "
                                     f"{[r['cfg'] for r in per_record]}")
            for r, mcfg in zip(per_record, mnar_cfgs):
                if r["cfg"] != mcfg:
                    raise AssertionError(f"the MNAR grid ran {r['cfg']}, "
                                         f"not {mcfg}")
                root = str(Path(tmp) / "experiments")
                saved = torch.load(
                    artifacts.eval_mnar_paths(mcfg, root)["rmse"],
                    weights_only=False)
                if not (np.isfinite(r["rmse"]) and saved.item() == r["rmse"]
                        and Path(checkpoint.checkpoint_path(mcfg,
                                                            root)).is_file()):
                    raise AssertionError(f"{mcfg.vae_type}: RMSE "
                                         f"{r['rmse']!r}, artifact "
                                         f"{saved.item()!r}")
                on_card = r["on_card"]
                ms = r["eval_s"] * 1e3
                wall = r["train_s"] + r["eval_s"]
                line = (f"{mcfg.vae_type}: wall-clock {wall:.6f} s (train "
                        f"{r['train_s']:.6f} s, eval {ms:.6f} ms, "
                        f"the eval under torch.profiler); RMSE "
                        f"{r['rmse']:.6f}, artifact and checkpoint at their "
                        f"reference names; eval at valid_k {mcfg.valid_k} "
                        f"over {mcfg.M} rep of 178 rows: peak device memory "
                        f"{r['peak'] / 2**20:.3f} MiB "
                        f"({(r['peak'] - r['base']) / 2**20:.3f} MiB above "
                        f"the {r['base'] / 2**20:.3f} MiB held before)")
                if on_card:
                    busy = profile_train.busy_ms(on_card)
                    top = profile_train.top_device_ms(on_card).most_common(6)
                    line += (f"; device busy {busy:.6f} ms ({busy / ms:.1%}"
                             f"), {len(on_card)} device operations; top "
                             "device ms: " + "; ".join(
                                 f"{n} {t:.6f}" for n, t in top))
                else:
                    line += ("; device busy share not measured, the trace "
                             "held no device event")
                print(line + f" [{card}]", flush=True)

    from vae_posterior_consistency_tpu_torch.engine import (
        active_learning as al,
    )
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        active_learning as al_main,
    )
    # the AL records as the entry point runs them (alpha 1.0, p_missingness
    # 30), with the parameters phase 7 trained for each (the
    # vanilla_EDDI1_with_drop run's for reg_EDDI1: one pointnet encoder and
    # decoder, K=10 in both)
    al_cfgs = [RunConfig.from_jsonl_record(records[i - 1], seed=SEED,
                                           alpha=1.0, p_missingness=30)
               for i in AL_RECORDS]
    if [(c.vae_type, c.M, c.K) for c in al_cfgs] != [
            ("reg_vae1", 50, 10), ("reg_EDDI1", 50, 10),
            ("reg_flow1", 50, 20), ("reg_MIWAE1", 1, 10)] or (
                al_cfgs[3].valid_k != 5000):
        raise AssertionError(f"records {AL_RECORDS} are not reg_vae1, "
                             f"reg_EDDI1, reg_flow1 at M=50 and reg_MIWAE1 "
                             f"at M=1, valid_k 5000: {al_cfgs}")
    al_params = {"reg_vae1": wine_params, "reg_EDDI1": drop_params,
                 "reg_flow1": flow_params, "reg_MIWAE1": miwae_params}

    with phase(f"active learning (a): al_step card vs CPU from the card's "
               f"masks and noise, M cut to {AL_CHECK_M}, records "
               f"{AL_RECORDS}"):
        for acfg in al_cfgs:
            acfg = acfg.replace(M=min(acfg.M, AL_CHECK_M))
            model = get_model(acfg)
            data = loaders.data_loader(str(REPO / "Data"), acfg.vae_type,
                                       acfg.missing_rate, 64, acfg.data_type,
                                       device="cuda")
            x = data.test.x
            n, D = x.shape
            src, kept = al.default_noise(acfg, "cuda"), {}

            def noise(kind, repeat, step, shape, _src=src, _kept=kept):
                t = _src(kind, repeat, step, shape)
                _kept[(kind, repeat, step)] = t
                return t

            card_p = al_params[acfg.vae_type]
            reset_counts()
            with no_plain_on_card(), torch.no_grad():
                ep = al.run_episode(model, card_p, acfg, x, noise)
            launched = counts()
            want_b2f = 1 + 6 * (D - 1) if "EDDI" in acfg.vae_type else 0
            # IW1 once an imputation sample of each completion: the
            # empty-mask predictive MSE's, then each step's imputations and
            # predictive MSE after the reveal, M (1 + 2 (D-1))
            want_iw = acfg.M * (1 + 2 * (D - 1)) if runs_iw1(acfg) else 0
            if launched != {**no_kernel, "embed_pool_fwd": want_b2f,
                            "iw_fused": want_iw}:
                raise AssertionError(f"the {acfg.vae_type} episode launched "
                                     f"{launched}")

            def replay(kind, repeat, step, shape, _kept=kept):
                t = _kept[(kind, repeat, step)]
                if tuple(t.shape) != tuple(shape):
                    raise AssertionError(f"{kind} {step}: {tuple(t.shape)}, "
                                         f"not {tuple(shape)}")
                return t.cpu()

            worst, knot, n_R, compared = al_card_vs_cpu(acfg, ep, card_p, x,
                                                        replay)
            print(f"{acfg.vae_type} M={acfg.M}: {D - 1} steps on {n} rows, "
                  f"card vs CPU: rewards {worst['R']:.3e}"
                  + (f" ({knot} of {n_R} at a spline knot)" if knot else "")
                  + f", imputations {worst['im']:.3e}, curve "
                  f"{worst['mse']:.3e}; reveals equal on {compared} of "
                  f"{n * (D - 1)} (row, step) pairs whose top two rewards "
                  f"clear the tolerance; launches {launched}", flush=True)

    with phase(f"active learning (b): experiment_main/active_learning.py "
               f"over records {AL_RECORDS} as they stand"):
        real_al, real_fwd = al.active_learning_func, fep._embed_pool_fwd_kernel
        per_record, b2f_shapes = [], []

        def shaped_fwd(x, masks, A, C, S, B, D, K, plan=None):
            b2f_shapes.append((S, B, D, K))
            return real_fwd(x, masks, A, C, S, B, D, K, plan)

        def measured_al(*args, **kw):
            """The entry point's episode: once under torch.profiler, not
            saved (it also warms up), then as the entry point asks, timed,
            its launches and B2f's shapes read."""
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                real_al(*args, **{**kw, "save": False})
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - t0) * 1e3
            reset_counts()
            b2f_shapes.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_al(*args, **kw)
            torch.cuda.synchronize()
            per_record.append({
                "cfg": args[3], "wall_s": time.perf_counter() - t0,
                "counts": counts(), "shapes": list(b2f_shapes),
                "prof_ms": prof_ms,
                "on_card": profile_train.device_events(prof)})
            return out

        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            (root / "Data").mkdir()
            os.symlink(REPO / "Data" / "wine", root / "Data" / "wine")
            with open(root / "Data" / "imputation_args.json", "w") as fh:
                for i in AL_RECORDS:
                    fh.write(json.dumps(records[i - 1]) + "\n")
            for acfg in al_cfgs:
                checkpoint.save(al_params[acfg.vae_type],
                                checkpoint.checkpoint_path(
                                    acfg, str(root / "experiments")))
            cwd = os.getcwd()
            os.chdir(tmp)
            al.active_learning_func = measured_al
            fep._embed_pool_fwd_kernel = shaped_fwd
            try:
                with no_plain_on_card():
                    rc = al_main.main([])
            finally:
                al.active_learning_func = real_al
                fep._embed_pool_fwd_kernel = real_fwd
                os.chdir(cwd)
            if rc != 0 or [r["cfg"] for r in per_record] != al_cfgs:
                raise AssertionError(f"the AL grid returned {rc}, ran "
                                     f"{[r['cfg'] for r in per_record]}")
            al_counts = collections.Counter()
            for r in per_record:
                acfg = r["cfg"]
                al_counts.update(r["counts"])
                n, D = AL_ROWS, WINE_D
                # B2f's launches an EDDI episode: the empty-mask predictive
                # MSE's imputations, then each of the D-1 steps' imputations,
                # q(x, mask), q(target revealed) over the M samples, the two
                # candidate posteriors over the M x (D-1) stack, and the
                # predictive MSE after the reveal: 1 + 6 (D-1)
                eddi = "EDDI" in acfg.vae_type
                # IW1, a MIWAE episode: M (1 + 2 (D-1)), as in (a)
                want = {**no_kernel,
                        "embed_pool_fwd": 1 + 6 * (D - 1) if eddi else 0,
                        "iw_fused": acfg.M * (1 + 2 * (D - 1))
                        if runs_iw1(acfg) else 0}
                if r["counts"] != want:
                    raise AssertionError(f"the {acfg.vae_type} episode "
                                         f"launched {r['counts']}, want "
                                         f"{want}")
                if eddi and max(b for _, b, _, _ in r["shapes"]) != (
                        acfg.M * (D - 1) * n):
                    raise AssertionError(f"B2f's shapes in the episode: "
                                         f"{sorted(set(r['shapes']))}")
                paths = artifacts.active_learning_paths(
                    acfg, str(root / "experiments"))
                saved = {k: torch.load(p, weights_only=True)
                         for k, p in paths.items()}
                shapes = {"information_curve": (1, n, D),
                          "action": (1, n, D - 1),
                          "R_hist": (1, D - 1, n, D - 1),
                          "im": (1, D - 1, acfg.M, n, D)}
                for k, shape in shapes.items():
                    if (saved[k].shape != shape
                            or saved[k].dtype != torch.float32
                            or not torch.isfinite(saved[k]).all()):
                        raise AssertionError(f"{acfg.vae_type} {k}: "
                                             f"{saved[k].dtype} "
                                             f"{tuple(saved[k].shape)}")
                for row in saved["action"][0].long():
                    if sorted(row.tolist()) != list(range(D - 1)):
                        raise AssertionError(f"{acfg.vae_type}: a row "
                                             f"revealed {row.tolist()}")
                r["curve"] = saved["information_curve"][0, 0]
                on_card = r["on_card"]
                line = (f"{acfg.vae_type} M={acfg.M}"
                        + (f" valid_k={acfg.valid_k}"
                           if "MIWAE" in acfg.vae_type else "")
                        + f": episode {r['wall_s'] * 1e3:.6f} ms (host "
                        f"clock), launches {r['counts']}; target MSE "
                        f"{r['curve'][0]:.6f} -> {r['curve'][-1]:.6f}; "
                        f"under torch.profiler {r['prof_ms']:.6f} ms")
                if on_card:
                    busy = profile_train.busy_ms(on_card)
                    top = profile_train.top_device_ms(on_card).most_common(5)
                    line += (f", device busy {busy:.6f} ms "
                             f"({busy / r['prof_ms']:.1%}), {len(on_card)} "
                             "device operations; top device ms: "
                             + "; ".join(f"{nm} {t:.6f}" for nm, t in top))
                else:
                    line += (", device operations and busy share not "
                             "measured, the trace held no device event")
                print(line + f" [{card}]", flush=True)

        # B2f at the episode's largest shape: the candidate posteriors of
        # reg_EDDI1 at M=50, one mask a row over M x (D-1) x 17 rows
        Bal = AL_M * (WINE_D - 1) * AL_ROWS
        Aal, Cal = layers._pointnet_affine(drop_params["encoder"])
        xal = torch.rand(Bal, WINE_D, device="cuda", generator=gen)
        mal = (torch.rand(1, Bal, WINE_D, device="cuda", generator=gen)
               < 0.5).float()
        with torch.no_grad():
            times["embed_pool_fwd_al"] = timed(
                f"B2f EmbedPool.forward S=1 B={Bal} D={WINE_D} (active "
                "learning, the candidate posteriors)",
                lambda: fep.embed_pool(xal, mal, Aal, Cal),
                lambda: fep.embed_pool_reference(xal, mal, Aal, Cal),
                embed_pool_bound_ms(1, Bal, WINE_D, K))
            torch.testing.assert_close(
                fep.embed_pool(xal, mal, Aal, Cal),
                fep.embed_pool_reference(xal, mal, Aal, Cal), **KERNEL_TOL)


    # ------------------------------------------------------------------
    # restartable training, early stopping, AIS and BDMC
    # ------------------------------------------------------------------
    from vae_posterior_consistency_tpu_torch.engine import ais
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        ais_eval as ais_main,
    )
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        imputation as imputation_main,
    )
    from vae_posterior_consistency_tpu_torch.utils.early_stopping import (
        EarlyStopping,
    )

    @contextlib.contextmanager
    def grid_dir(recs):
        """A temporary working directory holding Data/ with `recs` as its
        imputation_args.json and Data/wine linked in."""
        with tempfile.TemporaryDirectory() as tmp:
            (Path(tmp) / "Data").mkdir()
            os.symlink(REPO / "Data" / "wine", Path(tmp) / "Data" / "wine")
            with open(Path(tmp) / "Data" / "imputation_args.json", "w") as fh:
                for rec in recs:
                    fh.write(json.dumps(rec) + "\n")
            cwd = os.getcwd()
            os.chdir(tmp)
            try:
                yield Path(tmp)
            finally:
                os.chdir(cwd)

    flagship = records[RESUME_RECORD - 1]
    resume_cfg = RunConfig.from_jsonl_record(flagship, alpha=1.0,
                                             p_missingness=30,
                                             epoch=RESUME_EPOCHS)
    resume_steps = -(-wine.train.n // resume_cfg.batch_size)
    with phase(f"resume and early stopping (a): experiment_main/imputation"
               f".py on record {RESUME_RECORD} ({resume_cfg.vae_type}), "
               f"-epoch {RESUME_EPOCHS} -checkpoint_every {RESUME_EVERY}, "
               f"straight and stopped at {RESUME_STOP} then resumed"):
        finals, resume_s = {}, {}
        for mode, runs in (("straight", [(RESUME_EPOCHS, False)]),
                           ("resumed", [(RESUME_STOP, False),
                                        (RESUME_EPOCHS, True)])):
            with grid_dir([flagship]) as tmp:
                t0 = time.perf_counter()
                for epochs, resume in runs:
                    reset_counts()
                    with no_plain_on_card():
                        rc = imputation_main.main(
                            ["-epoch", str(epochs), "-checkpoint_every",
                             str(RESUME_EVERY), "-resume", str(resume)])
                    trained = epochs - (RESUME_STOP if resume else 0)
                    want = {**no_kernel,
                            "fused_posterior_fwd": trained * resume_steps,
                            "fused_posterior_bwd": trained * resume_steps}
                    if rc != 0 or counts() != want:
                        raise AssertionError(f"{mode} run to {epochs} "
                                             f"epochs returned {rc}, "
                                             f"launched {counts()}")
                resume_s[mode] = time.perf_counter() - t0
                path = checkpoint.checkpoint_path(resume_cfg, str(tmp / (
                    "experiments")))
                finals[mode] = torch.load(path, weights_only=False)
                saved = torch.load(path + ".resume.pt", weights_only=False)
                if int(saved["epoch"]) != RESUME_EPOCHS or any(
                        not np.array_equal(saved["params/" + k], v)
                        for k, v in finals[mode].items()):
                    raise AssertionError(f"{mode}: the resume file holds "
                                         f"epoch {int(saved['epoch'])}")
        unequal = [k for k, v in finals["straight"].items()
                   if not np.array_equal(v, finals["resumed"][k])]
        if sorted(finals["straight"]) != sorted(finals["resumed"]) or unequal:
            raise AssertionError(f"the resumed checkpoint differs from the "
                                 f"straight one at {unequal}")
        print(f"{len(finals['straight'])} leaves equal bit for bit, straight "
              f"and resumed; {RESUME_EPOCHS * resume_steps} steps each, B1 "
              f"and its backward once a step; wall-clock with the M="
              f"{resume_cfg.M} evaluation: straight "
              f"{resume_s['straight']:.6f} s, stopped and resumed "
              f"{resume_s['resumed']:.6f} s [{card}]", flush=True)

        stoppers, real_train = [], trainer.train

        class Recording(EarlyStopping):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.losses = []
                stoppers.append(self)

            def update(self, val_loss, params):
                self.losses.append(val_loss)
                return super().update(val_loss, params)

        def chunked(*args, **kw):
            return real_train(*args, **{**kw, "chunk_epochs": STOP_CHUNK})

        real_stopper = imputation_main.early_stopper
        with grid_dir([flagship]) as tmp:
            imputation_main.early_stopper = (
                lambda args, cfg: Recording(patience=cfg.patience,
                                            verbose=False)
                if args.early_stop else None)
            trainer.train = chunked
            reset_counts()
            t0 = time.perf_counter()
            try:
                with no_plain_on_card():
                    rc = imputation_main.main(
                        ["-epoch", str(STOP_EPOCHS), "-early_stop", "true",
                         "-patience", "1"])
            finally:
                imputation_main.early_stopper = real_stopper
                trainer.train = real_train
            stop_s = time.perf_counter() - t0
            stop_counts = counts()
            (es,) = stoppers
            checks = len(es.losses)
            ran = checks * STOP_CHUNK
            best = int(np.argmin(es.losses))
            # B1 once a step and once a check (the validation objective is
            # the training loss without gradients), its backward once a step
            want = {**no_kernel,
                    "fused_posterior_fwd": ran * resume_steps + checks,
                    "fused_posterior_bwd": ran * resume_steps}
            if (rc != 0 or not es.early_stop or ran >= STOP_EPOCHS
                    or stop_counts != want or best != checks - 2):
                raise AssertionError(f"early stopping: rc {rc}, stop "
                                     f"{es.early_stop}, losses {es.losses}, "
                                     f"launched {stop_counts}")
            saved = torch.load(checkpoint.checkpoint_path(
                resume_cfg, str(tmp / "experiments")), weights_only=False)
            kept = checkpoint.flatten(es.best_params)
            if any(not np.array_equal(v, kept[k].cpu().numpy())
                   for k, v in saved.items()):
                raise AssertionError("the saved checkpoint is not the best "
                                     "check's parameters")
        print(f"-early_stop true -patience 1, checks every {STOP_CHUNK} "
              f"epochs: stopped after {ran} of {STOP_EPOCHS} epochs, "
              f"validation losses "
              + ", ".join(f"{v:.6f}" for v in es.losses)
              + f"; the checkpoint saved is check {best + 1}'s (epoch "
              f"{(best + 1) * STOP_CHUNK}); launches {stop_counts}; wall-"
              f"clock {stop_s:.6f} s [{card}]", flush=True)

    # AIS card vs CPU: records 34, 10 and 1 with the parameters phase 7
    # trained, vanilla_notMIWAE1 from seeded parameters
    ais_cfgs = [RunConfig.from_jsonl_record(records[i - 1], seed=SEED,
                                            alpha=1.0, p_missingness=30)
                for i in AIS_RECORDS]
    if [(c.vae_type, c.ais_schedule, c.n_ais_dist, c.n_ais_iwae)
            for c in ais_cfgs] != [(v, "linear", 50, 40) for v in (
                "reg_vae1", "reg_flow1", "reg_MIWAE1")]:
        raise AssertionError(f"records {AIS_RECORDS} are not reg_vae1, "
                             f"reg_flow1, reg_MIWAE1 at linear T=50, 40 "
                             f"chains: {ais_cfgs}")
    nm_cfg = ais_cfgs[0].replace(vae_type="vanilla_notMIWAE1")
    nm_cpu, nm_card = seeded(nm_cfg, WINE_D)
    ais_params = {"reg_vae1": wine_params, "reg_flow1": flow_params,
                  "reg_MIWAE1": miwae_params, "vanilla_notMIWAE1": nm_card}
    ais_counts = collections.Counter()
    with phase(f"AIS (b): ais_step card vs CPU, one temperature at a time "
               f"from the card's states and draws, the {AL_ROWS} wine test "
               f"rows, linear T=50, 40 chains"):
        test_x = wine.test.x.to(device="cuda", dtype=torch.float32)
        for acfg in ais_cfgs + [nm_cfg]:
            bridge = ais.bridge_for(acfg)
            card_p = ais_params[acfg.vae_type]
            cpu_p = {k: v.cpu() for k, v in
                     checkpoint.flatten(card_p).items()}
            cpu_p = checkpoint.unflatten(cpu_p)
            n = acfg.n_ais_iwae
            x_card = test_x.repeat(n, 1)
            x_cpu = x_card.cpu()
            B = x_card.shape[0]
            sched = ais.default_schedule(acfg, warn=False)
            s_card = ais.as_schedule(sched, "cuda")
            s_cpu = ais.as_schedule(sched, "cpu")
            src = ais.GeneratorNoise(trainer.epoch_seed(acfg.seed + 4, 1),
                                     "cuda")

            def ll_card(z, _p=card_p, _b=bridge, _x=x_card):
                return _b.log_lik(_p, z, _x)

            def ll_cpu(z, _p=cpu_p, _b=bridge, _x=x_cpu):
                return _b.log_lik(_p, z, _x)

            state = ais.init_state(src("z0", 0, (B, acfg.latent_dim)))
            reset_counts()
            worst = {"z": 0.0, "eps": 0.0, "logw": 0.0}
            flips, gaps_max, t0 = 0, 0.0, time.perf_counter()
            with no_plain_on_card():
                for t in range(len(sched) - 1):
                    v = src("v", t, (B, acfg.latent_dim))
                    u = src("u", t, (B,))
                    nxt, _ = ais.ais_step(ll_card, state, s_card[t],
                                          s_card[t + 1], v, u)
                    cpu_in = ais.AISState(state.z.cpu(), state.eps.cpu(),
                                          state.accept_hist.cpu(),
                                          state.logw.cpu(), state.j)
                    ref, prob = ais.ais_step(ll_cpu, cpu_in, s_cpu[t],
                                             s_cpu[t + 1], v.cpu(), u.cpu())
                    flipped = (nxt.accept_hist.cpu() != ref.accept_hist)
                    if flipped.any():
                        # a decision within rounding of its threshold: the
                        # chain's -log f sets the size of that rounding
                        energy = -(ais._log_normal_nc(cpu_in.z)
                                   + s_cpu[t + 1] * ll_cpu(cpu_in.z))
                        gap = (torch.log(prob) - torch.log(u.cpu())).abs()
                        allowed = (AIS_FLIP_GAP_RTOL * energy.abs()
                                   + AIS_FLIP_GAP_ATOL)
                        if bool((gap[flipped] > allowed[flipped]).any()):
                            raise AssertionError(
                                f"{acfg.vae_type} step {t}: a decision "
                                f"flipped with gap {gap[flipped].max()}")
                        gaps_max = max(gaps_max, float(gap[flipped].max()))
                        flips += int(flipped.sum())
                    keep = ~flipped
                    for name in ("z", "eps") if keep.any() else ():
                        worst[name] = max(worst[name], max_abs(
                            getattr(nxt, name).cpu()[keep],
                            getattr(ref, name)[keep]))
                    dlogw = ((nxt.logw.cpu() - ref.logw).abs()
                             / (AIS_LOGW_ATOL + AIS_LOGW_RTOL
                                * ref.logw.abs()))
                    worst["logw"] = max(worst["logw"], float(dlogw.max()))
                    state = nxt
            card_s = time.perf_counter() - t0
            launched = counts()
            ais_counts.update(launched)
            decisions = B * (len(sched) - 1)
            if (launched != no_kernel or worst["z"] > AIS_Z_ATOL
                    or worst["eps"] > AIS_Z_ATOL or worst["logw"] > 1.0
                    or flips > AIS_FLIP_SHARE * decisions
                    or not torch.isfinite(state.logw).all()):
                raise AssertionError(f"{acfg.vae_type} AIS card vs CPU: "
                                     f"{worst}, {flips} flips, launched "
                                     f"{launched}")
            lw = torch.logsumexp(ais._chain_views(
                state.logw, state.z, n, AL_ROWS, AL_ROWS,
                acfg.latent_dim)[0], -1)
            print(f"{acfg.vae_type}: {B} chains x {len(sched) - 1} "
                  f"temperatures, card vs CPU from the card's states: max "
                  f"|dz| {worst['z']:.3e}, |deps| {worst['eps']:.3e}, "
                  f"logw within {worst['logw']:.3f} of its tolerance; "
                  f"{flips} of {decisions} decisions flipped (largest gap "
                  f"{gaps_max:.3e}); card's log p(x) "
                  f"{float(lw.mean()) - math.log(n):.6f}; no kernel; "
                  f"{card_s:.3f} s with the CPU steps", flush=True)

    def timed_ais(label, per_split):
        """Wraps `ais.ais_batch` (one call a split): each call's first
        AIS_PROFILE_TEMPS temperatures run once under torch.profiler when
        `profile(B0)` says so (a trace of the whole chain takes minutes to
        read), the noise generator put back as it was; then the call is
        timed with a sync at each end, its peak device memory read."""
        real = ais.ais_batch

        def run(*args, **kw):
            x, noise = args[1], args[5]
            prof_ms, on_card = None, None
            if per_split.get("profile", lambda B0: True)(x.shape[0]):
                saved = noise.generator.get_state()
                short = (*args[:4], args[4][:AIS_PROFILE_TEMPS + 1],
                         *args[5:])
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    real(*short, **kw)
                    torch.cuda.synchronize()
                    prof_ms = (time.perf_counter() - t0) * 1e3
                noise.generator.set_state(saved)
                on_card = profile_train.device_events(prof)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            res = real(*args, **kw)
            torch.cuda.synchronize()
            stage = ("BDMC forward" if per_split.get("in_bdmc") else
                     "train" if sum(not r["label"].endswith("BDMC forward")
                                    for r in per_split.get("runs", [])) % 2
                     == 0 else "test")
            per_split.setdefault("runs", []).append({
                "label": f"{label} {stage}", "rows": x.shape[0], "chains":
                x.shape[0] * args[2], "wall_ms":
                (time.perf_counter() - t0) * 1e3, "base": base,
                "peak": torch.cuda.max_memory_allocated(),
                "prof_ms": prof_ms, "on_card": on_card, "logw": res.logw})
            return res

        return real, run

    def print_split(r, extra=""):
        line = (f"{r['label']} {r['rows']} rows x "
                f"{r['chains'] // r['rows']} chains = {r['chains']}: "
                f"{r['wall_ms']:.6f} ms (host clock), log p(x) "
                f"{r['logw']:.6f}, peak device memory "
                f"{r['peak'] / 2**20:.3f} MiB ("
                f"{(r['peak'] - r['base']) / 2**20:.3f} MiB above the "
                f"{r['base'] / 2**20:.3f} MiB held before)" + extra)
        on_card = r["on_card"]
        if on_card:
            busy = profile_train.busy_ms(on_card)
            top = profile_train.top_device_ms(on_card).most_common(5)
            line += (f"; its first {AIS_PROFILE_TEMPS} temperatures under "
                     f"torch.profiler {r['prof_ms']:.6f} ms, device busy "
                     f"{busy:.6f} ms ({busy / r['prof_ms']:.1%}), "
                     f"{len(on_card)} device operations; top device ms: "
                     + "; ".join(f"{nm} {t:.6f}" for nm, t in top))
        elif on_card is not None:
            line += ("; device operations and busy share not measured, the "
                     "trace held no device event")
        print(line + f" [{card}]", flush=True)

    with phase(f"AIS (c): experiment_main/ais_eval.py over records "
               f"{AIS_RECORDS} as they stand, -bdmc true on record "
               f"{AIS_RECORDS[0]}"):
        with grid_dir(records) as tmp:
            for acfg in ais_cfgs:
                checkpoint.save(ais_params[acfg.vae_type],
                                checkpoint.checkpoint_path(
                                    acfg, str(tmp / "experiments")))
            real_bdmc, per_split = ais.eval_bdmc, {}
            bdmc_ms = []

            def timed_bdmc(*args, **kw):
                per_split["in_bdmc"] = True
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    out = real_bdmc(*args, **kw)
                finally:
                    per_split["in_bdmc"] = False
                torch.cuda.synchronize()
                bdmc_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            for acfg in ais_cfgs:
                real_batch, ais.ais_batch = timed_ais(acfg.vae_type,
                                                      per_split)
                ais.eval_bdmc = timed_bdmc
                argv = ["-vae_type", acfg.vae_type] + (
                    ["-bdmc", "true"] if acfg is ais_cfgs[0] else [])
                out = io.StringIO()
                reset_counts()
                try:
                    with no_plain_on_card(), \
                            contextlib.redirect_stdout(out):
                        rc = ais_main.main(argv)
                finally:
                    ais.ais_batch, ais.eval_bdmc = real_batch, real_bdmc
                printed = out.getvalue()
                print(printed, end="", flush=True)
                launched = counts()
                ais_counts.update(launched)
                if rc != 0 or launched != no_kernel:
                    raise AssertionError(f"ais_eval {argv} returned {rc}, "
                                         f"launched {launched}")
                warned = "[ais] WARNING: flow-family" in printed
                if warned != ("flow" in acfg.vae_type):
                    raise AssertionError(f"{acfg.vae_type}: the flow warning "
                                         f"printed: {warned}")
                base = Path("experiments") / acfg.vae_type / "wine" / (
                    "elbos") / f"{acfg.missing_rate}_missing" / (
                    f"{acfg.epoch}_epochs")
                sizes = {"train": wine.train.n, "test": wine.test.n}
                for stage, rows in sizes.items():
                    val = torch.load(base / f"{stage}_ais.pt",
                                     weights_only=False)
                    lat = torch.load(Path(str(base).replace(
                        "elbos", "latents")) / f"{stage}_ais_true_latents.pt",
                        weights_only=False)
                    if (val.dtype != torch.float64 or val.shape != ()
                            or not math.isfinite(val.item())
                            or lat.dtype != torch.float32
                            or tuple(lat.shape) != (rows, acfg.n_ais_iwae,
                                                    acfg.latent_dim)
                            or not torch.isfinite(lat).all()
                            or f"  [{stage}] AIS log p(x) = "
                               f"{val.item():.4f}" not in printed):
                        raise AssertionError(f"{acfg.vae_type} {stage}: "
                                             f"{val!r}, {lat.dtype} "
                                             f"{tuple(lat.shape)}")
                if "-bdmc" in argv:
                    bounds = [torch.load(base / f"bdmc_{b}.pt",
                                         weights_only=False).item()
                              for b in ("lower", "upper")]
                    if not (all(map(math.isfinite, bounds))
                            and "  [bdmc] sandwich on simulated data: "
                            f"lower={bounds[0]:.4f}" in printed):
                        raise AssertionError(f"BDMC bounds {bounds}")
        for r in per_split["runs"]:
            print_split(r)
        print(f"BDMC on {ais_cfgs[0].vae_type} (forward and reverse chains "
              f"over {min(64, wine.test.n)} simulated rows x 40): "
              f"{bdmc_ms[0]:.6f} ms (host clock) [{card}]", flush=True)

    mnist_ais_cfg = RunConfig(vae_type="reg_EDDI1", data_type="mnist",
                              missing_rate=30, seed=SEED,
                              ais_schedule="linear", n_ais_dist=50,
                              n_ais_iwae=40)
    with phase("AIS (d): eval_ais on the committed MNIST reg_EDDI1 "
               "checkpoint, both splits, linear T=50, 40 chains"):
        mnist_params = checkpoint.load_reference(
            checkpoint.checkpoint_path(mnist_ais_cfg,
                                       root=str(REPO / "experiments")),
            mnist_ais_cfg, 784, device="cuda")
        per_split = {"profile": lambda B0: B0 < 1000}
        real_batch, ais.ais_batch = timed_ais("MNIST reg_EDDI1", per_split)
        reset_counts()
        try:
            with no_plain_on_card():
                mnist_ais = ais.eval_ais(mnist, mnist_ais_cfg,
                                         params=mnist_params,
                                         n_sample=mnist_ais_cfg.n_ais_iwae,
                                         save=False, device="cuda")
        finally:
            ais.ais_batch = real_batch
        launched = counts()
        ais_counts.update(launched)
        if launched != no_kernel or [r["chains"] for r in
                                     per_split["runs"]] != [
                mnist.train.n * 40, mnist.test.n * 40] or not all(
                math.isfinite(r.logw) for r in mnist_ais.values()):
            raise AssertionError(f"MNIST AIS: launched {launched}, "
                                 f"{per_split['runs']}")
        for r in per_split["runs"]:
            # the decoder 10-200-500-500-784: 11 gradients (forward and
            # backward to z) and 2 forwards a temperature
            flop = r["chains"] * 49 * 2 * (10 * 200 + 200 * 500 + 500 * 500
                                           + 500 * 784) * (11 * 2 + 2)
            print_split(r, f"; {flop / 1e12:.3f} TFLOP of decoder "
                        f"matmuls, {flop / r['wall_ms'] / 1e9:.3f} TFLOP/s")

    env = locals()
    ens_kernels = ensembles(env)
    al_ens_launches = al_ais_ensembles(env)
    mesh_launches = mesh_phase(env)
    mesh_d_launches = mesh_part2_phase(env)
    bf16_launches = mixed_precision_phase(env)
    completeness_launches = completeness_phase(env)
    print(f"total {time.perf_counter() - t_start:.3f} s", flush=True)
    csrc = "vae_posterior_consistency_tpu_torch/csrc/"
    jax_ops = "vae_posterior_consistency_tpu/ops/"
    where = {
        "embed_pool_fwd": (csrc + "embed_pool.cu",
                           jax_ops + "fused_embed_pool.py:155"),
        "embed_pool_bwd": (csrc + "embed_pool.cu",
                           jax_ops + "fused_embed_pool.py:178"),
        "fused_posterior_fwd": (csrc + "fused_posterior.cu",
                                jax_ops + "fused_posterior.py:94"),
        # the jnp `_bwd` of the custom VJP, not a Pallas call
        "fused_posterior_bwd": (csrc + "fused_posterior.cu",
                                jax_ops + "fused_posterior.py:166"),
    }
    kernels = []
    for name, (source, replaces) in where.items():
        k_ms, p_ms, b_ms, b_by, n_ops = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": mnist_counts[name],
            "launches_per_call": n_ops,
            "max_abs_err": max_err[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            # launches on the MNIST evaluation of phase 8 (a)
            "eval_launches": mnist_eval_counts[name],
        })
    # B2f at the evaluation shape, S=1, B=64
    e_ms, e_plain, e_bound, _, _ = times["embed_pool_fwd_eval"]
    next(k for k in kernels if k["name"] == "embed_pool_fwd").update(
        eval_ms=e_ms, eval_plain_ms=e_plain, eval_bound_ms=e_bound)
    # B2f and B2b on the wine vanilla_EDDI1_with_drop run: launches, and
    # times at its shape (S=1, B=64, D=13)
    for k in kernels:
        if k["name"] in ("embed_pool_fwd", "embed_pool_bwd"):
            w_ms, w_plain, w_bound, _, _ = times[k["name"] + "_wine"]
            k.update(drop_launches=drop_counts[k["name"]], wine_ms=w_ms,
                     wine_plain_ms=w_plain, wine_bound_ms=w_bound)
    # launches on the active-learning grid of phase (b), and B2f's time at
    # the episode's largest shape (S=1, B=M x (D-1) x 17, D=13)
    a_ms, a_plain, a_bound, _, _ = times["embed_pool_fwd_al"]
    for k in kernels:
        k["al_launches"] = al_counts[k["name"]]
        # launches on the AIS phases (b)-(d): none, asserted there
        k["ais_launches"] = ais_counts[k["name"]]
        if k["name"] == "embed_pool_fwd":
            k.update(al_ms=a_ms, al_plain_ms=a_plain, al_bound_ms=a_bound,
                     al_shape=[1, AL_M * (WINE_D - 1) * AL_ROWS, WINE_D, K])
    # launches on the AL ensemble entry point's run (the AL and AIS
    # ensembles, (a)) and on the 128-replica reg_EDDI1 episode ((b))
    for k in kernels:
        k["al_ensemble_launches"] = al_ens_launches["entry"][k["name"]]
        k["al_ensemble_128_launches"] = al_ens_launches["R128"][k["name"]]
        # launches on the mesh phase's train_sharded runs ((a))
        k["mesh_launches"] = mesh_launches[k["name"]]
        # launches on the part-2 mesh phase's seed ensemble ((i)) and AL
        # episode ((ii))
        k["mesh_ensemble_launches"] = mesh_d_launches["ensemble"][k["name"]]
        k["mesh_al_launches"] = mesh_d_launches["al"][k["name"]]
        # launches on the mixed-precision phase's entry-point run (b)
        k["bf16_launches"] = bf16_launches[k["name"]]
        # launches on the completeness phase's serving (a) and CSV
        # imputer (b) runs
        k["completeness_launches"] = completeness_launches[k["name"]]
    # IW1 replaces no Pallas kernel (the JAX package computes MIWAE in jnp):
    # its error against its plain version and its times at the evaluation
    # batches of record 4, its launches on the MIWAE evaluation (e), and on
    # the MIWAE training (d), the AL grid (b), the AIS phases and the bf16
    # training run, each asserted where it ran
    for Bi in (64, 17):
        k_ms, p_ms, b_ms, b_by, n_ops = times[f"iw_fused_{Bi}"]
        kernels.append({
            "name": "iw_fused", "route": "cuda",
            "source": csrc + "iw_decode.cu", "replaces": None,
            "shape": [Bi, miwae_cfg.valid_k, WINE_D, LATENT],
            "launches_per_call": n_ops, "max_abs_err": iw_err[Bi],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "eval_launches": iw_launches,
            "train_launches": miwae_counts["iw_fused"],
            "al_launches": al_counts["iw_fused"],
            "ais_launches": ais_counts["iw_fused"],
            "bf16_launches": bf16_launches["iw_fused"]})
    # IW2 replaces no Pallas kernel either (the JAX package computes
    # notMIWAE in jnp): its error against its plain version and its times at
    # the MNAR records' evaluation and an eval_vae batch
    for Bi in (iw2_data.train.n, 64):
        k_ms, p_ms, b_ms, b_by, n_ops = times[f"iw_mnar_{Bi}"]
        kernels.append({
            "name": "iw_mnar", "route": "cuda",
            "source": csrc + "iw_decode.cu", "replaces": None,
            "shape": [Bi, MNAR_VALID_K, iw2_D, LATENT],
            "launches_per_call": n_ops, "max_abs_err": iw2_err[Bi],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "ais_launches": ais_counts["iw_mnar"],
            "bf16_launches": bf16_launches["iw_mnar"]})
    # the replica forms (ensembles): one launch for R replicas
    for k in ens_kernels:
        source, replaces = where[k["base"]]
        k.update(source=source, replaces=replaces)
        del k["base"]
    kernels += ens_kernels
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
    }}), flush=True)
    return 0


def ensembles(env) -> list:
    """The ensemble phases (slice 9), on the names main() set up (`env`):
    the replica kernels against their plain versions at R in REPLICAS and
    their times; a full-width seed ensemble of record 34; the two
    imputation entry points' ensemble paths. Returns the replica forms'
    entries of the kernels line (each with the name of its one-run form,
    `base`)."""
    import torch

    from vae_posterior_consistency_tpu_torch.config import RunConfig
    from vae_posterior_consistency_tpu_torch.data import loaders
    from vae_posterior_consistency_tpu_torch.engine import (
        checkpoint,
        profile_train,
    )
    from vae_posterior_consistency_tpu_torch.engine import train as trainer
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        imputation as imputation_main,
    )
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        imputation_mnar,
    )
    from vae_posterior_consistency_tpu_torch.ops import fused_embed_pool as fep
    from vae_posterior_consistency_tpu_torch.ops import fused_posterior as fp
    from vae_posterior_consistency_tpu_torch.parallel import sweep
    from vae_posterior_consistency_tpu_torch.utils.early_stopping import (
        EnsembleEarlyStopping,
    )

    card, counts, reset_counts = env["card"], env["counts"], env[
        "reset_counts"]
    no_plain_on_card, timed = env["no_plain_on_card"], env["timed"]
    backward_of, grid_dir = env["backward_of"], env["grid_dir"]
    records, wine, no_kernel = env["records"], env["wine"], env["no_kernel"]
    wine_host_ms = env["wine_host_ms"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    K, L, B = 10, LATENT, 64
    errs = collections.defaultdict(float)
    r_times = collections.defaultdict(dict)

    def one_launch(name, before):
        grew = {k: counts()[k] - before[k] for k in before}
        want = {k: int(k in name) for k in before}
        if grew != want:
            raise AssertionError(f"{name}: launched {grew}, want {want}")

    with phase(f"ensembles (a): the replica kernels against their plain "
               f"versions, R in {REPLICAS}, one launch a call"):
        for R in REPLICAS:
            # B1 at [R, 64, 10]: the statistics row and column halves of one
            # [R, 2B, 2L] encoder output, as a vmapped step hands them over;
            # eps shared by the replicas (replica stride 0), as the
            # validation draws are
            h = torch.randn(R, 2 * B, 2 * L, device="cuda", generator=gen)
            h[..., L:] = h[..., L:].clamp(-2.0, 1.0)
            mean_all, logvar_all = h.chunk(2, dim=-1)
            eps = torch.randn(2, B, L, device="cuda", generator=gen)
            st = (mean_all[:, :B], logvar_all[:, :B], mean_all[:, B:],
                  logvar_all[:, B:], eps[0].expand(R, B, L),
                  eps[1].expand(R, B, L))
            cts = (torch.randn(R, B, L, device="cuda", generator=gen),
                   torch.randn(R, B, L, device="cuda", generator=gen),
                   torch.randn(R, 3, device="cuda", generator=gen))
            before = counts()
            got = fp.fused_posterior_kernel(*st)
            one_launch("fused_posterior_fwd", before)
            before = counts()
            got_b = fp.fused_posterior_backward_kernel(st, *cts)
            one_launch("fused_posterior_bwd", before)
            torch.cuda.synchronize()
            zq, zp, kq, kp, kr = fp.fused_posterior_reference(*st)
            for u, v in zip(got, (zq, zp, torch.stack([kq, kp, kr], -1))):
                torch.testing.assert_close(u, v, **KERNEL_TOL)
                errs["fused_posterior_fwd"] = max(
                    errs["fused_posterior_fwd"], max_abs(u, v))
            for u, v in zip(got_b, fp.fused_posterior_backward(st, *cts)):
                torch.testing.assert_close(u, v, **KERNEL_TOL)
                errs["fused_posterior_bwd"] = max(
                    errs["fused_posterior_bwd"], max_abs(u, v))
            if R == 1:
                one = [t[0] for t in st]
                same = [*fp.fused_posterior_kernel(*one),
                        *fp.fused_posterior_backward_kernel(
                            one, cts[0][0], cts[1][0], cts[2][0])]
                if not all(torch.equal(u, v[0]) for u, v in zip(
                        same, (*got, *got_b))):
                    raise AssertionError("B1 at R=1 differs from the one-run "
                                         "kernel")
            r_times["fused_posterior_fwd"][R] = timed(
                f"B1 fused_posterior replicas R={R} [{B},{L}]",
                lambda: fp.fused_posterior_kernel(*st),
                lambda: fp.fused_posterior_reference(*st),
                fused_posterior_replicas_bound_ms(R, B, L), runs=ENS_RUNS)
            build = backward_of(
                lambda *lv: fp.FusedPosterior.apply(*lv, *st[4:]), st[:4],
                cts)
            r_times["fused_posterior_bwd"][R] = timed(
                f"B1 FusedPosterior.backward replicas R={R} [{B},{L}], the "
                "four statistics' gradients", build(),
                lambda: fp.fused_posterior_backward(st, *cts),
                fused_posterior_bwd_replicas_bound_ms(R, B, L), build=build,
                runs=ENS_RUNS)
            # B2f and B2b at the wine EDDI width (S=2, B=64, D=13) and at
            # MNIST width (D=784): x [R,B,D], masks [R,2,B,D], A and C
            # [R,D,K], each replica its own
            for D in (WINE_D, 784):
                x = torch.rand(R, B, D, device="cuda", generator=gen)
                m = (torch.rand(R, 2, B, D, device="cuda", generator=gen)
                     < 0.7).float()
                A = torch.randn(R, D, K, device="cuda", generator=gen) * 0.3
                C = torch.randn(R, D, K, device="cuda", generator=gen) * 0.3
                g = torch.randn(R, 2, B, K, device="cuda", generator=gen)
                before = counts()
                out = fep.embed_pool(x, m, A, C)
                one_launch("embed_pool_fwd", before)
                before = counts()
                grads = fep.embed_pool_bwd(x, m, A, C, g)
                one_launch("embed_pool_bwd", before)
                torch.cuda.synchronize()
                want = fep.embed_pool_reference(x, m, A, C)
                torch.testing.assert_close(out, want, **KERNEL_TOL)
                errs["embed_pool_fwd"] = max(errs["embed_pool_fwd"],
                                             max_abs(out, want))
                for i, (u, v) in enumerate(zip(
                        grads, fep.embed_pool_bwd_reference(x, m, A, C, g))):
                    torch.testing.assert_close(
                        u, v, rtol=BWD_RTOL,
                        atol=BWD_ATOL_PER_TERM * (B if i >= 2 else K))
                    errs["embed_pool_bwd"] = max(errs["embed_pool_bwd"],
                                                 max_abs(u, v))
                if R == 1:
                    same = [fep.embed_pool(x[0], m[0], A[0], C[0]),
                            *fep.embed_pool_bwd(x[0], m[0], A[0], C[0],
                                                g[0])]
                    if not all(torch.equal(u, v[0]) for u, v in zip(
                            same, (out, *grads))):
                        raise AssertionError(f"B2 at R=1, D={D} differs "
                                             "from the one-run kernels")
                with torch.no_grad():
                    r_times[f"embed_pool_fwd_{D}"][R] = timed(
                        f"B2f EmbedPool.forward replicas R={R} S=2 B={B} "
                        f"D={D}", lambda: fep.embed_pool(x, m, A, C),
                        lambda: fep.embed_pool_reference(x, m, A, C),
                        tuple(v * R if i == 0 else v for i, v in enumerate(
                            embed_pool_bound_ms(2, B, D, K))), runs=ENS_RUNS)
                build = backward_of(lambda A, C: fep.embed_pool(x, m, A, C),
                                    (A, C), g)
                r_times[f"embed_pool_bwd_{D}"][R] = timed(
                    f"B2b EmbedPool.backward replicas R={R} S=2 B={B} D={D}, "
                    "dA and dC only", build(),
                    lambda: fep.embed_pool_bwd_reference(x, m, A, C, g),
                    tuple(v * R if i == 0 else v for i, v in enumerate(
                        embed_pool_bwd_bound_ms(2, B, D, K, dx=False,
                                                dmasks=False))),
                    build=build, runs=ENS_RUNS)
            print(f"R={R}: replica kernels within tolerance, one launch "
                  f"each; max abs diff so far {dict(errs)}", flush=True)
        for name, per in r_times.items():
            if any(t[4] != 1 for t in per.values()):
                raise AssertionError(f"{name}: device operations a call "
                                     f"{[t[4] for t in per.values()]}")

    flag_rec = records[RESUME_RECORD - 1]
    ens_cfg = RunConfig.from_jsonl_record(flag_rec, alpha=1.0,
                                          p_missingness=30, epoch=ENS_EPOCHS,
                                          seed=SEED)
    seeds = list(range(ENS_S))
    steps = -(-wine.train.n // ens_cfg.batch_size)
    with phase(f"ensembles (b): train_seed_ensemble of record "
               f"{RESUME_RECORD} ({ens_cfg.vae_type}) on wine, batch "
               f"{ens_cfg.batch_size}, S={ENS_S}, {ENS_EPOCHS} epochs"):
        # the first step's per-replica losses, card against the CPU from the
        # same parameters and the card's recorded draws, on the first 64
        # training rows (one step an epoch)
        first = loaders_split(wine, ens_cfg.batch_size)

        class Recording(sweep.EnsembleNoise):
            drawn = []

            def epoch(self, *a):
                out = super().epoch(*a)
                Recording.drawn.append(out)
                return out

        card_run, card_p = sweep.build_seed_ensemble_runner(
            first, ens_cfg, seeds, device="cuda",
            noise=Recording("seed", "cuda", seeds=seeds))
        cpu_p = checkpoint.on_device(card_p, "cpu")
        card_leaves = trainer.trainable(card_p)
        reset_counts()
        with no_plain_on_card():
            card_loss = card_run(card_leaves,
                                 trainer.make_optimizer(card_leaves), 0, 1)
        first_counts = counts()

        class Replay:
            def epoch(self, *a):
                return {k: v.cpu() for k, v in Recording.drawn[0].items()}

        cpu_run, _ = sweep.build_seed_ensemble_runner(
            first, ens_cfg, seeds, device="cpu", noise=Replay(),
            params=cpu_p)
        cpu_leaves = trainer.trainable(cpu_p)
        cpu_loss = cpu_run(cpu_leaves, trainer.make_optimizer(cpu_leaves), 0,
                           1)
        np.testing.assert_allclose(card_loss, cpu_loss, rtol=STEP_LOSS_RTOL,
                                   atol=0)
        step_err = float(np.max(np.abs(card_loss - cpu_loss)
                                / np.abs(cpu_loss)))
        if first_counts != {**no_kernel, "fused_posterior_fwd": 1,
                            "fused_posterior_bwd": 1}:
            raise AssertionError(f"the first ensemble step launched "
                                 f"{first_counts}")
        print(f"first step, {ENS_S} replicas: per-replica loss card vs CPU "
              f"max rel diff {step_err:.3e} (rtol {STEP_LOSS_RTOL}); "
              f"launches {first_counts}", flush=True)

        # the whole ensemble: its counts reset just before, read just after
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_plain_on_card():
            ens_p, ens_hist = sweep.train_seed_ensemble(
                wine, ens_cfg, seeds, device="cuda")
        torch.cuda.synchronize()
        ens_s = time.perf_counter() - t0
        ens_counts = counts()
        n_steps = ENS_EPOCHS * steps
        if ens_counts != {**no_kernel, "fused_posterior_fwd": n_steps,
                          "fused_posterior_bwd": n_steps}:
            raise AssertionError(f"{n_steps} ensemble steps launched "
                                 f"{ens_counts}")
        means = ens_hist.mean(axis=0) / steps
        if ens_hist.shape != (ENS_S, ENS_EPOCHS) or not np.isfinite(
                ens_hist).all() or not means[-1] < means[0]:
            raise AssertionError(f"the ensemble's mean loss did not fall: "
                                 f"{means}")
        # a step's time and the card's busy share, over one epoch of the
        # trained ensemble under torch.profiler, then over 5 epochs timed
        run, _ = sweep.build_seed_ensemble_runner(wine, ens_cfg, seeds,
                                                  device="cuda", params=ens_p)
        leaves = trainer.trainable(ens_p)
        opt = trainer.make_optimizer(leaves)
        run(leaves, opt, ENS_EPOCHS, 1)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(leaves, opt, ENS_EPOCHS + 1, 1)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        on_card = profile_train.device_events(prof)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(leaves, opt, ENS_EPOCHS + 2, 5)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / (5 * steps)
        busy = (f"{profile_train.busy_ms(on_card) / prof_ms:.1%} busy "
                f"({len(on_card) / steps:.1f} device operations a step)"
                if on_card else "busy share not measured (no device event "
                "in the trace)")
        print(f"S={ENS_S}: {n_steps} steps in {ens_s:.6f} s, launches "
              f"{ens_counts}; a step {step_ms:.6f} ms (host clock, 5 epochs, "
              f"the replicas' per-epoch draws included), {step_ms / ENS_S:.6f}"
              f" ms a replica-step; one epoch under torch.profiler {busy}; "
              f"the serial {ens_cfg.vae_type} step {wine_host_ms:.6f} ms "
              f"(host clock) [{card}]", flush=True)
    ens_launches = dict(ens_counts)
    # the trained 128 replicas, for the AL and AIS ensemble phases
    env.update(ens_p=ens_p, ens_cfg=ens_cfg)

    eddi_recs = [records[i - 1] for i in ENS_EDDI_RECORDS]
    vae_recs = [records[i - 1] for i in ENS_VAE_RECORDS]
    if [r["vae_type"]["default"] for r in eddi_recs + vae_recs] != [
            "reg_EDDI1", "reg_EDDI2", "reg_EDDI3", "reg_vae1", "reg_vae2",
            "reg_vae3"]:
        raise AssertionError("records 37-39 / 34-36 are not reg_EDDI1-3 / "
                             "reg_vae1-3")
    cut = ["-epoch", str(ENS_ENTRY_EPOCHS)]

    def n_steps_of(recs):
        """Training steps an epoch of each record (its split's rows)."""
        out = []
        for r in recs:
            c = RunConfig.from_jsonl_record(r)
            n = loaders.data_loader(str(REPO / "Data"), c.vae_type,
                                    c.missing_rate, c.batch_size,
                                    c.data_type, device="cpu").train.n
            out.append(-(-n // c.batch_size))
        return out

    eddi_steps = max(n_steps_of(eddi_recs))  # wrap-padded to the largest
    vae_steps = n_steps_of(vae_recs)
    with phase(f"ensembles (c): experiment_main/imputation.py -ensemble true "
               f"-seeds 2 over records {ENS_EDDI_RECORDS} (reg_EDDI1-3), "
               f"-epoch {ENS_ENTRY_EPOCHS}"):
        with grid_dir(eddi_recs) as tmp:
            reset_counts()
            t0 = time.perf_counter()
            with no_plain_on_card():
                rc = imputation_main.main(["-ensemble", "true", "-seeds", "2",
                                           *cut])
            eddi_s = time.perf_counter() - t0
            eddi_counts = counts()
            cfgs = [RunConfig.from_jsonl_record(r, alpha=1.0,
                                                p_missingness=30)
                    for r in eddi_recs]
            root = str(tmp / "experiments")
            ckpts = [checkpoint.checkpoint_path(c, root) + sfx
                     for sfx in ("", ".seed1") for c in cfgs]
            arts = [p for c in cfgs for st in ("train", "test")
                    for p in env["artifacts"].eval_vae_paths(c, st,
                                                             root).values()]
            missing = [p for p in ckpts + arts if not os.path.isfile(p)]
            # kept for the AL ensemble phase, which runs over them
            env["eddi_ens_dir"] = tempfile.mkdtemp()
            shutil.copytree(root, Path(env["eddi_ens_dir"]) / "experiments")
        train_steps = ENS_ENTRY_EPOCHS * eddi_steps
        if rc != 0 or missing or eddi_counts["embed_pool_fwd"] <= train_steps \
                or eddi_counts["embed_pool_bwd"] != train_steps or \
                eddi_counts["fused_posterior_bwd"] != train_steps:
            raise AssertionError(f"-ensemble true -seeds 2: rc {rc}, "
                                 f"missing {missing}, launched {eddi_counts}")
        print(f"R=6 split ensemble: {len(ckpts)} checkpoints and "
              f"{len(arts)} artifacts at the reference names; launches "
              f"{eddi_counts} ({train_steps} training steps, B2b and B1's "
              f"backward once a step; B2f and B1 also once an evaluation "
              f"batch); wall-clock {eddi_s:.6f} s [{card}]", flush=True)
    eddi_launches = dict(eddi_counts)

    with phase(f"ensembles (d): -ensemble true -alphas 0.5,1.0 over records "
               f"{ENS_VAE_RECORDS}, -early_stop true, and "
               f"experiment_main/imputation_mnar.py -ensemble true"):
        with grid_dir(vae_recs) as tmp:
            reset_counts()
            t0 = time.perf_counter()
            with no_plain_on_card():
                rc = imputation_main.main(["-ensemble", "true", "-alphas",
                                           "0.5,1.0", *cut])
            alpha_s = time.perf_counter() - t0
            cfgs = [RunConfig.from_jsonl_record(r, alpha=a, p_missingness=30)
                    for r in vae_recs for a in (0.5, 1.0)]
            missing = [c.vae_type for c in cfgs if not os.path.isfile(
                checkpoint.checkpoint_path(c, str(tmp / "experiments")))]
            if rc != 0 or missing or counts()["fused_posterior_bwd"] != (
                    ENS_ENTRY_EPOCHS * sum(vae_steps)):
                raise AssertionError(f"-alphas: rc {rc}, missing {missing}, "
                                     f"launched {counts()}")
            print(f"-alphas 0.5,1.0: 3 alpha ensembles of 2, 6 checkpoints; "
                  f"launches {counts()}; wall-clock {alpha_s:.6f} s [{card}]",
                  flush=True)
            stoppers, real_split = [], sweep.train_split_ensemble

            def chunked(*a, **kw):
                stoppers.append(kw["early_stopping"])
                return real_split(*a, **{**kw, "chunk_epochs": STOP_CHUNK})

            sweep.train_split_ensemble = chunked
            try:
                with no_plain_on_card():
                    rc = imputation_main.main(
                        ["-ensemble", "true", "-early_stop", "true",
                         "-patience", "1", "-epoch", str(STOP_EPOCHS)])
            finally:
                sweep.train_split_ensemble = real_split
            (es,) = stoppers
            if rc != 0 or not isinstance(es, EnsembleEarlyStopping) or (
                    es.best_loss is None or es.best_loss.shape != (3,)):
                raise AssertionError(f"-early_stop: rc {rc}, tracker {es}")
            print(f"-ensemble true -early_stop true -patience 1, checks every "
                  f"{STOP_CHUNK} epochs: stopped {es.early_stop}, best "
                  f"validation losses {es.best_loss.tolist()}, counters "
                  f"{es.counter.tolist()}", flush=True)
        with tempfile.TemporaryDirectory() as mtmp:
            os.symlink(REPO / "Data", Path(mtmp) / "Data")
            cwd = os.getcwd()
            os.chdir(mtmp)
            try:
                reset_counts()
                t0 = time.perf_counter()
                with no_plain_on_card():
                    rc = imputation_mnar.main(["-ensemble", "true",
                                               "-seeds", "2"])
                mnar_s = time.perf_counter() - t0
                mnar_files = sorted(
                    os.path.relpath(os.path.join(d, f), mtmp)
                    for d, _, fs in os.walk(os.path.join(mtmp,
                                                         "experiments"))
                    for f in fs)
            finally:
                os.chdir(cwd)
        mnar_want = []
        for r in iter_records(REPO / "Data" / "imputation_args_mnar.json"):
            c = RunConfig.from_jsonl_record(
                r, alpha=1.0, p_missingness=imputation_mnar.MISSING_SWEEP[0],
                data_transform=imputation_mnar.DATA_TRANSFORM,
                not_miwae_type=imputation_mnar.NOT_MIWAE_TYPE)
            base = checkpoint.checkpoint_path(c, "experiments")
            mnar_want += [base, base + ".seed1", env["artifacts"]
                          .eval_mnar_paths(c, "experiments")["rmse"]]
        missing = [f for f in mnar_want if f not in mnar_files]
        if rc != 0 or missing:
            raise AssertionError(f"MNAR -ensemble true: rc {rc}, missing "
                                 f"{missing} of {mnar_files}")
        print(f"imputation_mnar -ensemble true -seeds 2: {len(mnar_files)} "
              f"files; launches {counts()}; wall-clock {mnar_s:.6f} s "
              f"[{card}]", flush=True)

    with phase(f"ensembles (e): -ensemble true -seeds 2 over records "
               f"{ENS_EDDI_RECORDS}, {ENS_ENTRY_EPOCHS} epochs straight and "
               f"stopped at {ENS_RESUME_STOP} then resumed"):
        finals = {}
        for mode, runs in (("straight", [(ENS_ENTRY_EPOCHS, False)]),
                           ("resumed", [(ENS_RESUME_STOP, False),
                                        (ENS_ENTRY_EPOCHS, True)])):
            with grid_dir(eddi_recs) as tmp:
                for epochs, resume in runs:
                    with no_plain_on_card():
                        rc = imputation_main.main(
                            ["-ensemble", "true", "-seeds", "2", "-epoch",
                             str(epochs), "-checkpoint_every",
                             str(ENS_RESUME_STOP), "-resume", str(resume)])
                    if rc != 0:
                        raise AssertionError(f"{mode} run returned {rc}")
                cfg0 = RunConfig.from_jsonl_record(eddi_recs[0], alpha=1.0,
                                                   p_missingness=30)
                base = checkpoint.checkpoint_path(cfg0, str(tmp / (
                    "experiments")))
                finals[mode] = {sfx: torch.load(base + sfx,
                                                weights_only=False)
                                for sfx in ("", ".seed1")}
                saved = torch.load(base + ".ens6.resume.pt",
                                   weights_only=False)
                if int(saved["epoch"]) != ENS_ENTRY_EPOCHS:
                    raise AssertionError(f"{mode}: the resume file holds "
                                         f"epoch {int(saved['epoch'])}")
        unequal = [(sfx, k) for sfx, ck in finals["straight"].items()
                   for k, v in ck.items()
                   if not np.array_equal(v, finals["resumed"][sfx][k])]
        if unequal:
            raise AssertionError(f"the resumed ensemble differs at {unequal}")
        print(f"resumed ensemble equals the straight one bit for bit "
              f"(replicas 0 and 3 of 6, {len(finals['straight'][''])} leaves "
              "each)", flush=True)

    out = []
    for name, base, launches, key in (
            ("fused_posterior_fwd_replicas", "fused_posterior_fwd",
             ens_launches, "fused_posterior_fwd"),
            ("fused_posterior_bwd_replicas", "fused_posterior_bwd",
             ens_launches, "fused_posterior_bwd"),
            ("embed_pool_fwd_replicas", "embed_pool_fwd", eddi_launches,
             f"embed_pool_fwd_{WINE_D}"),
            ("embed_pool_bwd_replicas", "embed_pool_bwd", eddi_launches,
             f"embed_pool_bwd_{WINE_D}")):
        per = r_times[key]
        k_ms, p_ms, b_ms, b_by, n_ops = per[ENS_S]
        entry = {"name": name, "base": base, "route": "cuda",
                 "launches": launches[base], "launches_per_call": n_ops,
                 "max_abs_err": errs[base], "ms": k_ms, "plain_ms": p_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 "replicas": ENS_S,
                 "ms_by_replicas": {str(r): t[0] for r, t in per.items()},
                 "plain_ms_by_replicas": {str(r): t[1]
                                          for r, t in per.items()},
                 "bound_ms_by_replicas": {str(r): t[2]
                                          for r, t in per.items()}}
        if base.startswith("embed_pool"):
            per784 = r_times[base + "_784"]
            entry["mnist_ms_by_replicas"] = {str(r): t[0]
                                             for r, t in per784.items()}
            entry["mnist_bound_ms_by_replicas"] = {
                str(r): t[2] for r, t in per784.items()}
        out.append(entry)
    return out


def al_ais_ensembles(env) -> dict:
    """The AL and AIS ensemble phases (slice 9 part 2) and the entry points'
    start-up (-profile, VPC_DEBUG_NANS), on the names main() and
    ensembles() set up (`env`): the AL entry point's -ensemble true -seeds
    2 over the reg_EDDI1-3 checkpoints of ensembles (c), each replica card
    vs CPU; 128-replica episodes of records 34 and 37 beside the serial
    one; ais_eval -seeds 2 on record 34 with replica 0 against the serial
    chain, and a 128-replica test split; a traced and an anomaly-checked
    run. Returns the kernels' launches on the entry point's run ("entry")
    and on the 128-replica reg_EDDI1 episode ("R128")."""
    import torch

    from vae_posterior_consistency_tpu_torch.config import RunConfig
    from vae_posterior_consistency_tpu_torch.data import loaders
    from vae_posterior_consistency_tpu_torch.engine import (
        active_learning as al,
    )
    from vae_posterior_consistency_tpu_torch.engine import (
        ais,
        artifacts,
        checkpoint,
        profile_train,
    )
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        active_learning as al_main,
    )
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        ais_eval as ais_main,
    )
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        imputation as imputation_main,
    )
    from vae_posterior_consistency_tpu_torch.models import get_model
    from vae_posterior_consistency_tpu_torch.parallel import sweep
    from vae_posterior_consistency_tpu_torch.utils import debugging

    card, counts, reset_counts = env["card"], env["counts"], env[
        "reset_counts"]
    no_plain_on_card, grid_dir = env["no_plain_on_card"], env["grid_dir"]
    records, wine, no_kernel = env["records"], env["wine"], env["no_kernel"]
    ens_p = env["ens_p"]
    eddi_recs = [records[i - 1] for i in ENS_EDDI_RECORDS]
    flagship = records[RESUME_RECORD - 1]
    n, D = AL_ROWS, WINE_D
    b2f_episode = 1 + 6 * (D - 1)
    launches = {}

    def profiled(fn):
        """fn() once under torch.profiler: (its host-clock ms, the device
        events of the trace)."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        return ms, profile_train.device_events(prof)

    def measured(fn):
        """fn() timed on the host clock with a sync at each end: (its
        result, ms, peak device memory above what was held, MiB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, (time.perf_counter() - t0) * 1e3,
                (torch.cuda.max_memory_allocated() - base) / 2**20)

    def busy(prof_ms, on_card):
        if not on_card:
            return ("busy share and device operations not measured (no "
                    "device event in the trace)")
        b = profile_train.busy_ms(on_card)
        top = profile_train.top_device_ms(on_card).most_common(4)
        return (f"under torch.profiler {prof_ms:.6f} ms, device busy "
                f"{b:.6f} ms ({b / prof_ms:.1%}), {len(on_card)} device "
                "operations; top device ms: "
                + "; ".join(f"{nm} {t:.6f}" for nm, t in top))

    with phase(f"AL and AIS ensembles (a): experiment_main/active_learning"
               f".py -ensemble true -seeds 2 over records {ENS_EDDI_RECORDS}"
               f" (reg_EDDI1-3, the checkpoints of ensembles (c)), M cut to "
               f"{AL_CHECK_M}, each replica card vs CPU"):
        runs, real_ens = [], al.active_learning_ensemble

        def recorded(*args, **kw):
            out = real_ens(*args, **kw)
            runs.append((args, out))
            return out

        with grid_dir(eddi_recs) as tmp:
            shutil.copytree(Path(env["eddi_ens_dir"]) / "experiments",
                            tmp / "experiments")
            al.active_learning_ensemble = recorded
            reset_counts()
            try:
                with no_plain_on_card():
                    rc = al_main.main(["-ensemble", "true", "-seeds", "2",
                                       "-M", str(AL_CHECK_M), "-epoch",
                                       str(ENS_ENTRY_EPOCHS)])
            finally:
                al.active_learning_ensemble = real_ens
            launches["entry"] = counts()
            bad = []
            for r in eddi_recs:
                c = RunConfig.from_jsonl_record(r, alpha=1.0,
                                                p_missingness=30,
                                                M=AL_CHECK_M)
                paths = artifacts.active_learning_paths(
                    c, str(tmp / "experiments"))
                shapes = {"information_curve": (1, n, D),
                          "action": (1, n, D - 1),
                          "R_hist": (1, D - 1, n, D - 1),
                          "im": (1, D - 1, c.M, n, D)}
                for name, shape in shapes.items():
                    for sfx in ("", ".seed1"):
                        path = paths[name] + sfx
                        t = (torch.load(path, weights_only=True)
                             if os.path.isfile(path) else None)
                        if (t is None or tuple(t.shape) != shape
                                or t.dtype != torch.float32
                                or not torch.isfinite(t).all()):
                            bad.append(path)
        shutil.rmtree(env["eddi_ens_dir"])
        want = {**no_kernel, "embed_pool_fwd": len(eddi_recs) * b2f_episode}
        if rc != 0 or bad or launches["entry"] != want or len(runs) != len(
                eddi_recs):
            raise AssertionError(f"AL -ensemble true -seeds 2: rc {rc}, "
                                 f"{len(runs)} ensemble episodes, launched "
                                 f"{launches['entry']} (want {want}), "
                                 f"missing or malformed {bad}")
        for (x, _, c, params_ens), out in runs:
            src = al.replay_noise(al.default_noise(c, "cuda"), c, n, D, 0,
                                  get_model(c).encode_stats is None)

            def replay(kind, repeat, step, shape, _src=src):
                return _src(kind, repeat, step, shape).cpu()

            for s in range(2):
                worst, knot, n_R, compared = al_card_vs_cpu(
                    c, {k: v[s, 0] for k, v in out.items()},
                    sweep.ensemble_replica(params_ens, s), x, replay)
                print(f"{c.vae_type} replica {s} of 2, M={c.M}: card vs CPU "
                      f"rewards {worst['R']:.3e}, imputations "
                      f"{worst['im']:.3e}, curve {worst['mse']:.3e}; "
                      f"reveals equal on {compared} of {n * (D - 1)}",
                      flush=True)
        print(f"the AL entry point's ensembles: artifacts and their .seed1 "
              f"siblings at the reference names for {len(eddi_recs)} "
              f"records; launches {launches['entry']} ({b2f_episode} B2f "
              f"launches an episode for both replicas) [{card}]", flush=True)

    with phase(f"AL and AIS ensembles (b): {ENS_S}-replica episodes of "
               f"records {RESUME_RECORD} and {ENS_EDDI_RECORDS[0]} at M="
               f"{AL_M}, against the serial episode"):
        for number in (RESUME_RECORD, ENS_EDDI_RECORDS[0]):
            c = RunConfig.from_jsonl_record(records[number - 1], alpha=1.0,
                                            p_missingness=30, seed=SEED)
            model = get_model(c)
            if number == RESUME_RECORD:
                p_ens = ens_p  # the trained seed ensemble of ensembles (b)
            else:
                reps = [checkpoint.flatten(model.init(
                    torch.Generator(device="cuda").manual_seed(SEED + i), c,
                    D, device="cuda")) for i in range(ENS_S)]
                p_ens = checkpoint.unflatten(
                    {k: torch.stack([r[k] for r in reps]) for k in reps[0]})
                del reps
            data = loaders.data_loader(str(REPO / "Data"), c.vae_type,
                                       c.missing_rate, c.batch_size,
                                       c.data_type, device="cuda")
            x = data.test.x
            p0 = sweep.ensemble_replica(p_ens, 0)

            def serial():
                return al.active_learning_func(None, x, data.test.mask, c,
                                               params=p0, save=False,
                                               device="cuda")

            def ensemble():
                return al.active_learning_ensemble(x, None, c, p_ens,
                                                   save=False, device="cuda")

            serial()
            _, serial_ms, _ = measured(serial)
            prof_ms, on_card = profiled(ensemble)
            reset_counts()
            with no_plain_on_card():
                out, ens_ms, peak = measured(ensemble)
            got = counts()
            eddi = "EDDI" in c.vae_type
            if eddi:
                launches["R128"] = got
            ok = got == {**no_kernel,
                         "embed_pool_fwd": b2f_episode if eddi else 0}
            acts = out["action"][:, 0].long().sort(dim=-1).values
            if not ok or tuple(out["im"].shape) != (
                    ENS_S, 1, D - 1, c.M, n, D) or not all(
                    torch.isfinite(v).all() for v in out.values()) or not (
                    acts == torch.arange(D - 1, device="cuda")).all():
                raise AssertionError(f"{c.vae_type} x {ENS_S}: launched "
                                     f"{got}, im {tuple(out['im'].shape)}")
            print(f"{c.vae_type} M={c.M}, {ENS_S} replicas: episode "
                  f"{ens_ms:.6f} ms (host clock) against the serial "
                  f"{serial_ms:.6f} ms ({ens_ms / serial_ms:.2f}x for "
                  f"{ENS_S} replicas, {ens_ms / ENS_S:.6f} ms a replica); "
                  f"peak device memory {peak:.3f} MiB above held; launches "
                  f"{got}; {busy(prof_ms, on_card)} [{card}]", flush=True)
            del p_ens, out

    with phase(f"AL and AIS ensembles (c): experiment_main/ais_eval.py "
               f"-seeds 2 on record {RESUME_RECORD}, replica 0 against the "
               f"serial chain on the card; a {ENS_S}-replica test split"):
        c = RunConfig.from_jsonl_record(flagship, alpha=1.0,
                                        p_missingness=30)
        steps, real_step = [], ais.ais_step

        def recording_step(ll_fn, state, t0, t1, v, u, leapfrog=10):
            out, prob = real_step(ll_fn, state, t0, t1, v, u, leapfrog)
            steps.append((state, t0, t1, v, u, out))
            return out, prob

        with grid_dir([flagship]) as tmp:
            base = checkpoint.checkpoint_path(c, str(tmp / "experiments"))
            for s in range(2):
                checkpoint.save(sweep.ensemble_replica(ens_p, s),
                                base + checkpoint.seed_suffix(s))
            ais.ais_step = recording_step
            printed = io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            try:
                with no_plain_on_card(), contextlib.redirect_stdout(printed):
                    rc = ais_main.main(["-vae_type", c.vae_type, "-seeds",
                                        "2"])
            finally:
                ais.ais_step = real_step
            entry_s = time.perf_counter() - t0
            printed = printed.getvalue()
            print(printed, end="", flush=True)
            launched = counts()
            elbos = tmp / "experiments" / c.vae_type / "wine" / "elbos" / (
                f"{c.missing_rate}_missing") / f"{c.epoch}_epochs"
            bad = [f"{st}_ais.pt{sfx}" for st in ("train", "test")
                   for sfx in ("", ".seed1")
                   if not (elbos / f"{st}_ais.pt{sfx}").is_file()]
            lines = [ln for ln in printed.splitlines()
                     if ln.startswith("  [") and "±" in ln and " s1=" in ln]
        T = c.n_ais_dist - 1
        if rc != 0 or launched != no_kernel or bad or len(lines) != 2 or (
                len(steps) != 2 * T):
            raise AssertionError(f"ais_eval -seeds 2: rc {rc}, launched "
                                 f"{launched}, missing {bad}, lines {lines}, "
                                 f"{len(steps)} steps")
        # replica 0 against the serial chain (eval_ais's step) on the card,
        # a temperature at a time from the ensemble's states, the test split
        bridge = ais.bridge_for(c)
        p0 = sweep.ensemble_replica(ens_p, 0)
        x_rep = wine.test.x.to(device="cuda").repeat(c.n_ais_iwae, 1)

        def ll0(z):
            return bridge.log_lik(p0, z, x_rep)

        worst = {"z": 0.0, "eps": 0.0, "logw": 0.0}
        flips = 0
        for state, t0_, t1_, v, u, out in steps[T:]:
            st0 = ais.AISState(state.z[0], state.eps[0],
                               state.accept_hist[0], state.logw[0], state.j)
            ref, prob = real_step(ll0, st0, t0_, t1_, v, u)
            flipped = out.accept_hist[0] != ref.accept_hist
            if flipped.any():
                energy = -(ais._log_normal_nc(st0.z) + t1_ * ll0(st0.z))
                gap = (torch.log(prob) - torch.log(u)).abs()
                allowed = AIS_FLIP_GAP_RTOL * energy.abs() + AIS_FLIP_GAP_ATOL
                if bool((gap[flipped] > allowed[flipped]).any()):
                    raise AssertionError(f"replica 0: a decision flipped "
                                         f"with gap {gap[flipped].max()}")
                flips += int(flipped.sum())
            keep = ~flipped
            for name in ("z", "eps") if keep.any() else ():
                worst[name] = max(worst[name], max_abs(
                    getattr(out, name)[0][keep], getattr(ref, name)[keep]))
            dlogw = ((out.logw[0] - ref.logw).abs()
                     / (AIS_LOGW_ATOL + AIS_LOGW_RTOL * ref.logw.abs()))
            worst["logw"] = max(worst["logw"], float(dlogw.max()))
        decisions = x_rep.shape[0] * T
        if (worst["z"] > AIS_Z_ATOL or worst["eps"] > AIS_Z_ATOL
                or worst["logw"] > 1.0 or flips > AIS_FLIP_SHARE * decisions):
            raise AssertionError(f"replica 0 against the serial chain: "
                                 f"{worst}, {flips} flips")
        print(f"ais_eval -seeds 2: {entry_s:.6f} s, both splits' estimates "
              f"and .seed1 files at the reference names, no kernel; replica "
              f"0 against the serial step from the ensemble's states over "
              f"{T} temperatures x {x_rep.shape[0]} chains: max |dz| "
              f"{worst['z']:.3e}, |deps| {worst['eps']:.3e}, logw within "
              f"{worst['logw']:.3f} of its tolerance, {flips} of {decisions} "
              f"decisions flipped [{card}]", flush=True)

        test_only = loaders.Dataset(wine.test, None, wine.obs_dim)
        sched = ais.default_schedule(c, warn=False)

        def ensemble(schedule=sched):
            return ais.eval_ais_ensemble(test_only, c, ens_p, schedule,
                                         n_sample=c.n_ais_iwae, save=False,
                                         device="cuda")

        def serial():
            return ais.eval_ais(test_only, c, params=p0, schedule=sched,
                                n_sample=c.n_ais_iwae, save=False,
                                device="cuda")

        serial()
        _, serial_ms, _ = measured(serial)
        prof_ms, on_card = profiled(
            lambda: ensemble(sched[:AIS_PROFILE_TEMPS + 1]))
        reset_counts()
        with no_plain_on_card():
            res, ens_ms, peak = measured(ensemble)
        logw = res["test"].logw
        if counts() != no_kernel or logw.shape != (ENS_S,) or not np.isfinite(
                logw).all():
            raise AssertionError(f"{ENS_S}-replica AIS: launched {counts()}, "
                                 f"logw {logw}")
        chains = wine.test.n * c.n_ais_iwae * ENS_S
        print(f"{ENS_S}-replica AIS of the test split, {chains} chains x "
              f"{T} temperatures: {ens_ms:.6f} ms (host clock) against the "
              f"serial split's {serial_ms:.6f} ms ({ens_ms / serial_ms:.2f}x "
              f"for {ENS_S} replicas); log p(x) {logw.mean():.6f} ± "
              f"{logw.std():.6f}; peak device memory {peak:.3f} MiB above "
              f"held; its first {AIS_PROFILE_TEMPS} temperatures "
              f"{busy(prof_ms, on_card)} [{card}]", flush=True)

    with phase(f"AL and AIS ensembles (d): -profile DIR and VPC_DEBUG_NANS=1"
               f" on a 2-epoch record {RESUME_RECORD} run"):
        cut = ["-epoch", "2", "-M", "1"]
        steps_run = 2 * -(-wine.train.n // c.batch_size)
        named = 0
        with grid_dir([flagship]) as tmp:
            # a trace may miss the card's events (the profiler's activity
            # buffers): up to three tries
            for attempt in range(3):
                trace_dir = tmp / f"trace{attempt}"
                reset_counts()
                with no_plain_on_card():
                    rc = imputation_main.main([*cut, "-profile",
                                               str(trace_dir)])
                traces = sorted(trace_dir.iterdir())
                if rc != 0 or len(traces) != 1 or counts()[
                        "fused_posterior_fwd"] != steps_run:
                    raise AssertionError(f"-profile: rc {rc}, {traces}, "
                                         f"launched {counts()}")
                with open(traces[0]) as fh:
                    events = json.load(fh)["traceEvents"]
                named = sum("fused_posterior_kernel" in e.get("name", "")
                            for e in events)
                if named:
                    break
            size = traces[0].stat().st_size
            os.environ["VPC_DEBUG_NANS"] = "1"
            try:
                rc = imputation_main.main(cut)
                anomaly = torch.is_anomaly_enabled()
            finally:
                del os.environ["VPC_DEBUG_NANS"]
                debugging.enable_nan_debugging(False)
        if not named or rc != 0 or not anomaly:
            raise AssertionError(f"the trace names B1 {named} times; "
                                 f"VPC_DEBUG_NANS run: rc {rc}, anomaly "
                                 f"detection {anomaly}")
        print(f"-profile: a {size} B Chrome trace of the run ({len(events)} "
              f"events, B1's kernel named in {named}, try {attempt + 1}); "
              f"VPC_DEBUG_NANS=1: the run finished with anomaly detection "
              f"on [{card}]", flush=True)
    return launches


def mesh_phase(env) -> dict:
    """The mesh phase (slice 10 part 1) on the names main() set up (`env`):
    (a) `make_parallel_train_step` and `train_sharded` on a world-size-1
    NCCL group in this process, records 34 and 37, first step card vs CPU;
    (b) the imputation entry point under torchrun at -mesh 1,1; (c) -mesh
    auto against -mesh ''. Returns the kernels' launches on (a)'s
    `train_sharded` runs."""
    import torch
    import torch.distributed as dist

    from vae_posterior_consistency_tpu_torch.config import RunConfig
    from vae_posterior_consistency_tpu_torch.engine import (
        artifacts,
        checkpoint,
        profile_train,
    )
    from vae_posterior_consistency_tpu_torch.engine import train as trainer
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        imputation as imputation_main,
    )
    from vae_posterior_consistency_tpu_torch.models import get_model
    from vae_posterior_consistency_tpu_torch.parallel import mesh as tmesh
    from vae_posterior_consistency_tpu_torch.parallel import multihost
    from vae_posterior_consistency_tpu_torch.parallel import train_parallel
    from vae_posterior_consistency_tpu_torch.utils import debugging

    card, counts, reset_counts = env["card"], env["counts"], env[
        "reset_counts"]
    no_plain_on_card, grid_dir = env["no_plain_on_card"], env["grid_dir"]
    records, no_kernel = env["records"], env["no_kernel"]
    launches = collections.Counter()

    def step_times(marks):
        """Host-clock ms between consecutive step ends after epoch 0."""
        later = [t for e, t in marks if e >= 1]
        return [(b - a) * 1e3 for a, b in zip(later, later[1:])]

    def grads_close(card_grads, cpu_grads, what):
        worst = 0.0
        for key, g in cpu_grads.items():
            if (g is None) != (card_grads[key] is None):
                raise AssertionError(f"{what} gradient {key}: on one device "
                                     "only")
            if g is None:
                continue
            scale = g.abs().max().item()
            diff = max_abs(card_grads[key].cpu(), g)
            if diff > STEP_GRAD_REL * scale:
                raise AssertionError(f"{what} gradient {key}: card vs CPU "
                                     f"max abs diff {diff:.3e} > "
                                     f"{STEP_GRAD_REL} * {scale:.3e}")
            worst = max(worst, diff / scale if scale else 0.0)
        return worst

    with phase("mesh (a): make_parallel_train_step and train_sharded on a "
               "world-size-1 NCCL group, records "
               + ", ".join(map(str, MESH_RECORDS))):
        multihost.ensure_group("cuda")
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"backend {dist.get_backend()}")
            mesh = tmesh.make_mesh(dp=1, tp=1, device="cuda")
            for number in MESH_RECORDS:
                cfg = RunConfig.from_jsonl_record(
                    records[number - 1], alpha=1.0, p_missingness=30,
                    seed=SEED, epoch=MESH_EPOCHS,
                    data_path=str(REPO / "Data"))
                model = get_model(cfg)
                ds = imputation_main.load_dataset(cfg, "cuda")
                obs = ds.obs_dim
                cpu_params = model.init(torch.Generator().manual_seed(SEED),
                                        cfg, obs, device="cpu")
                xb, mb = (ds.train.x[:cfg.batch_size],
                          ds.train.mask[:cfg.batch_size])
                # the first sharded step on the card, its draws recorded
                step, shard_inputs = train_parallel.make_parallel_train_step(
                    cfg, mesh)
                sp, opt = shard_inputs(checkpoint.on_device(cpu_params,
                                                            mesh.device))
                recorded = []
                gen_noise = trainer.GeneratorNoise(SEED + 1, mesh.device)

                def recording(kind, epoch, step_, shape):
                    t = gen_noise(kind, epoch, step_, shape)
                    recorded.append(t)
                    return t

                reset_counts()
                with no_plain_on_card():
                    card_loss = step(sp, opt, xb, mb, recording, 0, 0)
                first = counts()
                card_grads = {k: (None if p.grad is None
                                  else p.grad.full_tensor())
                              for k, p in checkpoint.flatten(sp).items()}
                # the serial step's math on the CPU, the same draws
                replay = iter([t.cpu() for t in recorded])
                leaves = {k: v.clone().requires_grad_() for k, v in
                          checkpoint.flatten(cpu_params).items()}
                eff, mask_p, eps, extra = trainer.draw_step(
                    cfg, lambda *a: next(replay), mb.cpu(), 0, 0)
                cpu_loss, _ = model.train_loss(
                    checkpoint.unflatten(leaves), xb.cpu(), eff, mask_p,
                    eps, 1.0, cfg, **extra)
                cpu_grads = dict(zip(leaves, torch.autograd.grad(
                    cpu_loss, list(leaves.values()), allow_unused=True)))
                torch.testing.assert_close(card_loss.cpu(),
                                           cpu_loss.detach(),
                                           rtol=STEP_LOSS_RTOL, atol=0)
                worst = grads_close(card_grads, cpu_grads, cfg.vae_type)
                eddi = "EDDI" in cfg.vae_type
                want_first = {**no_kernel, "fused_posterior_fwd": 1,
                              "fused_posterior_bwd": 1}
                if eddi:
                    want_first.update(embed_pool_fwd=1, embed_pool_bwd=1)
                if first != want_first:
                    raise AssertionError(f"first sharded step launched "
                                         f"{first}, want {want_first}")
                print(f"record {number} ({cfg.vae_type}, D={obs}) first "
                      f"sharded step: loss card {card_loss.item():.6f} CPU "
                      f"{cpu_loss.item():.6f}; worst gradient max|diff| / "
                      f"max|leaf| {worst:.3e}; launches {first}",
                      flush=True)
                # one step under the profiler: the device operations and
                # the NCCL all-reduce among them
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    step(sp, opt, xb, mb, gen_noise, 0, 1)
                    torch.cuda.synchronize()
                on_card = profile_train.device_events(prof)
                nccl = sorted({e.name for e in on_card
                               if "nccl" in e.name.lower()})
                # over one rank NCCL's in-place all-reduce launches nothing
                top = profile_train.top_device_ms(on_card).most_common(3)
                print("  one sharded step under torch.profiler: "
                      + (f"{len(on_card)} device operations, NCCL kernels "
                         f"{nccl or 'none'}, top device ms "
                         + "; ".join(f"{nm} {t:.6f}" for nm, t in top)
                         if on_card else "device operations not measured "
                         "(no device event in the trace)")
                      + f" [{card}]", flush=True)
                # the loop, then the serial engine's for its step time
                marks = {}
                for engine in ("sharded", "serial"):
                    marks[engine] = []

                    def on_step(epoch, s, loss, _m=marks[engine]):
                        _m.append((epoch, time.perf_counter()))

                    reset_counts()
                    with no_plain_on_card():
                        if engine == "sharded":
                            _, hist = train_parallel.train_sharded(
                                ds, cfg, mesh, on_step=on_step)
                        else:
                            _, hist = trainer.train(ds, cfg, save=False,
                                                    device="cuda",
                                                    on_step=on_step)
                    got = counts()
                    if engine == "sharded":
                        launches.update(got)
                    n_steps = len(marks[engine])
                    want = {k: n_steps * v for k, v in want_first.items()}
                    if got != want or not np.isfinite(hist).all():
                        raise AssertionError(f"{engine} {cfg.vae_type}: "
                                             f"launched {got}, want {want}; "
                                             f"history {hist}")
                sharded_ms = statistics.median(step_times(marks["sharded"]))
                serial_ms = statistics.median(step_times(marks["serial"]))
                print(f"  train_sharded {MESH_EPOCHS} epochs, "
                      f"{len(marks['sharded'])} steps, launches once a "
                      f"step; step p50 after the first epoch (host clock) "
                      f"{sharded_ms:.6f} ms against the serial engine's "
                      f"{serial_ms:.6f} ms ({sharded_ms / serial_ms:.2f}x) "
                      f"[{card}]", flush=True)
        finally:
            multihost.shutdown()
        if dist.is_initialized():
            raise AssertionError("the process group outlived the phase")

    entry_recs = [records[i - 1] for i in MESH_RECORDS]
    with phase("mesh (b): torchrun --standalone --nproc_per_node 1 -m "
               "...experiment_main.imputation -mesh 1,1 -epoch "
               f"{MESH_ENTRY_EPOCHS} over records "
               + ", ".join(map(str, MESH_RECORDS))):
        with grid_dir(entry_recs) as tmp:
            env_vars = dict(os.environ, PYTHONPATH=str(REPO))
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node", "1", "-m",
                 "vae_posterior_consistency_tpu_torch.experiment_main."
                 "imputation", "-mesh", "1,1", "-epoch",
                 str(MESH_ENTRY_EPOCHS)],
                cwd=tmp, env=env_vars, capture_output=True, text=True,
                timeout=300)
            tag = "mesh={'dp': 1, 'tp': 1}"
            if proc.returncode != 0 or proc.stdout.count(tag) != len(
                    entry_recs):
                raise AssertionError(f"torchrun -mesh 1,1: rc "
                                     f"{proc.returncode}\n{proc.stdout}"
                                     f"\n{proc.stderr[-3000:]}")
            for rec in entry_recs:
                cfg = RunConfig.from_jsonl_record(rec, alpha=1.0,
                                                  p_missingness=30)
                ck = torch.load(checkpoint.checkpoint_path(
                    cfg, str(tmp / "experiments")), weights_only=False)
                paths = [artifacts.eval_vae_paths(cfg, st, str(
                    tmp / "experiments")) for st in ("train", "test")]
                vals = [torch.load(p, weights_only=False).item()
                        for ps in paths for p in ps.values()]
                if not (all(np.isfinite(np.asarray(v)).all()
                            for v in ck.values()) and np.isfinite(vals)
                        .all()):
                    raise AssertionError(f"{cfg.vae_type}: a checkpoint "
                                         f"leaf or an artifact not finite")
            print(f"torchrun -mesh 1,1: exit 0, {tag} on each of "
                  f"{len(entry_recs)} records, checkpoints and the four "
                  f"artifacts a split at their reference names, finite",
                  flush=True)

    flagship = records[MESH_RECORDS[0] - 1]
    with phase("mesh (c): -mesh auto against -mesh '' in this process, "
               f"record {MESH_RECORDS[0]}, -epoch {MESH_ENTRY_EPOCHS}; -mesh "
               "1,1 under VPC_DEBUG_NANS=1"):
        cfg = RunConfig.from_jsonl_record(flagship, alpha=1.0,
                                          p_missingness=30)
        ck = {}
        for spec in ("auto", ""):
            with grid_dir([flagship]) as tmp:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = imputation_main.main(
                        ["-mesh", spec, "-epoch", str(MESH_ENTRY_EPOCHS),
                         "-M", "1"])
                if rc != 0 or "mesh=" in buf.getvalue() or \
                        dist.is_initialized():
                    raise AssertionError(f"-mesh {spec!r}: rc {rc}, "
                                         f"group {dist.is_initialized()}")
                ck[spec] = torch.load(checkpoint.checkpoint_path(
                    cfg, str(tmp / "experiments")), weights_only=False)
        if sorted(ck["auto"]) != sorted(ck[""]) or not all(
                np.array_equal(np.asarray(ck["auto"][k]),
                               np.asarray(ck[""][k])) for k in ck[""]):
            raise AssertionError("-mesh auto's checkpoint differs from "
                                 "-mesh ''s")
        print(f"-mesh auto: no mesh, no process group; its checkpoint "
              f"equals -mesh ''s bit for bit ({len(ck[''])} leaves)",
              flush=True)
        # a one-device mesh with no torchrun (the run makes its own
        # world-size-1 NCCL group), under the NaN tripwire
        with grid_dir([flagship]):
            os.environ["VPC_DEBUG_NANS"] = "1"
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    rc = imputation_main.main(["-mesh", "1,1", "-epoch", "1",
                                               "-M", "1"])
            finally:
                del os.environ["VPC_DEBUG_NANS"]
                debugging.enable_nan_debugging(False)
            if (rc != 0 or "mesh={'dp': 1, 'tp': 1}" not in buf.getvalue()
                    or dist.is_initialized()):
                raise AssertionError(f"-mesh 1,1 under VPC_DEBUG_NANS: rc "
                                     f"{rc}\n{buf.getvalue()}")
        print("-mesh 1,1 in this process under VPC_DEBUG_NANS=1: its own "
              "NCCL group, the tag, no NaN, the group destroyed",
              flush=True)
    return {k: launches[k] for k in ("embed_pool_fwd", "embed_pool_bwd",
                                     "fused_posterior_fwd",
                                     "fused_posterior_bwd")}


def mesh_part2_phase(env) -> dict:
    """The part-2 mesh phase (slice 10 part 2) on the names main() set up
    (`env`), each run on a world-size-1 NCCL group made in this process:
    (i) a seed ensemble, (ii) an AL episode through its entry point, (iii)
    AIS through its entry point, (iv) serving, each on a 1x1 mesh against
    the same run without one. Returns the kernels' launches on (i) and
    (ii)."""
    import torch
    import torch.distributed as dist

    from vae_posterior_consistency_tpu_torch.config import RunConfig
    from vae_posterior_consistency_tpu_torch.engine import (
        artifacts,
        checkpoint,
        serve,
    )
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        active_learning as al_main,
    )
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        ais_eval as ais_main,
    )
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        imputation as imputation_main,
    )
    from vae_posterior_consistency_tpu_torch.models import get_model
    from vae_posterior_consistency_tpu_torch.parallel import mesh as tmesh
    from vae_posterior_consistency_tpu_torch.parallel import multihost, sweep

    counts, reset_counts = env["counts"], env["reset_counts"]
    no_plain_on_card, grid_dir = env["no_plain_on_card"], env["grid_dir"]
    records, card = env["records"], env["card"]
    no_kernel, step_kernels = env["no_kernel"], env["step_kernels"]
    out = {}

    @contextlib.contextmanager
    def one_rank_mesh():
        multihost.ensure_group("cuda")
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"backend {dist.get_backend()}")
            yield tmesh.make_mesh(dp=1, tp=1, device="cuda")
        finally:
            multihost.shutdown()
        if dist.is_initialized():
            raise AssertionError("the process group outlived the run")

    def quiet(main, argv):
        buf = io.StringIO()
        reset_counts()
        with no_plain_on_card(), contextlib.redirect_stdout(buf):
            rc = main(argv)
        if rc != 0 or dist.is_initialized():
            raise AssertionError(f"{argv}: rc {rc}\n{buf.getvalue()}")
        return buf.getvalue(), counts()

    eddi = records[MESH_D_RECORDS[1] - 1]
    with phase(f"mesh (d)(i): train_seed_ensemble of record "
               f"{MESH_D_RECORDS[1]} with {MESH_D_SEEDS} seeds on a 1x1 mesh "
               f"against no mesh, {MESH_D_EPOCHS} epochs"):
        cfg = RunConfig.from_jsonl_record(
            eddi, alpha=1.0, p_missingness=30, seed=SEED,
            epoch=MESH_D_EPOCHS, data_path=str(REPO / "Data"))
        ds = imputation_main.load_dataset(cfg, "cuda")
        seeds = [SEED + s for s in range(MESH_D_SEEDS)]

        def plain_run():
            t0 = time.perf_counter()
            with no_plain_on_card():
                _, hist = sweep.train_seed_ensemble(ds, cfg, seeds,
                                                    device="cuda")
            return hist, time.perf_counter() - t0

        # no mesh, the mesh, no mesh again: the times compared are the
        # mesh run's and the second plain run's, both warm
        plain_hist, _ = plain_run()
        with one_rank_mesh() as mesh:
            reset_counts()
            t0 = time.perf_counter()
            with no_plain_on_card():
                _, mesh_hist = sweep.train_seed_ensemble(ds, cfg, seeds,
                                                         mesh=mesh)
            mesh_s = time.perf_counter() - t0
            launched = counts()
        again_hist, plain_s = plain_run()
        np.testing.assert_array_equal(again_hist, plain_hist)
        steps = MESH_D_EPOCHS * -(-ds.train.n // cfg.batch_size)
        want = {**no_kernel, **dict.fromkeys(step_kernels, steps)}
        if launched != want or mesh_hist.shape != (MESH_D_SEEDS,
                                                   MESH_D_EPOCHS):
            raise AssertionError(f"mesh seed ensemble: launched {launched}, "
                                 f"want {want}; history {mesh_hist.shape}")
        np.testing.assert_allclose(mesh_hist, plain_hist, rtol=1e-6)
        out["ensemble"] = launched
        print(f"seed ensemble of {cfg.vae_type}, {MESH_D_SEEDS} replicas on "
              f"a 1x1 mesh: {steps} steps, each kernel once a step for both "
              f"({launched}); history max |diff| against no mesh "
              f"{float(np.abs(mesh_hist - plain_hist).max()):.3e}; "
              f"host clock {mesh_s:.6f} s against {plain_s:.6f} s without "
              f"a mesh (each read back once a chunk) [{card}]", flush=True)

    with phase(f"mesh (d)(ii): experiment_main/active_learning.py -mesh 1,1 "
               f"on record {MESH_D_RECORDS[1]} against -mesh '', -M "
               f"{AL_CHECK_M}"):
        params = get_model(cfg).init(
            torch.Generator(device="cuda").manual_seed(SEED), cfg, WINE_D,
            device="cuda")
        cfg37 = RunConfig.from_jsonl_record(eddi, alpha=1.0,
                                            p_missingness=30)
        saved, launched, timing = {}, {}, {}
        for spec in ("", "1,1"):
            with grid_dir([eddi]) as tmp:
                root = str(tmp / "experiments")
                checkpoint.save(params, checkpoint.checkpoint_path(cfg37,
                                                                   root))
                printed, launched[spec] = quiet(
                    al_main.main, ["-mesh", spec, "-M", str(AL_CHECK_M)])
                if ("mesh={'dp': 1, 'tp': 1}" in printed) != bool(spec):
                    raise AssertionError(f"-mesh {spec!r}: tag\n{printed}")
                timing[spec] = [ln.strip() for ln in printed.splitlines()
                                if "[timing]" in ln]
                saved[spec] = {
                    name: torch.load(path, weights_only=True)
                    for name, path in artifacts.active_learning_paths(
                        cfg37.replace(M=AL_CHECK_M), root).items()}
        want = {**no_kernel, "embed_pool_fwd": 1 + 6 * (WINE_D - 1)}
        if launched["1,1"] != want:
            raise AssertionError(f"AL -mesh 1,1 launched {launched['1,1']}, "
                                 f"want {want}")
        a, b = saved[""], saved["1,1"]
        if not torch.equal(a["action"], b["action"]):
            raise AssertionError("AL -mesh 1,1: the reveals differ")
        torch.testing.assert_close(b["R_hist"], a["R_hist"],
                                   rtol=AL_REWARD_RTOL, atol=AL_REWARD_ATOL)
        torch.testing.assert_close(b["im"], a["im"], rtol=0,
                                   atol=AL_IM_ATOL)
        torch.testing.assert_close(b["information_curve"],
                                   a["information_curve"],
                                   rtol=AL_CURVE_RTOL, atol=0)
        out["al"] = launched["1,1"]
        print(f"AL -mesh 1,1 on {cfg37.vae_type}: B2f "
              f"{launched['1,1']['embed_pool_fwd']} times, nothing else; "
              f"artifacts against -mesh '': R_hist max |diff| "
              f"{max_abs(a['R_hist'], b['R_hist']):.3e}, curve max |diff| "
              f"{max_abs(a['information_curve'], b['information_curve']):.3e}"
              f", the reveals equal; -mesh '' {timing['']}, -mesh 1,1 "
              f"{timing['1,1']} [{card}]", flush=True)

    flagship = records[MESH_D_RECORDS[0] - 1]
    with phase(f"mesh (d)(iii): experiment_main/ais_eval.py -mesh 1,1 on "
               f"record {MESH_D_RECORDS[0]} against -mesh ''"):
        acfg = RunConfig.from_jsonl_record(flagship, seed=SEED, alpha=1.0,
                                           p_missingness=30)
        est = {}
        for spec in ("", "1,1"):
            with grid_dir([flagship]) as tmp:
                root = str(tmp / "experiments")
                checkpoint.save(env["wine_params"],
                                checkpoint.checkpoint_path(acfg, root))
                printed, launched = quiet(
                    ais_main.main, ["-vae_type", acfg.vae_type, "-mesh", spec])
                tagged = "mesh={'dp': 1, 'tp': 1}: AIS chains dp-sharded"
                if (tagged in printed) != bool(spec) or any(
                        launched.values()):
                    raise AssertionError(f"ais_eval -mesh {spec!r}: "
                                         f"launched {launched}\n{printed}")
                base = os.path.join(root, acfg.vae_type, acfg.data_type,
                                    "elbos", f"{acfg.missing_rate}_missing",
                                    f"{acfg.epoch}_epochs")
                est[spec] = {st: (torch.load(os.path.join(
                    base, f"{st}_ais.pt"), weights_only=False).item(),
                    torch.load(os.path.join(base.replace("elbos", "latents"),
                                            f"{st}_ais_true_latents.pt"),
                               weights_only=False))
                    for st in ("train", "test")}
        for st, (logw, lats) in est[""].items():
            m_logw, m_lats = est["1,1"][st]
            if (abs(m_logw - logw) > AIS_LOGW_ATOL + AIS_LOGW_RTOL * abs(logw)
                    or max_abs(torch.as_tensor(m_lats),
                               torch.as_tensor(lats)) > AIS_Z_ATOL):
                raise AssertionError(f"ais_eval -mesh 1,1 {st}: {m_logw} "
                                     f"against {logw}")
        print("ais_eval -mesh 1,1: "
              + "; ".join(f"{st} log p(x) {est['1,1'][st][0]:.6f} against "
                          f"{v[0]:.6f}" for st, v in est[""].items())
              + ", the latents equal, no kernel", flush=True)

    with phase("mesh (d)(iv): ImputationServer(mesh=...) on a 1x1 mesh "
               "against the plain server, 4 requests"):
        scfg = RunConfig.from_jsonl_record(flagship, seed=SEED)
        wine = env["wine"]
        plain = serve.ImputationServer(env["wine_params"], scfg, WINE_D,
                                       device="cuda")
        rows = (1, 8, 17, 64)
        x = wine.train.x[:max(rows)].cpu().numpy()
        m = wine.train.mask[:max(rows)].cpu().numpy()
        want = [plain.impute(x[:n], m[:n]) for n in rows]
        with one_rank_mesh() as mesh:
            meshed = serve.ImputationServer(env["wine_params"], scfg, WINE_D,
                                            mesh=mesh)
            got = [meshed.impute(x[:n], m[:n]) for n in rows]
        worst = 0.0
        for (f, sc), (wf, ws) in zip(got, want):
            if f.shape != wf.shape or not np.isfinite(f).all():
                raise AssertionError("mesh server: shape or finiteness")
            worst = max(worst, float(np.abs(f - wf).max()),
                        float(np.abs(sc - ws).max()))
        if worst > SERVE_ATOL:
            raise AssertionError(f"mesh server against plain: {worst:.3e}")
        print(f"ImputationServer on a 1x1 mesh: requests of {rows} rows, "
              f"max |diff| against the plain server {worst:.3e} [{card}]",
              flush=True)
    return out


def mixed_precision_phase(env) -> dict:
    """Mixed precision (compute_dtype 'bfloat16', slice 11 part a) and the
    host data plane (part b) on the names main() set up (`env`): (a) the
    first bf16 training step of MNIST reg_EDDI1 at full width and of wine
    reg_vae1, card against CPU, under torch.profiler; (b) record 37 through
    the imputation entry point in float32 and in bfloat16; (c) eval_vae
    and one active-learning step under bf16; (d) `data/native_io`. Returns
    the kernels' launches on (b)'s bf16 training run."""
    import torch

    from vae_posterior_consistency_tpu_torch.config import RunConfig
    from vae_posterior_consistency_tpu_torch.data import loaders, native_io
    from vae_posterior_consistency_tpu_torch.engine import (
        active_learning,
        artifacts,
        checkpoint,
        evaluate,
        profile_train,
    )
    from vae_posterior_consistency_tpu_torch.engine import train as trainer
    from vae_posterior_consistency_tpu_torch.experiment_main import (
        imputation as imputation_main,
    )
    from vae_posterior_consistency_tpu_torch.models import get_model, layers
    from vae_posterior_consistency_tpu_torch.nn import core
    from vae_posterior_consistency_tpu_torch.ops import fused_embed_pool

    counts, reset_counts = env["counts"], env["reset_counts"]
    no_plain_on_card, grid_dir = env["no_plain_on_card"], env["grid_dir"]
    records, card, mnist = env["records"], env["card"], env["mnist"]
    no_kernel, step_kernels = env["no_kernel"], env["step_kernels"]
    step_timer = env["step_timer"]
    BF16 = "bfloat16"

    def gemm_names(fn, want):
        """The GEMM kernels' names of one call of `fn` under
        torch.profiler. A trace may lose device events (one held none at
        all; one held 16 of a wine step's 17 bf16 GEMMs where the same
        step's earlier traces held 17), so up to three traces are taken:
        the first that holds `want` bf16 GEMMs is returned, else the one
        that holds the most."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        best = (-1, [])
        for _ in range(3):
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            gemms = [e.name for e in profile_train.device_events(prof)
                     if "gemm" in e.name.lower()]
            best = max(best, (sum("bf16" in n.lower() for n in gemms),
                              gemms))
            if best[0] >= want:
                break
        return best[1]

    @contextlib.contextmanager
    def float32_embed():
        """The card's precision policy on CPU tensors: the EDDI embed
        pooled by the kernels' plain version in float32 (C.4.32)."""
        saved = layers._pointnet_pool_multi

        def pool(params, x, masks):
            return fused_embed_pool.embed_pool(
                x, masks, *layers._pointnet_affine(params))

        layers._pointnet_pool_multi = pool
        try:
            yield
        finally:
            layers._pointnet_pool_multi = saved

    def ulps(card_grads, cpu_grads):
        """Each leaf's max |card - CPU| in bf16 ulps of its largest CPU
        magnitude; a leaf without a gradient must lack it on both."""
        out = {}
        for key, g in cpu_grads.items():
            if g is None or card_grads[key] is None:
                if (g is None) != (card_grads[key] is None):
                    raise AssertionError(f"gradient {key}: on one device "
                                         "only")
                continue
            out[key] = max_abs(card_grads[key].cpu(), g) / (
                BF16_ULP * g.abs().max().item())
        return out

    def first_step(cfg, xb, mb, obs_dim, want):
        """The first bf16 step on the card against the CPU: the loss within
        BF16_LOSS_RTOL, every leaf but the EDDI tables within
        BF16_GRAD_ULPS bf16 ulps of its largest magnitude, the tables too
        against a CPU step with the card's float32 embed; its launches
        `want`, no plain version on a CUDA tensor; then the step's dense
        products under torch.profiler, each a bf16 GEMM."""
        model = get_model(cfg)
        cpu_params = model.init(torch.Generator().manual_seed(SEED), cfg,
                                obs_dim, device="cpu")
        src, kept = trainer.GeneratorNoise(SEED + 1, "cuda"), []

        def recording(kind, epoch, step, shape):
            kept.append(src(kind, epoch, step, shape))
            return kept[-1]

        def step(params, x, m, noise):
            leaves = {k: v.clone().requires_grad_()
                      for k, v in checkpoint.flatten(params).items()}
            eff, mask_p, eps, extra = trainer.draw_step(cfg, noise, m, 0, 0)
            loss, _ = model.train_loss(checkpoint.unflatten(leaves), x, eff,
                                       mask_p, eps, 1.0, cfg, **extra)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            return loss.detach(), dict(zip(leaves, grads))

        card_params = checkpoint.unflatten({
            k: v.cuda() for k, v in checkpoint.flatten(cpu_params).items()})
        reset_counts()
        products = core.bf16_product.launches
        with no_plain_on_card():
            card_loss, card_grads = step(card_params, xb.cuda(), mb.cuda(),
                                         recording)
        torch.cuda.synchronize()
        launched, n_products = counts(), core.bf16_product.launches - products
        if launched != want:
            raise AssertionError(f"a bf16 step launched {launched}, want "
                                 f"{want}")
        def cpu_step():
            replay = iter([t.cpu() for t in kept])
            return step(cpu_params, xb.cpu(), mb.cpu(),
                        lambda kind, epoch, step, shape: next(replay))

        cpu_loss, cpu_grads = cpu_step()
        torch.testing.assert_close(card_loss.cpu(), cpu_loss,
                                   rtol=BF16_LOSS_RTOL, atol=0)
        worst = ulps(card_grads, cpu_grads)
        tables = {k: worst.pop(k) for k in BF16_TABLES if k in worst}
        if tables:
            with float32_embed():
                f32_loss, f32_grads = cpu_step()
            torch.testing.assert_close(card_loss.cpu(), f32_loss,
                                       rtol=BF16_LOSS_RTOL, atol=0)
            f32_ulps = ulps(card_grads, f32_grads)
            worst.update({f"{k} (float32 embed)": f32_ulps[k]
                          for k in tables})
        for key, n in worst.items():
            if n > BF16_GRAD_ULPS:
                raise AssertionError(f"gradient {key}: card vs CPU {n:.3f} "
                                     f"bf16 ulps of max|leaf| > "
                                     f"{BF16_GRAD_ULPS}")
        gemms = gemm_names(lambda: step(card_params, xb.cuda(), mb.cuda(),
                                        trainer.GeneratorNoise(SEED + 1,
                                                               "cuda")),
                           n_products)
        bf16_gemms = [n for n in gemms if "bf16" in n.lower()]
        if len(bf16_gemms) < n_products:
            raise AssertionError(
                f"{n_products} bf16 products, {len(bf16_gemms)} bf16 GEMM "
                f"kernels in the trace: {sorted(set(gemms))}")
        top = max(worst, key=worst.get)
        print(f"{cfg.vae_type} bf16 first step: loss card "
              f"{card_loss.item():.6f} CPU {cpu_loss.item():.6f} (rel "
              f"{abs(card_loss.item() / cpu_loss.item() - 1):.3e}); "
              f"{len(worst)} leaves, worst {worst[top]:.3f} bf16 ulps of "
              f"max|leaf| ({top}); "
              + "".join(f"{k} {v:.3f} ulps from the CPU's bf16 embed, "
                        f"{worst[k + ' (float32 embed)']:.3f} from its "
                        "float32 one; " for k, v in tables.items())
              + f"every leaf {({k: round(v, 3) for k, v in worst.items()})}; "
              f"launches {launched}; {n_products} bf16 "
              f"products, GEMM kernels in the trace {len(gemms)} "
              f"({len(bf16_gemms)} bf16): {sorted(set(gemms))} [{card}]",
              flush=True)

    # B1, B2f and B2b once a step; IW1 never (it runs without gradients)
    once = {**no_kernel, **dict.fromkeys(step_kernels, 1)}
    with phase("mixed precision (a): first bf16 steps, card vs CPU, and "
               "their GEMMs under torch.profiler"):
        mcfg = RunConfig(vae_type="reg_EDDI1", data_type="mnist",
                         missing_rate=30, seed=SEED, batch_size=64,
                         compute_dtype=BF16)
        first_step(mcfg, mnist.train.x[:64], mnist.train.mask[:64], 784,
                   once)
        wine_cfg = RunConfig(vae_type="reg_vae1", missing_rate=30,
                             seed=SEED, batch_size=64, compute_dtype=BF16)
        wine = loaders.data_loader(str(REPO / "Data"), "reg_vae1", 30, 64,
                                   "wine", device="cuda")
        first_step(wine_cfg, wine.train.x[:64], wine.train.mask[:64],
                   WINE_D, {**no_kernel, "fused_posterior_fwd": 1,
                            "fused_posterior_bwd": 1})

    rec = records[BF16_RECORD - 1]
    runs = {}
    with phase(f"mixed precision (b): record {BF16_RECORD} through "
               f"experiment_main/imputation.py in float32 and bfloat16, "
               f"{BF16_EPOCHS} epochs"):
        real_train = trainer.train
        for dtype in ("float32", BF16):
            r = json.loads(json.dumps(rec))
            r["compute_dtype"] = {"type": "str", "help": "", "default": dtype}
            run = runs[dtype] = {}

            def timed_train(dataset, cfg, _run=run, **kw):
                on_step, medians = step_timer()
                reset_counts()
                params, hist = real_train(dataset, cfg, on_step=on_step, **kw)
                _run.update(cfg=cfg, params=params, hist=np.asarray(hist),
                            launches=counts(), p50=medians(),
                            steps=-(-dataset.train.n // cfg.batch_size))
                return params, hist

            with grid_dir([r]):
                trainer.train = timed_train
                try:
                    with no_plain_on_card(), contextlib.redirect_stdout(
                            io.StringIO()) as buf:
                        rc = imputation_main.main([
                            "-device", "cuda", "-epoch", str(BF16_EPOCHS),
                            "-M", str(BF16_M)])
                finally:
                    trainer.train = real_train
                if rc != 0:
                    raise AssertionError(f"{dtype}: rc {rc}\n"
                                         f"{buf.getvalue()}")
                cfg = run["cfg"]
                if cfg.compute_dtype != dtype:
                    raise AssertionError(f"ran {cfg.compute_dtype}, not "
                                         f"{dtype}")
                written = [checkpoint.checkpoint_path(cfg, "experiments")]
                for stage in ("train", "test"):
                    written += artifacts.eval_vae_paths(
                        cfg, stage, "experiments").values()
                for path in written:
                    if not os.path.isfile(path):
                        raise AssertionError(f"{dtype}: no {path}")
            steps = run["steps"] * BF16_EPOCHS
            if run["launches"] != {**no_kernel,
                                   **dict.fromkeys(step_kernels, steps)}:
                raise AssertionError(f"{dtype}: {run['launches']} launches "
                                     f"in {steps} steps")
            hist = run["hist"]
            if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
                raise AssertionError(f"{dtype}: losses {hist}")
        f32, bf16 = runs["float32"]["hist"], runs[BF16]["hist"]
        np.testing.assert_allclose(bf16, f32, rtol=BF16_CURVE_RTOL)
        busy = {dtype: profile_train._run(
            RunConfig(vae_type="reg_EDDI1", data_type="mnist",
                      missing_rate=30, seed=SEED, batch_size=64,
                      compute_dtype=dtype), mnist, BF16_PROFILE_STEPS, None)
            for dtype in ("float32", BF16)}
        for dtype in ("float32", BF16):
            dev, host = runs[dtype]["p50"]
            b = busy[dtype]
            print(f"record {BF16_RECORD} {dtype}: losses {runs[dtype]['hist'][0]:.4f} -> "
                  f"{runs[dtype]['hist'][-1]:.4f}, max |bf16/f32 - 1| "
                  f"{np.abs(bf16 / f32 - 1).max():.3e}; step p50 {dev:.3f} "
                  f"ms (CUDA events) {host:.3f} ms (host); launches "
                  f"{runs[dtype]['launches']}; MNIST reg_EDDI1 "
                  f"(profile_train, {BF16_PROFILE_STEPS} steps): step "
                  f"{b['step_ms']:.3f} ms, device busy "
                  f"{b['device_busy_ms_per_step']:.3f} ms, idle share "
                  f"{b['device_idle_share']:.3f}, top "
                  f"{b['top_device_ms_per_step'][:4]} [{card}]", flush=True)

    with phase("mixed precision (c): eval_vae and an active-learning step "
               "under bf16, card vs CPU"):
        cfg, params = runs[BF16]["cfg"], runs[BF16]["params"]
        ds = loaders.data_loader(str(REPO / "Data"), cfg.vae_type,
                                 cfg.missing_rate, cfg.batch_size,
                                 cfg.data_type, device="cuda")
        src, kept = trainer.GeneratorNoise(cfg.seed + 1, "cuda"), []

        def rec_noise(kind, rep, step, shape):
            kept.append(src(kind, rep, step, shape))
            return kept[-1]

        with no_plain_on_card():
            got = evaluate.eval_vae(ds, cfg, params=params, noise=rec_noise,
                                    save=False, device="cuda")
        replay = iter([t.cpu() for t in kept])
        cpu_ds = loaders.data_loader(str(REPO / "Data"), cfg.vae_type,
                                     cfg.missing_rate, cfg.batch_size,
                                     cfg.data_type, device="cpu")
        cpu_params = checkpoint.on_device(params, "cpu")
        want = evaluate.eval_vae(
            cpu_ds, cfg, params=cpu_params, save=False, device="cpu",
            noise=lambda kind, rep, step, shape: next(replay))
        for stage in want:
            for name, value in want[stage].items():
                tol = (BF16_EVAL_RMSE_ATOL if name == "rmse"
                       else BF16_EVAL_RTOL * abs(value))
                if not abs(got[stage][name] - value) <= tol:
                    raise AssertionError(
                        f"bf16 eval [{stage}] {name}: card "
                        f"{got[stage][name]!r}, CPU {value!r}")
        print(f"bf16 eval_vae of record {BF16_RECORD}, card (CPU): " + "; ".join(
            f"[{st}] " + ", ".join(f"{k} {got[st][k]:.6f} ({v:.6f})"
                                   for k, v in want[st].items())
            for st in want), flush=True)

        x = ds.test.x
        mask = torch.zeros_like(x)
        mask[:, :3] = 1.0
        f32_cfg = cfg.replace(compute_dtype="float32")
        al_noise = active_learning.default_noise(cfg, "cuda")
        with torch.no_grad(), no_plain_on_card():
            out = active_learning.al_step(get_model(cfg), params, cfg, x,
                                          mask, al_noise, 0, 0)
            again = active_learning.rewards(get_model(f32_cfg), params,
                                            f32_cfg, x, mask, out["im"])
            f32_im = active_learning.al_step(
                get_model(f32_cfg), params, f32_cfg, x, mask,
                active_learning.default_noise(f32_cfg, "cuda"), 0, 0)["im"]
        if not torch.equal(again, out["R"]):
            raise AssertionError("bf16 AL step: its rewards are not the "
                                 "float32 rewards of its completions")
        if torch.equal(f32_im, out["im"]):
            raise AssertionError("bf16 AL step: the completions did not "
                                 "narrow")
        print(f"bf16 AL step of record {BF16_RECORD} on {x.shape[0]} rows: "
              f"rewards equal the float32 rewards of its completions bit "
              f"for bit; completions max |bf16 - f32| "
              f"{max_abs(out['im'], f32_im):.3e}", flush=True)

        # the MIWAE evaluation under bf16 keeps the eager composition:
        # IW1 computes in float32 only
        bf16_miwae = env["miwae_cfg"].replace(compute_dtype=BF16)
        reset_counts()
        with no_plain_on_card():
            evaluate.eval_vae(loaders.Dataset(None, env["miwae_data"].test,
                                              env["miwae_data"].obs_dim),
                              bf16_miwae, params=env["miwae_params"],
                              save=False, device="cuda")
        print(f"bf16 eval_vae of {bf16_miwae.vae_type}, the test split: "
              f"launches {counts()}", flush=True)
        if counts()["iw_fused"] != 0:
            raise AssertionError(f"the bf16 MIWAE evaluation launched IW1: "
                                 f"{counts()}")

    with phase("mixed precision (d): the data plane, data/native_io"):
        lib = native_io.library()
        if not native_io.available():
            raise AssertionError("native_io: the library is not in use")
        csvs = sorted((REPO / "Data").glob("*/*_index*.csv"))
        before = native_io.read_csv.native_calls
        for path in csvs:
            np.testing.assert_array_equal(
                native_io.read_csv(str(path)),
                np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2))
        loaders.data_loader(str(REPO / "Data"), "reg_vae2", 30, 64, "wine",
                            device="cuda")
        if native_io.read_csv.native_calls != before + len(csvs) + 2:
            raise AssertionError("native_io.read_csv: not every read went "
                                 "through the library")
        shape, seed = (200, 784), 1234
        bits = native_io.mcar_mask(shape, 30.0, seed)
        plain = (native_io._xorshift128p_uniforms(int(np.prod(shape)), seed)
                 < 0.7).astype(np.float32).reshape(shape)
        np.testing.assert_array_equal(bits, plain)
        packed = native_io.pack_mask(bits)
        np.testing.assert_array_equal(
            packed, np.packbits(bits.astype(bool).ravel(), bitorder="little"))
        np.testing.assert_array_equal(native_io.unpack_mask(packed, shape),
                                      bits)
        print(f"native_io: {lib._name} (ABI {lib.vpc_io_abi_version()}); "
              f"{len(csvs)} index CSVs equal np.loadtxt, the loaders read "
              f"theirs through it; mcar_mask {shape} equal to the numpy "
              f"fallback's bits; pack/unpack round trip", flush=True)
    return runs[BF16]["launches"]


def completeness_phase(env) -> dict:
    """The last modules (slice 11 part c) on the names main() set up
    (`env`): (a) reference state_dicts both ways and the converted models
    served on the card against the CPU; (b) the CSV imputer,
    examples/impute_csv, on a wine table with cells blanked; (c) the MNIST
    IDX converter and the loader. Returns the kernels' launches over (a)
    and (b)."""
    import gzip
    import struct

    import torch

    from vae_posterior_consistency_tpu_torch.config import RunConfig
    from vae_posterior_consistency_tpu_torch.data import loaders, native_io
    from vae_posterior_consistency_tpu_torch.engine import checkpoint, serve
    from vae_posterior_consistency_tpu_torch.examples import impute_csv
    from vae_posterior_consistency_tpu_torch.tools import convert_mnist_idx

    counts, reset_counts = env["counts"], env["reset_counts"]
    no_plain_on_card, card = env["no_plain_on_card"], env["card"]
    seeded, mnist, no_kernel = env["seeded"], env["mnist"], env["no_kernel"]
    miwae_cfg, flow_cfg = env["miwae_cfg"], env["flow_cfg"]
    total = collections.Counter()

    # (a) every family's reference state_dict both ways, then served
    eddi_cfg = RunConfig(vae_type="reg_EDDI1", data_type="mnist",
                         missing_rate=30, seed=SEED)
    nm_cfg = miwae_cfg.replace(vae_type="vanilla_notMIWAE1")
    cases = ((eddi_cfg, 784), (miwae_cfg, WINE_D), (nm_cfg, WINE_D),
             (nm_cfg.replace(not_miwae_type="author"), WINE_D),
             (flow_cfg, WINE_D))
    wine_m = env["miwae_data"].train.mask[:8].cpu().numpy()
    wine_x = env["miwae_data"].train.x[:8].cpu().numpy() * wine_m
    mnist_m = mnist.test.mask[:8].cpu().numpy()
    mnist_x = mnist.test.x[:8].cpu().numpy() * mnist_m
    with phase("completeness (a): reference state_dicts both ways, the "
               "converted models served, card vs CPU"):
        for cfg, D in cases:
            label = f"{cfg.vae_type} ({cfg.not_miwae_type})" if (
                "notMIWAE" in cfg.vae_type) else cfg.vae_type
            cpu_p, _ = seeded(cfg, D)
            want = {k: v.numpy() for k, v in
                    checkpoint.flatten(cpu_p).items()}
            sd = checkpoint.export_state_dict(cpu_p, cfg, D)
            with contextlib.redirect_stdout(io.StringIO()):
                back = checkpoint.flatten(
                    checkpoint.convert_state_dict(sd, cfg, D))
            # a leaf the state_dict lacks comes from the init seeded with 0,
            # as `seeded`'s does: every leaf comes back bit for bit
            if sorted(back) != sorted(want) or not all(
                    np.array_equal(back[k], want[k]) for k in want):
                raise AssertionError(f"{label}: the state_dict did not map "
                                     "back to its parameters")
            x, m = (mnist_x, mnist_m) if D == 784 else (wine_x, wine_m)
            rows = (1, 8)
            src, kept = serve.GeneratorNoise(cfg.seed + 9, "cuda"), []

            def rec(kind, ctr, shape, _src=src, _kept=kept):
                t = _src(kind, ctr, shape)
                _kept.append(t)
                return t

            srv = serve.ImputationServer(
                checkpoint.params_from_jax(back, "cuda"), cfg, D,
                buckets=SERVE_B_BUCKETS, device="cuda", noise=rec)
            reset_counts()
            with no_plain_on_card():
                outs = [srv.impute(x[:n], m[:n]) for n in rows]
            launched = counts()
            total.update(launched)
            want_l = dict.fromkeys(launched, 0)
            if D == 784:
                want_l["embed_pool_fwd"] = len(rows)
            if runs_iw1(cfg):  # IW1 once a request
                want_l["iw_fused"] = len(rows)
            if runs_iw2(cfg):  # IW2 once a request
                want_l["iw_mnar"] = len(rows)
            if launched != want_l:
                raise AssertionError(f"{label}: serving launched {launched},"
                                     f" want {want_l}")
            replay = iter([t.cpu() for t in kept])
            cpu_srv = serve.ImputationServer(
                checkpoint.params_from_jax(back, "cpu"), cfg, D,
                buckets=SERVE_B_BUCKETS, device="cpu",
                noise=lambda kind, ctr, shape: next(replay))
            worst_f = worst_s = 0.0
            for n, (filled, score) in zip(rows, outs):
                if not (np.isfinite(filled).all()
                        and np.isfinite(score).all()):
                    raise AssertionError(f"{label}: non-finite output")
                np.testing.assert_array_equal(filled * m[:n], x[:n])
                c_filled, c_score = cpu_srv.impute(x[:n], m[:n])
                np.testing.assert_allclose(filled, c_filled, rtol=0,
                                           atol=SERVE_ATOL)
                # a row score sums 784 cells at the MNIST width (serving's
                # bound), 13 at the wine width (serving (b)'s)
                tol = (dict(rtol=0, atol=SERVE_SCORE_ATOL) if D == 784 else
                       dict(rtol=SERVE_B_SCORE_RTOL,
                            atol=SERVE_B_SCORE_ATOL))
                np.testing.assert_allclose(score, c_score, **tol)
                worst_f = max(worst_f, float(np.abs(filled - c_filled).max()))
                worst_s = max(worst_s, float(np.abs(score - c_score).max()))
            print(f"{label} (D={D}): {len(sd)} reference tensors, mapped back"
                  f" bit for bit; requests of {rows} rows, card vs CPU max "
                  f"abs diff imputed {worst_f:.3e}, row score {worst_s:.3e};"
                  f" launches {launched}", flush=True)

    # (b) the CSV imputer on wine with about 30% of its cells blanked
    raw = torch.load(REPO / "Data" / "wine" / "data.pt",
                     weights_only=True).numpy()
    n, D = raw.shape
    kept_cells = native_io.mcar_mask(raw.shape, 30, SEED + 5) > 0.5
    steps = CSV_EPOCHS * math.ceil(n / 64)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "wine_blanked.csv"
        np.savetxt(src, np.where(kept_cells, raw, np.nan), delimiter=",",
                   fmt="%.6g")
        table = impute_csv.read_csv_with_nans(str(src))
        observed = ~np.isnan(table)
        if not np.array_equal(observed, kept_cells):
            raise AssertionError("the blanked CSV did not read back")
        lo = np.nanmin(table, axis=0)
        hi = np.nanmax(table, axis=0)
        span = np.where(hi > lo, hi - lo, 1.0)
        col_mean = np.nanmean(table, axis=0)
        holes = ~observed
        mean_rmse = float(np.sqrt(np.mean(
            (((col_mean - raw) / span)[holes]) ** 2)))
        for vae_type in CSV_TYPES:
            out = Path(tmp) / f"{vae_type}.csv"
            eddi = "EDDI" in vae_type
            with phase(f"completeness (b): examples/impute_csv "
                       f"--vae_type {vae_type}, {CSV_EPOCHS} epochs on "
                       f"{n} x {D} wine, {int(holes.sum())} cells blank"):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with no_plain_on_card(), contextlib.redirect_stderr(
                        io.StringIO()) as err:
                    impute_csv.main(["--input", str(src), "--output",
                                     str(out), "--epochs", str(CSV_EPOCHS),
                                     "--vae_type", vae_type,
                                     "--device", "cuda"])
                wall = time.perf_counter() - t0
                launched = counts()
                total.update(launched)
                want_l = {**no_kernel, "fused_posterior_fwd": steps,
                          "fused_posterior_bwd": steps}
                if eddi:
                    want_l.update(embed_pool_fwd=steps + 1,
                                  embed_pool_bwd=steps)
                if launched != want_l:
                    raise AssertionError(f"impute_csv {vae_type} launched "
                                         f"{launched}, want {want_l}")
                got = np.loadtxt(out, delimiter=",", dtype=np.float32)
                if got.shape != raw.shape or not np.isfinite(got).all():
                    raise AssertionError(f"impute_csv {vae_type}: output "
                                         f"{got.shape}, finite "
                                         f"{np.isfinite(got).all()}")
                np.testing.assert_array_equal(got[observed], table[observed])
                # the sigmoid decoder: each imputation inside its column's
                # observed range, to the file's 6 significant digits
                slack = 1e-5 * np.maximum(np.abs(lo), np.abs(hi))
                if ((got < lo - slack) | (got > hi + slack))[holes].any():
                    raise AssertionError(f"impute_csv {vae_type}: an "
                                         "imputation outside its column's "
                                         "observed range")
                rmse = float(np.sqrt(np.mean(
                    (((got - raw) / span)[holes]) ** 2)))
                print(f"impute_csv {vae_type}: {steps} steps and one serving"
                      f" call in {wall:.3f} s (host clock); launches "
                      f"{launched}; RMSE on the {int(holes.sum())} blanked "
                      f"cells, in units of each column's observed range, "
                      f"{rmse:.6f} against the column-mean fill's "
                      f"{mean_rmse:.6f} [{card}]", flush=True)
                print("  stderr: " + " | ".join(
                    err.getvalue().strip().splitlines()), flush=True)

        # (c) a small synthetic IDX pair through the converter and loader
        with phase("completeness (c): tools/convert_mnist_idx and "
                   "data_loader_mnist"):
            rng = np.random.default_rng(SEED)
            pixels = {}
            for stage, count, name in (("train", 16, "train-images-idx3-"
                                        "ubyte.gz"),
                                       ("test", 8, "t10k-images-idx3-ubyte")):
                pixels[stage] = rng.integers(0, 256, (count, 28, 28),
                                             dtype=np.uint8)
                opener = gzip.open if name.endswith(".gz") else open
                with opener(Path(tmp) / name, "wb") as fh:
                    fh.write(struct.pack(">IIII", 2051, count, 28, 28)
                             + pixels[stage].tobytes())
            with contextlib.redirect_stdout(io.StringIO()):
                convert_mnist_idx.main([
                    "--train_images",
                    str(Path(tmp) / "train-images-idx3-ubyte.gz"),
                    "--test_images", str(Path(tmp) / "t10k-images-idx3-ubyte"),
                    "--out", str(Path(tmp) / "idx" / "mnist"),
                    "--missing_rate", "30", "--seed", "1234"])
            ds = loaders.data_loader_mnist(str(Path(tmp) / "idx"),
                                           "reg_EDDI1", 30, 64,
                                           device="cuda")
            for (stage, split), seed in zip((("train", ds.train),
                                             ("test", ds.test)),
                                            (1234, 1235)):
                px = pixels[stage].reshape(-1, 784)
                if split.x.device.type != "cuda" or split.x.shape != px.shape:
                    raise AssertionError(f"IDX {stage}: {split.x.shape} on "
                                         f"{split.x.device}")
                np.testing.assert_array_equal(
                    split.x.cpu().numpy(), px.astype(np.float32) / 255.0)
                np.testing.assert_array_equal(
                    split.mask.cpu().numpy(),
                    (native_io.mcar_mask(px.shape, 30, seed) > 0.5).astype(
                        np.float32))
            print(f"IDX: {ds.train.n} + {ds.test.n} images converted and "
                  f"loaded on the card, pixels / 255 and the masks of seeds "
                  f"1234 and 1235; observed share "
                  f"{float(ds.train.mask.mean()):.3f}", flush=True)
    return dict(total)


def iter_records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def loaders_split(dataset, rows):
    """`dataset` cut to its first `rows` training rows (no test split)."""
    from vae_posterior_consistency_tpu_torch.data import loaders

    tr = dataset.train
    return loaders.Dataset(loaders.Split(tr.x[:rows], tr.mask[:rows],
                                         "train"), None, dataset.obs_dim)


if __name__ == "__main__":
    sys.exit(main())
