#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (moose_tpu_torch) once on one CUDA card.

Run from the root of a checkout, with no arguments, on a machine with an
NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. versions of torch, CUDA and nvcc, and the card's name and power
     limit as nvidia-smi reports them;
  2. build every kernel of the path from moose_tpu_torch/csrc (seven
     sources, one nvcc each, started together);
  3. hold each kernel against its plain PyTorch version on the card at
     the main path's shapes and at 2^20 elements, word for word, and
     time both with CUDA events after warm-up; K1 also at the trainers'
     shapes and past its segment depth, with an int8 tensor-core
     yardstick (torch._int_mm on as many int8 multiply-adds) beside the
     1000^3 rows; K4 with the public factor at its own shape (as
     spmd.mul_public passes it, broadcast in the kernel) and
     materialised at the shares' shape, at 2^20 elements also timed back
     to back, beside torch.mul at ring64; K5 at the logistic
     regression's and the trainers' element counts, there also timed
     back to back; the threefry kernel (K7) in both stream layouts:
     grouped, with the seeds derived on the card (the logistic
     regression's Horner group of 84 draws, its adder group of 16 bit
     banks, a truncation group of 6 at the secure dot's 10^6, a group of
     one at 2^20 words), beside the same draws one by one as the session
     drew them before groups (host seed, one launch each), and under a
     given key, words and bits; K3's fused cross_terms_reshare at the
     path's (3,2,1024) and broadcast (64,1024,1) x (1,1024,1) shapes and
     at 2^20, beside the composition it replaced (slot copies, the
     unfused kernel, the zero share, the pair layout); K2's trunc_pairs
     (the whole truncation after its draws, pair layout in and out) on
     the logistic regression's (1024,) operand, contiguous, transposed
     and broadcast, at 10^6 ring64, and on the secure dot's (1000, 1000)
     cross terms with their zero-share bank; K6 reading x's pair layout
     in place at (3, 1024), 14 steps, and at 2^20; the multinomial
     classifier's shapes: K1's (3,1024,101)@(3,101,10) logits, K2 at
     (1024, 10) by 40, 22 and 23, K3 on a tournament round's strided
     halves, K4 at (3,2,1024,10), K5's msb on (1024,5) halves and its
     decomposition at 10,240 elements, K6's exp ladder at 10,240
     elements (one thread an element) and log2's Pade ladders P_2524 and
     Q_2524 (negative raws, 3 steps) at f = 40 and 23, K7's OR-tree
     group of equal_zero_bit; the dense predictors' and the forest's
     and the correlation's shapes: K1 at (3,1024,100)@(3,100,64),
     (3,1024,64)@(3,64,32), (3,1024,32)@(3,32,1) and @(3,32,10), K2 at
     (1024,64), (1024,32) and (1000,1), K3 at those and a forest mux's
     (1024,) x (1,), K4 on (3,2,1024,1) and (3,2,1), K5's msb at 65,536,
     32,768 and 122,880 elements (relu's hidden layers, the forest's one
     less), K6's Pade ladder on one element, K7's group of relu's 16 bit
     banks of (3,128,65536); the ResNet's shapes: K1 on its im2col
     columns (3,65536,27)@(3,27,4) and (3,16384,36)@(3,36,4) and its Gemm
     (3,1024,4)@(3,4,3), K5's msb at 262,144 and 131,072 elements (the
     first relu, the max pool's first round), K7's group of that relu's
     16 bit banks of (3,128,262144), timed against its bound only (its
     plain version is held at 65,536); config 4's bit_compose: K3's
     reshare over b2a's (3,2,128,1024,100) ring128 and K4 on it by the
     (128,1,1) weights 2^i; the per-host layout's shapes: K1 at one
     party (the secure dot's, the logistic regression's and phase 20's
     trainer step's (1,128,100)@(1,100,1) and (1,100,128)@(1,128,1)) and
     in its product-only mode, K3 unfused, K4 and K7's single draws at
     (1024,1); then one
     spmd.trunc_pr of (1024,) ring128 and one polynomial_eval (the
     sigmoid's 14 steps) must each run exactly 2 device launches, one K7
     group and their kernel, as the wrappers count them, with no other
     device work under torch.profiler;
  4. the eDSL secure dot: 1000x1000 @ 1000x1000 at fixed(14,23), ring128,
     through LocalMooseRuntime on the card, checked against float64
     x @ y (max abs error < 2e-4);
  5. ONNX LinearRegressor inference, 100 features at fixed(24,40): three
     requests of 1024 rows, each checked against float64 x @ coef^T + b
     (max abs error < 1e-6);
  6. ONNX logistic regression (a binary LinearClassifier with the
     LOGISTIC post-transform, the exact protocol sigmoid), 100 features
     at fixed(24,40): three requests of 1024 rows, each checked against
     float64 [1 - sigmoid(z), sigmoid(z)] (max abs error < 5e-3);
  7. secure training under the threefry-pallas PRF: LogregSGDTrainer,
     100 features at fixed(24,40), ten chained SGD steps of 128 rows
     from zero weights, each step within 1e-4 of reference_epoch from
     the same input weights and the final weights within 1e-3 of the
     float64 trajectory; then MLPSGDTrainer (hidden 32), two steps, each
     within 1e-4.  The default threefry PRF is restored afterwards;
  8. ONNX multinomial logistic regression (a LinearClassifier with raw
     class rows and the SOFTMAX post-transform, the protocol softmax over
     10 classes), 100 features at fixed(24,40): three requests of 1024
     rows, each within 5e-3 of the float64 softmax and with the argmax
     of the probabilities agreeing with float64's on at least 0.99 of the
     rows;
  9. the protocol library through the eDSL: one traced computation at
     (1024, 10), fixed(24,40), that runs each of the 25 replicated kinds
     the library brought (comparisons, bit logic, Mux, Mean, exp, log,
     log2, sqrt, relu, abs, softmax, argmax, maximum and the structural
     kinds) and reveals each result to carole, held to float64 within the
     JAX package's own tolerances, comparisons and argmax exactly;
 10. BASELINE config 2, the scientific-computing tutorial's
     multiparty_correlation at fixed(24,40): the two columns of its own
     generator, 100 and 1,000 rows (past 1,000 its sums of squares leave
     fixed(24,40)'s range), in the departments' storage of a
     LocalMooseRuntime; the data scientist's saved correlation, read back
     as numpy, within the tutorial's 1e-2 of np.corrcoef; each size run
     twice, its wall and K7 groups printed;
 11. BASELINE config 5's MLP (bench.py:644-667): a binary sklearn-layout
     MLPClassifier, 100 -> 64 -> 32 -> 1, relu, random Glorot weights,
     through from_onnx and predictor_factory, three requests of 1024
     rows, each within 2e-2 of the float64 forward pass;
 12. a pytorch-layout NeuralNetwork (100 -> 64 relu -> 32 relu -> 10
     softmax), one request of 1024 rows within phase 8's limits;
 13. a random forest (TreeEnsembleClassifier, 8 trees of depth 4, 100
     features, 2 classes), one request of 1024 rows within 1e-3 of the
     float64 forest; its one batched less's element count printed;
 14. BASELINE config 5's small ResNet (sklearn_export.resnet_block_onnx,
     3 -> 4 channels, 8x8 images, 3 classes, weights from SEED): Conv3x3
     -> BN -> Relu -> MaxPool2x2 -> [Conv3x3 -> BN -> Relu -> Conv3x3 ->
     BN] + skip -> Relu -> GlobalAveragePool -> Gemm -> Softmax, through
     from_onnx (ConvNet) and predictor_factory at fixed(24,40): three
     requests of 1024 NCHW images, each within 5e-3 of a float64 forward
     pass in numpy (resnet_reference) and with its argmax agreeing on at
     least 0.99 of the rows; its walls, rows/s, device launches, busy
     time and idle share (one more request under torch.profiler) and
     peak device memory printed;
 15. BASELINE config 4, encrypted-input inference at config 3's width:
     phase 6's logistic regression through AesWrapper(LinearClassifier)
     .from_onnx at fixed(24,40), the client's 1024 x 100 features
     AES-GCM-encrypted (encrypt_fixed_array, frac 40, key and nonce from
     SEED: a (224, 1024, 100) wire array), the key a replicated AesKeyType
     argument; Decrypt's circuit under MPC, then the classifier's whole
     forward pass (aes_inference_computation): three requests, each within
     5e-3 of the float64 [1 - sigmoid(z), sigmoid(z)]; the wrapper's own
     predictor (the linear map) within 1e-6 of the float64 logits; Decrypt
     alone, cast to float64 on a host, equal to round(x * 2^40) / 2^40
     element for element; walls, rows/s, K7 groups, device launches, busy
     time and idle share, peak device memory printed;
 16. BASELINE config 4's share generation: one phase-6 request under the
     reference's aes-ctr PRF (each draw's seed derived on the host as
     the JAX session derives it, its stream AES-128-CTR expanded on the
     host, one copy to the card a group), within
     5e-3 of float64 and equal to the same request on the CPU under the
     same fixed keys; its keystream bytes, host expansion time and wall
     printed.  The PRF choice and the key knobs are restored afterwards;
 17. computations from bytes, under threefry and the same fixed keys
     (restored afterwards): phase 6's logistic regression traced,
     serialized (serde), compiled by elk_compiler with the logical passes
     (BYTES_PASSES) and served by LocalMooseRuntime.evaluate_compiled,
     three requests of 1024 x 100, each within 5e-3 of float64 and equal
     element for element to evaluate_computation of the traced graph on
     the same request; its serialized bytes equal to the JAX package's
     (BYTES_GOLDEN), and that blob, the textual round trip
     (parse_computation(to_textual(...))) and the graphs of phases 14 and
     15 from bytes equal to their phase's evaluate_computation on one
     request; the three requests' launch counts equal to phase 6's; blob
     bytes, serialize, deserialize, elk-compile and parse ms, textual
     characters, both walls a request, rows/s, device launches, busy time
     and idle share printed.
 18. the per-host layout (LocalMooseRuntime(layout="per-host"): one host
     tensor a share, every draw a single K7 launch from a seed derived on
     the host, as the JAX package's eager per-host walk draws them):
     (a) phase 4's secure dot, within 2e-4, K1 once a party; (b) phase
     6's logistic regression, two requests within 5e-3, each equal word
     for word to the same request per-host on the CPU under fixed keys,
     and one more request under torch.profiler (device launches, busy ms,
     idle share); (c) one request under threefry-pallas, which launches
     both streams (the ring draws in K7's layout, the zero shares' bits
     in threefry's, as the reference draws them); (d) the "auto" routing:
     a host-only graph (host Dot, Exp, Mean, Softmax) and a replicated
     product of host-selected columns (Select keeps the stacked layout
     off) must run per-host, and a replicated Inverse is routed
     per-host, where the reference refuses it too.  Its runtimes pass
     use_jit=False: the logical walk, not the lowered route of phase 19.
 19. the lowered route at config 3's width (1024 x 100, fixed(24,40),
     threefry, fixed keys): (a) phase 6's logistic regression through
     LocalMooseRuntime(layout="per-host").evaluate_computation(...,
     compiler_passes=DEFAULT_PASSES), one cold request (its lowering
     inside host.deterministic_sync_keys(SEED)) and two warm ones, each
     within 5e-3 and equal word for word to the same request on the CPU
     lowered under the same seed; the lowering's host ms, op count and
     top ten kinds, the walls, the launches (K1 in its product-only
     mode, K4, K7 single draws and nothing else), host seeds, device
     busy ms and idle share printed; (b) the same lowered graph written
     by serde and served by evaluate_compiled: word-equal to (a), with
     (a)'s launch counts; (c) the route: phase 6's graph per-host at
     use_jit=True runs lowered on the physical executor, at use_jit=False
     on the logical walk (``last_plan["lowered"]``); (d) Decrypt in the
     per-host layout: phase 15's encrypted-input inference (replicated
     key, RepBitOps circuit) per-host, one request at AES_PER_HOST_ROWS x
     100 within 5e-3, and Decrypt alone exact; walls, launches and peak
     memory printed.
 20. secure training sessions at benchmarks/logreg.py's width (100
     features, batches of 128, fixed(24,40), ring128; 1,280 rows from
     SEED by its recipe): (a) training.TrainingSession trains
     LogregSGDTrainer (10 steps an epoch) over LocalTrainingCluster with
     LocalMooseRuntime(use_jit=False) and one CheckpointStore(
     FilesystemStorage) a party: init, 2 epochs (load_shares -> steps ->
     save_shares on the per-host walk, each committed), export; the
     weights within 1e-3 of two reference_epochs in float64; the init,
     epoch, export and commit walls, one epoch's launches and K7 single
     draws, one more epoch's device launches, busy ms and idle share under
     torch.profiler, and the checkpoint bytes a party printed; (b) under
     fixed keys the same training twice, the second through a cluster
     that loses a peer (a retryable PeerUnreachableError) after epoch 2's
     session and before its commit: one resume, every party's committed
     #s0/#s1 words and the weights equal to the first run's bit for bit,
     and a fresh driver over those stores skips epochs 1 and 2 and
     commits nothing; (c) the same trainer at 2 steps an epoch (256 x
     100) under use_jit=True, its epochs lowered (DEFAULT_PASSES) and run
     by the physical executor with ring-typed Load and Save, on the card
     and on the CPU under fixed keys and pinned lowering nonces: equal
     committed words; the lowering's host ms and op count printed; (d)
     parallel.spmd.logreg_train_step, benchmarks/logreg.py's run_spmd
     workload (10 steps of 128 x 100 from zero weights, one session key a
     step from derive_step_keys), within 1e-3 of its float64 replica
     (plaintext_sgd), ms per step printed; (e) (a)'s exported weights
     through training.export.trained_predictor, one 1024 x 100
     logistic-regression request on the stacked layout within 5e-3.
Every evaluation of phases 4 to 17 must have run on the stacked layout,
phase 18's and 19's on the per-host one (``last_plan["layout"]``), and
phase 20's on both (the sessions per-host, the trained model stacked).
Phases 4 to 20 are the main path: the kernels' launch counters are set
to 0 just before each (each of phase 20's (a) to (e) apart) and read
just after.  K1, K2's trunc_pairs and the
threefry kernel in the phase's stream layout (threefry in all but 7,
threefry-pallas in 7, and never the other) must have launched in each
but 10 and 13, and every kernel (K1, K2's trunc_pairs, K3's
cross_terms_reshare, K4, K5 in both modes, K6) in phases 6 to 12 and 14
(K1 but in phases 9 and 10, which hold no matrix product), 15, 16 and
17; phase 13 must launch K5's msb, K3's cross_terms_reshare and K7;
phase 16 must launch no K7 and expand its draws on the host
(LAUNCHES["prf_aes_ctr_host"]), and no other phase may.  No seed may be
derived on the host in phases 4 to 15 and 17 (ring.mix_seed is
counted), and the K7 launches must stay
under their ceilings: 3 for a secure dot, 60 for a logistic-regression
request or a LogregSGDTrainer step, MULTI_K7_CEILING for a multinomial
request, MLPC_K7_CEILING for an MLP request, RESNET_K7_CEILING for a
ResNet request, AES_K7_CEILING for an AES-input request; one more
request of phases 6, 8, 11, 14 and 15 and one more step of phase 7 run
under torch.profiler, whose device launches must stay under their
ceilings (LOGREG_DEVICE_CEILING, TRAIN_DEVICE_CEILING,
MULTI_DEVICE_CEILING, MLPC_DEVICE_CEILING, RESNET_DEVICE_CEILING,
AES_DEVICE_CEILING).  Phase 18 must launch K1, K2's trunc_combine, K3's
cross_terms_mul, K4 and K7 (in (a) K1, K2 and K7), threefry's K7 layout
in (a), (b) and (d) and both in (c); its K7 launches and its host seed
derivations (one ring.mix_seed a key and a seed) stay under the counts
of the same requests on the CPU + 5% (PER_HOST_*).  Phase 19's lowered
requests must launch K1, K4 and threefry's K7 and none of K2, K3, K5 and
K6 (the lowered graph holds the reference's composition, no fused step);
its per-host Decrypt must launch K1, K2's trunc_combine, K3's
cross_terms_mul, K4 and K7.  Phase 20's walk (a, b) must launch K1, K2's
trunc_combine, K3's cross_terms_mul, K4 and K7; its lowered epochs (c)
K1, K4 and K7 and none of K2, K3, K5 and K6; logreg_train_step (d) K1,
K2's trunc_pairs, K3's cross_terms_reshare, K4 and K7; the trained model
(e) every kernel of phase 6; (d) and (e) derive no seed on the host.
The line before the last is the kernels' JSON record; the last line is
the device record.

Without a CUDA device, or without the moose_tpu_torch package beside
it, the script prints no result and exits with code 2.
"""

# no `from __future__ import annotations`: the eDSL reads the
# pm.Argument annotations of the traced function as objects
import json
import math
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# 32-bit integer instructions per second outside the tensor cores: an SM
# issues at most one warp instruction per scheduler and clock, 4 x 32 =
# 128 lanes (Hopper architecture white paper), the rate behind the data
# sheet's 67 TFLOP/s float32 (132 SMs x 128 lanes x 2 for the fused
# multiply-add x 1.98 GHz).  Integer adds reach it by issuing on the
# FP32 pipe as well as on the 64 INT32 lanes; shifts and logic ops have
# only the INT32 lanes, so a kernel of those alone gets half this rate.
# 64-bit integer work runs as several of these instructions.
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# 32-bit integer operations of one ring operation, counted from
# csrc/ring_words.cuh: a 64-bit add is two, a 128-bit add five (two
# words and the carry compare); a 64-bit low product four, a 128-bit
# product twenty (lo*lo in full with __umul64hi and the two cross terms)
RING_ADD_OPS = {64: 2, 128: 5}
RING_MUL_OPS = {64: 4, 128: 20}
# 32-bit integer operations per element of the truncation tail, counted
# from trunc_masks and trunc_finish in csrc/ring_words.cuh (12 shifts,
# 13 adds/subs, 2 selects on one or two u64 words, each u64 operation two
# to four 32-bit ones)
TRUNC_OPS_PER_ELEM = {64: 94, 128: 185}
# 32-bit integer operations of one threefry2x32-20 block, counted from
# csrc/threefry.cu: 2 initial key adds, 20 rounds of add, funnel shift
# and xor, 5 key injections of 2 adds, 1 to form the counter; a layout-0
# bit adds an xor and an and, and a layout-1 word of bits spreads its 16
# nibbles into bytes with a shift, an and, a multiply and an and each
THREEFRY_OPS_PER_BLOCK = 2 + 20 * 3 + 5 * 2 + 1
THREEFRY_BIT_OPS = 2
THREEFRY_SPREAD_OPS = 16 * 4

SEED = 20261016
DOT_N = 1000
DOT_PRECISION = (14, 23)
DOT_TOL = 2e-4
LINREG_FEATURES = 100
LINREG_ROWS = 1024
LINREG_REQUESTS = 3
LINREG_TOL = 1e-6
LOGREG_FEATURES = 100
LOGREG_ROWS = 1024
LOGREG_REQUESTS = 3
LOGREG_TOL = 5e-3  # the JAX package's own limit (bench.py:600)
# the protocol sigmoid's kernel shapes at 1024 rows (ring128): the K3
# cross terms run from (3, 1024) to (3, 64, 1024) words, K4 on
# (3, 2, 1024) against a scalar and on (3, 2, 64, 1024) against (64, 1)
# weights, K5 on 1024 elements, K6 with 14 steps at truncation amount 62
PATH_N = LOGREG_ROWS
BIG_N = 1 << 20
HORNER_STEPS = 14
HORNER_F = 62
# the reference's training table (benchmarks/logreg.py:1-8, :32-35):
# fixed(24,40), 100 features, batches of 128, learning rate 0.1
TRAIN_FEATURES = 100
TRAIN_ROWS = 128
TRAIN_STEPS = 10
TRAIN_LR = 0.1
TRAIN_STEP_TOL = 1e-4  # per step (tests/test_training.py:213)
TRAIN_TRAJECTORY_TOL = 1e-3  # over the steps (benchmarks/logreg.py:145)
MLP_HIDDEN = 32
MLP_STEPS = 2
# multinomial logistic regression: BASELINE.json config 3 in its
# multiclass form, 10 classes (benchmarks/softmax_bench.py:152)
MULTI_FEATURES = 100
MULTI_CLASSES = 10
MULTI_ROWS = 1024
MULTI_REQUESTS = 3
MULTI_TOL = 5e-3  # tests/test_predictors.py:85
MULTI_ARGMAX_AGREEMENT = 0.99  # benchmarks/softmax_bench.py:72
# the protocol library through the eDSL, at the classifier's logits'
# shape
LIBRARY_ROWS = 1024
LIBRARY_COLS = 10
# BASELINE.json config 2, the scientific-computing tutorial
# (tutorials/scientific_computing_multiple_players.py): its columns, its
# fixed(24,40) and its 1e-2 against numpy (:181).  The sums of squares
# and their product grow with n past fixed(24,40)'s range: the JAX
# package overflows at 4,096 rows, so 1,000 is the largest size here
CORR_IDS = ("pub_health_dpt", "education_dpt", "data_scientist")
CORR_PRECISION = (24, 40)
CORR_SIZES = (100, 1000)
CORR_TOL = 1e-2
# BASELINE.json config 5's MLP (bench.py:644-667): a binary sklearn
# MLPClassifier, 100 features, hidden (64, 32), relu, fixed(24,40),
# batch 1024, within 2e-2 (bench.py:666)
MLPC_FEATURES = 100
MLPC_HIDDEN = (64, 32)
MLPC_ROWS = 1024
MLPC_REQUESTS = 3
MLPC_TOL = 2e-2
# a pytorch-layout NeuralNetwork at the MLP's widths with a 10-class
# softmax head, held to phase 8's limits
NET_HIDDEN = (64, 32)
NET_CLASSES = 10
NET_ROWS = 1024
# a random forest: 8 trees of depth 4 on 100 features, 2 classes, within
# the JAX package's forest limit (tests/test_predictors.py:108)
FOREST_TREES = 8
FOREST_DEPTH = 4
FOREST_FEATURES = 100
FOREST_ROWS = 1024
FOREST_TOL = 1e-3
# BASELINE config 5's small ResNet ("ONNX MLP / small ResNet encrypted
# inference, batch=1024"): sklearn_export.resnet_block_onnx at the widths
# examples/resnet_inference.py builds it with (3 -> 4 channels, 8x8
# images, 3 classes), weights from SEED, fixed(24,40); held to the
# float64 forward pass within tests/test_conv.py:254's limit and phase
# 8's argmax agreement
RESNET_CH = 3
RESNET_MID = 4
RESNET_SIZE = 8
RESNET_CLASSES = 3
RESNET_ROWS = 1024
RESNET_REQUESTS = 3
RESNET_TOL = 5e-3
# BASELINE config 4 (AES/PRF-based share generation), served two ways.
# Encrypted-input inference: phase 6's logistic regression (config 3's
# width: 100 features, batch 1024, fixed(24,40)) behind AesWrapper, each
# client row AES-GCM-encrypted (encrypt_fixed_array, frac 40) under a key
# and nonce from SEED, the key a replicated AesKeyType argument; held to
# phase 6's limit, and Decrypt alone exactly.  Share generation under the
# reference's aes-ctr PRF: one phase-6 request, held to phase 6's limit
# and to the same request's words on the CPU
AES_FEATURES = 100
AES_ROWS = 1024
AES_REQUESTS = 3
AES_PRECISION = (24, 40)
AES_TOL = LOGREG_TOL
# Computations from bytes: phase 6's logistic regression serialized,
# compiled by elk_compiler with the logical passes and served by
# evaluate_compiled, three requests; the same graph as the JAX package
# serialized it (tests/golden_torch_logreg.msgpack, which
# tests/test_torch_serde.py regenerates); held to phase 6's limit and,
# word for word, to evaluate_computation under the same fixed keys
BYTES_REQUESTS = 3
BYTES_PASSES = ["typing", "prune", "toposort", "wellformed"]
BYTES_GOLDEN = "tests/golden_torch_logreg.msgpack"
# launch ceilings of the main path: K7 launches (groups) of a secure dot,
# of a logistic-regression request and of a LogregSGDTrainer step, and
# the device launches (PyTorch's and the port's kernels) of one request
# and one step
DOT_K7_CEILING = 3
LOGREG_K7_CEILING = 60
TRAIN_K7_CEILING = 60
LOGREG_DEVICE_CEILING = 1141  # 1,087 measured on the H100 + 5% (PERF.md)
TRAIN_DEVICE_CEILING = 1189  # 1,133 measured + 5%
MULTI_K7_CEILING = 72  # 69 measured on the H100 + 5% (PERF.md)
MULTI_DEVICE_CEILING = 1502  # 1,431 measured + 5%
MLPC_K7_CEILING = 62  # 59 measured on the H100 + 5% (PERF.md)
MLPC_DEVICE_CEILING = 1488  # 1,417 measured + 5%
RESNET_K7_CEILING = 92  # 88 measured on the H100 + 5% (PERF.md)
RESNET_DEVICE_CEILING = 2165  # 2,062 measured + 5%
AES_K7_CEILING = 141  # 134 counted on the CPU (any batch) + 5%
AES_DEVICE_CEILING = 15014  # 14,299 measured on the H100 + 5% (PERF.md)
# the per-host layout (phase 18): its K7 launches (single draws) and
# host seed derivations a secure dot and a logistic-regression request,
# as counted on the CPU (tests/test_torch_per_host_runtime.py holds
# them); the ceilings are these + 5%
PER_HOST_DOT_K7, PER_HOST_DOT_SEEDS = 16, 23
PER_HOST_LOGREG_K7, PER_HOST_LOGREG_SEEDS = 780, 899
PER_HOST_LOGREG_REQUESTS = 2
LOWERED_REQUESTS = 3  # one cold, two warm
# config 4's per-host request: the circuit's host-op count does not
# depend on the rows (PERF.md §6, phase 19 (d))
AES_PER_HOST_ROWS = 1024
# Secure training sessions (phase 20): benchmarks/logreg.py's training
# width (1-8, 32-35: 100 features, batches of 128, fixed(24,40), ring128)
# through training.TrainingSession, checkpointed on each party; the
# exported weights within tests/test_training.py:255-257's 1e-3 of
# reference_epoch, logreg_train_step's trajectory within
# benchmarks/logreg.py:145's 1e-3 of its float64 replica
SESSION_FEATURES = 100
SESSION_BATCH = 128
SESSION_STEPS = 10  # steps an epoch: 1,280 rows
SESSION_EPOCHS = 2
SESSION_LR = 0.1
SESSION_TOL = 1e-3
SESSION_LOWERED_STEPS = 2  # (c): 256 rows, also run on the CPU
TRAINED_ROWS = 1024  # (e): one request of the exported model


def per_host_ceiling(count):
    return math.ceil(count * 1.05)


# the session key of the K7 group rows
GROUP_MASTER = (0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D)


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(torch, fn, warmup=1, reps=5):
    """Median milliseconds of ``fn`` on the card, timed with CUDA events
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(torch, fn, calls=20):
    """Milliseconds per call of ``calls`` calls of ``fn`` between one
    pair of CUDA events after a warm-up: while the host enqueues faster
    than the card runs, this is the card's time per call, without the
    host time a single timed call carries."""
    return cuda_time_ms(torch, lambda: [fn() for _ in range(calls)],
                        reps=5) / calls


# torch.profiler now and then loses the first kernel the card runs in a
# profiled region (on the H100: a protocol op's first kernel, its K7
# group, in every check of one chip_smoke.py run; the marker below in 1 of
# 300 regions of another).  Every profiled region here starts with a
# marker kernel (torch.cuda._sleep) and a synchronize, and the marker is
# left out of what the region reports.
PROFILER_MARKER = "spin_kernel"


def profiled(torch, fn):
    """(result, device events) of ``fn`` under torch.profiler, the region
    opened by the marker kernel, which the events leave out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return out, [e for e in prof.events()
                 if e.device_type == cuda and PROFILER_MARKER not in e.name]


def device_events(torch, fn):
    """(result, names) of one call of ``fn``: the names of the kernels and
    copies the card ran for it, under torch.profiler."""
    out, events = profiled(torch, fn)
    return out, [e.name for e in events]


def device_launches(torch, fn):
    """The kernels and copies the card ran for one call of ``fn``, under
    torch.profiler."""
    return len(device_events(torch, fn)[1])


def device_busy(torch, fn):
    """(launches, busy ms) of one call of ``fn`` under torch.profiler:
    the kernels and copies the card ran for it, and their summed
    durations (one stream, so they do not overlap)."""
    _, events = profiled(torch, fn)
    return len(events), sum(e.device_time_total for e in events) / 1e3


# the device kernels of moose_tpu_torch/csrc, as the profiler names them
PORT_KERNELS = (
    "dot_cross_terms_split", "dot_cross_terms_gemm", "trunc_pairs_kernel",
    "cross_terms_mul_kernel",
    "cross_terms_reshare_kernel", "ring_mul_kernel", "bits_adder_pack",
    "bits_adder_add", "horner_kernel", "horner_lanes_kernel",
    "threefry_group_kernel",
)


def device_time_ms(torch, fn, calls=10):
    """Device time per call of ``fn`` under torch.profiler: the summed
    durations of the kernels the card ran over ``calls`` calls, without
    the host time between them."""
    fn()
    _, events = profiled(torch, lambda: [fn() for _ in range(calls)])
    return sum(e.device_time_total for e in events) / 1e3 / calls


def flat_tensors(value):
    """The tensors of a kernel result: a tensor, or nested (lo, hi)
    tuples with None for a missing high word."""
    if value is None:
        return []
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in flat_tensors(v)]
    return [value]


def word_diff(torch, got, want):
    """(equal, max abs error): word for word, and the largest difference
    of the words as float64 (at least 1 where they differ)."""
    got, want = flat_tensors(got), flat_tensors(want)
    equal = len(got) == len(want)
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            equal = False
            diff = 1.0
            if g.shape == w.shape:
                diff = float((g.double() - w.double()).abs().max())
            err = max(err, diff, 1.0)
    return equal, err


def random_words(torch, gen, shape, width):
    def draw():
        return torch.randint(
            -(1 << 63), (1 << 63) - 1, shape, generator=gen,
            dtype=torch.int64, device="cuda",
        )

    return draw(), None if width == 64 else draw()


def dot_bound(m, k, n, width, parties=3, terms=2):
    """Least time of the exact cross terms on an H100: bytes (4 operands
    read once, one output written once) against the int8 tensor-core
    limb formulation K1 runs (w/8 u8 limbs per word, the limb pairs below
    the ring modulus, two contractions, ``parties`` parties).  With
    ``terms`` 1, the product-only mode: two operands, one contraction."""
    word = width // 8
    nbytes = parties * terms * (m * k + k * n) * word + parties * m * n * word
    limbs = width // 8
    pairs = limbs * (limbs + 1) // 2
    ops = 2 * parties * pairs * terms * m * k * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_TENSOR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def dot_int8_macs(m, k, n, width):
    """int8 multiply-adds of K1's limb formulation: three parties, the
    limb pairs below the ring modulus, one contraction of depth 2k."""
    limbs = width // 8
    return 3 * limbs * (limbs + 1) // 2 * m * 2 * k * n


def int8_gemm_ms(torch, gen, macs, k=2000, n=1000, max_rows=40800):
    """The int8 tensor cores' time for ``macs`` multiply-adds through
    torch._int_mm ((rows, k) @ (k, n) int8 -> int32, in calls of at most
    ``max_rows`` rows): a yardstick of the rate K1's limb GEMM could
    reach.  It computes another function, so it is no library_ms, and
    the port never calls it."""
    rows_total = macs // (k * n)
    calls = -(-rows_total // max_rows)
    rows = rows_total // calls // 8 * 8
    a = torch.randint(-128, 128, (rows, k), generator=gen,
                      dtype=torch.int8, device="cuda")
    # B column-major: the layout of cuBLASLt's int8 tensor-core kernels
    b = torch.randint(-128, 128, (n, k), generator=gen, dtype=torch.int8,
                      device="cuda").t()

    def run():
        for _ in range(calls):
            torch._int_mm(a, b)

    return cuda_time_ms(torch, run, reps=5)


def bound(nbytes, int_ops):
    """Least time of a kernel: its bytes at the memory rate against its
    32-bit integer operations at the INT32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def trunc_draw_words(width, amount):
    """Ring words of the five truncation draws that reach the result:
    r, m_rt and z0 in full; not m_r, which cancels in the reveal
    c = (a0 + 2^(k-1) + m_r) + (a1 + r - m_r); and m_rm's low word only
    where k - amount >= 64 (ring128, amount <= 63), since the overflow
    correction shifts it up by k - amount bits."""
    return 3 + (0.5 if width == 128 and width - 1 - amount >= 64 else 1)


def trunc_bound(n, width, amount):
    """Least time of the truncation tail on the additive sharing: a0, a1
    and the draws that reach the result read, the 3 values written,
    against its integer operations and the add a0 + a1."""
    words = 2 + trunc_draw_words(width, amount) + 3
    return bound(n * words * (width // 8),
                 n * (TRUNC_OPS_PER_ELEM[width] + RING_ADD_OPS[width]))


def trunc_pairs_bound(x_elems, n, width, amount):
    """Least time of K2's trunc_pairs over n elements: the operand read
    once (slot 0, 3 words an element of its own shape; or the (3, n)
    cross terms of a matrix product, whose zero-share bank cancels in the
    reveal and is not counted), the draws that reach the result read (as
    ``trunc_draw_words`` counts them), the (3, 2, n) pair layout written;
    the tail's integer operations and the two adds of x's three words."""
    words = 3 * x_elems + trunc_draw_words(width, amount) * n + 6 * n
    return bound(words * (width // 8),
                 n * (TRUNC_OPS_PER_ELEM[width] + 2 * RING_ADD_OPS[width]))


def cross_mul_bound(n, width):
    """K3 over n words per operand: four operands read, one written; two
    products and three adds per word."""
    return bound(n * 5 * (width // 8),
                 n * (2 * RING_MUL_OPS[width] + 3 * RING_ADD_OPS[width]))


def ring_mul_bound(n, width, b_words):
    """K4 over n words: the shares and b's ``b_words`` words (n when b is
    materialised at the shares' shape) read once, the product written;
    one product per word."""
    return bound((2 * n + b_words) * (width // 8), n * RING_MUL_OPS[width])


def bits_bound(n, width, msb_only, n_ands):
    """K5 over n elements: the (3, 2) words and the n_ands uint8 AND
    banks read, the bit planes (one plane for msb) written.  Operations:
    each AND is six logic operations per party on k/32 32-bit words, and
    each output bit one extraction."""
    out_bits = 6 * (1 if msb_only else width)
    nbytes = n * (6 * (width // 8) + n_ands * 3 * width + out_bits)
    ops = n * (n_ands * 3 * 6 * (width // 32) + out_bits)
    return bound(nbytes, ops)


def horner_bound(n, width, steps, f):
    """K6 over n elements: x's two pair slots (6 words) and per step the
    truncation draws that reach the result (as ``trunc_draw_words``
    counts them; the zero-share banks cancel in each step's reveal) read,
    6 words written.  Operations: x regrouped once (6 adds), then per
    step three products and three adds (sum_p A_p y_p and the next
    coefficient) and the truncation tail."""
    words = 6 + steps * trunc_draw_words(width, f) + 6
    ops = 6 * RING_ADD_OPS[width] + steps * (
        3 * (RING_MUL_OPS[width] + RING_ADD_OPS[width])
        + TRUNC_OPS_PER_ELEM[width])
    return bound(n * words * (width // 8), n * ops)



def compare_kernel(torch, kernel, plain, args, bound_pair, reps,
                   library=None, **fields):
    """Hold ``kernel(*args)`` against ``plain(*args)`` on the card, word
    for word, and time both (and ``library``, one PyTorch call computing
    the same function, where there is one) with CUDA events."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    equal, err = word_diff(torch, got, want)
    del got, want
    bound_ms, bound_by = bound_pair
    return dict(
        fields, equal=equal, max_abs_err=err,
        ms=cuda_time_ms(torch, lambda: kernel(*args), reps=reps),
        plain_ms=cuda_time_ms(torch, lambda: plain(*args), reps=reps),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None if library is None
        else cuda_time_ms(torch, library, reps=reps),
    )


def compare_dot(torch, rk, ring, gen, m, k, n, width, reps, label="",
                yardstick=False, device=False):
    """K1 against its plain version; with ``yardstick``, beside it the
    int8 tensor cores' time for as many multiply-adds; with ``device``,
    its device time under torch.profiler (``device_ms``)."""
    x0, x1 = (random_words(torch, gen, (3, m, k), width) for _ in range(2))
    y0, y1 = (random_words(torch, gen, (3, k, n), width) for _ in range(2))
    ys = ring.add(*y0, *y1)
    row = compare_kernel(
        torch, rk.dot_cross_terms, rk.dot_cross_terms_plain,
        (x0, x1, y0, ys, width), dot_bound(m, k, n, width), reps,
        shape=f"(3,{m},{k})@(3,{k},{n})", width=width, path=label,
    )
    if device:
        row["device_ms"] = device_time_ms(
            torch, lambda: rk.dot_cross_terms(x0, x1, y0, ys, width))
    del x0, x1, y0, y1, ys
    row["int8_gemm_ms"] = (
        int8_gemm_ms(torch, gen, dot_int8_macs(m, k, n, width))
        if yardstick else None
    )
    return row


def compare_party_dot(torch, rk, ring, gen, m, k, n, width, reps,
                      label=""):
    """K1 at one party, as the per-host layout launches it
    (``party_dot_cross_terms`` on (m, k) and (k, n) operands), against
    its plain version, with its device time."""
    x0, x1 = (random_words(torch, gen, (m, k), width) for _ in range(2))
    y0, y1 = (random_words(torch, gen, (k, n), width) for _ in range(2))
    ys = ring.add(*y0, *y1)
    args = (x0, x1, y0, ys, width)
    row = compare_kernel(
        torch, rk.party_dot_cross_terms, rk.dot_cross_terms_plain, args,
        dot_bound(m, k, n, width, parties=1), reps,
        shape=f"(1,{m},{k})@(1,{k},{n})", width=width, path=label,
    )
    row["device_ms"] = device_time_ms(
        torch, lambda: rk.party_dot_cross_terms(*args))
    row["int8_gemm_ms"] = None
    return row


def compare_ring_matmul(torch, rk, gen, m, k, n, width, reps, label=""):
    """K1 in its product-only mode, as a host ring Dot runs it
    (``ring_matmul``: (m, k) @ (k, n) words, depth k), against the plain
    ring product, with its device time."""
    a = random_words(torch, gen, (m, k), width)
    b = random_words(torch, gen, (k, n), width)
    args = (a, b, width)
    row = compare_kernel(
        torch, rk.ring_matmul, rk.ring_matmul_plain, args,
        dot_bound(m, k, n, width, parties=1, terms=1), reps,
        shape=f"({m},{k})@({k},{n})", width=width, path=label,
        product_only=True,
    )
    row["device_ms"] = device_time_ms(torch, lambda: rk.ring_matmul(*args))
    row["int8_gemm_ms"] = None
    return row


def compare_trunc(torch, rk, gen, shape, width, amount, reps):
    """K2's trunc_combine (an additive sharing and its draws in), with its
    device time under torch.profiler (``device_ms``)."""
    a0, a1, *draws = (random_words(torch, gen, shape, width)
                      for _ in range(7))
    args = (a0, a1, tuple(draws), width, amount)
    row = compare_kernel(
        torch, rk.trunc_combine, rk.trunc_combine_plain, args,
        trunc_bound(math.prod(shape), width, amount), reps,
        shape=str(tuple(shape)), width=width, amount=amount,
        mode="trunc_combine",
    )
    row["device_ms"] = device_time_ms(torch, lambda: rk.trunc_combine(*args))
    return row


def compare_trunc_pairs(torch, rk, gen, shape, width, amount, reps,
                        view=None, cross=False):
    """K2's trunc_pairs as spmd calls it: a consistent sharing in the
    pair layout (``view`` "transposed": a view with its last two axes
    swapped; "broadcast": its first axis broadcast from size 1), or with
    ``cross`` a matrix product's (3, *shape) cross terms and zero-share
    bank; the (5, *shape) draws.  Beside the CUDA-event times, the
    device time under torch.profiler (``device_ms``)."""
    n = math.prod(shape)
    bank = None
    if cross:
        x = random_words(torch, gen, (3,) + shape, width)
        bank = random_words(torch, gen, (3,) + shape, width)
        own = shape
    else:
        own = {"transposed": shape[::-1],
               "broadcast": (1,) + shape[1:]}.get(view, shape)
        z = random_words(torch, gen, (3,) + own, width)
        x = tuple(None if w is None
                  else torch.stack([w, torch.roll(w, -1, dims=0)], dim=1)
                  for w in z)
        if view == "transposed":
            x = tuple(None if w is None else w.transpose(-1, -2) for w in x)
        elif view == "broadcast":
            x = tuple(None if w is None else w.expand((3, 2) + shape)
                      for w in x)
    draws = random_words(torch, gen, (5,) + shape, width)
    args = (x, draws, width, amount, bank)
    row = compare_kernel(
        torch, rk.trunc_pairs, rk.trunc_pairs_plain, args,
        trunc_pairs_bound(math.prod(own), n, width, amount), reps,
        shape=str(tuple(shape)), width=width, amount=amount,
        mode="trunc_pairs",
        input=("cross terms and bank" if cross
               else f"pairs, {view or 'contiguous'}"),
    )
    row["device_ms"] = device_time_ms(torch, lambda: rk.trunc_pairs(*args))
    return row


def compare_cross_mul(torch, rk, gen, shape, width, reps):
    ops = [random_words(torch, gen, shape, width) for _ in range(4)]
    return compare_kernel(
        torch, rk.cross_terms_mul, rk.cross_terms_mul_plain,
        (*ops, width), cross_mul_bound(math.prod(shape), width), reps,
        shape=str(tuple(shape)), width=width, mode="cross_terms_mul",
    )


def compare_ring_mul(torch, rk, gen, shape, const_shape, width, reps,
                     back_to_back=False, materialise=False):
    """K4 as spmd.mul_public calls it: shares times a public constant of
    ``const_shape``, which the kernel broadcasts; with ``materialise``,
    the constant broadcast to the shares' shape first (as before the
    kernel broadcast it).  The library call is torch.mul at ring64, on
    the same operands.  With ``back_to_back``, K4 and the library call
    are also timed as the card runs them (``back_to_back_ms``,
    ``device_time_ms``)."""
    a_lo, a_hi = random_words(torch, gen, shape, width)
    b_lo, b_hi = random_words(torch, gen, const_shape, width)
    if materialise:
        b_lo = b_lo.expand(shape).contiguous()
        b_hi = None if b_hi is None else b_hi.expand(shape).contiguous()
    library = None
    if width == 64:
        def library():  # int64 multiplication wraps: the ring64 product
            return torch.mul(a_lo, b_lo)
    args = (a_lo, a_hi, b_lo, b_hi, width)
    how = "materialised" if materialise else "own shape"
    row = compare_kernel(
        torch, rk.ring_mul, rk.ring_mul_plain, args,
        ring_mul_bound(math.prod(shape), width, b_lo.numel()), reps,
        library=library,
        shape=f"{tuple(shape)} x {how} {tuple(const_shape)}",
        width=width,
    )
    if back_to_back:
        row["ms_back_to_back"] = back_to_back_ms(
            torch, lambda: rk.ring_mul(*args))
        row["device_ms"] = device_time_ms(torch, lambda: rk.ring_mul(*args))
        if library is not None:
            row["library_ms_back_to_back"] = back_to_back_ms(torch, library)
            row["library_device_ms"] = device_time_ms(torch, library)
    return row


def compare_bits(torch, rk, gen, n, width, msb_only, reps,
                 back_to_back=False, label=""):
    """K5 in one mode; with ``back_to_back`` also timed as the card runs
    it (``back_to_back_ms``, ``device_time_ms``)."""
    x = random_words(torch, gen, (3, 2, n), width)
    n_ands = rk.adder_bank_count(width)
    banks = torch.randint(0, 2, (n_ands, 3, width, n), generator=gen,
                          dtype=torch.uint8, device="cuda")
    kernel, plain = ((rk.msb, rk.msb_plain) if msb_only
                     else (rk.bit_decompose, rk.bit_decompose_plain))
    args = (*x, width, banks)
    row = compare_kernel(
        torch, kernel, plain, args,
        bits_bound(n, width, msb_only, n_ands), reps,
        shape=f"(3,2,{n})", width=width, path=label,
        mode="msb" if msb_only else "bit_decompose",
    )
    if back_to_back:
        row["ms_back_to_back"] = back_to_back_ms(torch, lambda: kernel(*args))
        row["device_ms"] = device_time_ms(torch, lambda: kernel(*args))
    return row


def compare_horner(torch, rk, gen, n, width, steps, f, reps,
                   coeffs="P_1045"):
    """K6 as polynomial_eval calls it, with the named coefficients of
    ``dialects/fixedpoint.py`` (the 2^x Taylor series of the sigmoid and
    exp, or log2's Pade numerator and denominator, whose raws include
    negative words): x's (3, 2, n) pair layout read in place, the
    result's pair layout written; beside the CUDA-event times the device
    time under torch.profiler (``device_ms``)."""
    from moose_tpu_torch.dialects import fixedpoint

    raws = [fixedpoint.encode_const(c, f, width)
            for c in reversed(getattr(fixedpoint, coeffs)[:steps + 1])]
    x = random_words(torch, gen, (3, 2, n), width)
    zbanks = random_words(torch, gen, (steps, 3, n), width)
    tdraws = random_words(torch, gen, (steps, 5, n), width)
    args = (x, width, raws, f, zbanks, tdraws)
    row = compare_kernel(
        torch, rk.horner_pairs, rk.horner_pairs_plain, args,
        horner_bound(n, width, steps, f), reps,
        shape=f"(3,{n})", width=width, steps=steps, amount=f,
        lanes=rk.horner_lanes(n), coeffs=coeffs,
    )
    row["device_ms"] = device_time_ms(torch, lambda: rk.horner_pairs(*args))
    return row


def protocol_launches(torch, rk):
    """Device launches of one spmd.trunc_pr of (1024,) ring128 by 40 and
    of one polynomial_eval, the sigmoid's (14 steps at fixed(2, 62)): one
    K7 group and one kernel of their own each, and words equal to the CPU
    session's.  torch.profiler must see exactly two device events, the
    two kernels the wrappers counted (K2, K6 and K7 run one device kernel
    a launch): no PyTorch kernel, copy or memset."""
    import numpy as np

    from moose_tpu_torch import interop
    from moose_tpu_torch.dialects.fixedpoint import P_1045
    from moose_tpu_torch.parallel import spmd, spmd_math

    words = [np.random.default_rng(SEED).integers(
        0, 1 << 64, size=(PATH_N,), dtype=np.uint64) for _ in range(2)]
    entry = {"trunc_pr": "trunc_pairs", "polynomial_eval": "horner"}
    ops = {
        "trunc_pr": lambda s, x: spmd.trunc_pr(s, x, 40),
        "polynomial_eval": lambda s, x: spmd_math.polynomial_eval(
            s, P_1045, spmd.SpmdFixed(x, 2, HORNER_F),
            min_coeff=2.0 ** -(40 + 4)).tensor,
    }
    counts = {}
    for name, op in ops.items():
        out = {}
        for device in ("cpu", "cuda"):
            sess = spmd.SpmdSession(GROUP_MASTER, device)
            x = spmd.share(sess, *interop.ring_from_numpy(*words,
                                                          device=device), 128)
            if device == "cpu":
                out[device] = op(sess, x)
                continue
            before = dict(rk.LAUNCHES)
            out[device], seen = device_events(torch, lambda: op(sess, x))
            moved = {k: v - before[k] for k, v in rk.LAUNCHES.items()
                     if v != before[k]}
            ours = [e for e in seen if any(k in e for k in PORT_KERNELS)]
            counts[name] = len(seen)
            log(f"protocol {name}: device launches {counts[name]} "
                f"(kernel launches {moved}; the profiler saw {seen})")
            if (moved != {entry[name]: 1, "prf_threefry": 1}
                    or len(seen) != 2 or len(ours) != 2):
                raise AssertionError(
                    f"{name} ran {counts[name]} device launches, not 2: "
                    f"{moved} and {seen}")
        got, want = out["cuda"], out["cpu"]
        if not (torch.equal(got.lo.cpu(), want.lo)
                and torch.equal(got.hi.cpu(), want.hi)):
            raise AssertionError(f"{name} on the card differs from the CPU")
    return counts


def threefry_bound(n, layout, bits):
    """K7 over n outputs: the output written once (8 bytes a word, 1 a
    bit), nothing read; one cipher block per word, per layout-0 bit, or
    per 64 layout-1 bits."""
    if not bits:
        return bound(n * 8, n * THREEFRY_OPS_PER_BLOCK)
    if layout == "threefry":
        return bound(n, n * (THREEFRY_OPS_PER_BLOCK + THREEFRY_BIT_OPS))
    words = -(-n // 64)
    return bound(n, words * (THREEFRY_OPS_PER_BLOCK + THREEFRY_SPREAD_OPS))


def reshare_bound(x_elems, y_elems, n, width):
    """K3's fused reshare over n elements: slot 0 of x and y (3 words an
    element of their own shapes) and the (3, n) bank read, the (3, 2, n)
    pair layout written; per element and party two products and four
    adds (the y pair, the cross terms, the zero share's two)."""
    words = 3 * x_elems + 3 * y_elems + 3 * n + 6 * n
    ops = n * 3 * (2 * RING_MUL_OPS[width] + 4 * RING_ADD_OPS[width])
    return bound(words * (width // 8), ops)


def compare_reshare(torch, rk, ring, gen, x_shape, y_shape, width, reps,
                    halves=False):
    """K3's cross_terms_reshare as spmd.mul calls it: consistent
    sharings in the pair layout, broadcast to the common shape in the
    kernel, and the zero-share bank; with ``halves``, x and y are the
    even and odd halves (strided views) of one (*x_shape[:-1],
    2 * x_shape[-1]) pair layout, as a tournament round slices them.
    Beside it (``composition_ms``) the composition it replaced on the
    card: slot copies, the unfused cross_terms_mul kernel, the zero
    share's rolls and subtraction, the addition and the pair layout's
    rolls and stacks; and the device time of both under torch.profiler
    (``device_ms``, ``composition_device_ms``)."""
    def pair_layout(shape):
        z = random_words(torch, gen, (3,) + shape, width)
        return tuple(None if w is None
                     else torch.stack([w, torch.roll(w, -1, dims=0)], dim=1)
                     for w in z)

    if halves:
        both = pair_layout(x_shape[:-1] + (2 * x_shape[-1],))
        x, y = (tuple(None if w is None else w[..., start::2] for w in both)
                for start in (0, 1))
    else:
        x, y = pair_layout(x_shape), pair_layout(y_shape)
    shape = tuple(torch.broadcast_shapes(x_shape, y_shape))
    bank = random_words(torch, gen, (3,) + shape, width)

    def slot(t, s):
        return tuple(None if w is None
                     else w[:, s].expand((3,) + shape).contiguous()
                     for w in t)

    def composition():
        v = rk.cross_terms_mul(slot(x, 0), slot(x, 1), slot(y, 0),
                               slot(y, 1), width)
        roll = [None if w is None else torch.roll(w, -1, dims=0)
                for w in bank]
        z = ring.add(*v, *ring.sub(*bank, *roll))
        return tuple(None if w is None else torch.stack(
            [w, torch.roll(w, -1, dims=0)], dim=1) for w in z)

    row = compare_kernel(
        torch, rk.cross_terms_reshare, rk.cross_terms_reshare_plain,
        (x, y, bank, width),
        reshare_bound(math.prod(x_shape), math.prod(y_shape),
                      math.prod(shape), width), reps,
        shape=f"(3,2,{x_shape}) x (3,2,{y_shape})"
        + (" strided halves" if halves else ""), width=width,
        mode="cross_terms_reshare",
    )
    equal, _ = word_diff(torch, composition(), rk.cross_terms_reshare(
        x, y, bank, width))
    row["equal"] = row["equal"] and equal
    row["composition_ms"] = cuda_time_ms(torch, composition, reps=reps)
    row["device_ms"] = device_time_ms(
        torch, lambda: rk.cross_terms_reshare(x, y, bank, width))
    row["composition_device_ms"] = device_time_ms(torch, composition)
    return row


def group_bound(draws, layout):
    """K7 over a group: every draw's outputs written once, nothing read;
    one cipher block per output word (per layout-0 bit, per 64 layout-1
    bits) and, per draw, the four blocks and the key mixing of its seed
    derivation."""
    nbytes = ops = 0
    for kind, n in draws:
        bits = kind == "bits"
        outs = n * (2 if kind == "w128" else 1)
        nbytes += outs * (1 if bits else 8)
        if not bits:
            ops += outs * THREEFRY_OPS_PER_BLOCK
        elif layout == "threefry":
            ops += outs * (THREEFRY_OPS_PER_BLOCK + THREEFRY_BIT_OPS)
        else:
            ops += -(-outs // 64) * (THREEFRY_OPS_PER_BLOCK
                                    + THREEFRY_SPREAD_OPS)
        ops += 5 * THREEFRY_OPS_PER_BLOCK
    return bound(nbytes, ops)


def compare_group(torch, rk, ring, draws, layout, reps, label):
    """K7's group kernel against its plain version (the draws one by one,
    seeds derived on the host), in one layout; beside it
    (``sequential_ms``) the same draws as the session drew them before
    groups: per draw the host seed and one launch under its key; and the
    device time of both under torch.profiler (``device_ms``,
    ``sequential_device_ms``).  ``draws`` are (kind, n) with kind "w64",
    "w128" or "bits"."""
    def planes():
        out = []
        for kind, n in draws:
            dtype = torch.uint8 if kind == "bits" else torch.int64
            out.append(rk.GroupDraw(kind == "bits", n, tuple(
                (torch.empty(n, dtype=dtype, device="cuda"), 0)
                for _ in range(2 if kind == "w128" else 1))))
        return out

    got, want = planes(), planes()

    def kernel():
        rk.threefry_group(GROUP_MASTER, 0, 1000, layout, got)
        return [buf for d in got for buf, _ in d.planes]

    def plain():
        rk.threefry_group_plain(GROUP_MASTER, 0, 1000, layout, want)
        return [buf for d in want for buf, _ in d.planes]

    def sequential():
        for j, (kind, n) in enumerate(draws):
            seed = ring.draw_seed(GROUP_MASTER, 0, 1000 + j)
            key = ring.stream_key(seed, layout, kind == "bits")
            if kind == "bits":
                rk.threefry_bits(*key, n, layout, "cuda")
            else:
                rk.threefry_words(*key, n * (2 if kind == "w128" else 1),
                                  layout, "cuda")

    row = compare_kernel(
        torch, kernel, plain, (), group_bound(draws, layout), reps,
        shape=f"group of {len(draws)} ({label})", mode=layout,
    )
    row["sequential_ms"] = cuda_time_ms(torch, sequential, reps=reps)
    row["device_ms"] = device_time_ms(torch, kernel)
    row["sequential_device_ms"] = device_time_ms(torch, sequential)
    return row


def time_group(torch, rk, draws, layout, reps, label):
    """K7's group kernel alone, in one layout, where its plain version
    would take seconds a call: CUDA-event and device time and the bound,
    no comparison (``equal`` and ``max_abs_err`` None)."""
    out = [rk.GroupDraw(kind == "bits", n, tuple(
        (torch.empty(n, dtype=torch.uint8 if kind == "bits" else torch.int64,
                     device="cuda"), 0)
        for _ in range(2 if kind == "w128" else 1))) for kind, n in draws]

    def kernel():
        rk.threefry_group(GROUP_MASTER, 0, 1000, layout, out)

    bound_ms, bound_by = group_bound(draws, layout)
    row = dict(
        shape=f"group of {len(draws)} ({label})", mode=layout, equal=None,
        max_abs_err=None, ms=cuda_time_ms(torch, kernel, reps=reps),
        plain_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, device_ms=device_time_ms(torch, kernel),
    )
    del out
    return row


def compare_threefry(torch, rk, n, layout, bits, reps, label):
    """K7 in one layout against its plain version.  There is no library
    call: PyTorch's generators are Philox, another function."""
    k0, k1 = SEED & 0xFFFFFFFF, 0x9E3779B9
    kernel, plain = ((rk.threefry_bits, rk.threefry_bits_plain) if bits
                     else (rk.threefry_words, rk.threefry_words_plain))
    return compare_kernel(
        torch, kernel, plain, (k0, k1, n, layout, "cuda"),
        threefry_bound(n, layout, bits), reps,
        shape=f"{n} {'bits' if bits else 'words'} ({label})", mode=layout,
    )


def secure_dot_computation(pm, precision=DOT_PRECISION):
    """x on alice and y on bob, cast to fixed point, multiplied under the
    replicated placement, revealed to carole.  ``pm`` is the eDSL module
    (the port's; the tests also trace it with the JAX package's)."""
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    fx = pm.fixed(*precision)

    @pm.computation
    def secure_dot(x: pm.Argument(alice, dtype=pm.float64),
                   y: pm.Argument(bob, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=fx)
        with bob:
            yf = pm.cast(y, dtype=fx)
        with rep:
            z = pm.dot(xf, yf)
        with carole:
            out = pm.cast(z, dtype=pm.float64)
        return out

    return secure_dot


def linear_regressor(rng, n_features):
    """The port's LinearRegressor with random weights from ``rng``, built
    as a user would: an skl2onnx-style ONNX model (weights rounded to
    float32, as ONNX stores them) through ``predictors.from_onnx``."""
    import numpy as np

    from moose_tpu_torch.predictors import from_onnx, sklearn_export

    coef = rng.normal(size=(1, n_features)).astype(np.float32)
    intercept = rng.normal(size=(1,)).astype(np.float32)
    model = sklearn_export.linear_regressor_onnx(
        SimpleNamespace(coef_=coef.astype(np.float64),
                        intercept_=intercept.astype(np.float64)),
        n_features,
    )
    return from_onnx(model)


def logistic_regression(rng, n_features, aes=False,
                        package="moose_tpu_torch"):
    """The port's binary LinearClassifier with random weights from
    ``rng`` (scale 0.1, so the logits of unit-normal rows spread over the
    sigmoid as a fitted model's do), exported the way skl2onnx writes
    sklearn's LogisticRegression (mirrored class rows, LOGISTIC) and
    imported through ``predictors.from_onnx``; with ``aes``, through
    ``AesWrapper(LinearClassifier).from_onnx``.  ``package`` names the
    package whose predictors import the model (the tests pass the JAX
    package's)."""
    import importlib

    import numpy as np

    predictors = importlib.import_module(package + ".predictors")
    sklearn_export = importlib.import_module(
        package + ".predictors.sklearn_export")
    AesWrapper, LinearClassifier, from_onnx = (
        predictors.AesWrapper, predictors.LinearClassifier,
        predictors.from_onnx)

    coef = rng.normal(scale=0.1, size=(1, n_features)).astype(np.float32)
    intercept = rng.normal(scale=0.1, size=(1,)).astype(np.float32)
    model = sklearn_export.logistic_regression_onnx(
        SimpleNamespace(coef_=coef.astype(np.float64),
                        intercept_=intercept.astype(np.float64),
                        classes_=np.array([0, 1])),
        n_features,
    )
    if aes:
        return AesWrapper(LinearClassifier).from_onnx(model)
    return from_onnx(model)


def phase6_rng():
    """A generator from SEED in the state phase 6 draws its classifier
    from: past phase 4's operands and phase 5's weights and requests."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    for shape in ((DOT_N, DOT_N),) * 2 + ((1, LINREG_FEATURES), (1,)) \
            + ((LINREG_ROWS, LINREG_FEATURES),) * LINREG_REQUESTS:
        rng.normal(size=shape)
    return rng


def logistic_reference(predictor, x):
    """float64 [1 - sigmoid(z), sigmoid(z)] of the positive class's logit
    z = x @ w + b, with the weights as the model stores them."""
    import numpy as np

    z = x @ predictor.coeffs[1] + predictor.intercepts[0, 1]
    p = 1.0 / (1.0 + np.exp(-z))
    return np.stack([1.0 - p, p], axis=1)


def aes_key_nonce(seed=SEED):
    """An AES-128 key and a 96-bit base nonce drawn from ``seed``."""
    import numpy as np

    raw = np.random.default_rng(seed).integers(0, 256, size=28)
    return bytes(int(b) for b in raw[:16]), bytes(int(b) for b in raw[16:])


def aes_inference_computation(pm, model, fixedpoint_dtype):
    """BASELINE config 4's encrypted-input inference over a classifier
    wrapped by ``AesWrapper``: the wrapper's front end (the ciphertext on
    alice, the key on the replicated placement, Decrypt under MPC), then
    the classifier's whole forward pass, post-transform included,
    revealed to bob.  (The wrapper's own ``aes_predictor_factory`` runs
    ``predictor_fn`` alone, the linear map without the post-transform,
    in the JAX package as in the port.)  ``pm`` is the eDSL module of
    either package."""
    import importlib

    mixin = importlib.import_module(
        pm.__name__ + ".predictors.predictor").AesInputMixin

    @pm.computation
    def aes_inference(
        aes_data: pm.Argument(model.alice, vtype=pm.AesTensorType(
            dtype=fixedpoint_dtype)),
        aes_key: pm.Argument(model.replicated, vtype=pm.AesKeyType()),
    ):
        x = model.handle_aes_input(aes_key, aes_data,
                                   decryptor=model.replicated)
        with model.replicated:
            y = super(mixin, model).__call__(x, fixedpoint_dtype)
        return model.handle_output(y, prediction_handler=model.bob)

    return aes_inference


def decrypt_computation(pm, fixedpoint_dtype):
    """Decrypt alone: the ciphertext on alice, the key replicated, the
    plaintext decrypted under MPC and cast to float64 on bob."""
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])

    @pm.computation
    def decrypt(
        aes_data: pm.Argument(alice, vtype=pm.AesTensorType(
            dtype=fixedpoint_dtype)),
        aes_key: pm.Argument(rep, vtype=pm.AesKeyType()),
    ):
        with rep:
            x = pm.decrypt(aes_key, aes_data)
        with bob:
            out = pm.cast(x, dtype=pm.float64)
        return out

    return decrypt


def multinomial_regression(rng, n_features):
    """The port's multinomial LinearClassifier (MULTI_CLASSES classes)
    with random weights from ``rng`` of scale 0.1, exported the way
    skl2onnx writes a multinomial LogisticRegression (raw class rows,
    SOFTMAX) and imported through ``predictors.from_onnx``."""
    import numpy as np

    from moose_tpu_torch.predictors import from_onnx, sklearn_export

    coef = rng.normal(scale=0.1, size=(MULTI_CLASSES, n_features))
    intercept = rng.normal(scale=0.1, size=(MULTI_CLASSES,))
    model = sklearn_export.logistic_regression_onnx(
        SimpleNamespace(
            coef_=coef.astype(np.float32).astype(np.float64),
            intercept_=intercept.astype(np.float32).astype(np.float64),
            classes_=np.arange(MULTI_CLASSES)),
        n_features,
    )
    return from_onnx(model)


def softmax_reference(predictor, x):
    """float64 softmax over the classes of x @ coef^T + b, with the
    weights as the model stores them."""
    import numpy as np

    z = x @ predictor.coeffs.T + predictor.intercepts
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def correlated_columns(n):
    """The scientific-computing tutorial's two private columns (alcohol,
    grades), n rows each, from its own generator
    (``generate_synthetic_correlated_data``: seed 12, a known
    anticorrelation)."""
    import numpy as np

    mu = np.array([10.0, 0.0])
    r = np.array([[3.40, -2.75], [-2.75, 5.50]])
    x = np.random.default_rng(12).multivariate_normal(mu, r, size=n)
    return x[:, 0:1], x[:, 1:2]


def correlation_computation(pm):
    """The tutorial's ``multiparty_correlation`` in the eDSL of ``pm``:
    each department loads its own column from its own storage and casts
    it to fixed(24,40); the Pearson correlation runs on the replicated
    placement; the data scientist saves it as ``correlation``."""
    fx = pm.fixed(*CORR_PRECISION)
    health, education, scientist = (pm.host_placement(name)
                                    for name in CORR_IDS)
    government = pm.replicated_placement(
        "encrypted_government", players=[health, education, scientist])

    def pearson(x, y):
        x_mean = pm.mean(x, 0)
        y_mean = pm.mean(y, 0)
        stdv_x = pm.sum(pm.square(pm.sub(x, x_mean)))
        stdv_y = pm.sum(pm.square(pm.sub(y, y_mean)))
        corr_num = pm.sum(pm.mul(pm.sub(x, x_mean), pm.sub(y, y_mean)))
        corr_denom = pm.sqrt(pm.mul(stdv_x, stdv_y))
        return pm.div(corr_num, corr_denom)

    @pm.computation
    def multiparty_correlation():
        with health:
            alcohol = pm.cast(pm.load("alcohol_data", dtype=pm.float64),
                              dtype=fx)
        with education:
            grades = pm.cast(pm.load("grades_data", dtype=pm.float64),
                             dtype=fx)
        with government:
            correlation = pearson(alcohol, grades)
        with scientist:
            correlation = pm.cast(correlation, dtype=pm.float64)
            correlation = pm.save("correlation", correlation)
        return correlation

    return multiparty_correlation


def run_correlation(runtime_cls, comp, alcohol, grades, **kwargs):
    """The tutorial's ``run_local`` with ``runtime_cls``: the columns in
    the departments' storage, the computation called as a user calls it,
    the result read back from the data scientist's storage.  Returns
    (result, runtime)."""
    runtime = runtime_cls(
        list(CORR_IDS),
        storage_mapping={CORR_IDS[0]: {"alcohol_data": alcohol},
                         CORR_IDS[1]: {"grades_data": grades}},
        **kwargs,
    )
    runtime.set_default()
    outputs = comp()
    if list(outputs.values()) != [None]:
        raise AssertionError(f"a Save's output is None, got {outputs}")
    return runtime.read_value_from_storage(CORR_IDS[2], "correlation"), \
        runtime


def glorot(rng, fan_in, fan_out):
    """Weights of a dense layer as sklearn initialises them (Glorot
    uniform); a few training iterations leave them near there."""
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    return rng.uniform(-bound, bound, size=(fan_in, fan_out))


def mlp_model(rng, n_features, hidden, n_outputs=1, activation="relu"):
    """An sklearn MLPClassifier's attributes (``coefs_`` as (in, out),
    ``intercepts_``, ``activation``), from ``rng``: what
    ``sklearn_export.mlp_onnx`` reads."""
    widths = (n_features,) + tuple(hidden) + (n_outputs,)
    return SimpleNamespace(
        coefs_=[glorot(rng, a, b) for a, b in zip(widths, widths[1:])],
        intercepts_=[rng.uniform(-0.1, 0.1, size=b) for b in widths[1:]],
        activation=activation,
    )


def network_layers(rng, n_features, hidden, n_outputs):
    """A pytorch dense network's weights ((out, in), as nn.Linear stores
    them), biases and activations (relu hidden, softmax head): what
    ``sklearn_export.pytorch_nn_onnx`` takes."""
    widths = (n_features,) + tuple(hidden) + (n_outputs,)
    weights = [glorot(rng, a, b).T for a, b in zip(widths, widths[1:])]
    biases = [rng.uniform(-0.1, 0.1, size=b) for b in widths[1:]]
    activations = ["Relu"] * len(hidden) + ["Softmax"]
    return weights, biases, activations


def dense_reference(predictor, x):
    """float64 forward pass of a dense predictor (MLPClassifier or
    NeuralNetwork) with the weights as the model stores them; an
    MLPClassifier's one-logit head is [1 - sigmoid, sigmoid]."""
    import numpy as np

    from moose_tpu_torch.predictors import MLPClassifier

    def softmax(z):
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    acts = {"identity": lambda z: z, "relu": lambda z: np.maximum(z, 0),
            "sigmoid": lambda z: 1.0 / (1.0 + np.exp(-z)),
            "softmax": softmax}
    y = x
    for layer in predictor._stack.layers:
        y = acts[layer.activation](y @ layer.weights + layer.bias)
    if not isinstance(predictor, MLPClassifier):
        return y
    if y.shape[1] == 1:
        p = acts["sigmoid"](y)
        return np.concatenate([1.0 - p, p], axis=1)
    return softmax(y)


def forest_model(rng, n_trees, depth, n_features, n_classes=2):
    """A RandomForestClassifier's attributes from ``rng``: ``n_trees``
    complete trees of ``depth`` splits on random features and thresholds,
    nodes numbered depth first as sklearn numbers them, each leaf holding
    random class fractions; what ``sklearn_export._tree_arrays`` and
    ``random_forest_classifier_onnx`` read."""
    import numpy as np

    def tree():
        left, right, feature, threshold, value = [], [], [], [], []

        def grow(level):
            node = len(left)
            for column in (left, right, feature, threshold, value):
                column.append(None)
            if level == depth:
                left[node] = right[node] = feature[node] = -1
                threshold[node] = -2.0
                value[node] = [rng.dirichlet(np.ones(n_classes))]
                return node
            feature[node] = int(rng.integers(n_features))
            threshold[node] = float(rng.normal(scale=0.5))
            value[node] = [np.full(n_classes, 1.0 / n_classes)]
            left[node] = grow(level + 1)
            right[node] = grow(level + 1)
            return node

        grow(0)
        return SimpleNamespace(tree_=SimpleNamespace(
            children_left=np.array(left), children_right=np.array(right),
            feature=np.array(feature), threshold=np.array(threshold),
            value=np.array(value), node_count=len(left)))

    return SimpleNamespace(estimators_=[tree() for _ in range(n_trees)],
                           classes_=np.arange(n_classes))


def forest_reference(predictor, x):
    """float64 class probabilities of an imported binary
    TreeEnsembleClassifier: each tree walks left where x[feature] <
    threshold (the protocol's ``less``) down to its leaf weight, the
    forest sums them; [1 - p, p]."""
    import numpy as np

    p = np.zeros(x.shape[0])
    for tree in predictor.trees:
        node = np.zeros(x.shape[0], dtype=np.int64)
        for _ in range(len(tree.left)):
            inner = np.array([tree.left[n] != 0 for n in node])
            if not inner.any():
                break
            go_left = np.array([
                x[i, tree.split_indices[n]] < tree.split_conditions[n]
                for i, n in enumerate(node)
            ])
            nxt = np.where(go_left, [tree.left[n] for n in node],
                           [tree.right[n] for n in node])
            node = np.where(inner, nxt, node)
        p += np.array([tree.weights[n] for n in node])
    p += predictor.base_score
    return np.stack([1.0 - p, p], axis=1)


def conv_nchw(x, w, pad):
    """float64 convolution of NCHW ``x`` by OIHW ``w``, stride 1, zero
    padding ``pad`` on every side."""
    import numpy as np

    _, _, h, wd = x.shape
    _, _, kh, kw = w.shape
    xp = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    oh, ow = h + 2 * pad - kh + 1, wd + 2 * pad - kw + 1
    return sum(
        np.einsum("nchw,oc->nohw", xp[:, :, i:i + oh, j:j + ow], w[:, :, i, j])
        for i in range(kh) for j in range(kw)
    )


def resnet_reference(params, x):
    """float64 class probabilities of ``resnet_block_onnx``'s graph on
    NCHW ``x``, with the float32 weights its ONNX bytes carry (the
    forward pass of tests/test_conv.py:226-252): Conv3x3 -> BN -> Relu
    -> MaxPool2x2 -> [Conv3x3 -> BN -> Relu -> Conv3x3 -> BN] + skip ->
    Relu -> GlobalAveragePool -> Gemm -> Softmax."""
    import numpy as np

    def f32(a):
        return np.asarray(a, dtype=np.float32).astype(np.float64)

    def bn(v, i):
        g, b, m, var = (f32(params[f"{name}{i}"]).reshape(1, -1, 1, 1)
                        for name in "gbmv")
        return g * (v - m) / np.sqrt(var + 1e-5) + b

    h = np.maximum(bn(conv_nchw(x, f32(params["w0"]), 1), 0), 0)
    n, c, hh, ww = h.shape
    h = h.reshape(n, c, hh // 2, 2, ww // 2, 2).max(axis=(3, 5))
    r = np.maximum(bn(conv_nchw(h, f32(params["w1"]), 1), 1), 0)
    r = bn(conv_nchw(r, f32(params["w2"]), 1), 2)
    h = np.maximum(r + h, 0)
    logits = h.mean(axis=(2, 3)) @ f32(params["wf"]).T + f32(params["bf"])
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def library_computation(pm, rows=LIBRARY_ROWS, cols=LIBRARY_COLS,
                        precision=(24, 40)):
    """One traced computation that runs every replicated kind the
    protocol library brought (``LIBRARY_KINDS``, in output order) on
    (rows, cols) x, y on alice and bob and p > 0 on carole, and reveals
    each result to carole: fixed-point results as float64, bits, indices
    and the shape as they are."""
    import numpy as np

    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    fx = pm.fixed(*precision)

    @pm.computation
    def library(x: pm.Argument(alice, dtype=pm.float64),
                y: pm.Argument(bob, dtype=pm.float64),
                p: pm.Argument(carole, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=fx)
        with bob:
            yf = pm.cast(y, dtype=fx)
        with carole:
            pf = pm.cast(p, dtype=fx)
        with rep:
            lt = pm.less(xf, yf)
            lt_p = pm.less(yf, pf)
            results = [
                pm.identity(xf),
                pm.add(xf, pm.constant(np.linspace(-1.0, 1.0, cols),
                                       dtype=fx)),
                pm.add_n([xf, yf, pf]),
                pm.neg(xf),
                lt,
                pm.greater(xf, yf),
                pm.equal(xf, yf),
                pm.logical_and(lt, lt_p),
                pm.logical_or(lt, lt_p),
                pm.logical_xor(lt, lt_p),
                pm.mux(lt, xf, yf),
                pm.mean(xf, axis=1),
                pm.exp(xf),
                pm.log(pf),
                pm.log2(pf),
                pm.sqrt(pf),
                pm.relu(xf),
                pm.abs(xf),
                pm.softmax(xf, axis=1, upmost_index=cols),
                pm.argmax(xf, axis=1, upmost_index=cols),
                pm.maximum([xf, yf, pf]),
                pm.reshape(xf, (rows * cols // 2, 2)),
                pm.squeeze(pm.expand_dims(pm.mean(yf, axis=1), axis=1),
                           axis=1),
                pm.strided_slice(xf, (slice(None), slice(1, cols, 3))),
                pm.shape(xf),
            ]
        with carole:
            outs = tuple(
                pm.cast(r, dtype=pm.float64) if kind in _LIBRARY_FIXED
                else pm.identity(r)
                for kind, r in zip(LIBRARY_KINDS, results)
            )
        return outs

    return library


# the kinds library_computation runs, in output order, and those whose
# results are fixed-point
LIBRARY_KINDS = (
    "Identity", "Constant", "AddN", "Neg", "Less", "Greater", "Equal", "And",
    "Or", "Xor", "Mux", "Mean", "Exp", "Log", "Log2", "Sqrt", "Relu", "Abs",
    "Softmax", "Argmax", "Maximum", "Reshape", "Squeeze", "Slice", "Shape",
)
_LIBRARY_FIXED = frozenset(LIBRARY_KINDS) - {
    "Less", "Greater", "Equal", "And", "Or", "Xor", "Argmax", "Shape"}
# max abs error against float64 (relative where given as (atol, rtol)):
# the JAX package's own limits for its stacked protocols
# (tests/test_spmd.py:315-370: exp rtol 2e-3 atol 1e-4, log2/log/sqrt
# 5e-3, softmax 2e-3, max 1e-4); 2^-30 for what only encodes, adds or
# moves words; 1e-6 for Mean's public multiply; 0 (exact) for bits,
# indices and the shape
LIBRARY_TOLS = {
    "Exp": (1e-4, 2e-3), "Log": 5e-3, "Log2": 5e-3, "Sqrt": 5e-3,
    "Softmax": 2e-3, "Maximum": 1e-4, "Mean": 1e-6, "Squeeze": 1e-6,
}


def library_inputs(rng, rows=LIBRARY_ROWS, cols=LIBRARY_COLS):
    """x, y apart by far more than an LSB except where equal (a quarter
    of the entries, for Equal), and p in [0.1, 100)."""
    import numpy as np

    x = rng.normal(size=(rows, cols)) * 2.0
    y = np.where(rng.random((rows, cols)) < 0.25, x,
                 rng.normal(size=(rows, cols)) * 2.0)
    p = rng.uniform(0.1, 100.0, size=(rows, cols))
    return {"x": x, "y": y, "p": p}


def library_reference(args):
    """float64 (or exact) results of LIBRARY_KINDS on ``args``."""
    import numpy as np

    x, y, p = args["x"], args["y"], args["p"]
    rows, cols = x.shape
    e = np.exp(x - x.max(axis=1, keepdims=True))
    lt, lt_p = x < y, y < p
    return {
        "Identity": x, "Constant": x + np.linspace(-1.0, 1.0, cols),
        "AddN": x + y + p, "Neg": -x, "Less": lt, "Greater": x > y,
        "Equal": x == y, "And": lt & lt_p, "Or": lt | lt_p,
        "Xor": lt ^ lt_p, "Mux": np.where(lt, x, y),
        "Mean": x.mean(axis=1), "Exp": np.exp(x), "Log": np.log(p),
        "Log2": np.log2(p), "Sqrt": np.sqrt(p), "Relu": np.maximum(x, 0.0),
        "Abs": np.abs(x), "Softmax": e / e.sum(axis=1, keepdims=True),
        "Argmax": x.argmax(axis=1), "Maximum": np.maximum(np.maximum(x, y),
                                                          p),
        "Reshape": x.reshape(rows * cols // 2, 2), "Squeeze": y.mean(axis=1),
        "Slice": x[:, 1::3], "Shape": np.array(x.shape),
    }


def library_errors(outputs, args):
    """Each kind's max abs error against ``library_reference`` (0 for an
    exact match of bits, indices and shape, inf for a wrong shape or a
    mismatch there), and the kinds past their tolerance."""
    import numpy as np

    want = library_reference(args)
    errs, failed = {}, []
    for i, kind in enumerate(LIBRARY_KINDS):
        got = np.asarray(outputs[f"output_{i}"])
        ref = want[kind]
        if got.shape != ref.shape:
            errs[kind] = float("inf")
        elif kind in _LIBRARY_FIXED:
            if not np.all(np.isfinite(got)):
                errs[kind] = float("inf")
            else:
                errs[kind] = float(np.abs(got - ref).max())
        else:
            exact = np.array_equal(got.astype(np.int64),
                                   ref.astype(np.int64))
            errs[kind] = 0.0 if exact else float("inf")
        tol = LIBRARY_TOLS.get(kind, 0.0 if kind not in _LIBRARY_FIXED
                               else 2.0 ** -30)
        if isinstance(tol, tuple):
            atol, rtol = tol
            ok = got.shape == ref.shape and np.all(
                np.abs(got - ref) <= atol + rtol * np.abs(ref))
        else:
            ok = errs[kind] <= tol
        if not ok:
            failed.append(kind)
    return errs, failed


def training_data(rng, n_rows, n_features):
    """Features and labels as ``benchmarks/logreg.py:169-173`` makes
    them: unit normal rows scaled by 0.1, labels of a random linear model
    with a little noise."""
    import numpy as np

    x = rng.normal(size=(n_rows, n_features)) * 0.1
    true_w = rng.normal(size=(n_features, 1))
    noise = 0.05 * rng.normal(size=(n_rows, 1))
    return x, (x @ true_w + noise > 0).astype(np.float64)


def train_steps(runtime, trainer, batches, state, sync=lambda: None):
    """Chained SGD steps of ``trainer`` through ``runtime``, one per
    ``(x, y)`` batch, from the float ``state``.  Each step's weights are
    held against ``reference_epoch`` from the same input weights.
    Returns (final state, max abs error per step, seconds per step)."""
    import numpy as np

    names = sorted(trainer.state_shapes)
    errs, seconds = [], []
    for x, y in batches:
        comp = trainer.step_computation(x.shape[0])
        sync()
        t0 = time.perf_counter()
        out = runtime.evaluate_computation(comp, dict(state, x=x, y=y))
        sync()
        seconds.append(time.perf_counter() - t0)
        want = trainer.reference_epoch(state, x, y)
        state = {name: out[f"output_{i}"] for i, name in enumerate(names)}
        err = 0.0
        for name in names:
            got = state[name]
            if got.shape != want[name].shape or not np.all(np.isfinite(got)):
                raise AssertionError(f"{name} malformed: {got.shape}")
            err = max(err, float(np.abs(got - want[name]).max()))
        errs.append(err)
    return state, errs, seconds


def run_training(torch, rk, runtime, rng):
    """Phase 7: the logistic-regression trainer's chained steps, then the
    MLP trainer's, each checked as ``train_steps`` says; returns the
    phase's record with its launch counts under ``launches``."""
    import numpy as np

    from moose_tpu_torch.predictors import trainers

    x, y = training_data(rng, TRAIN_ROWS * TRAIN_STEPS, TRAIN_FEATURES)
    batches = [
        (x[i * TRAIN_ROWS:(i + 1) * TRAIN_ROWS],
         y[i * TRAIN_ROWS:(i + 1) * TRAIN_ROWS])
        for i in range(TRAIN_STEPS)
    ]
    logreg = trainers.LogregSGDTrainer(TRAIN_FEATURES, TRAIN_LR)
    mlp = trainers.MLPSGDTrainer(TRAIN_FEATURES, MLP_HIDDEN, TRAIN_LR)
    mlp_state = {
        "w1": rng.normal(size=(TRAIN_FEATURES, MLP_HIDDEN)) * 0.1,
        "w2": rng.normal(size=(MLP_HIDDEN, 1)) * 0.1,
    }
    rk.reset_launches()
    state, errs, seconds = train_steps(
        runtime, logreg, batches, {"w": np.zeros((TRAIN_FEATURES, 1))},
        torch.cuda.synchronize,
    )
    logreg_launches = dict(rk.LAUNCHES)
    _, mlp_errs, mlp_seconds = train_steps(
        runtime, mlp, batches[:MLP_STEPS], mlp_state, torch.cuda.synchronize
    )
    launches = dict(rk.LAUNCHES)
    want = {"w": np.zeros((TRAIN_FEATURES, 1))}
    for xb, yb in batches:
        want = logreg.reference_epoch(want, xb, yb)
    trajectory_err = float(np.abs(state["w"] - want["w"]).max())
    log(f"training logreg: {TRAIN_STEPS} steps of {TRAIN_ROWS}x"
        f"{TRAIN_FEATURES} fixed(24, 40) threefry-pallas latencies_ms "
        f"{[round(t * 1e3, 3) for t in seconds]} rows_per_s "
        f"{TRAIN_ROWS * TRAIN_STEPS / sum(seconds):.1f} step_errs "
        f"{max(errs):.3e} trajectory_err {trajectory_err:.3e} "
        f"launches {logreg_launches}")
    log(f"training mlp: {MLP_STEPS} steps of {TRAIN_ROWS}x{TRAIN_FEATURES} "
        f"hidden {MLP_HIDDEN} latencies_ms "
        f"{[round(t * 1e3, 3) for t in mlp_seconds]} step_errs "
        f"{max(mlp_errs):.3e} launches (both trainers) {launches}")
    if max(errs + mlp_errs) >= TRAIN_STEP_TOL:
        raise AssertionError(
            f"a training step is off its reference by {max(errs + mlp_errs)}"
        )
    if trajectory_err >= TRAIN_TRAJECTORY_TOL:
        raise AssertionError(f"trajectory error {trajectory_err}")
    return {
        "prf": "threefry-pallas",
        "logreg_step_ms": [t * 1e3 for t in seconds],
        "logreg_rows_per_s": TRAIN_ROWS * TRAIN_STEPS / sum(seconds),
        "logreg_step_max_abs_err": max(errs),
        "logreg_trajectory_max_abs_err": trajectory_err,
        "logreg_launches": logreg_launches,
        "mlp_step_ms": [t * 1e3 for t in mlp_seconds],
        "mlp_step_max_abs_err": max(mlp_errs),
        "launches": launches,
    }


def step_device_launches(torch, runtime, rng):
    """The device launches of one more LogregSGDTrainer step (128 x 100,
    from zero weights), under torch.profiler."""
    import numpy as np

    from moose_tpu_torch.predictors import trainers

    trainer = trainers.LogregSGDTrainer(TRAIN_FEATURES, TRAIN_LR)
    comp = trainer.step_computation(TRAIN_ROWS)
    x, y = training_data(rng, TRAIN_ROWS, TRAIN_FEATURES)
    args = {"w": np.zeros((TRAIN_FEATURES, 1)), "x": x, "y": y}
    return device_launches(
        torch, lambda: runtime.evaluate_computation(comp, args))


def run_from_bytes(torch, rk, runtime, serde, textual, elk_compiler,
                   tracer, logreg, classifier, rng, golden, graphs):
    """Phase 17, under fixed keys: phase 6's logistic regression
    (``logreg``) traced, serialized, compiled by ``elk_compiler`` with
    BYTES_PASSES and served by ``runtime.evaluate_compiled``, three
    requests, each within phase 6's limit and equal to
    ``evaluate_computation`` of the traced graph; then, once each, the
    textual round trip, the JAX package's blob ``golden`` (which must be
    this graph's bytes) and the graphs of ``graphs`` (name: (computation,
    arguments)) from bytes, each equal to ``evaluate_computation`` of its
    computation as its phase calls it.  Returns (record, the launches of
    the three requests)."""
    import numpy as np

    def ms_of(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    def equal(got, want):
        return got.keys() == want.keys() and all(
            np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
            for k in want)

    traced = tracer.trace(logreg)
    blob, serialize_ms = ms_of(lambda: serde.serialize_computation(traced))
    _, deserialize_ms = ms_of(lambda: serde.deserialize_computation(blob))
    compiled, compile_ms = ms_of(
        lambda: elk_compiler.compile_computation(blob, BYTES_PASSES))
    if blob != golden:
        raise AssertionError(
            "phase 6's graph does not serialize to the JAX package's bytes")
    requests = [rng.normal(size=(LOGREG_ROWS, LOGREG_FEATURES))
                for _ in range(BYTES_REQUESTS)]
    rk.reset_launches()
    outs, walls = [], []
    for xr in requests:
        out, s = timed(torch, lambda: runtime.evaluate_compiled(
            compiled, {"x": xr}))
        outs.append(out)
        walls.append(s)
    launches = dict(rk.LAUNCHES)
    errs, equal_words, direct_walls = [], [], []
    for xr, out in zip(requests, outs):
        pred, want = out["output_0"], logistic_reference(classifier, xr)
        if pred.shape != want.shape or not np.all(np.isfinite(pred)):
            raise AssertionError(f"from-bytes output malformed: {pred.shape}")
        errs.append(float(np.abs(pred - want).max()))
        direct, s = timed(torch, lambda: runtime.evaluate_computation(
            traced, {"x": xr}))
        direct_walls.append(s)
        equal_words.append(equal(out, direct))
    text = textual.to_textual(traced)
    parsed, parse_ms = ms_of(lambda: textual.parse_computation(text))
    args = {"x": requests[0]}
    checks = {
        "textual": equal(runtime.evaluate_computation(parsed, args),
                         outs[0]),
        "jax_blob": equal(runtime.evaluate_compiled(golden, args), outs[0]),
    }
    for name, (comp, comp_args) in graphs.items():
        graph = tracer.trace(comp)
        checks[name] = equal(
            runtime.evaluate_compiled(serde.serialize_computation(graph),
                                      comp_args),
            runtime.evaluate_computation(comp, comp_args))
    busy_launches, busy_ms = device_busy(
        torch, lambda: runtime.evaluate_compiled(compiled, args))
    wall_ms = statistics.median(walls) * 1e3
    record = {
        "blob_bytes": len(blob),
        "serialize_ms": serialize_ms,
        "deserialize_ms": deserialize_ms,
        "elk_compile_ms": compile_ms,
        "textual_chars": len(text),
        "parse_ms": parse_ms,
        "evaluate_compiled_ms": [s * 1e3 for s in walls],
        "evaluate_computation_ms": [s * 1e3 for s in direct_walls],
        "rows_per_s": LOGREG_ROWS * BYTES_REQUESTS / sum(walls),
        "max_abs_err": max(errs),
        "equal_to_evaluate_computation": equal_words,
        "equal": checks,
        "k7_groups": launches["prf_threefry"] / BYTES_REQUESTS,
        "device_launches": busy_launches,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
    }
    log(f"from_bytes: {BYTES_REQUESTS} requests of {LOGREG_ROWS}x"
        f"{LOGREG_FEATURES} fixed(24, 40), passes {BYTES_PASSES} "
        f"{json.dumps(record)} launches {launches}")
    if max(errs) >= LOGREG_TOL:
        raise AssertionError(f"from-bytes error {max(errs)} >= {LOGREG_TOL}")
    if not all(equal_words):
        raise AssertionError(
            f"evaluate_compiled differs from evaluate_computation: "
            f"{equal_words}")
    for name, ok in checks.items():
        if not ok:
            raise AssertionError(f"{name} from bytes differs")
    return record, launches


def host_math_computation(pm):
    """A host-only graph: a fixed-point host Dot, Exp, Mean and Softmax
    on alice (``auto`` keeps it per-host: there is nothing to stack)."""
    alice, bob = pm.host_placement("alice"), pm.host_placement("bob")

    @pm.computation
    def host_math(x: pm.Argument(alice, dtype=pm.float64),
                  y: pm.Argument(bob, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=pm.fixed(24, 40))
            yf = pm.cast(y, dtype=pm.fixed(24, 40))
            e = pm.exp(pm.dot(xf, pm.transpose(yf)))
            z = pm.softmax(pm.sub(e, pm.mean(e, axis=0)), axis=1,
                           upmost_index=2)
        with bob:
            out = pm.cast(z, dtype=pm.float64)
        return out

    return host_math


def host_math_reference(x, y):
    import numpy as np

    e = np.exp(x @ y.T)
    e = e - e.mean(axis=0)
    z = np.exp(e - e.max(axis=1, keepdims=True))
    return z / z.sum(axis=1, keepdims=True)


def selected_product_computation(pm):
    """A replicated product of host-selected columns (the first and the
    last of three): Select's data-dependent shape keeps the stacked
    layout off the graph, in the reference and the port."""
    import numpy as np

    alice, bob, carole = (pm.host_placement(n)
                          for n in ("alice", "bob", "carole"))
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    keep = np.array([True, False, True])

    @pm.computation
    def selected(x: pm.Argument(alice, dtype=pm.float64),
                 y: pm.Argument(bob, dtype=pm.float64)):
        with alice:
            xs = pm.cast(pm.select(x, 1, pm.constant(keep, dtype=pm.bool_)),
                         dtype=pm.fixed(24, 40))
        with bob:
            ys = pm.cast(pm.select(y, 1, pm.constant(keep, dtype=pm.bool_)),
                         dtype=pm.fixed(24, 40))
        with rep:
            z = pm.mul(xs, ys)
        with carole:
            out = pm.cast(z, dtype=pm.float64)
        return out

    return selected


def inverse_computation(pm):
    """A replicated Inverse: no stacked kind, and the reference's
    per-host layout has none either (moose_tpu/dialects/logical.py:880),
    so both refuse it there."""
    from importlib import import_module

    edsl = import_module(f"{pm.__name__}.edsl.base")
    alice, bob, carole = (pm.host_placement(n)
                          for n in ("alice", "bob", "carole"))
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])

    @pm.computation
    def inverse(x: pm.Argument(alice, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=pm.fixed(14, 23))
        with rep:
            z = edsl.inverse(xf)
        with bob:
            out = pm.cast(z, dtype=pm.float64)
        return out

    return inverse


def run_per_host(torch, rk, ring, pm, runtime_cls, classifier, logreg, rng):
    """Phase 18: the per-host layout on the card, (a) to (d) of the
    module's docstring.  Returns (record, launches by path); raises on
    any failed check."""
    import os

    import numpy as np

    from moose_tpu_torch.edsl import tracer

    ids = ["alice", "bob", "carole"]
    draws, seeds = [0], [0]
    threefry, mix_seed = rk._threefry, ring.mix_seed

    def counted_threefry(*args, **kwargs):
        draws[0] += 1
        return threefry(*args, **kwargs)

    def counted_mix_seed(*args, **kwargs):
        seeds[0] += 1
        return mix_seed(*args, **kwargs)

    def k7(launches):
        return launches["prf_threefry"] + launches["prf_threefry_pallas"]

    def check(what, got, limit):
        log(f"ceiling: {what} {got} <= {limit}")
        if got > limit:
            raise AssertionError(f"{what}: {got} > {limit}")

    knobs = ("MOOSE_TPU_FIXED_KEYS", "MOOSE_TPU_ALLOW_WEAK_PRF")
    saved = {k: os.environ.get(k) for k in knobs}
    rk._threefry, ring.mix_seed = counted_threefry, counted_mix_seed
    record, launches = {}, {}
    try:
        runtime = runtime_cls(ids, layout="per-host", use_jit=False)

        # (a) the secure dot
        x = rng.normal(size=(DOT_N, DOT_N))
        y = rng.normal(size=(DOT_N, DOT_N))
        comp = secure_dot_computation(pm)
        rk.reset_launches()
        seeds[0] = 0
        out, dot_s = timed(torch, lambda: runtime.evaluate_computation(
            comp, {"x": x, "y": y}))
        launches["per_host_secure_dot"] = dict(rk.LAUNCHES)
        dot_seeds = seeds[0]
        z = out["output_0"]
        dot_err = float(np.abs(z - x @ y).max())
        record["secure_dot"] = {
            "latency_ms": dot_s * 1e3, "max_abs_err": dot_err,
            "k7_launches": k7(launches["per_host_secure_dot"]),
            "host_seed_derivations": dot_seeds,
        }
        log(f"per_host secure_dot: {DOT_N}x{DOT_N} fixed{DOT_PRECISION} "
            f"{json.dumps(record['secure_dot'])} launches "
            f"{launches['per_host_secure_dot']}")
        if z.shape != (DOT_N, DOT_N) or not np.all(np.isfinite(z)):
            raise AssertionError(f"per-host dot output malformed: {z.shape}")
        if dot_err >= DOT_TOL:
            raise AssertionError(f"per-host dot error {dot_err}")
        if launches["per_host_secure_dot"]["dot_cross_terms"] != 3:
            raise AssertionError("per-host secure dot: K1 not once a party")
        check("per-host secure dot K7 launches",
              record["secure_dot"]["k7_launches"],
              per_host_ceiling(PER_HOST_DOT_K7))
        check("per-host secure dot host seeds", dot_seeds,
              per_host_ceiling(PER_HOST_DOT_SEEDS))

        # (b) the logistic regression under fixed keys, against the CPU
        os.environ.update(dict(zip(knobs, (f"chip-smoke-{SEED}", "1"))))
        requests = [rng.normal(size=(LOGREG_ROWS, LOGREG_FEATURES))
                    for _ in range(PER_HOST_LOGREG_REQUESTS)]
        rk.reset_launches()
        seeds[0] = 0
        walls, errs, outs = [], [], []
        for xr in requests:
            out, s = timed(torch, lambda: runtime.evaluate_computation(
                logreg, {"x": xr}))
            pred, want = out["output_0"], logistic_reference(classifier, xr)
            if pred.shape != want.shape or not np.all(np.isfinite(pred)):
                raise AssertionError(f"per-host logreg malformed: "
                                     f"{pred.shape}")
            errs.append(float(np.abs(pred - want).max()))
            walls.append(s)
            outs.append(pred)
        launches["per_host_logistic_regression"] = dict(rk.LAUNCHES)
        logreg_seeds = seeds[0] / len(requests)
        cpu = runtime_cls(ids, layout="per-host", use_jit=False,
                          device="cpu")
        draws[0] = seeds[0] = 0
        t0 = time.perf_counter()
        cpu_outs = [cpu.evaluate_computation(logreg, {"x": xr})["output_0"]
                    for xr in requests]
        cpu_s = (time.perf_counter() - t0) / len(requests)
        cpu_draws, cpu_seeds = (draws[0] / len(requests),
                                seeds[0] / len(requests))
        equal = all(np.array_equal(a, b) for a, b in zip(outs, cpu_outs))
        n_dev, busy_ms = device_busy(torch, lambda: runtime
                                     .evaluate_computation(
                                         logreg, {"x": requests[0]}))
        wall_ms = statistics.median(walls) * 1e3
        record["logistic_regression"] = {
            "latency_ms": [s * 1e3 for s in walls],
            "rows_per_s": LOGREG_ROWS * len(walls) / sum(walls),
            "max_abs_err": max(errs), "equal_to_cpu": equal,
            "cpu_latency_ms": cpu_s * 1e3,
            "k7_launches": k7(launches["per_host_logistic_regression"])
            / len(requests),
            "host_seed_derivations": logreg_seeds,
            "cpu_k7_draws": cpu_draws, "cpu_host_seed_derivations": cpu_seeds,
            "device_launches": n_dev, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        }
        log(f"per_host logistic_regression: {len(requests)} requests of "
            f"{LOGREG_ROWS}x{LOGREG_FEATURES} fixed(24, 40) "
            f"{json.dumps(record['logistic_regression'])} launches "
            f"{launches['per_host_logistic_regression']}")
        if max(errs) >= LOGREG_TOL:
            raise AssertionError(f"per-host logreg error {max(errs)}")
        if not equal:
            raise AssertionError("per-host logreg differs from the CPU's")
        check("per-host K7 launches a logistic-regression request",
              record["logistic_regression"]["k7_launches"],
              per_host_ceiling(PER_HOST_LOGREG_K7))
        check("per-host host seeds a logistic-regression request",
              logreg_seeds, per_host_ceiling(PER_HOST_LOGREG_SEEDS))

        # (c) one request under threefry-pallas: both streams
        ring.set_prf_impl("threefry-pallas")
        try:
            xr = rng.normal(size=(LOGREG_ROWS, LOGREG_FEATURES))
            rk.reset_launches()
            seeds[0] = 0
            out, pallas_s = timed(torch, lambda: runtime
                                  .evaluate_computation(logreg, {"x": xr}))
            launches["per_host_pallas"] = dict(rk.LAUNCHES)
        finally:
            ring.set_prf_impl("threefry")
        pallas_err = float(np.abs(
            out["output_0"] - logistic_reference(classifier, xr)).max())
        record["threefry_pallas"] = {
            "latency_ms": pallas_s * 1e3, "max_abs_err": pallas_err,
            "k7_launches": k7(launches["per_host_pallas"]),
            "host_seed_derivations": seeds[0],
        }
        log(f"per_host threefry-pallas: 1 request "
            f"{json.dumps(record['threefry_pallas'])} launches "
            f"{launches['per_host_pallas']}")
        if pallas_err >= LOGREG_TOL:
            raise AssertionError(f"per-host pallas error {pallas_err}")
        check("per-host K7 launches under threefry-pallas",
              record["threefry_pallas"]["k7_launches"],
              per_host_ceiling(PER_HOST_LOGREG_K7))
        check("per-host host seeds under threefry-pallas", seeds[0],
              per_host_ceiling(PER_HOST_LOGREG_SEEDS))

        # (d) "auto": what it routes per-host
        auto = runtime_cls(ids, use_jit=False)
        hx = rng.normal(size=(LOGREG_ROWS, LOGREG_FEATURES)) * 0.1
        hy = rng.normal(size=(2, LOGREG_FEATURES)) * 0.1
        sx, sy = (rng.normal(size=(LOGREG_ROWS, 3)) for _ in range(2))
        rk.reset_launches()
        host_out = auto.evaluate_computation(
            host_math_computation(pm), {"x": hx, "y": hy})["output_0"]
        host_layout = auto.last_plan["layout"]
        sel_out = auto.evaluate_computation(
            selected_product_computation(pm), {"x": sx, "y": sy})["output_0"]
        sel_layout = auto.last_plan["layout"]
        launches["per_host_auto"] = dict(rk.LAUNCHES)
        inverse = tracer.trace(inverse_computation(pm))
        inverse_layout = auto.layout_for(inverse)
        try:
            auto.evaluate_computation(inverse, {"x": np.eye(2) * 2.0})
            inverse_refused = None
        except NotImplementedError as e:
            inverse_refused = str(e)
        record["auto"] = {
            "host_only": {"layout": host_layout, "max_abs_err": float(
                np.abs(host_out - host_math_reference(hx, hy)).max())},
            "select": {"layout": sel_layout, "max_abs_err": float(np.abs(
                sel_out - sx[:, [0, 2]] * sy[:, [0, 2]]).max())},
            "inverse": {"layout": inverse_layout,
                        "refused": inverse_refused},
        }
        log(f"per_host auto: {json.dumps(record['auto'])} launches "
            f"{launches['per_host_auto']}")
        if (host_layout, sel_layout, inverse_layout) != ("per-host",) * 3:
            raise AssertionError(f"auto routing: {record['auto']}")
        for name in ("host_only", "select"):
            if record["auto"][name]["max_abs_err"] >= 1e-6:
                raise AssertionError(f"auto {name}: {record['auto'][name]}")
        if inverse_refused != "replicated op Inverse (inverse_0)":
            raise AssertionError(f"replicated Inverse: {inverse_refused}")
    finally:
        rk._threefry, ring.mix_seed = threefry, mix_seed
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return record, launches


def _fixed_keys(os):
    """Set the fixed-key knobs; return their previous values."""
    knobs = ("MOOSE_TPU_FIXED_KEYS", "MOOSE_TPU_ALLOW_WEAK_PRF")
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(dict(zip(knobs, (f"chip-smoke-{SEED}", "1"))))
    return saved


def _restore(os, saved):
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def run_lowered(torch, rk, ring, pm, runtime_cls, classifier, logreg,
                aes_model, aes_comp, aes_key, rng):
    """Phase 19: the lowered route and the per-host Decrypt, (a) to (d)
    of the module's docstring.  Returns (record, launches by path);
    raises on any failed check."""
    import collections
    import os

    import numpy as np

    from moose_tpu_torch import serde
    from moose_tpu_torch.compilation import (
        DEFAULT_PASSES,
        compile_computation,
    )
    from moose_tpu_torch.compilation.lowering import (
        arg_specs_from_arguments,
    )
    from moose_tpu_torch.dialects import aes, host
    from moose_tpu_torch.edsl import tracer

    ids = ["alice", "bob", "carole"]
    seeds = [0]
    mix_seed = ring.mix_seed

    def counted_mix_seed(*args, **kwargs):
        seeds[0] += 1
        return mix_seed(*args, **kwargs)

    record, launches = {}, {}
    saved = _fixed_keys(os)
    ring.mix_seed = counted_mix_seed
    try:
        # (a) through evaluate_computation(compiler_passes=DEFAULT_PASSES)
        requests = [rng.normal(size=(LOGREG_ROWS, LOGREG_FEATURES))
                    for _ in range(LOWERED_REQUESTS)]
        traced = tracer.trace(logreg)
        specs = arg_specs_from_arguments({"x": requests[0]})
        t0 = time.perf_counter()
        with host.deterministic_sync_keys(SEED):
            lowered = compile_computation(traced, DEFAULT_PASSES, specs)
        lower_ms = (time.perf_counter() - t0) * 1e3
        hist = collections.Counter(op.kind
                                   for op in lowered.operations.values())
        runtime = runtime_cls(ids, layout="per-host")
        rk.reset_launches()
        seeds[0] = 0
        walls, outs, errs = [], [], []
        for i, xr in enumerate(requests):
            def request():
                return runtime.evaluate_computation(
                    logreg, {"x": xr}, compiler_passes=DEFAULT_PASSES)
            if i == 0:
                # the cold request lowers: under the seed of `lowered`
                with host.deterministic_sync_keys(SEED):
                    out, s = timed(torch, request)
            else:
                out, s = timed(torch, request)
            if not runtime.last_plan.get("lowered"):
                raise AssertionError(f"not lowered: {runtime.last_plan}")
            pred, want = out["output_0"], logistic_reference(classifier, xr)
            if pred.shape != want.shape or not np.all(np.isfinite(pred)):
                raise AssertionError(f"lowered logreg malformed: "
                                     f"{pred.shape}")
            errs.append(float(np.abs(pred - want).max()))
            walls.append(s)
            outs.append(pred)
        launches["lowered_logistic_regression"] = dict(rk.LAUNCHES)
        lowered_seeds = seeds[0] / len(requests)
        cpu = runtime_cls(ids, layout="per-host", device="cpu")
        t0 = time.perf_counter()
        with host.deterministic_sync_keys(SEED):
            cpu_outs = [cpu.evaluate_computation(
                logreg, {"x": xr}, compiler_passes=DEFAULT_PASSES)["output_0"]
                for xr in requests]
        cpu_s = (time.perf_counter() - t0) / len(requests)
        equal = all(np.array_equal(a, b) for a, b in zip(outs, cpu_outs))
        n_dev, busy_ms = device_busy(torch, lambda: runtime
                                     .evaluate_computation(
                                         logreg, {"x": requests[1]},
                                         compiler_passes=DEFAULT_PASSES))
        warm_ms = statistics.median(walls[1:]) * 1e3
        counts = launches["lowered_logistic_regression"]
        record["lowered_logistic_regression"] = {
            "lowering_host_ms": lower_ms,
            "ops": len(lowered.operations),
            "top_kinds": hist.most_common(10),
            "latency_ms": [s * 1e3 for s in walls],
            "max_abs_err": max(errs), "equal_to_cpu": equal,
            "cpu_latency_ms": cpu_s * 1e3,
            "k1_product_only_launches": counts["dot_cross_terms"]
            / len(requests),
            "k4_launches": counts["ring_mul"] / len(requests),
            "k7_launches": counts["prf_threefry"] / len(requests),
            "host_seed_derivations": lowered_seeds,
            "device_launches": n_dev, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / warm_ms),
        }
        log(f"lowered logistic_regression: {len(requests)} requests of "
            f"{LOGREG_ROWS}x{LOGREG_FEATURES} fixed(24, 40) "
            f"{json.dumps(record['lowered_logistic_regression'])} "
            f"launches {counts}")
        if max(errs) >= LOGREG_TOL:
            raise AssertionError(f"lowered logreg error {max(errs)}")
        if not equal:
            raise AssertionError("lowered logreg differs from the CPU's")

        # (b) the lowered graph from bytes
        blob = serde.serialize_computation(lowered)
        rk.reset_launches()
        bytes_walls, bytes_equal = [], []
        for xr, want in zip(requests, outs):
            out, s = timed(torch, lambda: runtime.evaluate_compiled(
                blob, {"x": xr}))
            bytes_walls.append(s)
            bytes_equal.append(bool(np.array_equal(out["output_0"], want)))
        launches["lowered_from_bytes"] = dict(rk.LAUNCHES)
        record["lowered_from_bytes"] = {
            "blob_bytes": len(blob),
            "latency_ms": [s * 1e3 for s in bytes_walls],
            "equal_to_a": bytes_equal,
        }
        log(f"lowered from bytes: {json.dumps(record['lowered_from_bytes'])}"
            f" launches {launches['lowered_from_bytes']}")
        if not all(bytes_equal):
            raise AssertionError("evaluate_compiled differs from (a)")
        if launches["lowered_from_bytes"] != counts:
            raise AssertionError(
                f"from bytes launched {launches['lowered_from_bytes']}, "
                f"(a) {counts}")

        # (c) the route follows use_jit
        routes = {}
        for use_jit in (True, False):
            r = runtime_cls(ids, layout="per-host", use_jit=use_jit)
            out, s = timed(torch, lambda: r.evaluate_computation(
                logreg, {"x": requests[0]}))
            routes[str(use_jit)] = {
                "lowered": r.last_plan["lowered"], "latency_ms": s * 1e3,
                "max_abs_err": float(np.abs(out["output_0"] - (
                    logistic_reference(classifier, requests[0]))).max()),
            }
        record["route"] = routes
        log(f"lowered route: {json.dumps(routes)}")
        if (routes["True"]["lowered"], routes["False"]["lowered"]) != (
                True, False):
            raise AssertionError(f"use_jit route: {routes}")
        if max(v["max_abs_err"] for v in routes.values()) >= LOGREG_TOL:
            raise AssertionError(f"route error: {routes}")
    finally:
        ring.mix_seed = mix_seed
        _restore(os, saved)

    # (d) config 4's encrypted input per-host: Decrypt alone, then the
    # inference
    key, nonce = aes_key_nonce()
    xr = rng.normal(size=(AES_PER_HOST_ROWS, AES_FEATURES))
    wire = aes.encrypt_fixed_array(key, nonce, xr, AES_PRECISION[1])
    args = {"aes_data": wire, "aes_key": aes_key}
    runtime = runtime_cls(ids, layout="per-host")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    decrypted, decrypt_s = timed(torch, lambda: runtime.evaluate_computation(
        decrypt_computation(pm, pm.fixed(*AES_PRECISION)), args))
    decrypt_lowered = runtime.last_plan["lowered"]
    exact = np.round(xr * 2.0 ** AES_PRECISION[1]) / 2.0 ** AES_PRECISION[1]
    decrypt_exact = bool(np.array_equal(decrypted["output_0"], exact))
    rk.reset_launches()
    out, aes_s = timed(torch, lambda: runtime.evaluate_computation(
        aes_comp, args))
    launches["per_host_decrypt"] = dict(rk.LAUNCHES)
    pred, want = out["output_0"], logistic_reference(aes_model, xr)
    if pred.shape != want.shape or not np.all(np.isfinite(pred)):
        raise AssertionError(f"per-host AES output malformed: {pred.shape}")
    aes_err = float(np.abs(pred - want).max())
    record["per_host_decrypt"] = {
        "rows": AES_PER_HOST_ROWS, "features": AES_FEATURES,
        "decrypt_only_ms": decrypt_s * 1e3, "decrypt_only_exact":
        decrypt_exact, "latency_ms": aes_s * 1e3, "max_abs_err": aes_err,
        "lowered": decrypt_lowered or runtime.last_plan["lowered"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    log(f"per_host decrypt: {json.dumps(record['per_host_decrypt'])} "
        f"launches {launches['per_host_decrypt']}")
    if not decrypt_exact:
        raise AssertionError("per-host Decrypt is not the encoded input")
    if aes_err >= AES_TOL:
        raise AssertionError(f"per-host AES inference error {aes_err}")
    if record["per_host_decrypt"]["lowered"]:
        raise AssertionError("an AES graph was lowered")
    return record, launches


def plaintext_sgd(x, y, batch_size, n_batches, lr):
    """Float64 replica of ``spmd.logreg_train_step``'s math from zero
    weights (degree-3 polynomial sigmoid, plain SGD), as
    ``benchmarks/logreg.py:107-119``'s ``_plaintext_sgd`` at any width."""
    import numpy as np

    n_features = x.shape[1]
    w = np.zeros((n_features, 1))
    xb = x.reshape(n_batches, batch_size, n_features)
    yb = y.reshape(n_batches, batch_size, 1)
    for i in range(n_batches):
        t = xb[i] @ w
        preds = 0.5 + 0.19828547 * t - 0.00446928 * (t ** 3)
        grad = xb[i].T @ (preds - yb[i])
        w = w - (lr / batch_size) * grad
    return w


def spmd_training(torch, spmd, x, y, batch_size, lr, device):
    """``benchmarks/logreg.py``'s ``run_spmd`` workload on the port: from
    zero weights, one ``logreg_train_step`` a batch of ``batch_size``
    rows, each step under its own session key (``derive_step_keys``),
    its batch shared inside the step.  Returns the revealed weights as
    float64 numpy."""
    import numpy as np

    # run_spmd's master key
    mk = np.frombuffer(b"moose-tpu-logreg", dtype=np.uint32)
    n_batches = x.shape[0] // batch_size
    xb = torch.as_tensor(x, device=device).reshape(
        n_batches, batch_size, x.shape[1])
    yb = torch.as_tensor(y, device=device).reshape(n_batches, batch_size, 1)
    sess = spmd.SpmdSession(mk, device)
    w = spmd.fx_encode_share(
        sess, torch.zeros((x.shape[1], 1), dtype=torch.float64,
                          device=device), 24, 40, 128)
    # one copy of the (n, 4) key words to the host: a session's master
    # key is Python ints
    keys = spmd.derive_step_keys(mk, n_batches, device=device).tolist()
    for k, xi, yi in zip(keys, xb, yb):
        s = spmd.SpmdSession(k, device)
        xs = spmd.fx_encode_share(s, xi, 24, 40, 128)
        ys = spmd.fx_encode_share(s, yi, 24, 40, 128)
        w = spmd.logreg_train_step(s, xs, ys, w, lr)
    return spmd.fx_reveal_decode(w).cpu().numpy()


class TimedCluster:
    """A training cluster that times each session and each commit and
    counts the kernels each session launched (``LAUNCHES`` before and
    after, never reset).  With ``fail_at``, the ``fail_at``-th session
    (counting from 1) raises a retryable ``PeerUnreachableError`` once,
    after it ran and before its commit: a peer lost between an epoch's
    session and its commit."""

    def __init__(self, cluster, sync, rk, fail_at=None):
        self.cluster = cluster
        self.parties = cluster.parties
        self.sync = sync
        self.rk = rk
        self.fail_at = fail_at
        self.sessions = []  # (computation, seconds, launches, lowered)
        self.commit_s = []

    def run(self, comp, arguments, timeout):
        from moose_tpu_torch.errors import PeerUnreachableError

        before = dict(self.rk.LAUNCHES)
        self.sync()
        t0 = time.perf_counter()
        out = self.cluster.run(comp, arguments, timeout)
        self.sync()
        seconds = time.perf_counter() - t0
        self.sessions.append((
            comp, seconds,
            {k: v - before.get(k, 0) for k, v in self.rk.LAUNCHES.items()},
            self.cluster.runtime.last_plan.get("lowered"),
        ))
        if len(self.sessions) == self.fail_at:
            raise PeerUnreachableError(
                "injected: a peer lost after the session, before its commit")
        return out

    def control(self, party, cmd, **args):
        t0 = time.perf_counter()
        out = self.cluster.control(party, cmd, **args)
        if cmd == "commit":
            self.commit_s.append(time.perf_counter() - t0)
        return out

    def walls(self, comp):
        return [s for c, s, _, _ in self.sessions if c is comp]

    def launches(self, comp):
        return [n for c, _, n, _ in self.sessions if c is comp]


def committed_words(stores, trainer):
    """Every party's committed ``#s0``/``#s1`` limb planes."""
    import numpy as np

    return {(party, key): np.asarray(store.load(key))
            for party, store in stores.items()
            for key in trainer.expected_staged()}


def directory_bytes(root):
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def run_training_sessions(torch, rk, ring, pm, runtime_cls, device="cuda"):
    """Phase 20: secure training sessions, (a) to (e) of the module's
    docstring, with the port's runtimes on ``device`` (on the CPU, as
    the tests run it small, without the profiled epoch).  Returns
    (record, launches by path); raises on any failed check."""
    import os
    import tempfile

    import numpy as np

    from moose_tpu_torch.compilation import (
        DEFAULT_PASSES,
        compile_computation,
    )
    from moose_tpu_torch.compilation.lowering import (
        arg_specs_from_arguments,
    )
    from moose_tpu_torch.dialects import host
    from moose_tpu_torch.parallel import spmd
    from moose_tpu_torch.predictors.trainers import LogregSGDTrainer
    from moose_tpu_torch.storage import FilesystemStorage
    from moose_tpu_torch.training import (
        CheckpointStore,
        TrainingConfig,
        TrainingSession,
        export,
    )
    from moose_tpu_torch.training.session import LocalTrainingCluster

    ids = ["alice", "bob", "carole"]
    fixed = pm.fixed(24, 40)
    steps = SESSION_STEPS
    rows = SESSION_BATCH * steps
    on_card = torch.device(device).type == "cuda"
    x, y = training_data(np.random.default_rng(SEED), rows,
                         SESSION_FEATURES)

    def sync():
        torch.cuda.synchronize()

    def trainer_of(n_steps):
        return LogregSGDTrainer(
            n_features=SESSION_FEATURES, learning_rate=SESSION_LR,
            steps_per_epoch=n_steps, fixedpoint_dtype=fixed)

    def train(root, trainer, xs, ys, on=device, use_jit=False,
              fail_at=None):
        stores = {p: CheckpointStore(FilesystemStorage(
            os.path.join(root, p)), party=p) for p in ids}
        runtime = runtime_cls(ids, storage_mapping=stores,
                              use_jit=use_jit, device=on)
        cluster = TimedCluster(LocalTrainingCluster(runtime, ids), sync, rk,
                               fail_at)
        session = TrainingSession(trainer, cluster,
                                  TrainingConfig(epochs=SESSION_EPOCHS))
        return session, session.run(xs, ys), cluster, stores, runtime

    def reference(session, trainer, xs, ys):
        state = {"w": session._initial_value("w", (SESSION_FEATURES, 1))}
        for _ in range(SESSION_EPOCHS):
            state = trainer.reference_epoch(state, xs, ys)
        return state["w"]

    record, launches = {}, {}
    seeds = [0]
    mix_seed = ring.mix_seed

    def counted_mix_seed(*args, **kwargs):
        seeds[0] += 1
        return mix_seed(*args, **kwargs)

    # the walk derives each draw's seed on the host, as phase 18's does:
    # counted here, apart from the stacked paths' count
    ring.mix_seed = counted_mix_seed
    try:
        # (a) init and two epochs on the walk, then the export
        trainer = trainer_of(steps)
        epoch_comp = trainer.epoch_computation(rows)
        with tempfile.TemporaryDirectory() as root:
            rk.reset_launches()
            session, report, cluster, stores, runtime = train(
                root, trainer, x, y)
            launches["training_session"] = dict(rk.LAUNCHES)
            session_seeds = seeds[0]
            w = report["weights"]["w"]
            want = reference(session, trainer, x, y)
            if w.shape != want.shape or not np.all(np.isfinite(w)):
                raise AssertionError(f"trained weights malformed: {w.shape}")
            err = float(np.abs(w - want).max())
            epoch_s = cluster.walls(epoch_comp)
            epoch_launches = cluster.launches(epoch_comp)[0]
            n_dev = busy_ms = None
            if on_card:
                # one more epoch under the profiler; its stage is dropped
                n_dev, busy_ms = device_busy(
                    torch, lambda: runtime.evaluate_computation(
                        epoch_comp, {"x": x, "y": y}))
                for store in stores.values():
                    store.discard_staged()
            generation = {
                p: sum(np.asarray(store.load(k)).nbytes
                       for k in trainer.expected_staged())
                for p, store in stores.items()}
            record["session"] = {
                "rows": rows, "features": SESSION_FEATURES,
                "steps_per_epoch": steps, "epochs": report["epochs_committed"],
                "init_ms": cluster.walls(trainer.init_computation())[0] * 1e3,
                "epoch_ms": [s * 1e3 for s in epoch_s],
                "export_ms": cluster.walls(trainer.export_computation())[0]
                * 1e3,
                # one commit a party, three an epoch
                "commit_ms": [s * 1e3 for s in cluster.commit_s],
                "commit_fanout_ms": [
                    sum(cluster.commit_s[i:i + len(ids)]) * 1e3
                    for i in range(0, len(cluster.commit_s), len(ids))],
                "max_abs_err": err,
                "epoch_launches": epoch_launches,
                "epoch_k7_single_draws": epoch_launches["prf_threefry"]
                + epoch_launches["prf_threefry_pallas"],
                "host_seed_derivations": session_seeds,
                "epoch_device_launches": n_dev, "epoch_device_busy_ms":
                busy_ms,
                "epoch_device_idle_share": None if busy_ms is None else max(
                    0.0, 1.0 - busy_ms / (statistics.median(epoch_s) * 1e3)),
                "checkpoint_array_bytes_per_party": generation,
                "checkpoint_directory_bytes_per_party": {
                    p: directory_bytes(os.path.join(root, p)) for p in ids},
            }
        log(f"training session: {json.dumps(record['session'])} launches "
            f"{launches['training_session']}")
        if err >= SESSION_TOL:
            raise AssertionError(f"trained weights off by {err}")
        if report["epochs_committed"] != list(range(SESSION_EPOCHS + 1)):
            raise AssertionError(f"committed {report['epochs_committed']}")

        # (b) bit-exact resume under fixed keys: an uninterrupted run, a
        # run that loses a peer after epoch 2's session, and a fresh
        # driver over the resumed run's stores
        saved = _fixed_keys(os)
        try:
            rk.reset_launches()
            runs = {}
            for fault in (False, True):
                with tempfile.TemporaryDirectory() as root:
                    _, rep, cluster, stores, _ = train(
                        root, trainer, x, y,
                        fail_at=SESSION_EPOCHS + 1 if fault else None)
                    words = committed_words(stores, trainer)
                    again = None
                    if fault:
                        again = TrainingSession(
                            trainer_of(steps), LocalTrainingCluster(
                                runtime_cls(ids, storage_mapping=stores,
                                            use_jit=False, device=device),
                                ids),
                            TrainingConfig(epochs=SESSION_EPOCHS),
                        ).run(x, y)
                    runs[fault] = (rep, words, again)
            launches["training_resume"] = dict(rk.LAUNCHES)
        finally:
            _restore(os, saved)
        (clean, clean_words, _), (resumed, resumed_words, again) = (
            runs[False], runs[True])
        record["resume"] = {
            "resumes": resumed["resumes"],
            "attempts": {str(k): v for k, v in resumed["attempts"].items()},
            "words_equal": all(np.array_equal(clean_words[k],
                                              resumed_words[k])
                               for k in clean_words),
            "weights_equal": bool(np.array_equal(
                clean["weights"]["w"], resumed["weights"]["w"])),
            "fresh_driver_skipped": again["epochs_skipped"],
            "fresh_driver_committed": again["epochs_committed"],
            "fresh_driver_weights_equal": bool(np.array_equal(
                again["weights"]["w"], clean["weights"]["w"])),
        }
        log(f"training resume: {json.dumps(record['resume'])} launches "
            f"{launches['training_resume']}")
        if (clean["resumes"], resumed["resumes"]) != (0, 1):
            raise AssertionError(
                f"resumes {clean['resumes']}, {resumed['resumes']}")
        if not (record["resume"]["words_equal"]
                and record["resume"]["weights_equal"]
                and record["resume"]["fresh_driver_weights_equal"]):
            raise AssertionError("the resumed run is not bit-exact")
        if again["epochs_skipped"] != list(range(1, SESSION_EPOCHS + 1)) \
                or again["epochs_committed"]:
            raise AssertionError(f"a fresh driver replayed: {again}")

        # (c) the lowered route (use_jit=True: the epoch graph's estimated
        # size passes the segment limit), on the card and on the CPU under
        # the same fixed keys and pinned lowering nonces
        low_rows = SESSION_BATCH * SESSION_LOWERED_STEPS
        xl, yl = x[:low_rows], y[:low_rows]
        low = trainer_of(SESSION_LOWERED_STEPS)
        low_epoch = low.epoch_computation(low_rows)
        t0 = time.perf_counter()
        with host.deterministic_sync_keys(SEED):
            lowered = compile_computation(
                low_epoch, DEFAULT_PASSES,
                arg_specs_from_arguments({"x": xl, "y": yl}))
        lower_ms = (time.perf_counter() - t0) * 1e3
        saved = _fixed_keys(os)
        try:
            out = {}
            for on in (device, "cpu"):
                with tempfile.TemporaryDirectory() as root:
                    rk.reset_launches()
                    t0 = time.perf_counter()
                    with host.deterministic_sync_keys(SEED):
                        _, rep, cluster, stores, _ = train(
                            root, low, xl, yl, on=on, use_jit=True)
                    out[on] = (rep, committed_words(stores, low), cluster,
                               time.perf_counter() - t0, dict(rk.LAUNCHES))
        finally:
            _restore(os, saved)
        rep, words, cluster, card_s, launches["training_lowered"] = out[device]
        cpu_rep, cpu_words, _, cpu_s, _ = out["cpu"]
        lowered_routes = [lw for c, _, _, lw in cluster.sessions
                          if c is low_epoch]
        low_launches = cluster.launches(low_epoch)
        record["lowered"] = {
            "rows": low_rows, "steps_per_epoch": SESSION_LOWERED_STEPS,
            "lowering_host_ms": lower_ms, "ops": len(lowered.operations),
            "epoch_lowered": lowered_routes,
            "epoch_ms": [s * 1e3 for s in cluster.walls(low_epoch)],
            "run_s": card_s, "cpu_run_s": cpu_s,
            "words_equal_to_cpu": all(np.array_equal(words[k], cpu_words[k])
                                      for k in words),
            "weights_equal_to_cpu": bool(np.array_equal(
                rep["weights"]["w"], cpu_rep["weights"]["w"])),
            "max_abs_err": float(np.abs(rep["weights"]["w"] - reference(
                TrainingSession(low, None), low, xl, yl)).max()),
            "epoch_launches": low_launches[0],
        }
        log(f"training lowered: {json.dumps(record['lowered'])} launches "
            f"{launches['training_lowered']}")
        if lowered_routes != [True] * SESSION_EPOCHS:
            raise AssertionError(f"epochs not lowered: {lowered_routes}")
        if not (record["lowered"]["words_equal_to_cpu"]
                and record["lowered"]["weights_equal_to_cpu"]):
            raise AssertionError("the lowered epochs differ from the CPU's")
        if record["lowered"]["max_abs_err"] >= SESSION_TOL:
            raise AssertionError(
                f"lowered weights off by {record['lowered']['max_abs_err']}")
        # the lowered epoch holds the reference's composition: no fused
        # step
        for counts in low_launches:
            for name in ("trunc_combine", "trunc_pairs", "cross_terms_mul",
                         "cross_terms_reshare", "bit_decompose", "msb",
                         "horner"):
                if counts[name]:
                    raise AssertionError(f"a lowered epoch launched {name}")
    finally:
        ring.mix_seed = mix_seed

    # (d) and (e) run on the stacked protocol, whose seeds the card
    # derives: no seed on the host
    ring.mix_seed = counted_mix_seed
    seeds[0] = 0
    try:
        # (d) logreg_train_step: benchmarks/logreg.py's run_spmd
        # workload
        rk.reset_launches()
        sync()
        t0 = time.perf_counter()
        w_fit = spmd_training(torch, spmd, x, y, SESSION_BATCH, SESSION_LR,
                              device)
        sync()
        cold_s = time.perf_counter() - t0
        launches["logreg_train_step"] = dict(rk.LAUNCHES)
        sync()
        t0 = time.perf_counter()
        spmd_training(torch, spmd, x, y, SESSION_BATCH, SESSION_LR, device)
        sync()
        warm_s = time.perf_counter() - t0
        w_ref = plaintext_sgd(x, y, SESSION_BATCH, steps, SESSION_LR)
        traj_err = float(np.abs(w_fit - w_ref).max())
        record["logreg_train_step"] = {
            "steps": steps, "batch": SESSION_BATCH,
            "cold_ms_per_step": cold_s * 1e3 / steps,
            "ms_per_step": warm_s * 1e3 / steps,
            "trajectory_max_abs_err": traj_err,
        }
        log(f"logreg_train_step: {json.dumps(record['logreg_train_step'])} "
            f"launches {launches['logreg_train_step']}")
        if w_fit.shape != w_ref.shape or not np.all(np.isfinite(w_fit)):
            raise AssertionError(f"logreg_train_step malformed: {w_fit.shape}")
        if traj_err >= SESSION_TOL:
            raise AssertionError(
                f"logreg_train_step trajectory off by {traj_err}")

        # (e) (a)'s exported weights served as a logistic regression
        model = export.trained_predictor(w)
        request = np.random.default_rng(SEED + 1).normal(
            size=(TRAINED_ROWS, SESSION_FEATURES))
        runtime = runtime_cls(ids, device=device)
        rk.reset_launches()
        served, served_s = timed(torch, lambda: runtime.evaluate_computation(
            model.predictor_factory(fixed), {"x": request}))
        launches["trained_predictor"] = dict(rk.LAUNCHES)
        pred, want = served["output_0"], logistic_reference(model, request)
        if pred.shape != want.shape or not np.all(np.isfinite(pred)):
            raise AssertionError(f"trained predictor malformed: {pred.shape}")
        record["trained_predictor"] = {
            "rows": TRAINED_ROWS, "latency_ms": served_s * 1e3,
            "max_abs_err": float(np.abs(pred - want).max()),
            "layout": runtime.last_plan["layout"],
        }
        log(f"trained predictor: {json.dumps(record['trained_predictor'])} "
            f"launches {launches['trained_predictor']}")
        served_err = record["trained_predictor"]["max_abs_err"]
        if served_err >= LOGREG_TOL:
            raise AssertionError(f"trained predictor error {served_err}")
    finally:
        ring.mix_seed = mix_seed
    if seeds[0] and on_card:
        raise AssertionError(f"(d) and (e) derived {seeds[0]} host seeds")
    return record, launches


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        import moose_tpu_torch as pm
        from moose_tpu_torch.dialects import ring
        from moose_tpu_torch.native import build
        from moose_tpu_torch.native import ring_kernels as rk
        from moose_tpu_torch.runtime import LocalMooseRuntime
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    import numpy as np

    # phase 1: versions and the card
    nvcc = build.nvcc_path()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True,
        timeout=60,
    ).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc {nvcc_version}")
    smi = nvidia_smi_line()
    log(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 2: build
    build_s = build.build_all()
    log(f"build: {len(build.KERNELS)} kernels in {build_s:.2f} s")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "C7520" in line:
                log(f"  {name}: {line.strip()}")

    # phase 3: each kernel against its plain version on the card
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    # K1 at the secure dot, the predictors' logit (1024 x 101 @ 101 x 1),
    # the trainers' dots as phase 7 launches them (LogregSGDTrainer's
    # forward and x^T err, MLPSGDTrainer's hidden layer and x^T dh), a
    # contraction past one segment (K' = 6000 > 5504) and a tiny one
    t, f, h = TRAIN_ROWS, TRAIN_FEATURES, MLP_HIDDEN
    dot_rows = [
        compare_dot(torch, rk, ring, gen, DOT_N, DOT_N, DOT_N, 128, reps=5,
                    label="secure dot", yardstick=True),
        compare_dot(torch, rk, ring, gen, LINREG_ROWS, LINREG_FEATURES + 1,
                    1, 128, reps=20, label="LinearRegressor, logreg"),
        compare_dot(torch, rk, ring, gen, t, f, 1, 128, reps=20,
                    label="logreg trainer forward"),
        compare_dot(torch, rk, ring, gen, f, t, 1, 128, reps=20,
                    label="logreg trainer x^T err"),
        compare_dot(torch, rk, ring, gen, t, f, h, 128, reps=20,
                    label="MLP trainer hidden layer"),
        compare_dot(torch, rk, ring, gen, f, t, h, 128, reps=20,
                    label="MLP trainer x^T dh"),
        compare_dot(torch, rk, ring, gen, 256, 3000, 64, 128, reps=5,
                    label="two segments", device=True),
        compare_dot(torch, rk, ring, gen, DOT_N, DOT_N, DOT_N, 64, reps=5,
                    yardstick=True, device=True),
        compare_dot(torch, rk, ring, gen, 5, 7, 3, 128, reps=20),
        compare_dot(torch, rk, ring, gen, 5, 7, 3, 64, reps=20),
        compare_dot(torch, rk, ring, gen, MULTI_ROWS, MULTI_FEATURES + 1,
                    MULTI_CLASSES, 128, reps=20,
                    label="multinomial logits"),
    ] + [
        # the dense predictors' layers at batch 1024: the MLP's 100 -> 64
        # -> 32 -> 1, the network's 32 -> 10 head
        compare_dot(torch, rk, ring, gen, MLPC_ROWS, k, n, 128, reps=20,
                    label=label, device=True)
        for k, n, label in (
            (MLPC_FEATURES, MLPC_HIDDEN[0], "MLP layer 1"),
            (MLPC_HIDDEN[0], MLPC_HIDDEN[1], "MLP layer 2"),
            (MLPC_HIDDEN[1], 1, "MLP logit"),
            (NET_HIDDEN[1], NET_CLASSES, "network logits"),
        )
    ] + [
        # the ResNet's im2col contractions at batch 1024: the first 3x3
        # conv over 8x8 images of 3 channels, the block's two over the
        # pooled 4x4 maps of 4 channels, and the Gemm head
        compare_dot(torch, rk, ring, gen, m, k, n, 128, reps=20,
                    label=label, device=True)
        for m, k, n, label in (
            (RESNET_ROWS * RESNET_SIZE ** 2, 9 * RESNET_CH, RESNET_MID,
             "ResNet conv 1"),
            (RESNET_ROWS * (RESNET_SIZE // 2) ** 2, 9 * RESNET_MID,
             RESNET_MID, "ResNet block convs"),
            (RESNET_ROWS, RESNET_MID, RESNET_CLASSES, "ResNet Gemm"),
        )
    ]
    # K2: trunc_pairs at the logistic regression's (1024,) operand (first:
    # the main path's shape), transposed and broadcast, at 10^6 ring64, and
    # on the secure dot's cross terms; then the tail alone
    trunc_rows = [
        compare_trunc_pairs(torch, rk, gen, (PATH_N,), 128, 40, reps=20),
        compare_trunc_pairs(torch, rk, gen, (32, 32), 128, 40, reps=20,
                            view="transposed"),
        compare_trunc_pairs(torch, rk, gen, (4, PATH_N // 4), 128, 40,
                            reps=20, view="broadcast"),
        compare_trunc_pairs(torch, rk, gen, (DOT_N * DOT_N,), 64, 23,
                            reps=20),
        compare_trunc_pairs(torch, rk, gen, (DOT_N, DOT_N), 128,
                            DOT_PRECISION[1], reps=20, cross=True),
        compare_trunc(torch, rk, gen, (DOT_N, DOT_N), 128, DOT_PRECISION[1],
                      reps=20),
        compare_trunc(torch, rk, gen, (LINREG_ROWS, 1), 128, 40, reps=20),
        compare_trunc(torch, rk, gen, (DOT_N, DOT_N), 64, DOT_PRECISION[1],
                      reps=20),
        # the multinomial classifier's (1024, 10): fx_mul_public by 40,
        # exp's 2^x by k - 2 - f = 22, int2fl by max_bit_len - 1 - f = 23
        compare_trunc_pairs(torch, rk, gen, (MULTI_ROWS, MULTI_CLASSES), 128,
                            40, reps=20),
        compare_trunc_pairs(torch, rk, gen, (MULTI_ROWS, MULTI_CLASSES), 128,
                            22, reps=20),
        compare_trunc_pairs(torch, rk, gen, (MULTI_ROWS, MULTI_CLASSES), 128,
                            23, reps=20),
    ] + [
        # the MLP's hidden layers' dots and the correlation's centred
        # column, by 40
        compare_trunc_pairs(torch, rk, gen, shape, 128, 40, reps=20)
        for shape in ((MLPC_ROWS, MLPC_HIDDEN[0]), (MLPC_ROWS, MLPC_HIDDEN[1]),
                      (CORR_SIZES[-1], 1))
    ]
    # the protocol sigmoid's kernels, at the logistic regression's shapes
    # (which time launch latency) and at 2^20 elements
    # K3: the fused reshare spmd.mul runs, at the path's shapes (an
    # elementwise (1024,) product, the (64, 1024, 1) bit-weighted terms
    # against a (1, 1024, 1) factor) and at 2^20; then the unfused entry
    cross_rows = [
        compare_reshare(torch, rk, ring, gen, (PATH_N,), (PATH_N,), 128,
                        reps=20),
        compare_reshare(torch, rk, ring, gen, (64, PATH_N, 1),
                        (1, PATH_N, 1), 128, reps=20),
        compare_reshare(torch, rk, ring, gen, (BIG_N,), (BIG_N,), 128,
                        reps=5),
        compare_reshare(torch, rk, ring, gen, (BIG_N,), (BIG_N,), 64,
                        reps=5),
        compare_cross_mul(torch, rk, gen, (3, PATH_N), 128, reps=20),
        compare_cross_mul(torch, rk, gen, (3, 64, PATH_N), 128, reps=20),
        compare_cross_mul(torch, rk, gen, (3, BIG_N), 128, reps=5),
        compare_cross_mul(torch, rk, gen, (3, 64, PATH_N), 64, reps=20),
    ] + [
        # the tournament rounds over 10 classes: halves of (1024, 10),
        # (1024, 5) and (1024, 3), read in place as strided views
        compare_reshare(torch, rk, ring, gen, (MULTI_ROWS, m),
                        (MULTI_ROWS, m), 128, reps=20, halves=True)
        for m in (5, 2, 1)
    ] + [compare_reshare(torch, rk, ring, gen, (MULTI_ROWS, MULTI_CLASSES),
                         (MULTI_ROWS, MULTI_CLASSES), 128, reps=20)] + [
        # relu's x * b2a(msb) on the MLP's hidden layers, a forest mux of a
        # split's column against a leaf, the correlation's centred product
        compare_reshare(torch, rk, ring, gen, x_shape, y_shape, 128,
                        reps=20)
        for x_shape, y_shape in (
            ((MLPC_ROWS, MLPC_HIDDEN[0]),) * 2,
            ((MLPC_ROWS, MLPC_HIDDEN[1]),) * 2,
            ((FOREST_ROWS,), (1,)),
            ((CORR_SIZES[-1], 1),) * 2,
            # b2a's two multiplies in bit_compose, over the decrypted
            # block's 128 bits of every element of config 4's batch
            ((128, AES_ROWS, AES_FEATURES),) * 2,
        )
    ]
    # K4: the constant at its own shape, as the path passes it, then the
    # rows of earlier runs with it materialised at the shares' shape
    mul_rows = [
        compare_ring_mul(torch, rk, gen, (3, 2, PATH_N), (), 128, reps=20),
        compare_ring_mul(torch, rk, gen, (3, 2, 64, PATH_N), (64, 1), 128,
                         reps=20),
        compare_ring_mul(torch, rk, gen, (3, 2, BIG_N), (), 128, reps=5,
                         back_to_back=True),
        compare_ring_mul(torch, rk, gen, (3, 2, 64, PATH_N), (64, 1), 64,
                         reps=20),
        compare_ring_mul(torch, rk, gen, (3, 2, BIG_N), (), 64, reps=5,
                         back_to_back=True),
    ] + [
        compare_ring_mul(torch, rk, gen, shape, const, width, reps=reps,
                         back_to_back=shape[-1] == BIG_N, materialise=True)
        for shape, const, width, reps in (
            ((3, 2, PATH_N), (), 128, 20),
            ((3, 2, 64, PATH_N), (64, 1), 128, 20),
            ((3, 2, BIG_N), (), 128, 5),
            ((3, 2, 64, PATH_N), (64, 1), 64, 20),
            ((3, 2, BIG_N), (), 64, 5),
        )
    ] + [compare_ring_mul(torch, rk, gen, (3, 2, MULTI_ROWS, MULTI_CLASSES),
                          (), 128, reps=20, back_to_back=True)] + [
        # the MLP head's sigmoid constants on its (1024, 1) logit, the
        # correlation's Mean (1/n on a (1,) sum)
        compare_ring_mul(torch, rk, gen, shape, (), 128, reps=20,
                         back_to_back=True)
        for shape in ((3, 2, MLPC_ROWS, 1), (3, 2, 1))
    ] + [
        # bit_compose's 2^i weights on the 128 bits of config 4's batch
        compare_ring_mul(torch, rk, gen, (3, 2, 128, AES_ROWS, AES_FEATURES),
                         (128, 1, 1), 128, reps=5, back_to_back=True)
    ]
    # K5 at the logistic regression's 1024 elements, the trainers' 128
    # (LogregSGDTrainer) and 128 x 32 = 4096 (MLPSGDTrainer's hidden
    # layer), and at 2^20
    bits_rows = [
        compare_bits(torch, rk, gen, n, 128, msb_only, reps=20,
                     back_to_back=True, label=label)
        for n, label in ((PATH_N, "logistic regression"),
                         (TRAIN_ROWS, "LogregSGDTrainer"),
                         (TRAIN_ROWS * MLP_HIDDEN, "MLPSGDTrainer hidden"))
        for msb_only in (False, True)
    ] + [
        compare_bits(torch, rk, gen, BIG_N, 128, False, reps=3),
        compare_bits(torch, rk, gen, BIG_N, 128, True, reps=3),
        compare_bits(torch, rk, gen, PATH_N, 64, False, reps=20),
        # the multinomial classifier: msb of a tournament round's (1024, 5)
        # halves, the decomposition of exp's (1024, 10)
        compare_bits(torch, rk, gen, MULTI_ROWS * 5, 128, True, reps=20,
                     back_to_back=True, label="(1024,5) tournament halves"),
        compare_bits(torch, rk, gen, MULTI_ROWS * MULTI_CLASSES, 128, False,
                     reps=20, back_to_back=True, label="(1024,10) exp"),
    ] + [
        # relu's msb on the MLP's hidden layers and the forest's one less
        # over every split
        compare_bits(torch, rk, gen, n, 128, True, reps=20,
                     back_to_back=True, label=label)
        for n, label in (
            (MLPC_ROWS * MLPC_HIDDEN[0], "MLP relu (1024,64)"),
            (MLPC_ROWS * MLPC_HIDDEN[1], "MLP relu (1024,32)"),
            (FOREST_ROWS * FOREST_TREES * (2 ** FOREST_DEPTH - 1),
             "forest splits (1024,120)"),
            # the ResNet's first relu over (1024,8,8,4) and its max pool's
            # first round over (1024,4,4,2,4) halves
            (RESNET_ROWS * RESNET_SIZE ** 2 * RESNET_MID,
             "ResNet relu (1024,8,8,4)"),
            (RESNET_ROWS * RESNET_SIZE ** 2 * RESNET_MID // 2,
             "ResNet max pool round 1"),
        )
    ]
    horner_rows = [
        compare_horner(torch, rk, gen, PATH_N, 128, HORNER_STEPS, HORNER_F,
                       reps=20),
        compare_horner(torch, rk, gen, BIG_N, 128, HORNER_STEPS, HORNER_F,
                       reps=5),
        compare_horner(torch, rk, gen, PATH_N, 64, 9, 35, reps=20),
        # the multinomial classifier's exp at (1024, 10), past the three-
        # lane variant's 4,096 elements; log2's Pade ladders (negative
        # raws, 3 steps) at fixed(24,40) and fixed(14,23)
        compare_horner(torch, rk, gen, MULTI_ROWS * MULTI_CLASSES, 128,
                       HORNER_STEPS, HORNER_F, reps=20),
        compare_horner(torch, rk, gen, MULTI_ROWS * MULTI_CLASSES, 128, 3, 40,
                       reps=20, coeffs="P_2524"),
        compare_horner(torch, rk, gen, MULTI_ROWS * MULTI_CLASSES, 128, 3, 40,
                       reps=20, coeffs="Q_2524"),
        compare_horner(torch, rk, gen, PATH_N, 128, 3, 23, reps=20,
                       coeffs="P_2524"),
        # the correlation's Sqrt: log2's Pade ladders on one element
        compare_horner(torch, rk, gen, 1, 128, 3, 40, reps=20,
                       coeffs="P_2524"),
    ]
    # K7 grouped, as the session draws: the logistic regression's Horner
    # group (14 steps of a (3, 1024) bank and five (1024,) draws,
    # ring128), its adder group (16 bit banks of (3, 128, 1024)), a
    # truncation group of 6 at the secure dot's 10^6 ring128 and a group
    # of one at 2^20 words
    horner_group = ([("w128", 3 * PATH_N)] + [("w128", PATH_N)] * 5) \
        * HORNER_STEPS
    group_rows = [
        compare_group(torch, rk, ring, draws, layout, reps, label)
        for layout in ("threefry", "threefry-pallas")
        for draws, reps, label in (
            (horner_group, 20, "Horner, 84 draws at (3,1024) ring128"),
            ([("bits", 3 * 128 * LOGREG_ROWS)] * 16, 20,
             "adder, 16 bit banks of (3,128,1024)"),
            ([("w128", 3 * DOT_N * DOT_N)] + [("w128", DOT_N * DOT_N)] * 5,
             5, "truncation, 6 at the secure dot's 10^6 ring128"),
            ([("w64", BIG_N)], 20, "one draw of 2^20 words"),
            ([("bits", 3 * (64 >> j) * MULTI_ROWS * MULTI_CLASSES)
              for j in range(7)], 20,
             "equal_zero_bit's OR tree, 7 bit banks at (1024,10)"),
            ([("bits", 3 * 128 * MLPC_ROWS * MLPC_HIDDEN[0])] * 16, 5,
             "MLP relu's adder, 16 bit banks of (3,128,65536)"),
        )
    ]
    # the ResNet's first relu: 16 bit banks of (3,128,262144), the
    # widest group of any path, timed and bounded; its words are held to
    # the plain version at the MLP relu's 65,536 elements above
    group_rows += [
        time_group(torch, rk, [("bits", 3 * 128 * RESNET_ROWS
                                * RESNET_SIZE ** 2 * RESNET_MID)] * 16,
                   layout, reps=5,
                   label="ResNet relu's adder, 16 bit banks of "
                         "(3,128,262144)")
        for layout in ("threefry", "threefry-pallas")
    ]
    # K7 under a given key, one draw: the trainer's largest (sharing its
    # 128x100 ring128 batch), the logistic regression's bit banks
    # (3, 128, 1024), 2^20 words and the secure dot's (2, 3, 1000, 1000)
    threefry_rows = group_rows + [
        compare_threefry(torch, rk, n, layout, bits, reps, label)
        for layout in ("threefry-pallas", "threefry")
        for n, bits, reps, label in (
            (2 * 3 * TRAIN_ROWS * TRAIN_FEATURES, False, 20,
             "trainer's largest draw"),
            (3 * 128 * LOGREG_ROWS, True, 20,
             "logistic regression's bit banks"),
            (BIG_N, False, 20, "2^20 words"),
            (2 * 3 * DOT_N * DOT_N, False, 5, "secure dot's (2,3,1000,1000)"),
        )
    ]
    # the per-host layout's shapes (phase 18): K1 at one party (the
    # secure dot's and the logistic regression's per-party products) and
    # in its product-only mode (the host-only graph's host Dot), K3
    # unfused and K4 on a (1024, 1) share, K7's single draws of a
    # (1024, 1) ring128 mask and of the (128, 1024, 1) zero-share bits
    dot_rows += [
        compare_party_dot(torch, rk, ring, gen, DOT_N, DOT_N, DOT_N, 128,
                          reps=5, label="per-host secure dot, one party"),
        compare_party_dot(torch, rk, ring, gen, LOGREG_ROWS,
                          LOGREG_FEATURES + 1, 1, 128, reps=20,
                          label="per-host logreg, one party"),
        # phase 20's per-host training step at the trainer width: x @ w
        # and x^T err, one party
        compare_party_dot(torch, rk, ring, gen, SESSION_BATCH,
                          SESSION_FEATURES, 1, 128, reps=20,
                          label="per-host trainer forward, one party"),
        compare_party_dot(torch, rk, ring, gen, SESSION_FEATURES,
                          SESSION_BATCH, 1, 128, reps=20,
                          label="per-host trainer x^T err, one party"),
        compare_ring_matmul(torch, rk, gen, LOGREG_ROWS, LOGREG_FEATURES, 2,
                            128, reps=20, label="per-host host Dot"),
        compare_ring_matmul(torch, rk, gen, DOT_N, DOT_N, DOT_N, 128,
                            reps=5, label="host ring Dot at 1000^3"),
    ]
    cross_rows.append(compare_cross_mul(torch, rk, gen, (PATH_N, 1), 128,
                                        reps=20))
    mul_rows.append(compare_ring_mul(torch, rk, gen, (PATH_N, 1),
                                     (PATH_N, 1), 128, reps=20,
                                     back_to_back=True))
    threefry_rows += [
        compare_threefry(torch, rk, 2 * PATH_N, layout, False, 20,
                         "per-host draw at (1024,1) ring128")
        for layout in ("threefry", "threefry-pallas")
    ] + [compare_threefry(torch, rk, 128 * PATH_N, "threefry", True, 20,
                          "per-host zero-share bits at (128,1024,1)")]
    rows_by_kernel = {
        "dot_cross_terms": dot_rows, "trunc_combine": trunc_rows,
        "cross_terms_mul": cross_rows, "ring_mul": mul_rows,
        "bits_adder": bits_rows, "horner": horner_rows,
        "threefry": threefry_rows,
    }
    for name, rows in rows_by_kernel.items():
        for row in rows:
            log(f"compare {name}: {json.dumps(row)}")
            # equal is None on a row timed without its plain version
            if row["equal"] is False:
                raise AssertionError(f"{name} disagrees with plain: {row}")
    torch.cuda.empty_cache()
    protocol_device_launches = protocol_launches(torch, rk)

    # the main path derives no seed on the host: count ring.mix_seed
    host_seeds = [0]
    mix_seed = ring.mix_seed

    def counted_mix_seed(*args, **kwargs):
        host_seeds[0] += 1
        return mix_seed(*args, **kwargs)

    ring.mix_seed = counted_mix_seed

    # every evaluation records the layout it ran on, by phase
    layouts = {}
    phase = [3]
    evaluate = LocalMooseRuntime.evaluate_computation

    def recorded(self, *args, **kwargs):
        out = evaluate(self, *args, **kwargs)
        layouts.setdefault(phase[0], set()).add(
            self.last_plan.get("layout"))
        return out

    LocalMooseRuntime.evaluate_computation = recorded

    phase[0] = 4
    # phase 4: the eDSL secure dot through the runtime (main path)
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(DOT_N, DOT_N))
    y = rng.normal(size=(DOT_N, DOT_N))
    runtime = LocalMooseRuntime(["alice", "bob", "carole"])
    comp = secure_dot_computation(pm)
    rk.reset_launches()
    out, dot_s = timed(
        torch, lambda: runtime.evaluate_computation(comp, {"x": x, "y": y})
    )
    dot_launches = dict(rk.LAUNCHES)
    z = out["output_0"]
    dot_err = float(np.abs(z - x @ y).max())
    log(f"secure_dot: {DOT_N}x{DOT_N} fixed{DOT_PRECISION} ring128 "
        f"latency {dot_s * 1e3:.3f} ms max_abs_err {dot_err:.3e} "
        f"launches {dot_launches}")
    if z.shape != (DOT_N, DOT_N) or not np.all(np.isfinite(z)):
        raise AssertionError(f"secure dot output malformed: {z.shape}")
    if dot_err >= DOT_TOL:
        raise AssertionError(f"secure dot error {dot_err} >= {DOT_TOL}")
    warm = [
        timed(torch, lambda: runtime.evaluate_computation(
            comp, {"x": x, "y": y}))[1]
        for _ in range(3)
    ]
    log(f"secure_dot: warm latency median "
        f"{statistics.median(warm) * 1e3:.3f} ms over {len(warm)} runs")

    phase[0] = 5
    # phase 5: ONNX LinearRegressor, three requests (main path)
    predictor = linear_regressor(rng, LINREG_FEATURES)
    linreg = predictor.predictor_factory()
    requests = [
        rng.normal(size=(LINREG_ROWS, LINREG_FEATURES))
        for _ in range(LINREG_REQUESTS)
    ]
    rk.reset_launches()
    latencies, linreg_errs = [], []
    for xr in requests:
        out, s = timed(
            torch, lambda: runtime.evaluate_computation(linreg, {"x": xr})
        )
        pred = out["output_0"]
        want = xr @ predictor.coeffs.T + predictor.intercepts
        if pred.shape != want.shape or not np.all(np.isfinite(pred)):
            raise AssertionError(f"prediction malformed: {pred.shape}")
        linreg_errs.append(float(np.abs(pred - want).max()))
        latencies.append(s)
    linreg_launches = dict(rk.LAUNCHES)
    rows_per_s = LINREG_ROWS * LINREG_REQUESTS / sum(latencies)
    log(f"linear_regressor: {LINREG_REQUESTS} requests of {LINREG_ROWS}x"
        f"{LINREG_FEATURES} fixed(24, 40) latencies_ms "
        f"{[round(s * 1e3, 3) for s in latencies]} rows_per_s "
        f"{rows_per_s:.1f} max_abs_err {max(linreg_errs):.3e} "
        f"launches {linreg_launches}")
    if max(linreg_errs) >= LINREG_TOL:
        raise AssertionError(
            f"linear regressor error {max(linreg_errs)} >= {LINREG_TOL}"
        )

    phase[0] = 6
    # phase 6: ONNX logistic regression, three requests (main path)
    classifier = logistic_regression(rng, LOGREG_FEATURES)
    logreg = classifier.predictor_factory()
    requests = [
        rng.normal(size=(LOGREG_ROWS, LOGREG_FEATURES))
        for _ in range(LOGREG_REQUESTS)
    ]
    rk.reset_launches()
    logreg_latencies, logreg_errs = [], []
    for xr in requests:
        out, s = timed(
            torch, lambda: runtime.evaluate_computation(logreg, {"x": xr})
        )
        pred = out["output_0"]
        want = logistic_reference(classifier, xr)
        if pred.shape != want.shape or not np.all(np.isfinite(pred)):
            raise AssertionError(f"logreg output malformed: {pred.shape}")
        logreg_errs.append(float(np.abs(pred - want).max()))
        logreg_latencies.append(s)
    logreg_launches = dict(rk.LAUNCHES)
    logreg_device_launches = device_launches(
        torch, lambda: runtime.evaluate_computation(logreg,
                                                    {"x": requests[0]}))
    logreg_rows_per_s = (LOGREG_ROWS * LOGREG_REQUESTS
                         / sum(logreg_latencies))
    log(f"logistic_regression: {LOGREG_REQUESTS} requests of {LOGREG_ROWS}x"
        f"{LOGREG_FEATURES} fixed(24, 40) latencies_ms "
        f"{[round(s * 1e3, 3) for s in logreg_latencies]} rows_per_s "
        f"{logreg_rows_per_s:.1f} max_abs_err {max(logreg_errs):.3e} "
        f"launches {logreg_launches} device launches a request "
        f"{logreg_device_launches}")
    if max(logreg_errs) >= LOGREG_TOL:
        raise AssertionError(
            f"logistic regression error {max(logreg_errs)} >= {LOGREG_TOL}"
        )

    phase[0] = 7
    # phase 7: secure training under threefry-pallas (main path)
    ring.set_prf_impl("threefry-pallas")
    try:
        training = run_training(torch, rk, runtime, rng)
        training["logreg_device_launches"] = step_device_launches(
            torch, runtime, rng)
    finally:
        ring.set_prf_impl("threefry")

    phase[0] = 8
    # phase 8: ONNX multinomial logistic regression, three requests (main
    # path)
    multi = multinomial_regression(rng, MULTI_FEATURES)
    multi_comp = multi.predictor_factory()
    requests = [
        rng.normal(size=(MULTI_ROWS, MULTI_FEATURES))
        for _ in range(MULTI_REQUESTS)
    ]
    rk.reset_launches()
    multi_latencies, multi_errs, multi_agree = [], [], []
    for xr in requests:
        out, s = timed(
            torch, lambda: runtime.evaluate_computation(multi_comp, {"x": xr})
        )
        pred = out["output_0"]
        want = softmax_reference(multi, xr)
        if pred.shape != want.shape or not np.all(np.isfinite(pred)):
            raise AssertionError(f"multinomial output malformed: {pred.shape}")
        multi_errs.append(float(np.abs(pred - want).max()))
        multi_agree.append(float(np.mean(
            pred.argmax(axis=1) == want.argmax(axis=1))))
        multi_latencies.append(s)
    multi_launches = dict(rk.LAUNCHES)
    multi_device_launches = device_launches(
        torch, lambda: runtime.evaluate_computation(multi_comp,
                                                    {"x": requests[0]}))
    multi_rows_per_s = MULTI_ROWS * MULTI_REQUESTS / sum(multi_latencies)
    log(f"multinomial_regression: {MULTI_REQUESTS} requests of {MULTI_ROWS}x"
        f"{MULTI_FEATURES}, {MULTI_CLASSES} classes, fixed(24, 40) "
        f"latencies_ms {[round(s * 1e3, 3) for s in multi_latencies]} "
        f"rows_per_s {multi_rows_per_s:.1f} max_abs_err "
        f"{max(multi_errs):.3e} argmax_agreement {min(multi_agree):.4f} "
        f"launches {multi_launches} device launches a request "
        f"{multi_device_launches}")
    if max(multi_errs) >= MULTI_TOL:
        raise AssertionError(
            f"multinomial error {max(multi_errs)} >= {MULTI_TOL}")
    if min(multi_agree) < MULTI_ARGMAX_AGREEMENT:
        raise AssertionError(
            f"multinomial argmax agreement {min(multi_agree)} < "
            f"{MULTI_ARGMAX_AGREEMENT}")

    phase[0] = 9
    # phase 9: the protocol library through the eDSL, every kind it
    # brought in one traced computation
    library_args = library_inputs(rng)
    library = library_computation(pm)
    rk.reset_launches()
    out, library_s = timed(
        torch, lambda: runtime.evaluate_computation(library, library_args))
    library_launches = dict(rk.LAUNCHES)
    library_errs, failed = library_errors(out, library_args)
    log(f"protocol_library: {len(LIBRARY_KINDS)} kinds at ({LIBRARY_ROWS}, "
        f"{LIBRARY_COLS}) fixed(24, 40) latency {library_s * 1e3:.3f} ms "
        f"max_abs_errs {json.dumps(library_errs)} launches "
        f"{library_launches}")
    if failed:
        raise AssertionError(
            f"protocol library kinds past their tolerance: {failed} "
            f"({library_errs})")

    phase[0] = 10
    # phase 10: BASELINE config 2, the scientific-computing tutorial's
    # correlation: the columns in the departments' storage, the result
    # read back from the data scientist's (main path)
    corr_comp = correlation_computation(pm)
    rk.reset_launches()
    correlation = []
    for n in CORR_SIZES:
        alcohol, grades = correlated_columns(n)
        np_corr = float(np.corrcoef(alcohol.ravel(), grades.ravel())[1, 0])
        for run in ("first", "again"):
            before = dict(rk.LAUNCHES)
            (value, _), s = timed(torch, lambda: run_correlation(
                LocalMooseRuntime, corr_comp, alcohol, grades))
            k7 = sum(rk.LAUNCHES[c] - before[c]
                     for c in ("prf_threefry", "prf_threefry_pallas"))
            if type(value) is not np.ndarray or value.shape != () \
                    or value.dtype != np.float64 or not np.isfinite(value):
                raise AssertionError(
                    f"correlation result malformed: {value!r}")
            err = abs(float(value) - np_corr)
            correlation.append({"n": n, "run": run, "wall_ms": s * 1e3,
                                "correlation": float(value),
                                "numpy": np_corr, "abs_err": err,
                                "k7_groups": k7})
            log(f"correlation: n={n} ({run}) fixed{CORR_PRECISION} wall "
                f"{s * 1e3:.3f} ms correlation {float(value):.6f} numpy "
                f"{np_corr:.6f} abs_err {err:.3e} K7 groups {k7}")
            if err >= CORR_TOL:
                raise AssertionError(
                    f"correlation at n={n}: error {err} >= {CORR_TOL}")
    corr_launches = dict(rk.LAUNCHES)
    log(f"correlation: launches {corr_launches}")

    phase[0] = 11
    # phase 11: BASELINE config 5's MLP, the binary sklearn MLPClassifier
    # (100 -> 64 -> 32 -> 1, relu), through from_onnx and
    # predictor_factory, three requests (main path)
    from moose_tpu_torch import predictors
    from moose_tpu_torch.predictors import from_onnx, sklearn_export

    mlp = from_onnx(sklearn_export.mlp_onnx(
        mlp_model(rng, MLPC_FEATURES, MLPC_HIDDEN), MLPC_FEATURES,
        classifier=True))
    if not isinstance(mlp, predictors.MLPClassifier):
        raise AssertionError(f"from_onnx gave {type(mlp).__name__}")
    mlp_comp = mlp.predictor_factory()
    requests = [rng.normal(size=(MLPC_ROWS, MLPC_FEATURES))
                for _ in range(MLPC_REQUESTS)]
    rk.reset_launches()
    mlp_latencies, mlp_errs = [], []
    for xr in requests:
        out, s = timed(
            torch, lambda: runtime.evaluate_computation(mlp_comp, {"x": xr}))
        pred = out["output_0"]
        want = dense_reference(mlp, xr)
        if pred.shape != want.shape or not np.all(np.isfinite(pred)):
            raise AssertionError(f"MLP output malformed: {pred.shape}")
        mlp_errs.append(float(np.abs(pred - want).max()))
        mlp_latencies.append(s)
    mlp_launches = dict(rk.LAUNCHES)
    mlp_device_launches = device_launches(
        torch, lambda: runtime.evaluate_computation(mlp_comp,
                                                    {"x": requests[0]}))
    mlp_rows_per_s = MLPC_ROWS * MLPC_REQUESTS / sum(mlp_latencies)
    log(f"mlp_classifier: {MLPC_REQUESTS} requests of {MLPC_ROWS}x"
        f"{MLPC_FEATURES}, hidden {MLPC_HIDDEN} relu, fixed(24, 40) "
        f"latencies_ms {[round(s * 1e3, 3) for s in mlp_latencies]} "
        f"rows_per_s {mlp_rows_per_s:.1f} max_abs_err {max(mlp_errs):.3e} "
        f"launches {mlp_launches} device launches a request "
        f"{mlp_device_launches}")
    if max(mlp_errs) >= MLPC_TOL:
        raise AssertionError(f"MLP error {max(mlp_errs)} >= {MLPC_TOL}")

    phase[0] = 12
    # phase 12: a pytorch-layout NeuralNetwork (100 -> 64 relu -> 32 relu
    # -> 10 softmax), one request (main path)
    net = from_onnx(sklearn_export.pytorch_nn_onnx(
        *network_layers(rng, MLPC_FEATURES, NET_HIDDEN, NET_CLASSES),
        MLPC_FEATURES))
    if not isinstance(net, predictors.NeuralNetwork):
        raise AssertionError(f"from_onnx gave {type(net).__name__}")
    xr = rng.normal(size=(NET_ROWS, MLPC_FEATURES))
    net_comp = net.predictor_factory()
    rk.reset_launches()
    out, net_s = timed(
        torch, lambda: runtime.evaluate_computation(net_comp, {"x": xr}))
    net_launches = dict(rk.LAUNCHES)
    pred, want = out["output_0"], dense_reference(net, xr)
    if pred.shape != want.shape or not np.all(np.isfinite(pred)):
        raise AssertionError(f"network output malformed: {pred.shape}")
    net_err = float(np.abs(pred - want).max())
    net_agree = float(np.mean(pred.argmax(axis=1) == want.argmax(axis=1)))
    log(f"neural_network: {NET_ROWS}x{MLPC_FEATURES}, hidden {NET_HIDDEN} "
        f"relu, {NET_CLASSES}-class softmax, fixed(24, 40) latency "
        f"{net_s * 1e3:.3f} ms max_abs_err {net_err:.3e} argmax_agreement "
        f"{net_agree:.4f} launches {net_launches}")
    if net_err >= MULTI_TOL:
        raise AssertionError(f"network error {net_err} >= {MULTI_TOL}")
    if net_agree < MULTI_ARGMAX_AGREEMENT:
        raise AssertionError(
            f"network argmax agreement {net_agree} < "
            f"{MULTI_ARGMAX_AGREEMENT}")

    phase[0] = 13
    # phase 13: a random forest, one request (main path)
    forest = from_onnx(sklearn_export.random_forest_classifier_onnx(
        forest_model(rng, FOREST_TREES, FOREST_DEPTH, FOREST_FEATURES),
        FOREST_FEATURES))
    if not isinstance(forest, predictors.TreeEnsembleClassifier):
        raise AssertionError(f"from_onnx gave {type(forest).__name__}")
    splits = sum(len(tree.inner_nodes()) for tree in forest.trees)
    xr = rng.normal(size=(FOREST_ROWS, FOREST_FEATURES))
    forest_comp = forest.predictor_factory()
    rk.reset_launches()
    out, forest_s = timed(
        torch, lambda: runtime.evaluate_computation(forest_comp, {"x": xr}))
    forest_launches = dict(rk.LAUNCHES)
    pred, want = out["output_0"], forest_reference(forest, xr)
    if pred.shape != want.shape or not np.all(np.isfinite(pred)):
        raise AssertionError(f"forest output malformed: {pred.shape}")
    forest_err = float(np.abs(pred - want).max())
    log(f"random_forest: {FOREST_TREES} trees of depth {FOREST_DEPTH}, "
        f"{FOREST_FEATURES} features, {FOREST_ROWS} rows, fixed(24, 40) "
        f"latency {forest_s * 1e3:.3f} ms max_abs_err {forest_err:.3e}; "
        f"one less over ({FOREST_ROWS}, {splits}) = "
        f"{FOREST_ROWS * splits} elements; launches {forest_launches}")
    if forest_err >= FOREST_TOL:
        raise AssertionError(f"forest error {forest_err} >= {FOREST_TOL}")

    phase[0] = 14
    # phase 14: BASELINE config 5's small ResNet through from_onnx and
    # predictor_factory, three requests of NCHW images (main path)
    resnet_proto, resnet_params = sklearn_export.resnet_block_onnx(
        seed=SEED, in_ch=RESNET_CH, mid_ch=RESNET_MID, size=RESNET_SIZE,
        n_classes=RESNET_CLASSES)
    resnet = from_onnx(resnet_proto)
    if not isinstance(resnet, predictors.ConvNet):
        raise AssertionError(f"from_onnx gave {type(resnet).__name__}")
    resnet_comp = resnet.predictor_factory()
    requests = [
        rng.normal(size=(RESNET_ROWS, RESNET_CH, RESNET_SIZE, RESNET_SIZE))
        * 0.5 for _ in range(RESNET_REQUESTS)
    ]
    rk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    resnet_latencies, resnet_errs, resnet_agree = [], [], []
    for xr in requests:
        out, s = timed(torch, lambda: runtime.evaluate_computation(
            resnet_comp, {"x": xr}))
        pred, want = out["output_0"], resnet_reference(resnet_params, xr)
        if pred.shape != want.shape or not np.all(np.isfinite(pred)):
            raise AssertionError(f"ResNet output malformed: {pred.shape}")
        resnet_errs.append(float(np.abs(pred - want).max()))
        resnet_agree.append(
            float(np.mean(pred.argmax(axis=1) == want.argmax(axis=1))))
        resnet_latencies.append(s)
    resnet_launches = dict(rk.LAUNCHES)
    resnet_device_launches, resnet_busy_ms = device_busy(
        torch, lambda: runtime.evaluate_computation(resnet_comp,
                                                    {"x": requests[0]}))
    resnet_wall_ms = statistics.median(resnet_latencies) * 1e3
    resnet_rows_per_s = RESNET_ROWS * RESNET_REQUESTS / sum(resnet_latencies)
    resnet_record = {
        "latency_ms": [s * 1e3 for s in resnet_latencies],
        "rows_per_s": resnet_rows_per_s,
        "max_abs_err": max(resnet_errs),
        "argmax_agreement": min(resnet_agree),
        "device_launches": resnet_device_launches,
        "device_busy_ms": resnet_busy_ms,
        "device_idle_share": max(0.0, 1.0 - resnet_busy_ms / resnet_wall_ms),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    log(f"resnet: {RESNET_REQUESTS} requests of {RESNET_ROWS}x{RESNET_CH}x"
        f"{RESNET_SIZE}x{RESNET_SIZE}, mid {RESNET_MID}, {RESNET_CLASSES} "
        f"classes, fixed(24, 40) {json.dumps(resnet_record)} launches "
        f"{resnet_launches}")
    if max(resnet_errs) >= RESNET_TOL:
        raise AssertionError(
            f"ResNet error {max(resnet_errs)} >= {RESNET_TOL}")
    if min(resnet_agree) < MULTI_ARGMAX_AGREEMENT:
        raise AssertionError(
            f"ResNet argmax agreement {min(resnet_agree)} < "
            f"{MULTI_ARGMAX_AGREEMENT}")

    phase[0] = 15
    # phase 15: BASELINE config 4, encrypted-input inference at config 3's
    # width through AesWrapper(LinearClassifier), three requests (main
    # path)
    from moose_tpu_torch.dialects import aes

    aes_fixed = pm.fixed(*AES_PRECISION)
    aes_model = logistic_regression(rng, AES_FEATURES, aes=True)
    if type(aes_model).__name__ != "AesLinearClassifier":
        raise AssertionError(f"AesWrapper gave {type(aes_model).__name__}")
    aes_comp = aes_inference_computation(pm, aes_model, aes_fixed)
    key, nonce = aes_key_nonce()
    aes_key = aes.bytes_to_bits_be(key)
    requests = [rng.normal(size=(AES_ROWS, AES_FEATURES))
                for _ in range(AES_REQUESTS)]
    t0 = time.perf_counter()
    wires = [aes.encrypt_fixed_array(key, nonce, xr, AES_PRECISION[1])
             for xr in requests]
    encrypt_s = (time.perf_counter() - t0) / AES_REQUESTS
    if wires[0].shape != (224, AES_ROWS, AES_FEATURES):
        raise AssertionError(f"wire array of shape {wires[0].shape}")

    def aes_args(wire):
        return {"aes_data": wire, "aes_key": aes_key}

    rk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    aes_latencies, aes_errs = [], []
    for xr, wire in zip(requests, wires):
        out, s = timed(torch, lambda: runtime.evaluate_computation(
            aes_comp, aes_args(wire)))
        pred, want = out["output_0"], logistic_reference(aes_model, xr)
        if pred.shape != want.shape or not np.all(np.isfinite(pred)):
            raise AssertionError(f"AES output malformed: {pred.shape}")
        aes_errs.append(float(np.abs(pred - want).max()))
        aes_latencies.append(s)
    aes_launches = dict(rk.LAUNCHES)
    aes_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    aes_device_launches, aes_busy_ms = device_busy(
        torch, lambda: runtime.evaluate_computation(aes_comp,
                                                    aes_args(wires[0])))
    # the wrapper's own predictor is the linear map (the reference's
    # AesInputMixin runs predictor_fn without the post-transform)
    logits = runtime.evaluate_computation(
        aes_model.aes_predictor_factory(aes_fixed),
        aes_args(wires[0]))["output_0"]
    z = requests[0] @ aes_model.coeffs[1] + aes_model.intercepts[0, 1]
    logits_err = float(np.abs(logits - np.stack([-z, z], axis=1)).max())
    # Decrypt alone: the client's fixed-point encoding, exactly
    decrypted, decrypt_s = timed(torch, lambda: runtime.evaluate_computation(
        decrypt_computation(pm, aes_fixed), aes_args(wires[0])))
    exact = np.round(requests[0] * 2.0 ** AES_PRECISION[1]) \
        / 2.0 ** AES_PRECISION[1]
    decrypt_exact = bool(np.array_equal(decrypted["output_0"], exact))
    aes_wall_ms = statistics.median(aes_latencies) * 1e3
    aes_record = {
        "latency_ms": [s * 1e3 for s in aes_latencies],
        "rows_per_s": AES_ROWS * AES_REQUESTS / sum(aes_latencies),
        "max_abs_err": max(aes_errs),
        "client_encrypt_ms": encrypt_s * 1e3,
        "k7_groups": aes_launches["prf_threefry"] / AES_REQUESTS,
        "device_launches": aes_device_launches,
        "device_busy_ms": aes_busy_ms,
        "device_idle_share": max(0.0, 1.0 - aes_busy_ms / aes_wall_ms),
        "peak_memory_gib": aes_peak_gib,
        "wrapper_logits_max_abs_err": logits_err,
        "decrypt_only_ms": decrypt_s * 1e3,
        "decrypt_only_exact": decrypt_exact,
    }
    log(f"aes_inference: {AES_REQUESTS} requests of {AES_ROWS}x"
        f"{AES_FEATURES} AES-GCM-encrypted rows, fixed{AES_PRECISION} "
        f"{json.dumps(aes_record)} launches {aes_launches}")
    if max(aes_errs) >= AES_TOL:
        raise AssertionError(f"AES inference error {max(aes_errs)} >= "
                             f"{AES_TOL}")
    if logits_err >= LINREG_TOL:
        raise AssertionError(f"AES wrapper logits error {logits_err}")
    if not decrypt_exact:
        raise AssertionError("Decrypt's output is not the encoded input")

    # the threefry paths are done: aes-ctr derives its seeds on the host
    ring.mix_seed = mix_seed

    phase[0] = 16
    # phase 16: BASELINE config 4's share generation under the
    # reference's aes-ctr PRF: one phase-6 request on the card and the
    # same request on the CPU under the same fixed keys (main path)
    import os

    knobs = ("MOOSE_TPU_FIXED_KEYS", "MOOSE_TPU_ALLOW_WEAK_PRF")
    saved = {k: os.environ.get(k) for k in knobs}
    prev_prf = ring.get_prf_impl()
    ring.set_prf_impl("aes-ctr")
    os.environ.update(dict(zip(knobs, (f"chip-smoke-{SEED}", "1"))))
    try:
        xr = rng.normal(size=(LOGREG_ROWS, LOGREG_FEATURES))
        rk.reset_launches()
        out, ctr_s = timed(torch, lambda: runtime.evaluate_computation(
            logreg, {"x": xr}))
        ctr_launches = dict(rk.LAUNCHES)
        ctr_host = dict(rk.AES_CTR_HOST)
        cpu_out = LocalMooseRuntime(
            ["alice", "bob", "carole"], device="cpu",
        ).evaluate_computation(logreg, {"x": xr})
    finally:
        ring.set_prf_impl(prev_prf)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    pred = out["output_0"]
    ctr_err = float(np.abs(pred - logistic_reference(classifier, xr)).max())
    ctr_record = {
        "latency_ms": ctr_s * 1e3,
        "max_abs_err": ctr_err,
        "equal_to_cpu": bool(np.array_equal(pred, cpu_out["output_0"])),
        "host_expansions": ctr_launches["prf_aes_ctr_host"],
        "keystream_bytes": ctr_host["bytes"],
        "host_expansion_ms": ctr_host["ms"],
        "keystream_mb_per_s": ctr_host["bytes"] / ctr_host["ms"] / 1e3,
    }
    log(f"aes_ctr_logistic_regression: 1 request of {LOGREG_ROWS}x"
        f"{LOGREG_FEATURES} fixed(24, 40) under aes-ctr "
        f"{json.dumps(ctr_record)} launches {ctr_launches}")
    if ctr_err >= LOGREG_TOL:
        raise AssertionError(f"aes-ctr logistic regression error {ctr_err}")
    if not ctr_record["equal_to_cpu"]:
        raise AssertionError("aes-ctr request differs from the CPU's")

    phase[0] = 17
    # phase 17: computations from bytes (main path): phase 6's logistic
    # regression serialized, compiled by elk_compiler and served by
    # evaluate_compiled under threefry and fixed keys, each request held
    # to evaluate_computation's words; the textual round trip, the JAX
    # package's blob and the ResNet's and the AES input's graphs likewise
    from pathlib import Path

    from moose_tpu_torch import elk_compiler, serde, textual
    from moose_tpu_torch.edsl import tracer

    os.environ.update(dict(zip(knobs, (f"chip-smoke-{SEED}", "1"))))
    ring.mix_seed = counted_mix_seed
    try:
        bytes_record, bytes_launches = run_from_bytes(
            torch, rk, runtime, serde, textual, elk_compiler, tracer,
            logreg, classifier, rng,
            golden=(Path(__file__).resolve().parent
                    / BYTES_GOLDEN).read_bytes(),
            graphs={
                "resnet": (resnet_comp, {"x": rng.normal(size=(
                    RESNET_ROWS, RESNET_CH, RESNET_SIZE, RESNET_SIZE))
                    * 0.5}),
                "aes_inference": (aes_comp, aes_args(wires[0])),
            })
    finally:
        ring.mix_seed = mix_seed
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if bytes_launches != logreg_launches:
        raise AssertionError(
            f"from bytes launched {bytes_launches}, phase 6 "
            f"{logreg_launches}")

    # phase 18: the per-host layout (main path, its own draw and seed
    # counts: this layout derives each draw's seed on the host)
    phase[0] = 18
    per_host_record, per_host_launches = run_per_host(
        torch, rk, ring, pm, LocalMooseRuntime, classifier, logreg, rng)

    # phase 19: the lowered route and the per-host Decrypt (main path)
    phase[0] = 19
    lowered_record, lowered_launches = run_lowered(
        torch, rk, ring, pm, LocalMooseRuntime, classifier, logreg,
        aes_model, aes_comp, aes_key, rng)

    # phase 20: secure training sessions (main path, each of (a) to (e)
    # counted on its own)
    phase[0] = 20
    session_record, session_launches = run_training_sessions(
        torch, rk, ring, pm, LocalMooseRuntime)
    LocalMooseRuntime.evaluate_computation = evaluate
    log(f"layouts by phase: "
        f"{json.dumps({p: sorted(v) for p, v in layouts.items()})}")
    for p in range(4, 21):
        # phase 20: the sessions per-host, the trained model stacked
        want = ({"per-host", "stacked"} if p == 20
                else {"per-host" if p >= 18 else "stacked"})
        if layouts.get(p) != want:
            raise AssertionError(
                f"phase {p} ran on {layouts.get(p)}, not {want}")

    launches_by_path = {
        "secure_dot": dot_launches,
        "linear_regressor": linreg_launches,
        "logistic_regression": logreg_launches,
        "training": training.pop("launches"),
        "multinomial_regression": multi_launches,
        "protocol_library": library_launches,
        "correlation": corr_launches,
        "mlp_classifier": mlp_launches,
        "neural_network": net_launches,
        "random_forest": forest_launches,
        "resnet": resnet_launches,
        "aes_inference": aes_launches,
        "aes_ctr_logistic_regression": ctr_launches,
        "from_bytes": bytes_launches,
        **per_host_launches,
        **lowered_launches,
        **session_launches,
    }
    protocol = ("dot_cross_terms", "trunc_pairs", "cross_terms_reshare",
                "ring_mul", "bit_decompose", "msb", "horner")
    per_host_kernels = ("dot_cross_terms", "trunc_combine",
                        "cross_terms_mul", "ring_mul")
    lowered_kernels = ("dot_cross_terms", "ring_mul", "prf_threefry")
    required = {
        "secure_dot": ("dot_cross_terms", "trunc_pairs", "prf_threefry"),
        "linear_regressor": ("dot_cross_terms", "trunc_pairs",
                             "prf_threefry"),
        "logistic_regression": protocol + ("prf_threefry",),
        "training": protocol + ("prf_threefry_pallas",),
        "multinomial_regression": protocol + ("prf_threefry",),
        # the library's kinds hold no matrix product: no K1
        "protocol_library": protocol[1:] + ("prf_threefry",),
        # nor does the correlation
        "correlation": protocol[1:] + ("prf_threefry",),
        "mlp_classifier": protocol + ("prf_threefry",),
        "neural_network": protocol + ("prf_threefry",),
        # the one less (msb) and the muxes
        "random_forest": ("msb", "cross_terms_reshare", "prf_threefry"),
        # the convolutions and the Gemm on K1, BatchNorm's scale on K4,
        # the relus' and the max pool's msb, softmax's exp on K5 and K6
        "resnet": protocol + ("prf_threefry",),
        # Decrypt's 80 ANDs and its bit shares on K7, bit_compose's b2a
        # on K3 and its weights on K4, then phase 6's request
        "aes_inference": protocol + ("prf_threefry",),
        # every draw expanded on the host: no K7
        "aes_ctr_logistic_regression": protocol + ("prf_aes_ctr_host",),
        # phase 6's request from bytes
        "from_bytes": protocol + ("prf_threefry",),
        # the per-host layout: K1 a party, K2's additive tail, K7 single
        # draws; the logistic regression's elementwise products on K3
        # unfused and its public factors on K4
        "per_host_secure_dot": ("dot_cross_terms", "trunc_combine",
                                "prf_threefry"),
        "per_host_logistic_regression": per_host_kernels + (
            "prf_threefry",),
        "per_host_pallas": per_host_kernels + ("prf_threefry",
                                               "prf_threefry_pallas"),
        # (the host Mean's factor on K4)
        "per_host_auto": ("dot_cross_terms", "trunc_combine",
                          "cross_terms_mul", "ring_mul", "prf_threefry"),
        # the lowered graph: host ring Dots on K1 in its product-only
        # mode, host ring Muls on K4, every SampleSeeded one K7 draw
        "lowered_logistic_regression": lowered_kernels,
        "lowered_from_bytes": lowered_kernels,
        # Decrypt's ANDs draw on K7, bit_compose's b2a multiplies on K3
        # and its weights on K4, then the per-host classifier
        "per_host_decrypt": per_host_kernels + ("prf_threefry",),
        # phase 20: the walk's epochs (a per-host step: K1 a party and
        # dot, K2's trunc_combine, K3 unfused, K4, K7 single draws), the
        # lowered epochs (K1 product-only, K4, K7), logreg_train_step on
        # the stacked protocol (its polynomial sigmoid compares nothing:
        # no K5 or K6) and the trained model served stacked
        "training_session": per_host_kernels + ("prf_threefry",),
        "training_resume": per_host_kernels + ("prf_threefry",),
        "training_lowered": lowered_kernels,
        "logreg_train_step": ("dot_cross_terms", "trunc_pairs",
                              "cross_terms_reshare", "ring_mul",
                              "prf_threefry"),
        "trained_predictor": protocol + ("prf_threefry",),
    }
    # the lowered graph holds the reference's composition: no fused step
    for path in ("lowered_logistic_regression", "lowered_from_bytes"):
        for name in ("trunc_combine", "trunc_pairs", "cross_terms_mul",
                     "cross_terms_reshare", "bit_decompose", "msb",
                     "horner"):
            if launches_by_path[path][name]:
                raise AssertionError(f"{path} launched {name}")
    # the streams a phase did not select expand nothing; the per-host
    # layout under threefry-pallas draws its zero shares' bits in
    # threefry's layout, as the reference does
    streams = ("prf_threefry", "prf_threefry_pallas", "prf_aes_ctr_host")
    selected = {path: ("prf_threefry",) for path in required}
    selected["training"] = ("prf_threefry_pallas",)
    selected["aes_ctr_logistic_regression"] = ("prf_aes_ctr_host",)
    selected["per_host_pallas"] = ("prf_threefry", "prf_threefry_pallas")
    for path, names in required.items():
        for name in names:
            if launches_by_path[path][name] < 1:
                raise AssertionError(f"{path} never launched {name}")
        for name in streams:
            if name not in selected[path] and launches_by_path[path][name]:
                raise AssertionError(f"{path} launched {name}")
    if host_seeds[0]:
        raise AssertionError(
            f"the main path derived {host_seeds[0]} seeds on the host")
    k7 = {path: counts["prf_threefry"] + counts["prf_threefry_pallas"]
          for path, counts in launches_by_path.items()}
    logreg_steps_k7 = sum(training["logreg_launches"][c] for c in
                          ("prf_threefry", "prf_threefry_pallas"))
    for what, got, ceiling in (
        ("secure dot K7 launches", k7["secure_dot"], DOT_K7_CEILING),
        ("K7 launches a logistic-regression request",
         k7["logistic_regression"] / LOGREG_REQUESTS, LOGREG_K7_CEILING),
        ("K7 launches a LogregSGDTrainer step",
         logreg_steps_k7 / TRAIN_STEPS, TRAIN_K7_CEILING),
        ("device launches a logistic-regression request",
         logreg_device_launches, LOGREG_DEVICE_CEILING),
        ("device launches a LogregSGDTrainer step",
         training["logreg_device_launches"], TRAIN_DEVICE_CEILING),
        ("K7 launches a multinomial request",
         k7["multinomial_regression"] / MULTI_REQUESTS, MULTI_K7_CEILING),
        ("device launches a multinomial request",
         multi_device_launches, MULTI_DEVICE_CEILING),
        ("K7 launches an MLP request",
         k7["mlp_classifier"] / MLPC_REQUESTS, MLPC_K7_CEILING),
        ("device launches an MLP request",
         mlp_device_launches, MLPC_DEVICE_CEILING),
        ("K7 launches a ResNet request",
         k7["resnet"] / RESNET_REQUESTS, RESNET_K7_CEILING),
        ("device launches a ResNet request",
         resnet_device_launches, RESNET_DEVICE_CEILING),
        ("K7 launches an AES-input request",
         k7["aes_inference"] / AES_REQUESTS, AES_K7_CEILING),
        ("device launches an AES-input request",
         aes_device_launches, AES_DEVICE_CEILING),
    ):
        log(f"ceiling: {what} {got} <= {ceiling}")
        if got > ceiling:
            raise AssertionError(f"{what}: {got} > {ceiling}")

    for mod in sys.modules:
        if mod == "jax" or mod.startswith(("jax.", "moose_tpu.")) \
                or mod == "moose_tpu":
            raise AssertionError(f"the port loaded {mod}")

    tpu = "moose_tpu/native/ring128_kernels.py"
    replaces = {
        "dot_cross_terms": f"{tpu}:1037",
        "trunc_combine": f"{tpu}:589",
        "cross_terms_mul": f"{tpu}:558",
        "ring_mul": f"{tpu}:534",
        "bits_adder": f"{tpu}:769 (bit_decompose), :779 (msb)",
        "horner": f"{tpu}:857",
        "threefry": "moose_tpu/dialects/pallas_prf.py:119",
    }
    # the LAUNCHES names behind each kernel (K2 and K3 count their two
    # entry points, K5 its two modes, K7 its two stream layouts), and the
    # one a phase-3 row ran
    counters = {name: (name,) for name in replaces}
    counters["trunc_combine"] = ("trunc_pairs", "trunc_combine")
    counters["bits_adder"] = ("bit_decompose", "msb")
    counters["cross_terms_mul"] = ("cross_terms_reshare", "cross_terms_mul")
    counters["threefry"] = ("prf_threefry", "prf_threefry_pallas")

    def entry_of(name, row):
        if name == "threefry":
            return "prf_threefry" + ("" if row["mode"] == "threefry"
                                     else "_pallas")
        mode = row.get("mode")
        return mode if mode in counters[name] else counters[name][0]
    kernels = []
    for name, rows in rows_by_kernel.items():
        head = rows[0]  # the main path's shape
        by_path = {
            path: sum(counts[c] for c in counters[name])
            for path, counts in launches_by_path.items()
        }
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"moose_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "equal": all(r["equal"] for r in rows
                         if r["equal"] is not None),
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["max_abs_err"] is not None),
            "tolerance": "exact word equality",
            "shape": head["shape"],
            "ms": head["ms"],
            "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "int8_gemm_ms": head.get("int8_gemm_ms"),
            "shapes": rows,
        }
        # every entry point of the kernel: its launches and its head row
        entry["entries"] = []
        for mode in counters[name]:
            mine = [r for r in rows if entry_of(name, r) == mode]
            by_mode = {path: counts[mode]
                       for path, counts in launches_by_path.items()}
            entry["entries"].append({
                "entry": mode,
                "launches": sum(by_mode.values()),
                "launches_by_path": by_mode,
                **({} if not mine else {
                    key: mine[0][key] for key in (
                        "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")
                }),
                "max_abs_err": max((r["max_abs_err"] for r in mine
                                    if r["max_abs_err"] is not None),
                                   default=None),
            })
        kernels.append(entry)
    record = {
        "card": smi,
        "build_s": build_s,
        "host_seed_derivations": host_seeds[0],
        "k7_launches": k7,
        "protocol_device_launches": protocol_device_launches,
        "logreg_device_launches": logreg_device_launches,
        "secure_dot": {"latency_ms": dot_s * 1e3,
                       "warm_latency_ms": [s * 1e3 for s in warm],
                       "max_abs_err": dot_err},
        "linear_regressor": {"latency_ms": [s * 1e3 for s in latencies],
                             "rows_per_s": rows_per_s,
                             "max_abs_err": max(linreg_errs)},
        "logistic_regression": {
            "latency_ms": [s * 1e3 for s in logreg_latencies],
            "rows_per_s": logreg_rows_per_s,
            "max_abs_err": max(logreg_errs),
        },
        "training": training,
        "multinomial_regression": {
            "latency_ms": [s * 1e3 for s in multi_latencies],
            "rows_per_s": multi_rows_per_s,
            "max_abs_err": max(multi_errs),
            "argmax_agreement": min(multi_agree),
            "device_launches": multi_device_launches,
        },
        "protocol_library": {"latency_ms": library_s * 1e3,
                             "max_abs_err": library_errs},
        "correlation": correlation,
        "mlp_classifier": {
            "latency_ms": [s * 1e3 for s in mlp_latencies],
            "rows_per_s": mlp_rows_per_s,
            "max_abs_err": max(mlp_errs),
            "device_launches": mlp_device_launches,
        },
        "neural_network": {"latency_ms": net_s * 1e3,
                           "max_abs_err": net_err,
                           "argmax_agreement": net_agree},
        "random_forest": {"latency_ms": forest_s * 1e3,
                          "max_abs_err": forest_err,
                          "less_elements": FOREST_ROWS * splits},
        "resnet": resnet_record,
        "aes_inference": aes_record,
        "aes_ctr_logistic_regression": ctr_record,
        "from_bytes": bytes_record,
        "per_host": per_host_record,
        "lowered": lowered_record,
        "training_sessions": session_record,
    }
    log(json.dumps(record))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
