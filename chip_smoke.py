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
 21. the static analyzer on the main path (``chip_smoke.run_analyzer``):
     (a) phase 20's graphs (init, the 10-step epoch at 1,280 rows,
     export) linted at their trace by the trainers' build-time range and
     keystream gate, its host ms each, launching nothing; the same
     trainer at ranges of +-1e9 refused with MSA701 at its trace; (b)
     phase 6's config-3 graph (1024 x 100, fixed(24,40), threefry): the
     shape-only stacked draw replay (``stacked_draw_trace`` on ``meta``
     tensors) launches nothing and equals the draw ledger of one request
     on the card, event for event, which launches every kernel of phase 6
     within 5e-3; (c) the static per-host draw counts
     (``host_draw_counts``) equal the ledger of phase 18's per-host
     request on the card, which launches K1, K2's trunc_combine, K3's
     cross_terms_mul, K4 and K7; (d) config 3 compiled with
     ``DEFAULT_PASSES + ["lint"]`` and ``strict=True`` (no error, its host
     ms and diagnostics by rule printed), served by evaluate_compiled on
     the card within 5e-3 launching K1, K4 and K7, ``python -m
     moose_tpu_torch.bin.prancer --format json`` on its blob exiting 0,
     and a phase-6 request's ``last_timings`` holding
     ``evaluate_computation`` and ``execute``, the second no longer.
 22. secure-inference serving (``chip_smoke.run_serving``) of phase 6's
     logistic regression (config 3: 100 features, fixed(24,40),
     threefry) through ``moose_tpu_torch.serving.InferenceServer`` on
     the card, ``max_batch`` 1024: (a) registration over the autotuned
     ladder of 11 power-of-two buckets (one warm-up evaluation a bucket,
     each bucket's ms and the decision's source printed); (b) a burst of
     1,024 rows in 1-, 7- and 64-row requests from 8 threads, then one
     request of 1,000 rows, every row within 5e-3 of float64; rows/s,
     p50/p99 request latency, batch fill, the device's busy ms and idle
     share over the burst printed; under fixed keys one batch of exactly
     1,024 rows (a long max_wait_ms) word-equal to a direct evaluation
     of that bucket on the card and on the CPU, launching phase 6's
     counts a request; (c) ``bin/blitzen``'s handler in process on
     127.0.0.1: /readyz 200, a predict within 5e-3, /metrics parsing, a
     full queue answering 429 with ``retryable``; (d) ``bin/donner``'s
     router over two such replicas on the one card: the request routed,
     then one replica drained (its /readyz 503), a request sent to it
     retried on the other, and the drained one ejected; (e)
     ``training.export.hot_swap`` of phase 20's exported weights into
     the live server under traffic (no request fails, results within
     5e-3 of the swapped model's float64), then one ``ControlPlane``
     promote of the phase-6 weights as a generation over
     ``LocalFleetClient`` under routed tenant traffic; (f)
     ``save_snapshot`` and a fresh server's ``load_snapshot`` under fixed
     keys: every probe digest verified, the first request word-equal to
     the original server's, no re-trace, the restore wall beside (a)'s.
 23. distributed secure execution (``run_distributed``): (a) config 1's
     secure dot (1000x1000 @ 1000x1000, fixed(14,23), ring128, within
     2e-4 of float64) and config 3's logistic regression (1024 x 100,
     fixed(24,40), within 5e-3) on three workers on the card, first over
     ``LocalNetworking`` (dasher's path), then as three in-process gRPC
     ``WorkerServer``s under ``GrpcMooseRuntime``: one cold and
     DIST_REQUESTS warm requests each, per-role
     ``elapsed_time_micros``, the gRPC wire counters of each request
     equal to ``cost_report``'s prediction,
     one profiled warm gRPC request's device launches, busy ms and idle
     share; under fixed keys config 3's outputs and every payload on the
     wire equal to the same run on the CPU; (b) three ``comet``
     processes on the card and ``cometctl run`` of config 3 from a TOML
     session file, rows within 5e-3, each process stopped by SIGTERM
     with exit code 0; (c) ``profiling`` around one warm gRPC request
     (every phase of a session in one trace) and around a blitzen burst
     (the batcher's records), ``/debug/profile`` on blitzen and on the
     metrics server (200, and 409 while a capture runs), and a warm
     phase-6 request with the profiler's hooks stubbed out, present and
     off, and on, 10 rounds in turns; (d) ``autotune_plan`` of both
     graphs on the card and K1's ``measure_dot_micro`` for the mxu,
     tall and small classes;
 24. secret integers, faults and the other workers (``run_faults``):
     (a) Add, Mul and Dot (x^T y) of two secret uint64 columns of 1024 x
     100 words drawn from SEED (a quarter of them at or beyond 2^63) on
     the stacked layout, FAULT_INT_REQUESTS requests, each equal to
     numpy's uint64 arithmetic, under fixed keys equal to the CPU's;
     (b) config 3 (1024 x 100) on three in-process gRPC workers under a
     ``ChaosConfig`` (FAULT_CHAOS: drop_send, dup_send, delay): the
     client's retries succeed, the outputs equal the clean run's under
     fixed keys and lie within 5e-3 of float64, and the drops'
     ``schedule_digest`` equals the same schedule's on CPU workers;
     (c) ``TrainingSession(LogregSGDTrainer(100), GrpcTrainingCluster)``
     on three card workers, FAULT_TRAIN_EPOCHS epochs of
     FAULT_TRAIN_STEPS steps of 128 x 100, once clean and once with
     carole killed after FAULT_KILL_AT of her ops and restarted by
     ``start_chaos_restarter``: at least one resume, every committed
     ``#s0``/``#s1`` plane and the weights equal to the clean run's, the
     weights within 1e-3 of float64 ``reference_epoch``s; (d) three
     ``vixen`` processes over ``TcpNetworking`` on config 3's lowered
     graph from a file: exit 0, rows within 5e-3 and equal under fixed
     keys to a LocalNetworking run on the card; (e) three ``rudolph``
     processes (started beside the vixens) on one ``.session`` file of
     that graph: the retrieved rows likewise, each process exiting 0 on
     SIGTERM; (f) config 3's text and its lowered graph's (past 64 KiB)
     parsed by the native and the Python parser: the same serialized
     bytes, the native count risen (the lowered text also by default),
     the host ms of each.
 25. the device mesh and the fabric transport (``run_fabric``): (a)
     phase 6's config 3 (its first request) through
     ``LocalMooseRuntime(layout="stacked", mesh=spmd.make_mesh())``, the
     card's (1, 1) mesh, word-equal to phase 6's runtime on it under
     fixed keys and within 5e-3; ``logreg_train_step(..., mesh=)`` at
     phase 20's width (10 steps of 128 x 100) with revealed weights equal
     bit for bit to the mesh-less steps'; the mesh's shape printed; (b) a
     ``FabricDomain`` of three ``devices.virtual_devices("cuda", 3)``
     handles under ``trust_model="simulation"``: config 1's secure dot
     (1000 x 1000) and config 3 over three in-process gRPC workers
     (``start_local_cluster(..., fabric_domain=)``), one cold and one warm
     session, word-equal under fixed keys to the same sessions over
     ``LocalNetworking`` and over gRPC, no wire send, every fabric counter
     (sends, permutes, batched permutes, payloads, tx bytes) equal to
     ``cost_report(..., transport="fabric")``, the session report's
     transport ``fabric``; one more warm config-3 session under
     torch.profiler (the device-to-device copies a permute); a mixed
     domain with carole outside it: the outputs equal, its
     ``trust_boundary`` fallbacks equal to the model's
     ``fallback_sends``; (c) phase 24 (b)'s chaos schedule over the
     fabric: the same drop schedule as phase 24's, the dropped keys
     replayed on the wire (``forced_wire``), the outputs equal to (b)'s.
     Walls printed.
 26. the ring Dot at ranks past 2 (``run_ranks``), under the JAX
     package's rule (x's last axis against y's first, the output
     ``x.shape[:-1] + y.shape[1:]``) at config 5's MLP first layer,
     fixed(24,40), ring128: (a) x (8, 128, 100) on alice against W
     (100, 64) on bob, a replicated Dot revealed to carole, stacked;
     (b) x (1024, 100) against Y (100, 8, 8), stacked, out (1024, 8, 8);
     (c) (a) and (b) per-host; (d) (b) and (100,) @ Y as host
     fixed-point Dots on alice; each one K1 call (one a party per-host)
     at (1024, 100) @ (100, 64) (K1 product-only for (d)), its words
     equal to the same request on the CPU under fixed keys, within 1e-6
     of float64 ``np.tensordot(x, y, 1)``; (e) (2, 3, 4) @ (2, 4, 5)
     refused on both layouts with no K1 launch.  K1's time at (a)'s
     fold printed on its own line.
 27. the reference's user journeys as the port's programs
     (``run_programs``): the seven of PROGRAMS imported and their
     ``main([..., "--device", "cuda"])`` called at the JAX scripts'
     defaults (the logistic-regression trainer and its query, the ONNX
     example, the ResNet at 4 images, AES-GCM input on the stacked
     layout, the correlation from storage, the ONNX tutorial, the
     multichip tutorial's step and softmax on a (3, 2) mesh of six
     handles over the card), each passing its own checks, the trainer
     within PROGRAM_TRAIN_TOL of float64's 8 steps and its scores within
     PROGRAM_SCORE_TOL, the ResNet within RESNET_TOL of
     ``resnet_reference``; no plain version of a kernel may see a card
     tensor (``plain_on_card``); then the three of PROGRAM_PROCESSES
     (the CLI tutorial, AES and the correlation over three comets),
     PROGRAM_AT_ONCE at a time, as ``python -m ... --device cuda``, each
     in a session of its
     own: exit 0, the line each prints on success, and no process of the
     session left.  Each program's wall printed beside the card.
 28. the stacked layout's compiled plans (``run_plans``), CUDA graphs
     replayed against the eager walk: (a) config 1's secure dot
     (1000x1000, fixed(14,23), ring128), config 3's logistic regression
     (1024 x 100), config 4's AES input and config 5's MLP and ResNet at
     phases 4, 6, 15, 11 and 14's widths, each on a fresh runtime: its
     first evaluations validate and it settles promoted (``last_plan``:
     plan_state "jit", plan_mode not eager, no pinned op), within its
     phase's tolerance, a replay counting the eager walk's launches;
     under two fixed master keys five replays of the secure dot and of
     the logistic regression each equal the eager walk's words under the
     same key, and the two keys' words differ; (b) for each, the median
     wall of ten eager and ten replayed requests in turns, the
     validating evaluations' walls, the launches a request, one eager
     and one replayed request's device launches, busy ms and idle share
     under torch.profiler, and the plan's private pool bytes; (c)
     ``MOOSE_TPU_SELFCHECK_FORCE=1`` with ``MOOSE_TPU_SELFCHECK_FAULT=
     Dot`` on the secure dot descends to the per-op rung and pins exactly
     its Dot, the segment rungs returning the eager walk's words and the
     per-op plan its reference's; (d) aes-ctr under ``use_jit`` raises
     the JAX package's ConfigurationError; (e) two threads of eight
     config-3 requests on one runtime, each equal to the single-thread
     run under fixed keys and within 5e-3.  Every phase from 4 on that
     runs the stacked layout with the default ``use_jit`` replays such
     plans: each counts and times its requests once its plan has
     validated (``settle``), and phase 16 (aes-ctr) runs eagerly.
 29. the physical executor's compiled plans (``run_lowered_plans``), the
     lowered route's CUDA graphs: (a) config 3 (1024 x 100, fixed(24,40),
     threefry) lowered by DEFAULT_PASSES (inside
     ``host.deterministic_sync_keys(SEED)``) on a fresh per-host runtime
     settles promoted (``last_plan``: plan_state "jit", no pinned op, a
     CUDA graph replayed) within 5e-3; under the two fixed keys of
     PLAN_KEYS, PLAN_REPLAYS replays each equal the eager run's words
     (``use_jit=False``: host keys, seeds derived on the host) and the
     CPU's, and the two keys' words differ; (b) the same lowered graph
     serialized and served by ``evaluate_compiled`` settles promoted and
     gives (a)'s words; (c) a lowered secure dot (1000x1000) under
     ``MOOSE_TPU_SELFCHECK_FORCE=1`` and ``MOOSE_TPU_SELFCHECK_FAULT=Dot``
     descends to the per-op rung and pins exactly its Dot ops, every
     evaluation returning the eager run's words; (d) phase 20 (c)'s
     lowered epochs ran under their plan; (e) the median wall of
     PLAN_WALLS eager and replayed config-3 requests in turns, the
     validating evaluations' walls, a request's launches (K1, K4 and K7
     only, the replay counting the eager run's), its host seed
     derivations (none replayed; ``ring.mix_seed`` counted), one eager
     and one replayed request's device launches, busy ms and idle share
     under torch.profiler, and the plan's private pool bytes.  Phases
     19, 20 (c) and 21 (d) run the same route: their first evaluations
     of a lowered graph validate it.
 30. the distributed workers' fast path (``run_worker_plans``), each
     role's segments captured as CUDA graphs under the JAX package's
     per-segment validated ladder: (a) config 3 (1024 x 100,
     fixed(24,40), threefry) lowered by DEFAULT_PASSES on three workers
     over ``LocalNetworking`` on the card validates for its first
     ``MOOSE_TPU_JIT_SELFCHECK`` sessions, then every role is
     "segmented" or "full-jit" with no pinned segment and
     ``validating_evaluations`` one a role a validating session, as on
     the CPU, within 5e-3; under each of the two fixed keys of PLAN_KEYS
     WORKER_KEYED settled sessions equal the legacy scheduler's outputs
     and wire payloads (phase 23 (a) holds a settled session of config
     3 equal to the CPU's), each role's launch tally and draw events
     equal its legacy ones (three roles in one process), derive no seed
     on the host, and the two keys' words differ; (b) the same graph over
     a fabric of three handles over the card, replaying (a)'s plans
     (words equal to (a)'s legacy run, counters equal to
     ``cost_report``'s), and on three in-process gRPC
     ``WorkerServer``s under ``GrpcMooseRuntime`` (``last_plan_modes``
     settled, wire counters equal to ``cost_report``'s); (c) under
     ``MOOSE_TPU_SELFCHECK_FAULT=Dot`` exactly the validatable segments
     that hold a Dot are pinned, every session within 5e-3; (d) config
     1's secure dot on three workers settles within 2e-4; (e) the median
     wall of WORKER_WALLS legacy and settled sessions in turns, over
     ``LocalNetworking`` and over the fabric, each role's segments,
     captured graphs, replays a session and pool bytes, the validating
     sessions' walls, K1, K4 and K7 launches a session, and one legacy
     and one settled session's device launches, busy ms and idle share
     under torch.profiler.  Phases 23 to 25 and 27 run their workers on
     the same fast path (the default): their first sessions of a graph
     validate it.
Every evaluation of phases 4 to 17 and 22 must have run on the stacked
layout, phase 18's and 19's on the per-host one
(``last_plan["layout"]``), and phase 20's and 21's on both (the sessions
per-host, the trained model stacked; the draw oracles one each), and
phase 24 (a)'s and 25 (a)'s on the stacked one.  Phases 4 to 30 are the
main path:
the kernels' launch counters are set to 0 just before each (each of
phase 20's, 21's, 22's, 23's, 24's, 25's, 26's, 27's, 29's and 30's
parts apart) and read just after;
phase 23's comet processes, phase 24's vixen and rudolph processes and
phase 27's program processes count in their own processes.  K1, K2's
trunc_pairs and the threefry kernel in the phase's stream layout
(threefry in all but 7, threefry-pallas in 7, and never the other) must
have launched in each but 10 and 13, and every kernel (K1, K2's
trunc_pairs, K3's cross_terms_reshare, K4, K5 in both modes, K6) in
phases 6 to 12 and 14
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
Each of phase 22's paths must launch every kernel of phase 6, and its
bucket-1024 batches (the fixed-keys batch and the 1,000-row request)
exactly phase 6's counts a request; the burst one K1 a batch.  Each of
phase 23's in-process paths (its warm requests, counted apart) must
launch K1, K4 and threefry's K7 and none of K2, K3, K5 and K6, and so
must phase 24's chaos runs (b) and (c) and phase 30's validating,
settled and fabric sessions; phase 24's secret integers (a) K1, K3's
cross_terms_reshare and K7, and no K2.  Phase 25's config 3 on the mesh
must launch every kernel of phase 6, its logreg_train_step those of
phase 20 (d), and its fabric sessions those of phase 23.  Phase 26's
stacked Dots must launch K1, K2's trunc_pairs and K7, its per-host ones
K1, K2's trunc_combine and K7, its host Dots K1.  Each of phase 27's
in-process programs must launch every kernel of phase 6 (the
correlation all but K1, as phase 10).
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
# phase 22: secure-inference serving of phase 6's logistic regression
SERVE_FEATURES = LOGREG_FEATURES
SERVE_MAX_BATCH = LOGREG_ROWS  # the ladder's largest bucket
SERVE_BURST = ((64, 14), (7, 16), (1, 16))  # (rows, requests): 1,024 rows
SERVE_THREADS = 8
SERVE_BIG = 1000  # one request of 1,000 rows after the burst
SERVE_WAIT_MS = 2.0
SERVE_QUEUE = 64
SERVE_PROBE_ROWS = 7  # (c)'s and (f)'s request
# phase 23: distributed secure execution (config 1's secure dot and config
# 3's logistic regression on three workers)
DIST_REQUESTS = 1  # warm requests after one cold
DIST_OVERHEAD_RUNS = 10  # paired runs of the profiler's cost
DIST_MICRO_ITERS = 5
# phase 24: secret integers, the chaos layer, TCP and filesystem workers,
# the native parser
FAULT_INT_COLS = 100  # (a): two secret uint64 columns of LOGREG_ROWS rows
FAULT_INT_REQUESTS = 3
FAULT_CHAOS = "drop_send:0.002,dup_send:0.05,delay_ms:1"  # (b), with a seed
FAULT_ATTEMPTS = 6
FAULT_RECEIVE_S = 4.0  # (b): a dropped send fails its attempt this soon
FAULT_CPU_ROWS = 16  # (b): the CPU's run of the same schedule
# phase 26: the ring Dot at ranks past 2, at config 5's MLP first layer
# (MLPC_ROWS x 100 -> 64): a batched x (8, 128, 100) against W (100, 64),
# x (1024, 100) against a rank-3 Y (100, 8, 8); every one folds to K1's
# (1024, 100) @ (100, 64)
RANKS_X = (8, 128, MLPC_FEATURES)
RANKS_Y = (MLPC_FEATURES, 8, 8)
RANKS_TOL = 1e-6  # against float64 np.tensordot(x, y, 1)
RANKS_REFUSED = ((2, 3, 4), (2, 4, 5))
# phase 27: the reference's user journeys as the port's programs
# (moose_tpu_torch/examples, moose_tpu_torch/tutorials) at the JAX
# scripts' defaults: the seven that run in this process, by module under
# moose_tpu_torch, with the line each prints on success (None: the JAX
# script prints none and checks nothing, so the results are held here)
PROGRAMS = {
    "examples.logistic_regression": None,
    "examples.onnx_predictor": "OK",
    "examples.resnet_inference": None,
    "examples.aes_inference": "OK",
    "tutorials.scientific_computing_multiple_players":
        "OK — secure result matches the plaintext statistic",
    "tutorials.ml_inference_with_onnx":
        "OK — encrypted inference matches the float64 model",
    "tutorials.multichip_spmd": "multichip SPMD tutorial OK",
}
# the three that start processes (elk and dasher; three comets each),
# run as a user runs them: flags, and the line printed on success
PROGRAM_PROCESSES = {
    "tutorials.interfacing_textual_and_cli": ((), "OK — dasher computed"),
    "examples.aes_inference": (("--grpc",), "OK"),
    "tutorials.scientific_computing_multiple_players": (
        ("--grpc",), "OK — secure result matches the plaintext statistic"),
}
PROGRAM_TIMEOUT_S = 600
# the process programs running at once (three at once oversubscribe an
# eight-core H100 host: AES over comets took 133 s there, 82-103 s beside
# fewer)
PROGRAM_AT_ONCE = 2
PROGRAM_TRAIN_TOL = 1e-3  # the 8 secure SGD steps against float64's
PROGRAM_SCORE_TOL = 5e-3  # the exact sigmoid (phase 6's limit)
# phase 28: the compiled plans
PLAN_KEYS = (f"chip-smoke-{SEED}-plan-a", f"chip-smoke-{SEED}-plan-b")
PLAN_REPLAYS = 5  # (a): replays under each key
PLAN_WALLS = 10  # (b): eager and replayed requests, in turns
PLAN_THREADS = 2  # (e)
PLAN_THREAD_REQUESTS = 8
# phase 30's depth, cut to its 90 s: (e) legacy and settled sessions in
# turns on each transport, (a) settled sessions under each fixed key
WORKER_WALLS = 3
WORKER_KEYED = 2
FAULT_TRAIN_STEPS = 1  # (c): steps of SESSION_BATCH rows an epoch
FAULT_TRAIN_EPOCHS = 2
FAULT_KILL_AT = 0.75  # (c): carole dies after this share of her ops


def per_host_ceiling(count):
    return math.ceil(count * 1.05)


# the session key of the K7 group rows
GROUP_MASTER = (0x01234567, 0x89ABCDEF, 0xDEADBEEF, 0x0BADF00D)
# a lowered DeriveSeed's sync key words (K7's mode (b) rows)
LOWERED_NONCE = (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)


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


PERMUTE_RANGE = "chip_smoke.fabric_permute"
# profiled reads of phase 25's permutes before a short count fails
PERMUTE_READS = 3


def permute_copies(torch, domain, fn):
    """(result, device events, leaves, ranges, short calls) of ``fn``
    under torch.profiler with the CPU of every thread traced: the device
    events launched inside ``domain``'s permutes (each call wrapped in a
    profiler range here, whichever worker thread makes it), the
    non-empty tensor leaves those calls were given, the ranges found,
    and each call whose range holds fewer device events than it had
    leaves (its leaves' shapes, dtypes and devices, and the events'
    names).  Off the card the events are []."""
    from torch.profiler import ProfilerActivity, profile, record_function

    inner, leaves, calls = domain.permute, [0], []

    def permute(sender, receiver, payload):
        mine = [(list(leaf.shape), str(leaf.dtype), str(leaf.device))
                for leaf in payload
                if isinstance(leaf, torch.Tensor) and leaf.numel() > 0]
        leaves[0] += len(mine)
        calls.append(mine)
        with record_function(f"{PERMUTE_RANGE}#{len(calls) - 1}"):
            return inner(sender, receiver, payload)

    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    domain.permute = permute
    try:
        if on_card:
            torch.cuda.synchronize()
        with profile(activities=activities,
                     experimental_config=config) as prof:
            out = fn()
            if on_card:
                torch.cuda.synchronize()
    finally:
        del domain.permute

    def under(event):
        return list(event.kernels) + [k for child in event.cpu_children
                                      for k in under(child)]

    # the ranges on the CPU's timeline (on the card each also has a
    # device-side annotation of the same name)
    cpu = torch.autograd.DeviceType.CPU
    ranges = [e for e in prof.events()
              if e.name.startswith(PERMUTE_RANGE + "#")
              and e.device_type == cpu]
    short = []
    for e in ranges:
        got = under(e)
        want = calls[int(e.name.rsplit("#", 1)[1])]
        if len(got) < len(want):
            short.append({"leaves": want, "events": [k.name for k in got]})
    return (out, [k for e in ranges for k in under(e)], leaves[0],
            len(ranges), short)


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
    # the session's master key on the card, as SpmdSession keeps it and
    # a captured plan writes it before each replay
    key = rk.key_tensor(GROUP_MASTER, "cuda")

    def kernel():
        rk.threefry_group(key, 0, 1000, layout, got)
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
    key = rk.key_tensor(GROUP_MASTER, "cuda")

    def kernel():
        rk.threefry_group(key, 0, 1000, layout, out)

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


def compare_seeded(torch, rk, n, layout, bits, nonce, reps, label,
                   untagged=False):
    """K7 under a draw's own key on the card (a lowered plan's key table
    row), its seed made in the kernel: ``mix_seed(key, nonce)`` (mode
    (b), a lowered DeriveSeed's) or the key itself (``nonce`` None, mode
    (c), an unseeded Sample's), against the plain version, which derives
    the seed on the host."""
    key = torch.tensor(GROUP_MASTER, dtype=torch.int64, device="cuda")
    mode = "b" if nonce is not None else "c"

    def kernel():
        return rk.threefry_seeded(key, nonce, n, layout, bits, untagged)

    row = compare_kernel(
        torch, kernel,
        lambda: rk.threefry_seeded_plain(GROUP_MASTER, nonce, n, layout,
                                         bits, "cuda", untagged),
        (), threefry_bound(n, layout, bits), reps,
        shape=f"{n} {'bits' if bits else 'words'} ({label}; mode ({mode})"
              f"{', untagged' if untagged else ''})", mode=layout,
    )
    # the kernel's own time on the card, without the host's launch
    row["device_ms"] = device_time_ms(torch, kernel)
    return row


def secret_uint64_computation(pm):
    """Add, Mul and Dot of two secret uint64 columns, each cast back to
    uint64 on carole: the secret-uint64 acceptance graph
    (tests/test_integration_acceptance.py) with a Dot beside it."""
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])

    @pm.computation
    def secret_uint64(x: pm.Argument(alice, dtype=pm.uint64),
                      y: pm.Argument(bob, dtype=pm.uint64)):
        with rep:
            s = pm.add(x, y)
            p = pm.mul(x, y)
            d = pm.dot(pm.transpose(x), y)
        with carole:
            outs = tuple(pm.cast(v, dtype=pm.uint64) for v in (s, p, d))
        return outs

    return secret_uint64


def secret_uint64_reference(x, y):
    """numpy's uint64 arithmetic (wrapping mod 2^64) of the graph above."""
    import numpy as np

    with np.errstate(over="ignore"):
        return x + y, x * y, x.T @ y


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
    # each trainer's step graph validates its plan first
    for trainer, state in ((logreg, {"w": np.zeros((TRAIN_FEATURES, 1))}),
                           (mlp, mlp_state)):
        settle(runtime, trainer.step_computation(TRAIN_ROWS),
               dict(state, x=batches[0][0], y=batches[0][1]))
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
    settle(runtime, comp, args)
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
    settle(runtime, compiled, {"x": requests[0]},
           evaluate=runtime.evaluate_compiled)
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


def spmd_training(torch, spmd, x, y, batch_size, lr, device, mesh=None):
    """``benchmarks/logreg.py``'s ``run_spmd`` workload on the port: from
    zero weights, one ``logreg_train_step`` a batch of ``batch_size``
    rows (on ``mesh`` when given), each step under its own session key
    (``derive_step_keys``), its batch shared inside the step.  Returns
    the revealed weights as float64 numpy."""
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
        w = spmd.logreg_train_step(s, xs, ys, w, lr, mesh=mesh)
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
        self.plans = []  # (computation, the session's last_plan)
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
        self.plans.append((comp, dict(self.cluster.runtime.last_plan)))
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
        # every graph of the session traced (and linted, which lowers it
        # and draws sync keys) before the nonces are pinned, so the card's
        # run and the CPU's draw the same nonces
        low.init_computation()
        low.export_computation()
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
        # the last lowered epoch's plan
        low_plan = [plan for c, plan in cluster.plans if c is low_epoch][-1]
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
            # the route's compiled plan (phase 29 (d))
            "plan": {k: low_plan.get(k) for k in (
                "plan_mode", "pinned_ops", "plan_state", "cuda_graphs")},
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
            # phase 22 hot-swaps these into its live server
            "weights": [float(v) for v in np.asarray(w).reshape(-1)],
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


def run_analyzer(torch, rk, pm, runtime_cls, classifier, logreg, rng,
                 device="cuda"):
    """Phase 21: the static analyzer on the main path, (a) to (d) of the
    module's docstring, with the port's runtimes on ``device``.  Returns
    (record, launches by path); raises on any failed check."""
    import os
    import tempfile
    from collections import Counter

    import numpy as np

    from moose_tpu_torch import serde
    from moose_tpu_torch.compilation import (
        DEFAULT_PASSES,
        compile_computation,
    )
    from moose_tpu_torch.compilation.analysis import Severity, analyze
    from moose_tpu_torch.compilation.analysis.keystream import (
        host_draw_counts,
        stacked_draw_trace,
    )
    from moose_tpu_torch.compilation.lowering import (
        arg_specs_from_arguments,
    )
    from moose_tpu_torch.edsl import tracer
    from moose_tpu_torch.errors import MalformedComputationError
    from moose_tpu_torch.execution import drawledger
    from moose_tpu_torch.predictors.trainers import LogregSGDTrainer

    ids = ["alice", "bob", "carole"]
    record, launches = {}, {}

    on_card = torch.device(device).type == "cuda"

    def host_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    def wall(fn):
        if on_card:
            return timed(torch, fn)
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    def launched_nothing(what):
        if any(rk.LAUNCHES.values()):
            raise AssertionError(f"{what} launched {dict(rk.LAUNCHES)}")

    def request_error(out, xr):
        pred, want = out["output_0"], logistic_reference(classifier, xr)
        if pred.shape != want.shape or not np.all(np.isfinite(pred)):
            raise AssertionError(f"analyzer request malformed: {pred.shape}")
        err = float(np.abs(pred - want).max())
        if err >= LOGREG_TOL:
            raise AssertionError(f"analyzer request error {err}")
        return err

    # (a) the trainers' build-time gate over phase 20's graphs
    rows = SESSION_BATCH * SESSION_STEPS
    trainer = LogregSGDTrainer(
        n_features=SESSION_FEATURES, learning_rate=SESSION_LR,
        steps_per_epoch=SESSION_STEPS, fixedpoint_dtype=pm.fixed(24, 40))
    rk.reset_launches()
    gate = {}
    for name, args, n_rows in (("init", (), None), ("epoch", (rows,), rows),
                               ("export", (), None)):
        comp, trace_ms = host_ms(
            lambda: getattr(trainer, f"{name}_computation")(*args))
        _, lint_ms = host_ms(lambda: trainer._range_lint(comp, n_rows))
        gate[name] = {"ops": len(comp.operations), "lint_ms": lint_ms,
                      "trace_and_lint_ms": trace_ms}
    hostile = LogregSGDTrainer(
        n_features=SESSION_FEATURES, learning_rate=SESSION_LR,
        steps_per_epoch=SESSION_STEPS, fixedpoint_dtype=pm.fixed(24, 40),
        feature_range=(-1e9, 1e9), weight_range=(-1e9, 1e9))
    try:
        hostile.epoch_computation(rows)
    except MalformedComputationError as e:
        refused = sorted({d.rule for d in e.diagnostics})
    else:
        raise AssertionError("the range gate let a +-1e9 epoch through")
    if "MSA701" not in refused:
        raise AssertionError(f"the range gate refused with {refused}")
    launched_nothing("the range gate")
    record["gate"] = {"graphs": gate, "refused_with": refused}
    log(f"analyzer gate: {json.dumps(record['gate'])}")

    # (b) the stacked draw oracle: the meta replay against the card
    traced = tracer.trace(logreg)
    specs = {"x": (LOGREG_ROWS, LOGREG_FEATURES)}
    rk.reset_launches()
    static, replay_ms = host_ms(lambda: stacked_draw_trace(traced, specs))
    launched_nothing("the meta replay")
    runtime = runtime_cls(ids, device=device)
    xr = rng.normal(size=(LOGREG_ROWS, LOGREG_FEATURES))
    # a validating request runs the eager walk beside its candidate
    settle(runtime, logreg, {"x": xr})
    rk.reset_launches()
    with drawledger.recording() as ledger:
        out, stacked_s = wall(
            lambda: runtime.evaluate_computation(logreg, {"x": xr}))
    launches["analyzer_stacked_request"] = dict(rk.LAUNCHES)
    if runtime.last_plan["layout"] != "stacked":
        raise AssertionError("the stacked oracle ran per-host")
    dynamic = ledger.stacked_trace()
    if dynamic != static:
        at = next((i for i, (a, b) in enumerate(zip(static, dynamic))
                   if a != b), min(len(static), len(dynamic)))
        raise AssertionError(
            f"stacked draw trace diverged at event {at} (static "
            f"{len(static)}, card {len(dynamic)})")
    record["stacked_oracle"] = {
        "replay_host_ms": replay_ms, "events": len(static),
        "counts": ledger.stacked_counts(),
        "request_ms": stacked_s * 1e3,
        "max_abs_err": request_error(out, xr),
    }
    log(f"analyzer stacked oracle: {json.dumps(record['stacked_oracle'])} "
        f"launches {launches['analyzer_stacked_request']}")

    # (c) the per-host draw oracle: phase 18's request on the card
    knobs = ("MOOSE_TPU_FIXED_KEYS", "MOOSE_TPU_ALLOW_WEAK_PRF")
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(dict(zip(knobs, (f"chip-smoke-{SEED}", "1"))))
    try:
        counts, counts_ms = host_ms(lambda: host_draw_counts(traced, specs))
        per_host = runtime_cls(ids, layout="per-host", use_jit=False,
                               device=device)
        rk.reset_launches()
        with drawledger.recording() as ledger:
            out, per_host_s = wall(lambda: per_host.evaluate_computation(
                logreg, {"x": xr}))
        launches["analyzer_per_host_request"] = dict(rk.LAUNCHES)
    finally:
        _restore(os, saved)
    plan = dict(per_host.last_plan)
    # the walk's plan autotuner table: on the card its False kernel
    # decisions route nothing (kernel or raise) and say so
    tuned = plan.pop("autotune", {}).get("decisions", {})
    applied = tuned.get("pallas_dot", {}).get(
        "applied", tuned.get("pallas_dot", {}).get("choice"))
    if plan != {"layout": "per-host", "lowered": False,
                "plan_mode": "eager", "pinned_ops": []} or (
            torch.device(device).type == "cuda" and applied is not False):
        raise AssertionError(f"per-host oracle ran {per_host.last_plan}")
    if ledger.host_report() != counts:
        raise AssertionError("per-host draw counts differ from the card's")
    record["per_host_oracle"] = {
        "static_host_ms": counts_ms,
        "keys": len(counts),
        "draws": sum(c["draws"] for c in counts.values()),
        "request_ms": per_host_s * 1e3,
        "max_abs_err": request_error(out, xr),
    }
    log(f"analyzer per-host oracle: "
        f"{json.dumps(record['per_host_oracle'])} launches "
        f"{launches['analyzer_per_host_request']}")

    # (d) a strict compile with a trailing lint pass, served and linted
    args = {"x": xr}
    lowered, strict_ms = host_ms(lambda: compile_computation(
        traced, DEFAULT_PASSES + ["lint"], arg_specs_from_arguments(args),
        strict=True))
    diagnostics, analyze_ms = host_ms(lambda: analyze(lowered))
    if any(d.severity >= Severity.ERROR for d in diagnostics):
        raise AssertionError("the strict compile left an error")
    by_rule = dict(sorted(Counter(d.rule for d in diagnostics).items()))
    blob = serde.serialize_computation(lowered)
    compiled = runtime_cls(ids, use_jit=True, device=device)
    rk.reset_launches()
    out, compiled_s = wall(lambda: compiled.evaluate_compiled(blob, args))
    launches["analyzer_strict_compiled"] = dict(rk.LAUNCHES)
    compiled_err = request_error(out, xr)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config3.lowered.bin")
        with open(path, "wb") as f:
            f.write(blob)
        cli = subprocess.run(
            [sys.executable, "-m", "moose_tpu_torch.bin.prancer", path,
             "--format", "json"],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    if cli.returncode != 0:
        raise AssertionError(f"prancer exited {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    cli_records = json.loads(cli.stdout)
    runtime.evaluate_computation(logreg, {"x": xr})
    timings = dict(runtime.last_timings)
    if not {"evaluate_computation", "execute"} <= set(timings) or \
            timings["execute"] > timings["evaluate_computation"]:
        raise AssertionError(f"phase-6 request timings {timings}")
    record["strict_compile"] = {
        "ops": len(lowered.operations), "compile_host_ms": strict_ms,
        "analyze_host_ms": analyze_ms, "diagnostics_by_rule": by_rule,
        "request_ms": compiled_s * 1e3, "max_abs_err": compiled_err,
        "prancer_records": len(cli_records),
        "last_timings_us": timings,
    }
    log(f"analyzer strict compile: {json.dumps(record['strict_compile'])} "
        f"launches {launches['analyzer_strict_compiled']}")
    return record, launches


def run_serving(torch, rk, pm, classifier, weights, rng, card,
                per_request=None, device="cuda"):
    """Phase 22: secure-inference serving of phase 6's logistic
    regression, (a) to (f) of the module's docstring, with servers on
    ``device``.  ``weights`` are phase 20's exported weights (the
    hot-swapped model), ``per_request`` phase 6's launches a request (the
    counts a bucket-``SERVE_MAX_BATCH`` batch must launch; None skips
    that check).  Every number logged carries ``card``.  Returns (record,
    launches by path); raises on any failed check."""
    import json as _json
    import os
    import re
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np

    from moose_tpu_torch.bin import blitzen, donner
    from moose_tpu_torch.compilation import autotune
    from moose_tpu_torch.runtime import LocalMooseRuntime
    from moose_tpu_torch.serving import (
        CanaryConfig,
        ControlPlane,
        InferenceServer,
        LocalFleetClient,
        ServingConfig,
    )
    from moose_tpu_torch.training import export

    on_card = torch.device(device).type == "cuda"
    features, max_batch = SERVE_FEATURES, SERVE_MAX_BATCH
    kernel_names = ("dot_cross_terms", "trunc_pairs", "cross_terms_reshare",
                    "ring_mul", "bit_decompose", "msb", "horner",
                    "prf_threefry")
    record, launches = {"card": card}, {}
    closers = []

    def say(what, payload):
        log(f"serving {what} [{card}]: {_json.dumps(payload)}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def config(**overrides):
        values = dict(max_batch=max_batch, max_wait_ms=SERVE_WAIT_MS,
                      queue_bound=SERVE_QUEUE)
        values.update(overrides)
        return ServingConfig(**values)

    def new_server(buckets=(), **overrides):
        server = InferenceServer(config=config(**overrides), device=device)
        closers.append(server.close)
        t0 = time.perf_counter()
        registered = server.register_model(
            "logreg", classifier, row_shape=(features,), buckets=buckets)
        return server, registered, time.perf_counter() - t0

    def clock(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def within(got, x, model=classifier):
        want = logistic_reference(model, x)
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"served rows malformed: {got.shape}")
        return float(np.abs(got - want).max())

    def counted(path, fn):
        sync()
        rk.reset_launches()
        out = fn()
        sync()
        launches[path] = dict(rk.LAUNCHES)
        return out

    def batch_counts(path, batches=1):
        # a bucket-max_batch batch launches what a phase-6 request does
        if per_request is None:
            return
        got = {k: launches[path][k] for k in kernel_names}
        want = {k: per_request[k] * batches for k in kernel_names}
        if got != want:
            raise AssertionError(f"{path} launched {got}, not {want}")

    def serve(httpd):
        threading.Thread(target=httpd.serve_forever, daemon=True).start()

        def stop():
            httpd.shutdown()
            httpd.server_close()
        closers.append(stop)
        return f"http://127.0.0.1:{httpd.server_port}"

    def post(url, payload, headers=None):
        request = urllib.request.Request(
            url, data=_json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(request, timeout=300) as resp:
                return resp.status, _json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, _json.loads(e.read())

    def status_of(url):
        try:
            with urllib.request.urlopen(url, timeout=60) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code

    try:
        # (a) warm-up: the default autotuned ladder, one evaluation a
        # bucket, each bucket's eval_s recorded for later registrations
        decision = autotune.serving_bucket_plan(max_batch)
        server, registered, register_s = new_server()
        warm = {b: r["eval_s"] * 1e3
                for b, r in registered.warmup_report.items()}
        record["warmup"] = {
            "buckets": list(registered.buckets),
            "source": decision.source, "why": decision.why,
            "register_ms": register_s * 1e3, "warm_ms_by_bucket": warm,
            "plan_state": sorted({r["plan_state"] for r in
                                  registered.warmup_report.values()}),
        }
        say("warm-up", record["warmup"])
        if registered.buckets != tuple(decision.choice):
            raise AssertionError(f"warmed {registered.buckets}")

        # (b) a burst of 1-, 7- and 64-row requests from SERVE_THREADS
        # threads, then one request of SERVE_BIG rows
        sizes = [n for n, count in SERVE_BURST for _ in range(count)]
        burst_x = [rng.normal(size=(n, features)) for n in sizes]
        results, failures = [None] * len(sizes), []

        def client(k):
            try:
                futures = [(i, server.submit("logreg", burst_x[i]))
                           for i in range(k, len(sizes), SERVE_THREADS)]
                for i, future in futures:
                    results[i] = future.result(timeout=600)
            except Exception as e:  # noqa: BLE001 — counted below
                failures.append(repr(e))

        def burst():
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(SERVE_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        _, burst_s = counted("serving_burst", lambda: clock(burst))
        if failures:
            raise AssertionError(f"burst requests failed: {failures[:3]}")
        snap = server.metrics_snapshot()
        busy = None
        if on_card:
            # the same burst once more under the profiler: the card's
            # busy time over that burst's own wall (the profiler slows
            # the host, so its wall is kept beside the unprofiled one)
            def timed_burst():
                t0 = time.perf_counter()
                burst()
                sync()
                return time.perf_counter() - t0
            profiled_s, events = profiled(torch, timed_burst)
            if failures:
                raise AssertionError(f"burst failed: {failures[:3]}")
            busy_ms = sum(e.device_time_total for e in events) / 1e3
            if busy_ms > profiled_s * 1e3:
                raise AssertionError(
                    f"the card was busy {busy_ms} ms in a burst of "
                    f"{profiled_s * 1e3} ms")
            busy = {
                "device_busy_ms": busy_ms,
                "profiled_wall_ms": profiled_s * 1e3,
                "device_idle_share": 1.0 - busy_ms / (profiled_s * 1e3),
                "profiled_batches": server.metrics_snapshot()["batches"]
                - snap["batches"],
                "profiler_wall_ratio": profiled_s / burst_s,
            }
        burst_err = max(within(r, x) for r, x in zip(results, burst_x))
        if launches["serving_burst"]["dot_cross_terms"] != snap["batches"] \
                and on_card:
            raise AssertionError(
                f"{snap['batches']} burst batches launched K1 "
                f"{launches['serving_burst']['dot_cross_terms']} times")
        big_x = rng.normal(size=(SERVE_BIG, features))
        big, big_s = counted("serving_big_request", lambda: clock(
            lambda: server.predict("logreg", big_x, timeout_s=600)))
        big_err = within(big, big_x)
        batch_counts("serving_big_request")
        record["burst"] = {
            "requests": len(sizes), "rows": sum(sizes),
            "threads": SERVE_THREADS, "wall_ms": burst_s * 1e3,
            "rows_per_s": sum(sizes) / burst_s, "batches": snap["batches"],
            "batch_size_hist": snap["batch_size_hist"],
            "batch_fill_ratio": snap["batch_fill_ratio"],
            "request_latency_p50_ms": snap["request_latency_p50_s"] * 1e3,
            "request_latency_p99_ms": snap["request_latency_p99_s"] * 1e3,
            "queue_wait_p99_ms": snap["queue_wait_p99_s"] * 1e3,
            "compute_p99_ms": snap["compute_p99_s"] * 1e3,
            "profiled_burst": busy,
            "max_abs_err": burst_err,
            "big_request": {"rows": SERVE_BIG, "wall_ms": big_s * 1e3,
                            "max_abs_err": big_err},
            "retraces_after_warm": snap["retraces_after_warm"],
        }
        say("burst", record["burst"])
        if max(burst_err, big_err) >= LOGREG_TOL:
            raise AssertionError(
                f"served rows off by {max(burst_err, big_err)}")
        if snap["retraces_after_warm"]:
            raise AssertionError("a warm batch re-entered the tracer")

        # (b) under fixed keys: exactly one batch of max_batch rows,
        # gathered under a long max_wait_ms, word-equal to a direct
        # evaluation of that bucket on the card and on the CPU
        saved = _fixed_keys(os)
        try:
            fixed, fixed_reg, _ = new_server(
                max_wait_ms=600_000.0, buckets=(max_batch,),
                queue_bound=max_batch)
            per = max(1, max_batch // 16)
            fixed_x = rng.normal(size=(max_batch, features))

            def one_batch():
                futures = [fixed.submit("logreg", fixed_x[i:i + per])
                           for i in range(0, max_batch, per)]
                return np.concatenate(
                    [f.result(timeout=600) for f in futures])
            served = counted("serving_fixed_batch", one_batch)
            batch_counts("serving_fixed_batch")
            if fixed.metrics_snapshot()["batch_size_hist"] != {max_batch: 1}:
                raise AssertionError("the fixed batch was split")
            direct = {}
            for where in ((device, "cpu") if on_card else ("cpu",)):
                runtime = LocalMooseRuntime(
                    ["alice", "bob", "carole"], device=where)
                (out,) = runtime.evaluate_computation(
                    fixed_reg.comp, {fixed_reg.input_name: fixed_x}
                ).values()
                direct[where] = np.asarray(out)
        finally:
            _restore(os, saved)
        record["fixed_batch"] = {
            "rows": max_batch, "requests": max_batch // per,
            "equal_to_direct": {w: bool(np.array_equal(served, d))
                                for w, d in direct.items()},
            "launches": {k: launches["serving_fixed_batch"][k]
                         for k in kernel_names},
            "max_abs_err": within(served, fixed_x),
        }
        say("fixed-keys batch", record["fixed_batch"])
        if not all(record["fixed_batch"]["equal_to_direct"].values()):
            raise AssertionError("the served batch differs from a direct "
                                 "evaluation of its bucket")

        # (c) blitzen in-process: readiness, a predict, /metrics, 429
        lifecycle_a = blitzen.ReplicaLifecycle("a")
        url_a = serve(ThreadingHTTPServer(
            ("127.0.0.1", 0), blitzen._make_handler(server, lifecycle_a)))
        if status_of(url_a + "/readyz") != 200:
            raise AssertionError("replica a not ready after warm-up")
        probe_x = burst_x[0][:SERVE_PROBE_ROWS]
        code, body = counted("serving_http", lambda: post(
            url_a + "/v1/models/logreg:predict", {"x": probe_x.tolist()}))
        http_y = np.asarray(body.get("y"), dtype=np.float64)
        if code != 200:
            raise AssertionError(f"predict answered {code}: {body}")
        http_err = within(http_y, probe_x)
        vs_burst = float(np.abs(http_y - results[0][:SERVE_PROBE_ROWS]).max())
        if max(http_err, vs_burst) >= LOGREG_TOL:
            raise AssertionError(f"predict off by {http_err}, {vs_burst} "
                                 f"from (b)'s rows")
        with urllib.request.urlopen(url_a + "/metrics", timeout=60) as resp:
            text = resp.read().decode()
        sample = re.compile(
            r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$")
        samples = [line for line in text.splitlines()
                   if line and not line.startswith("#")]
        bad = [line for line in samples if not sample.match(line)]
        for line in samples:
            float(line.rsplit(" ", 1)[1])
        if bad or not samples:
            raise AssertionError(f"/metrics does not parse: {bad[:3]}")
        # a full queue: hold the evaluation lock until the scheduler holds
        # one batch it cannot evaluate, then flood the replica past the
        # queue's bound
        answers = []

        def flood():
            answers.append(post(url_a + "/v1/models/logreg:predict",
                                {"x": probe_x[:1].tolist()}))
        with server.registry.eval_lock:
            flooders = [threading.Thread(target=flood)]
            flooders[0].start()
            deadline = time.perf_counter() + 120
            while server.metrics_snapshot()["queue_depths"]["logreg"] \
                    or server._queues["logreg"]._in_flight == 0:
                if time.perf_counter() > deadline:
                    raise AssertionError("the scheduler took no batch")
                time.sleep(0.01)
            flooders += [threading.Thread(target=flood)
                         for _ in range(SERVE_QUEUE + 8)]
            for t in flooders[1:]:
                t.start()
            while not any(c == 429 for c, _ in answers):
                if time.perf_counter() > deadline:
                    raise AssertionError("the queue never answered 429")
                time.sleep(0.01)
        for t in flooders:
            t.join()
        rejected = [b for c, b in answers if c == 429]
        if not all(b.get("retryable") is True for b in rejected) or any(
                c not in (200, 429) for c, _ in answers):
            raise AssertionError(f"flood answers {answers[:3]}")
        record["http"] = {
            "predict_max_abs_err": http_err,
            "predict_vs_burst_rows": vs_burst,
            "metrics_samples": len(samples),
            "flood": {"requests": len(answers), "429": len(rejected),
                      "200": sum(c == 200 for c, _ in answers)},
        }

        # (d) donner in front of two replicas on the one card
        server_b, _, register_b_s = new_server()
        lifecycle_b = blitzen.ReplicaLifecycle("b")
        url_b = serve(ThreadingHTTPServer(
            ("127.0.0.1", 0), blitzen._make_handler(server_b, lifecycle_b)))
        router = donner.Router([url_a, url_b], config=donner.FleetConfig(
            backoff_ms=5.0, backoff_cap_ms=50.0, attempt_timeout_s=300.0,
            eject_after=2))
        for replica in router.replicas:
            router.probe_once(replica)
        if len(router.ready_replicas()) != 2:
            raise AssertionError("donner sees no two ready replicas")
        url_d = serve(ThreadingHTTPServer(
            ("127.0.0.1", 0), donner._make_handler(router)))
        code, body = counted("serving_routed", lambda: post(
            url_d + "/v1/models/logreg:predict", {"x": probe_x.tolist()}))
        if code != 200:
            raise AssertionError(f"donner answered {code}: {body}")
        routed_err = within(np.asarray(body["y"]), probe_x)
        if routed_err >= LOGREG_TOL:
            raise AssertionError(f"routed predict off by {routed_err}")
        # replica b drains: readiness flips, donner ejects it
        lifecycle_b.start_drain()
        drained = server_b.drain(timeout_s=60)
        readyz_b = status_of(url_b + "/readyz")
        router._rr = 0  # the first choice lands on b
        retry_status, retry_body, retry_info = router.forward(
            "/v1/models/logreg:predict",
            _json.dumps({"x": probe_x.tolist()}).encode(), {})
        for _ in range(2):
            router.probe_once(router.replicas[1])
        ejected = router.replicas[1].ejected
        code, body = post(url_d + "/v1/models/logreg:predict",
                          {"x": probe_x.tolist()})
        retry_err = after_err = None
        if retry_status == 200:
            retry_err = within(np.asarray(
                _json.loads(retry_body)["y"], dtype=np.float64), probe_x)
        if code == 200:
            after_err = within(np.asarray(body["y"], dtype=np.float64),
                               probe_x)
        record["http"]["drain_readyz"] = readyz_b
        record["routing"] = {
            "register_b_ms": register_b_s * 1e3,
            "routed_max_abs_err": routed_err, "b_drained": drained,
            "b_readyz": readyz_b, "retry_status": retry_status,
            "retry_attempts": retry_info.get("attempts"),
            "retry_max_abs_err": retry_err,
            "b_ejected": ejected, "after_ejection_status": code,
            "after_ejection_max_abs_err": after_err,
            "ready_replicas": [r.base_url for r in router.ready_replicas()],
        }
        say("http", record["http"])
        say("routing", record["routing"])
        if readyz_b != 503 or not drained:
            raise AssertionError("the drain did not flip /readyz to 503")
        if retry_status != 200 or not ejected or code != 200 or max(
                retry_err, after_err) >= LOGREG_TOL:
            raise AssertionError(f"routing around a drain failed: "
                                 f"{record['routing']}")
        server_b.close()

        # (e) hot swap of phase 20's weights under traffic, then one
        # control-plane promote over LocalFleetClient
        trained = export.trained_predictor(weights)
        stop, errors, served_n = threading.Event(), [], [0]

        def traffic(k):
            while not stop.is_set():
                try:
                    server.submit("logreg", burst_x[k % len(sizes)]).result(
                        timeout=600)
                    served_n[0] += 1
                except Exception as e:  # noqa: BLE001 — counted below
                    errors.append(repr(e))
                k += 4
        flows = [threading.Thread(target=traffic, args=(k,))
                 for k in range(4)]
        for t in flows:
            t.start()
        try:
            t0 = time.perf_counter()
            counted("serving_hot_swap",
                    lambda: export.hot_swap(server, "logreg", weights))
            swap_s = time.perf_counter() - t0
        finally:
            stop.set()
            for t in flows:
                t.join()
        swapped_x = rng.normal(size=(SERVE_PROBE_ROWS, features))
        swapped_err = within(server.predict("logreg", swapped_x),
                             swapped_x, trained)
        # the promote: the phase-6 weights come back as generation g1
        coef = classifier.coeffs[1].reshape(-1, 1)
        g1 = export.logreg_onnx_bytes(coef, classifier.intercepts[0, 1])
        base_t, canary_t = [], []
        for i in range(10_000):
            side = donner._assign_generation(
                "logreg", f"tenant-{i}", {"base": 0.5, "g1": 0.5})
            (base_t if side == "base" else canary_t).append(f"tenant-{i}")
            if len(base_t) >= 2 and len(canary_t) >= 2:
                break
        stop.clear()
        routed_codes, routed_failures = [], []

        def tenant_traffic(tenant):
            body = _json.dumps({"x": probe_x.tolist()}).encode()
            while not stop.is_set():
                status, answer, _ = router.forward(
                    "/v1/models/logreg:predict", body,
                    {"X-Moose-Tenant": tenant})
                routed_codes.append(status)
                if status != 200:
                    routed_failures.append(
                        (status, answer[:300].decode(errors="replace")))
                stop.wait(0.05)
        tenants = [threading.Thread(target=tenant_traffic, args=(t,))
                   for t in base_t[:2] + canary_t[:2]]
        plane = ControlPlane(LocalFleetClient(router, [server]), "logreg",
                             CanaryConfig(fraction=0.5, watch_s=0.5,
                                          min_requests=4, p99_slo_s=60.0,
                                          error_rate_slo=0.2, poll_s=0.1,
                                          timeout_s=300.0))
        for t in tenants:
            t.start()
        try:
            t0 = time.perf_counter()
            report = counted("serving_canary", lambda: plane.run_generation(
                "g1", g1, features))
            promote_s = time.perf_counter() - t0
        finally:
            stop.set()
            for t in tenants:
                t.join()
        promoted_x = rng.normal(size=(SERVE_PROBE_ROWS, features))
        promoted_err = within(server.predict("logreg", promoted_x),
                              promoted_x)
        record["hot_swap"] = {
            "swap_ms": swap_s * 1e3, "requests_during": served_n[0],
            "failed": len(errors), "max_abs_err": swapped_err,
            "promote": {"promoted": report["promoted"],
                        "reason": report["reason"],
                        "observed": report["observed"],
                        "wall_ms": promote_s * 1e3,
                        "routed_requests": len(routed_codes),
                        "non_200": routed_failures,
                        "max_abs_err": promoted_err},
        }
        say("hot swap", record["hot_swap"])
        if errors or swapped_err >= LOGREG_TOL:
            raise AssertionError(f"hot swap: {record['hot_swap']}")
        if not report["promoted"] or promoted_err >= LOGREG_TOL or any(
                c != 200 for c in routed_codes):
            raise AssertionError(f"promote: {record['hot_swap']['promote']}")
        if server.registry.names() != ["logreg"]:
            raise AssertionError(f"left {server.registry.names()}")

        # (f) snapshot, then a fresh server restores it (fixed keys)
        saved = _fixed_keys(os)
        try:
            with tempfile.TemporaryDirectory() as root:
                t0 = time.perf_counter()
                server.save_snapshot(root)
                save_s = time.perf_counter() - t0
                fresh = InferenceServer(config=config(), device=device)
                closers.append(fresh.close)
                t0 = time.perf_counter()
                restore = fresh.load_snapshot(root)
                restore_s = time.perf_counter() - t0
            snap_x = rng.normal(size=(SERVE_PROBE_ROWS, features))
            original = server.predict("logreg", snap_x)
            first = counted("serving_snapshot_request",
                            lambda: fresh.predict("logreg", snap_x))
            model = fresh.registry.get("logreg")
            padded, _ = model.pad(snap_x)
            _, eval_report = fresh.registry.evaluate(model, padded)
        finally:
            _restore(os, saved)
        record["snapshot"] = {
            "save_ms": save_s * 1e3, "restore_ms": restore_s * 1e3,
            "rewarm_ms": restore["rewarm_s"] * 1e3,
            "warmup_register_ms": register_s * 1e3,
            "probe_checked": restore["probe_checked"],
            "aot": restore["aot"]["logreg"],
            "first_request_equal": bool(np.array_equal(first, original)),
            "retraced": eval_report["retraced"],
            "retraces_after_warm":
                fresh.metrics_snapshot()["retraces_after_warm"],
            "max_abs_err": within(first, snap_x),
        }
        say("snapshot", record["snapshot"])
        if not record["snapshot"]["first_request_equal"] or \
                eval_report["retraced"] or \
                record["snapshot"]["retraces_after_warm"] or \
                restore["probe_checked"] != len(model.buckets):
            raise AssertionError(f"snapshot: {record['snapshot']}")
    finally:
        for close in reversed(closers):
            close()
    return record, launches


def run_distributed(torch, rk, ring, pm, classifier, logreg, runtime, rng,
                    card, device="cuda"):
    """Phase 23: distributed secure execution, (a) to (d) of the module's
    docstring: three workers on ``device``, first over LocalNetworking
    (dasher's path), then as three in-process gRPC WorkerServers under
    GrpcMooseRuntime, then as three comet processes driven by cometctl;
    the profiler around them and around a blitzen burst; the plan
    autotuner's tables and K1's micro.  ``classifier``/``logreg`` are
    phase 6's model and graph, ``runtime`` phase 6's runtime.  Every
    number logged carries ``card``.  Returns (record, launches by path);
    raises on any failed check."""
    import contextlib
    import json as _json
    import os
    import signal
    import socket
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer
    from pathlib import Path

    import numpy as np

    from moose_tpu_torch import metrics, profiling, serde
    from moose_tpu_torch.bin import blitzen
    from moose_tpu_torch.compilation import (
        DEFAULT_PASSES,
        autotune,
        compile_computation,
    )
    from moose_tpu_torch.compilation.analysis import cost_report
    from moose_tpu_torch.compilation.lowering import arg_specs_from_arguments
    from moose_tpu_torch.dialects import host
    from moose_tpu_torch.distributed.choreography import start_local_cluster
    from moose_tpu_torch.distributed.networking import LocalNetworking
    from moose_tpu_torch.distributed.worker import execute_role
    from moose_tpu_torch.edsl import tracer
    from moose_tpu_torch.runtime import GrpcMooseRuntime
    from moose_tpu_torch.serving import InferenceServer, ServingConfig

    ids = ("alice", "bob", "carole")
    record, launches = {"card": card}, {}
    kernel_names = ("dot_cross_terms", "ring_mul", "prf_threefry")

    def say(what, payload):
        log(f"distributed {what} [{card}]: {_json.dumps(payload)}")

    def sync():
        torch.cuda.synchronize()

    # config 1's secure dot and config 3's logistic regression, traced
    # once (a traced graph hits the client's and the workers' caches)
    x_dot = rng.normal(size=(DOT_N, DOT_N))
    y_dot = rng.normal(size=(DOT_N, DOT_N))
    x_log = [rng.normal(size=(LOGREG_ROWS, LOGREG_FEATURES))
             for _ in range(DIST_REQUESTS + 1)]
    graphs = {
        "secure_dot": (tracer.trace(secure_dot_computation(pm)),
                       lambda k: {"x": x_dot, "y": y_dot},
                       lambda k: x_dot @ y_dot, DOT_TOL),
        "logistic_regression": (
            tracer.trace(logreg),
            lambda k: {"x": x_log[k]},
            lambda k: logistic_reference(classifier, x_log[k]),
            LOGREG_TOL),
    }

    def error(name, out, k):
        _, _, reference, _ = graphs[name]
        got = out["output_0"]
        want = reference(k)
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            raise AssertionError(f"{name} output malformed: {got.shape}")
        return float(np.abs(got - want).max())

    def local_run(comp, args, net, session, dev=device):
        results, errors = {}, {}

        def work(identity):
            try:
                results[identity] = execute_role(
                    comp, identity, {}, args, net, session, timeout=300.0,
                    device=dev)
            except Exception as e:  # noqa: BLE001 — raised below
                errors[identity] = e

        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"local workers failed: {errors}")
        return results, {k: v for r in results.values()
                         for k, v in r["outputs"].items()}

    def capture(net):
        seen = {}
        put = net._store.put

        def keep(key, value):
            seen[key] = value
            put(key, value)

        net._store.put = keep
        return seen

    # (a) LocalNetworking: one cold and DIST_REQUESTS warm sessions a
    # graph
    lowered = {}
    for name, (comp, args_of, _, tol) in graphs.items():
        args0 = args_of(0)
        with host.deterministic_sync_keys(SEED):
            lowered[name] = compile_computation(
                comp, DEFAULT_PASSES, arg_specs_from_arguments(args0))
        net = LocalNetworking(device=device)
        walls, errs = [], []
        for k in range(DIST_REQUESTS + 1):
            if k == 1:
                sync()
                rk.reset_launches()
            (results, out), s = timed(torch, lambda: local_run(
                lowered[name], args_of(k), net, f"local-{name}-{k}"))
            walls.append(s)
            errs.append(error(name, out, k))
        launches[f"distributed_local_{name}"] = dict(rk.LAUNCHES)
        if max(errs) > tol:
            raise AssertionError(f"local {name}: error {max(errs)} > {tol}")
        record[f"local_{name}"] = {
            "cold_ms": walls[0] * 1e3,
            "warm_ms": [s * 1e3 for s in walls[1:]],
            "max_abs_err": max(errs),
            "elapsed_time_micros": {
                i: r["elapsed_time_micros"] for i, r in results.items()},
            "plan_modes": sorted({r["plan_mode"] for r in results.values()}),
        }
        say(f"local {name}", record[f"local_{name}"])

    # (a) fixed keys: the card's words are the CPU's, outputs and every
    # payload on the wire, for config 3 over LocalNetworking
    saved = _fixed_keys(os)
    try:
        words, fixed_modes = {}, {}
        for dev in (device, "cpu"):
            net = LocalNetworking(device=dev)
            wire = capture(net)
            results, out = local_run(lowered["logistic_regression"],
                                     graphs["logistic_regression"][1](0),
                                     net, "fixed-keys", dev=dev)
            words[dev] = (out, wire)
            fixed_modes[str(dev)] = sorted(
                {r["plan_mode"] for r in results.values()})
    finally:
        _restore(os, saved)
    (card_out, card_wire), (cpu_out, cpu_wire) = words[device], words["cpu"]
    if not (set(card_out) == set(cpu_out) and all(
            np.array_equal(card_out[k], cpu_out[k]) for k in cpu_out)):
        raise AssertionError("fixed-keys outputs differ from the CPU's")
    if card_wire != cpu_wire:
        diff = sorted(k for k in cpu_wire if card_wire.get(k) != cpu_wire[k])
        raise AssertionError(f"fixed-keys payloads differ: {diff[:4]}")
    # the card's session replays its settled role plans (its cold and
    # warm sessions validated them): phase 30 (a) leans on this
    if not set(fixed_modes[str(device)]) <= {"segmented", "full-jit"}:
        raise AssertionError(f"fixed-keys session ran {fixed_modes}")
    record["fixed_keys_equal_to_cpu"] = {
        "outputs": len(cpu_out), "payloads": len(cpu_wire),
        "payload_bytes": sum(len(v) for v in cpu_wire.values()),
        "plan_modes": fixed_modes}
    say("fixed keys, card against CPU", record["fixed_keys_equal_to_cpu"])

    # (a) three in-process gRPC WorkerServers and GrpcMooseRuntime
    net_names = {
        "tx_bytes": "moose_tpu_net_tx_bytes_total",
        "rx_bytes": "moose_tpu_net_rx_bytes_total",
        "sends": "moose_tpu_net_sends_total",
        "send_many_envelopes": "moose_tpu_net_send_many_total",
        "send_many_payloads": "moose_tpu_net_send_many_payloads_total",
        "receives": "moose_tpu_net_receives_total",
    }

    def wire_counts():
        return {k: metrics.REGISTRY.value(v, transport="grpc")
                for k, v in net_names.items()}

    servers, endpoints = start_local_cluster(ids, device=device)
    profiled_trace = None
    try:
        client = GrpcMooseRuntime(endpoints, device=device)
        for name, (comp, args_of, _, tol) in graphs.items():
            walls, errs, timings = [], [], []
            for k in range(DIST_REQUESTS + 1):
                if k == 1:
                    sync()
                    rk.reset_launches()
                before = wire_counts()
                (out, tim), s = timed(torch, lambda: client
                                      .evaluate_computation(
                                          comp, args_of(k), timeout=600))
                measured = {key: int(v - before[key])
                            for key, v in wire_counts().items()}
                walls.append(s)
                errs.append(error(name, out, k))
                timings.append(dict(tim))
            launches[f"distributed_grpc_{name}"] = dict(rk.LAUNCHES)
            if max(errs) > tol:
                raise AssertionError(
                    f"grpc {name}: error {max(errs)} > {tol}")
            (compiled, _), = client._client._compile_cache[comp].values()
            report = cost_report(compiled, session_id="0" * 32,
                                 transport="grpc")
            predicted = {k: int(report["totals"][k]) for k in net_names}
            if not report["resolved"] or predicted != measured:
                raise AssertionError(
                    f"grpc {name}: measured {measured}, cost model "
                    f"{predicted}")
            # one more warm request under the profiler, its wall timed
            # inside the profiled region: the busy share of that run
            (_, profiled_s), events = profiled(torch, lambda: timed(
                torch, lambda: client.evaluate_computation(
                    comp, args_of(1), timeout=600)))
            busy_ms = sum(e.device_time_total for e in events) / 1e3
            if busy_ms > profiled_s * 1e3:
                raise AssertionError(
                    f"grpc {name}: the card was busy {busy_ms} ms in a "
                    f"request of {profiled_s * 1e3} ms")
            record[f"grpc_{name}"] = {
                "cold_ms": walls[0] * 1e3,
                "warm_ms": [s * 1e3 for s in walls[1:]],
                "max_abs_err": max(errs),
                "elapsed_time_micros": timings[1:],
                "plan_modes": client.last_plan_modes,
                "wire": measured,
                "wire_equal_to_cost_model": True,
                "device_launches": len(events),
                "device_busy_ms": busy_ms,
                "profiled_wall_ms": profiled_s * 1e3,
                "device_idle_share": 1.0 - busy_ms / (profiled_s * 1e3),
            }
            say(f"grpc {name}", record[f"grpc_{name}"])

        # (c) one profiled request of (a)
        comp, args_of, _, _ = graphs["logistic_regression"]
        profiling.start()
        try:
            client.evaluate_computation(comp, args_of(1), timeout=600)
        finally:
            profiled_trace = profiling.stop()
    finally:
        for srv in servers.values():
            srv.stop()

    def phase_summary(trace):
        out = {}
        for e in trace["traceEvents"]:
            if e.get("ph") == "X":
                entry = out.setdefault(e["name"], [0, 0.0])
                entry[0] += 1
                entry[1] += e["dur"] / 1e3
        return {k: {"count": c, "ms": ms} for k, (c, ms) in sorted(
            out.items())}

    phases = phase_summary(profiled_trace)
    want = {"run_computation", "attempt", "launch", "retrieve",
            "execute_role", "worker_segment", "serde", "net_send",
            "net_receive"}
    if not want <= set(phases):
        raise AssertionError(f"profile lacks {sorted(want - set(phases))}")
    if len({e["args"].get("trace_id") for e in profiled_trace["traceEvents"]
            if e.get("ph") == "X" and e["name"] == "execute_role"}) != 1:
        raise AssertionError("the workers' roots are not one trace")
    record["profile_request"] = phases
    say("profiled request", phases)

    # (b) three comet processes on the card, cometctl run from a TOML
    # session file (config 3)
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    ports = []
    for _ in ids:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    spec = ",".join(f"{i}=127.0.0.1:{p}" for i, p in zip(ids, ports))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        procs = {}
        try:
            for i, p in zip(ids, ports):
                procs[i] = subprocess.Popen(
                    [sys.executable, "-m", "moose_tpu_torch.bin.comet",
                     "--identity", i, "--port", str(p), "--endpoints", spec,
                     "--device", str(device)],
                    cwd=root, env=env, stdout=open(tmp / f"{i}.log", "w"),
                    stderr=subprocess.STDOUT)
            t0 = time.perf_counter()
            for i, p in zip(ids, ports):
                while True:
                    if procs[i].poll() is not None:
                        raise AssertionError(
                            f"comet {i} exited: "
                            f"{(tmp / f'{i}.log').read_text()[-2000:]}")
                    with contextlib.suppress(OSError), socket.create_connection(
                            ("127.0.0.1", p), timeout=1.0):
                        break
                    if time.perf_counter() - t0 > 300:
                        raise AssertionError(f"comet {i} never listened")
                    time.sleep(0.2)
            start_s = time.perf_counter() - t0
            x = args_of(DIST_REQUESTS)["x"]
            (tmp / "comp.bin").write_bytes(serde.serialize_computation(comp))
            (tmp / "args.json").write_text(_json.dumps({"x": x.tolist()}))
            (tmp / "session.toml").write_text(
                f'[computation]\npath = "{tmp / "comp.bin"}"\n[roles]\n'
                + "".join(f'{i} = "127.0.0.1:{p}"\n'
                          for i, p in zip(ids, ports)))
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "moose_tpu_torch.bin.cometctl", "run",
                 str(tmp / "session.toml"), "--args", str(tmp / "args.json"),
                 "--json"],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=600)
            run_s = time.perf_counter() - t0
            if run.returncode != 0:
                raise AssertionError(f"cometctl failed: {run.stderr[-3000:]}")
            rows = np.asarray(_json.loads(
                run.stdout.strip().splitlines()[-1])["output_0"])
            comet_err = error("logistic_regression", {"output_0": rows},
                              DIST_REQUESTS)
            if comet_err > LOGREG_TOL:
                raise AssertionError(f"comet rows: error {comet_err}")
            role_us = {
                line.split(":")[0].lstrip("# "): int(
                    line.split(":")[1].split()[0])
                for line in run.stderr.splitlines()
                if line.startswith("# ") and line.endswith(" us")}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
            codes = {}
            for i, proc in procs.items():
                try:
                    codes[i] = proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    codes[i] = proc.wait()
        if any(codes.values()):
            raise AssertionError(
                f"comets did not stop cleanly: {codes}; "
                + (tmp / "alice.log").read_text()[-2000:])
    record["comet"] = {
        "start_s": start_s, "cometctl_run_s": run_s,
        "max_abs_err": comet_err, "elapsed_time_micros": role_us,
        "exit_codes": codes,
    }
    say("comet processes and cometctl", record["comet"])

    # (c) a blitzen burst under the profiler, and /debug/profile on
    # blitzen and on the metrics server: a capture, and 409 while busy
    server = InferenceServer(config=ServingConfig(
        max_batch=64, max_wait_ms=SERVE_WAIT_MS, queue_bound=SERVE_QUEUE),
        device=device)
    metrics_server = metrics.serve_http(0)
    httpd = None
    try:
        # registered before the front end opens, so it answers ready
        server.register_model("logreg", classifier,
                              row_shape=(LOGREG_FEATURES,), buckets=(1, 64))
        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    blitzen._make_handler(server))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_port}"

        def post(rows):
            request = urllib.request.Request(
                f"{base}/v1/models/logreg:predict",
                data=_json.dumps({"x": rows.tolist()}).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(request, timeout=300) as resp:
                answers.append(_json.loads(resp.read()))

        burst = [rng.normal(size=(4, LOGREG_FEATURES)) for _ in range(16)]
        answers = []
        profiling.start()
        try:
            threads = [threading.Thread(target=post, args=(rows,))
                       for rows in burst]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
        finally:
            burst_trace = profiling.stop()
        if len(answers) != len(burst):
            raise AssertionError(
                f"blitzen answered {len(answers)} of {len(burst)}")
        served = phase_summary(burst_trace)
        want = {"serve_queue_wait", "serve_compute", "serve_batch",
                "execute"}
        if not want <= set(served):
            raise AssertionError(
                f"burst profile lacks {sorted(want - set(served))}")
        answers = {}
        for label, url in (
                ("blitzen", f"{base}/debug/profile"),
                ("metrics", f"http://127.0.0.1:{metrics_server.port}"
                            "/debug/profile")):
            with urllib.request.urlopen(f"{url}?seconds=0.2",
                                        timeout=60) as resp:
                body = _json.loads(resp.read())
                if resp.status != 200 or "traceEvents" not in body:
                    raise AssertionError(f"{label} capture: {resp.status}")
            profiling.start()
            try:
                urllib.request.urlopen(f"{url}?seconds=0.2", timeout=60)
                raise AssertionError(f"{label}: no 409 while busy")
            except urllib.error.HTTPError as e:
                if e.code != 409:
                    raise AssertionError(f"{label}: {e.code}, not 409")
            finally:
                profiling.stop()
            answers[label] = {"capture": 200, "busy": 409}
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        metrics_server.close()
        server.close()
    record["profile_burst"] = served
    record["debug_profile"] = answers
    say("profiled blitzen burst", {"phases": served, "endpoints": answers})

    # (c) the profiler's cost on a warm phase-6 request: hooks stubbed
    # out, hooks present and off, profiler on; 10 rounds in turns
    x6 = x_log[0]
    runtime.evaluate_computation(logreg, {"x": x6})
    hooks = {name: getattr(profiling, name)
             for name in ("phase", "fence", "record_complete")}
    stubs = {"phase": lambda *a, **k: contextlib.nullcontext(),
             "fence": lambda *a, **k: None,
             "record_complete": lambda *a, **k: None}
    walls = {"stubbed": [], "off": [], "on": []}
    for _ in range(DIST_OVERHEAD_RUNS):
        for mode in ("stubbed", "off", "on"):
            if mode == "stubbed":
                for name, fn in stubs.items():
                    setattr(profiling, name, fn)
            elif mode == "on":
                profiling.start()
            try:
                _, s = timed(torch, lambda: runtime.evaluate_computation(
                    logreg, {"x": x6}))
            finally:
                for name, fn in hooks.items():
                    setattr(profiling, name, fn)
                if mode == "on":
                    profiling.stop()
            walls[mode].append(s * 1e3)
    medians = {k: statistics.median(v) for k, v in walls.items()}
    record["profiler_overhead"] = {
        "median_ms": medians,
        "off_over_stubbed": medians["off"] / medians["stubbed"] - 1.0,
        "on_over_off": medians["on"] / medians["off"] - 1.0,
        "runs": walls,
    }
    say("profiler overhead", record["profiler_overhead"])

    # (d) the plan autotuner: the decision tables of config 1's and
    # config 3's graphs on the card, and K1's micro per shape class
    tables = {
        name: autotune.autotune_plan(graphs[name][0],
                                     device=device).as_dict()
        for name in graphs
    }
    micro = {}
    for cls in ("mxu", "tall", "small"):
        row = autotune.measure_dot_micro(128, cls, iters=DIST_MICRO_ITERS,
                                         device=device)
        if row is None:
            raise AssertionError(f"measure_dot_micro({cls}) measured nothing")
        m, k, n = autotune._DOT_CLASS_SHAPES[cls]
        bound_ms, bound_by = dot_bound(m, k, n, 128)
        micro[cls] = {"shape": [m, k, n], "k1_ms": row["cuda_s"] * 1e3,
                      "bound_ms": bound_ms, "bound_by": bound_by}
    record["autotune"] = {"tables": tables, "dot_micro": micro}
    say("autotune", record["autotune"])
    for path, counts in launches.items():
        for name in kernel_names:
            if counts[name] < 1:
                raise AssertionError(f"{path} never launched {name}")
    return record, launches


def run_faults(torch, rk, pm, classifier, logreg, card, device="cuda",
               rows=LOGREG_ROWS):
    """Phase 24: (a) to (f) of the module's docstring with the port on
    ``device`` (on the CPU, as the tests run it small, ``rows`` rows).
    ``classifier``/``logreg`` are phase 6's model and graph.  Every
    number logged carries ``card``.  Returns (record, launches by path);
    raises on any failed check."""
    import contextlib
    import json as _json
    import os
    import signal
    import socket
    import tempfile
    import threading
    from pathlib import Path

    import numpy as np

    from moose_tpu_torch import serde, textual
    from moose_tpu_torch.compilation import (
        DEFAULT_PASSES,
        compile_computation,
    )
    from moose_tpu_torch.compilation.lowering import arg_specs_from_arguments
    from moose_tpu_torch.dialects import host
    from moose_tpu_torch.distributed.chaos import ChaosConfig
    from moose_tpu_torch.distributed.choreography import (
        ChoreographyClient,
        start_chaos_restarter,
        start_local_cluster,
    )
    from moose_tpu_torch.distributed.client import GrpcClientRuntime
    from moose_tpu_torch.distributed.networking import LocalNetworking
    from moose_tpu_torch.distributed.worker import execute_role
    from moose_tpu_torch.edsl import tracer
    from moose_tpu_torch.native import textual as native_textual
    from moose_tpu_torch.predictors.trainers import LogregSGDTrainer
    from moose_tpu_torch.runtime import LocalMooseRuntime
    from moose_tpu_torch.storage import FilesystemStorage
    from moose_tpu_torch.training import (
        CheckpointStore,
        TrainingConfig,
        TrainingSession,
    )
    from moose_tpu_torch.training.session import GrpcTrainingCluster

    ids = ("alice", "bob", "carole")
    on_card = torch.device(device).type == "cuda"
    record, launches = {"card": card}, {}
    root = Path(__file__).resolve().parent

    def say(what, payload):
        log(f"faults {what} [{card}]: {_json.dumps(payload)}")

    def clock(fn):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same(a, b):
        return set(a) == set(b) and all(
            np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)

    def free_ports():
        socks = [socket.socket() for _ in ids]
        try:
            for s in socks:
                s.bind(("127.0.0.1", 0))
            return [s.getsockname()[1] for s in socks]
        finally:
            for s in socks:
                s.close()

    # (a) secret integers on the stacked layout: values at and beyond
    # 2^63, exact against numpy's uint64 arithmetic
    gen = np.random.default_rng(SEED)
    xu, yu = (gen.integers(0, 2 ** 64, size=(rows, FAULT_INT_COLS),
                           dtype=np.uint64) for _ in range(2))
    int_comp = tracer.trace(secret_uint64_computation(pm))
    want = secret_uint64_reference(xu, yu)
    runtime = LocalMooseRuntime(ids, device=device)
    runtime.evaluate_computation(int_comp, {"x": xu, "y": yu})
    rk.reset_launches()
    walls = []
    for _ in range(FAULT_INT_REQUESTS):
        out, s = clock(lambda: runtime.evaluate_computation(
            int_comp, {"x": xu, "y": yu}))
        walls.append(s)
        for got, ref in zip(out.values(), want):
            if got.dtype != np.uint64 or not np.array_equal(got, ref):
                raise AssertionError("secret uint64 values differ from "
                                     "numpy's")
    launches["secret_uint64"] = dict(rk.LAUNCHES)
    if runtime.last_plan["layout"] != "stacked":
        raise AssertionError(
            f"secret uint64 ran {runtime.last_plan['layout']}")
    saved = _fixed_keys(os)
    try:
        words = [LocalMooseRuntime(ids, device=dev).evaluate_computation(
            int_comp, {"x": xu, "y": yu}) for dev in (device, "cpu")]
    finally:
        _restore(os, saved)
    if not same(*words):
        raise AssertionError("fixed-keys secret uint64 differs from the CPU")
    record["secret_uint64"] = {
        "shape": [rows, FAULT_INT_COLS],
        "operands_at_or_above_2_63": int(
            (xu >= 2 ** 63).sum() + (yu >= 2 ** 63).sum()),
        "wall_ms": [s * 1e3 for s in walls],
        "launches": {k: launches["secret_uint64"][k] for k in (
            "dot_cross_terms", "cross_terms_reshare", "prf_threefry")},
        "layout": runtime.last_plan["layout"],
        "fixed_keys_equal_to_cpu": True,
    }
    say("secret uint64", record["secret_uint64"])

    # (b) config 3 over gRPC workers under a chaos schedule: the client's
    # retries succeed, the words are the clean run's, the schedule the
    # CPU's for the same seed
    x3 = np.random.default_rng(SEED + 3).normal(size=(rows,
                                                      LOGREG_FEATURES))
    want3 = logistic_reference(classifier, x3)
    traced3 = tracer.trace(logreg)
    grpc_kw = dict(ping_interval=0.25, ping_misses=3, startup_grace=10.0,
                   receive_timeout=FAULT_RECEIVE_S, stall_grace=1.0)

    def cluster_run(dev, chaos, x=x3):
        servers, endpoints = start_local_cluster(ids, device=dev,
                                                 chaos=chaos, **grpc_kw)
        try:
            client = GrpcClientRuntime(endpoints,
                                       max_attempts=FAULT_ATTEMPTS,
                                       backoff_base_s=0.05,
                                       backoff_cap_s=0.2)
            with host.deterministic_sync_keys(SEED):
                out, _ = client.run_computation(traced3, {"x": x},
                                                timeout=300)
            return out, client.last_session_report
        finally:
            for srv in servers.values():
                srv.stop()

    spec = f"seed:{SEED},{FAULT_CHAOS}"
    saved = _fixed_keys(os)
    try:
        clean, _ = cluster_run(device, None)
        chaos = ChaosConfig.from_env(spec)
        rk.reset_launches()
        (out, report), chaos_s = clock(lambda: cluster_run(device, chaos))
        launches["chaos_grpc"] = dict(rk.LAUNCHES)
        # the rendezvous keys of the lowering do not depend on the rows:
        # the CPU runs the schedule on FAULT_CPU_ROWS of them
        cpu_chaos = ChaosConfig.from_env(spec)
        cpu_out, cpu_report = cluster_run("cpu", cpu_chaos,
                                          x3[:FAULT_CPU_ROWS])
    finally:
        _restore(os, saved)
    # every key's first send is decided once, whatever the timing, so
    # the drops are the seed's alone; a duplicate decision also counts
    # the sends of the failed attempt, which the abort cuts at a time
    kinds = {"drop_send"}
    counts = {k: sum(f["kind"] == k for f in report["faults_injected"])
              for k in ("drop_send", "dup_send", "delay")}
    err3 = float(np.abs(out["output_0"] - want3).max())
    if not report["ok"] or not report["faults_injected"]:
        raise AssertionError(f"chaos run: {report.get('attempts')}")
    if counts["drop_send"] and report["n_attempts"] < 2:
        raise AssertionError("a dropped send was not retried")
    if not same(out, clean) or not cpu_report["ok"]:
        raise AssertionError("chaos outputs differ from the clean run's")
    if err3 > LOGREG_TOL:
        raise AssertionError(f"chaos rows: error {err3} > {LOGREG_TOL}")
    digest = chaos.schedule_digest(kinds=kinds)
    if digest != cpu_chaos.schedule_digest(kinds=kinds):
        raise AssertionError("the card's chaos schedule is not the CPU's")
    record["chaos_grpc"] = {
        "spec": spec, "faults": counts,
        "attempts": report["n_attempts"],
        "cpu_attempts": cpu_report["n_attempts"],
        "wall_ms": chaos_s * 1e3, "max_abs_err": err3,
        "schedule_digest": digest, "equal_to_clean": True,
    }
    say("chaos over gRPC", record["chaos_grpc"])

    # (c) TrainingSession over GrpcTrainingCluster: once clean, once with
    # carole killed mid-epoch and restarted; bit-exact resume
    xt, yt = training_data(np.random.default_rng(SEED),
                           SESSION_BATCH * FAULT_TRAIN_STEPS,
                           SESSION_FEATURES)
    train_kw = dict(ping_interval=0.25, ping_misses=3, startup_grace=10.0,
                    receive_timeout=10.0, stall_grace=2.0, device=device)

    def train(tmp, chaos):
        stores = {p: CheckpointStore(FilesystemStorage(str(tmp / p)),
                                     party=p) for p in ids}
        servers, endpoints = start_local_cluster(
            ids, storages=stores, chaos=chaos, **train_kw)
        stop = start_chaos_restarter(servers, endpoints, stores, chaos,
                                     **train_kw)
        try:
            trainer = LogregSGDTrainer(
                n_features=SESSION_FEATURES, learning_rate=SESSION_LR,
                steps_per_epoch=FAULT_TRAIN_STEPS)
            session = TrainingSession(
                trainer, GrpcTrainingCluster(GrpcClientRuntime(
                    endpoints, max_attempts=3, backoff_base_s=0.1,
                    backoff_cap_s=0.5)),
                TrainingConfig(epochs=FAULT_TRAIN_EPOCHS,
                               session_timeout_s=300,
                               max_epoch_attempts=8, backoff_base_s=0.2,
                               backoff_cap_s=1.0))
            with host.deterministic_sync_keys(SEED):
                report = session.run(xt, yt)
            return report, committed_words(stores, trainer), session, \
                trainer
        finally:
            stop()
            for srv in servers.values():
                srv.stop()

    saved = _fixed_keys(os)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            # a kill budget never reached counts carole's ops
            counter = ChaosConfig(seed=SEED, kill_after_ops=10 ** 9,
                                  party="carole")
            (clean, clean_words, session, trainer), clean_s = clock(
                lambda: train(tmp / "clean", counter))
            total_ops = counter._ops["carole"]
            kill = ChaosConfig(seed=SEED,
                               kill_after_ops=int(FAULT_KILL_AT * total_ops),
                               party="carole", max_kills=1)
            rk.reset_launches()
            (chaotic, chaotic_words, _, _), chaos_s = clock(
                lambda: train(tmp / "chaos", kill))
            launches["chaos_training"] = dict(rk.LAUNCHES)
    finally:
        _restore(os, saved)
    state = {"w": session._initial_value("w", (SESSION_FEATURES, 1))}
    for _ in range(FAULT_TRAIN_EPOCHS):
        state = trainer.reference_epoch(state, xt, yt)
    w = chaotic["weights"]["w"]
    train_err = float(np.abs(w - state["w"]).max())
    if not [f for f in kill.faults if f["kind"] == "kill"]:
        raise AssertionError("the chaos schedule never killed carole")
    if not (clean["ok"] and chaotic["ok"] and chaotic["resumes"] >= 1):
        raise AssertionError(f"resume: {chaotic}")
    if not np.array_equal(w, clean["weights"]["w"]) or not same(
            {repr(k): v for k, v in clean_words.items()},
            {repr(k): v for k, v in chaotic_words.items()}):
        raise AssertionError("the resumed run's words differ")
    if w.shape != state["w"].shape or train_err > SESSION_TOL:
        raise AssertionError(f"trained weights: error {train_err}")
    record["chaos_training"] = {
        "epochs": FAULT_TRAIN_EPOCHS, "steps_per_epoch": FAULT_TRAIN_STEPS,
        "batch": [SESSION_BATCH, SESSION_FEATURES],
        "carole_ops": total_ops, "kill_after_ops": kill.kill_after_ops,
        "resumes": chaotic["resumes"], "clean_s": clean_s,
        "chaos_s": chaos_s, "max_abs_err": train_err,
        "committed_planes": len(clean_words), "words_equal": True,
    }
    say("chaos-resumed training", record["chaos_training"])

    # (d) and (e): config 3's lowered graph from a file on three vixen
    # processes over TCP, then on three rudolph processes from a
    # .session file; each against a LocalNetworking run on the card
    with host.deterministic_sync_keys(SEED):
        lowered3 = compile_computation(traced3, DEFAULT_PASSES,
                                       arg_specs_from_arguments({"x": x3}))
    env = dict(os.environ, PYTHONPATH=str(root))
    saved = _fixed_keys(os)
    try:
        env.update({k: os.environ[k] for k in saved})
        net = LocalNetworking(device=device)
        results = {}

        def work(identity):
            results[identity] = execute_role(
                lowered3, identity, {}, {"x": x3}, net, "local-24",
                timeout=300.0, device=device)

        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        local = {k: v for r in results.values()
                 for k, v in r["outputs"].items()}
    finally:
        _restore(os, saved)
    if len(results) != len(ids):
        raise AssertionError("the LocalNetworking workers failed")

    def wait_all(procs, logs, limit=300):
        codes = {}
        for i, proc in procs.items():
            try:
                codes[i] = proc.wait(timeout=limit)
            except subprocess.TimeoutExpired:
                proc.kill()
                codes[i] = proc.wait()
        if any(codes.values()):
            raise AssertionError(
                f"exit codes {codes}: "
                + "".join(Path(f).read_text()[-1500:] for f in logs))
        return codes

    def listening(procs, ports, logs, t0):
        for (i, p), f in zip(zip(ids, ports), logs):
            while True:
                if procs[i].poll() is not None:
                    raise AssertionError(
                        f"{i} exited: {f.read_text()[-1500:]}")
                with contextlib.suppress(OSError), \
                        socket.create_connection(("127.0.0.1", p),
                                                 timeout=1.0):
                    break
                if time.perf_counter() - t0 > 300:
                    raise AssertionError(f"{i} never listened")
                time.sleep(0.2)

    # the rudolph processes start first and come up while the vixens run
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        blob = serde.serialize_computation(lowered3)
        (tmp / "comp.bin").write_bytes(blob)
        (tmp / "args.json").write_text(_json.dumps({"x": x3.tolist()}))
        sessions = tmp / "sessions"
        sessions.mkdir()
        r_ports = free_ports()
        r_logs = [tmp / f"rudolph-{i}.log" for i in ids]
        r_procs = {}
        try:
            t0 = time.perf_counter()
            for (i, p), f in zip(zip(ids, r_ports), r_logs):
                r_procs[i] = subprocess.Popen(
                    [sys.executable, "-m", "moose_tpu_torch.bin.rudolph",
                     "--identity", i, "--port", str(p), "--sessions-dir",
                     str(sessions), "--poll-interval", "0.2", "--device",
                     str(device)],
                    cwd=root, env=env, stdout=open(f, "w"),
                    stderr=subprocess.STDOUT)
            spec = ",".join(f"{i}=127.0.0.1:{p}"
                            for i, p in zip(ids, free_ports()))
            v_logs = [tmp / f"vixen-{i}.log" for i in ids]
            v_procs = {
                i: subprocess.Popen(
                    [sys.executable, "-m", "moose_tpu_torch.bin.vixen",
                     str(tmp / "comp.bin"), "--identity", i, "--endpoints",
                     spec, "--session-id", "vixen-24", "--args",
                     str(tmp / "args.json"), "--passes", "", "--device",
                     str(device), "--outputs", str(tmp / f"{i}.npz")],
                    cwd=root, env=env, stdout=open(f, "w"),
                    stderr=subprocess.STDOUT)
                for i, f in zip(ids, v_logs)}
            vixen_codes = wait_all(v_procs, v_logs)
            vixen_s = time.perf_counter() - t0
            vixen_out = {}
            for i in ids:
                with np.load(tmp / f"{i}.npz") as data:
                    vixen_out.update({k: data[k] for k in data.files})
            vixen_err = float(np.abs(vixen_out["output_0"] - want3).max())
            if not same(vixen_out, local) or vixen_err > LOGREG_TOL:
                raise AssertionError(f"vixen rows: error {vixen_err}, "
                                     f"words equal {same(vixen_out, local)}")
            record["vixen"] = {"wall_s": vixen_s, "exit_codes": vixen_codes,
                               "max_abs_err": vixen_err,
                               "words_equal": True}
            say("vixen over TCP", record["vixen"])

            listening(r_procs, r_ports, r_logs, t0)
            t1 = time.perf_counter()
            (sessions / "comp.bin").write_bytes(blob)
            (sessions / "args.json").write_text(
                _json.dumps({"x": x3.tolist()}))
            (sessions / "run.session").write_text(
                'session_id = "rudolph-24"\narguments = "args.json"\n'
                '[computation]\npath = "comp.bin"\n[roles]\n'
                + "".join(f'{i} = "127.0.0.1:{p}"\n'
                          for i, p in zip(ids, r_ports)))
            rudolph_out = {}
            for p in r_ports:
                result = ChoreographyClient(f"127.0.0.1:{p}").retrieve(
                    "rudolph-24", timeout=300)
                if "error" in result:
                    raise AssertionError(f"rudolph session: {result}")
                for name, value in (result.get("outputs") or {}).items():
                    rudolph_out[name] = serde.deserialize_value(value)
            rudolph_s = time.perf_counter() - t1
        finally:
            for proc in r_procs.values():
                if proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
        rudolph_codes = wait_all(r_procs, r_logs, limit=60)
        rudolph_err = float(np.abs(rudolph_out["output_0"] - want3).max())
        if not same(rudolph_out, local) or rudolph_err > LOGREG_TOL:
            raise AssertionError(f"rudolph rows: error {rudolph_err}")
        record["rudolph"] = {"session_s": rudolph_s,
                             "exit_codes_on_sigterm": rudolph_codes,
                             "max_abs_err": rudolph_err,
                             "words_equal": True}
        say("rudolph from a .session file", record["rudolph"])

    # (f) the native textual parser against the Python one: config 3's
    # text, and its lowered graph's, past _NATIVE_PARSE_THRESHOLD
    t0 = time.perf_counter()
    if native_textual.load() is None:
        raise AssertionError("g++ did not build the native parser")
    parses = {"build_ms": (time.perf_counter() - t0) * 1e3}
    texts = {"logistic_regression": textual.to_textual(traced3),
             "lowered_logistic_regression": textual.to_textual(lowered3)}
    if len(texts["lowered_logistic_regression"]) < \
            textual._NATIVE_PARSE_THRESHOLD:
        raise AssertionError("the lowered text is under the threshold")
    before = dict(textual.PARSES)
    for name, text in texts.items():
        t0 = time.perf_counter()
        native = textual.parse_computation(text, force_native=True)
        native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        python = textual.parse_computation(text, force_native=False)
        python_ms = (time.perf_counter() - t0) * 1e3
        if serde.serialize_computation(native) != \
                serde.serialize_computation(python):
            raise AssertionError(f"{name}: the parsers' graphs differ")
        parses[name] = {"bytes": len(text), "native_ms": native_ms,
                        "python_ms": python_ms}
    textual.parse_computation(texts["lowered_logistic_regression"])
    if textual.PARSES["native"] - before["native"] != len(texts) + 1:
        raise AssertionError("the native parser did not run")
    record["textual"] = parses
    say("native parser", parses)
    return record, launches


def rank_dot_computation(pm, family="rep", precision=(24, 40)):
    """x on alice and y on bob at ``precision``, their Dot on the
    replicated placement (``family`` "rep") or as a host fixed-point Dot
    on alice ("host"), revealed to carole as float64."""
    alice = pm.host_placement("alice")
    bob = pm.host_placement("bob")
    carole = pm.host_placement("carole")
    rep = pm.replicated_placement("rep", players=[alice, bob, carole])
    fx = pm.fixed(*precision)

    @pm.computation
    def rank_dot(x: pm.Argument(alice, dtype=pm.float64),
                 y: pm.Argument(bob, dtype=pm.float64)):
        with alice:
            xf = pm.cast(x, dtype=fx)
        with bob:
            yf = pm.cast(y, dtype=fx)
        with rep if family == "rep" else alice:
            z = pm.dot(xf, yf)
        with carole:
            out = pm.cast(z, dtype=pm.float64)
        return out

    return rank_dot


def run_ranks(torch, rk, pm, card, device="cuda"):
    """Phase 26: the ring Dot at ranks past 2 on ``device``, (a) to (e)
    of the module's docstring.  Every Dot must fold to one K1 product
    (one a party per-host) at (1024, 100) @ (100, 64) and give the words
    of the same request on the CPU under fixed keys.  Every number
    logged carries ``card``.  Returns (record, launches by path); raises
    on any failed check."""
    import os

    import numpy as np

    from moose_tpu_torch.dialects import ring
    from moose_tpu_torch.runtime import LocalMooseRuntime

    ids = ("alice", "bob", "carole")
    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(SEED + 26)
    x3 = rng.normal(size=RANKS_X)
    x2 = x3.reshape(-1, RANKS_X[-1])
    w = glorot(rng, MLPC_FEATURES, MLPC_HIDDEN[0])
    y3 = w.reshape(RANKS_Y)
    m, k, n = x2.shape[0], MLPC_FEATURES, MLPC_HIDDEN[0]
    record, launches = {"card": card}, {}
    comps = {family: rank_dot_computation(pm, family)
             for family in ("rep", "host")}
    # (path, layout, family, x, y, K1 calls, the K1 shapes each calls)
    cases = [
        ("ranks_stacked_batched_x", "stacked", "rep", x3, w, 1,
         ((3, m, k), (3, k, n), 2)),
        ("ranks_stacked_rank3_y", "stacked", "rep", x2, y3, 1,
         ((3, m, k), (3, k, n), 2)),
        ("ranks_per_host_batched_x", "per-host", "rep", x3, w, 3,
         ((1, m, k), (1, k, n), 2)),
        ("ranks_per_host_rank3_y", "per-host", "rep", x2, y3, 3,
         ((1, m, k), (1, k, n), 2)),
        ("ranks_host_rank3_y", "auto", "host", x2, y3, 1,
         ((1, m, k), (1, k, n), 1)),
        ("ranks_host_vector", "auto", "host", x2[0], y3, 1,
         ((1, 1, k), (1, k, n), 1)),
    ]
    calls = []
    dot_cross_terms = rk.dot_cross_terms

    def logged(x0, x1, y0, ysum, width):
        calls.append((tuple(x0[0].shape), tuple(ysum[0].shape),
                      1 if x1 is None else 2))
        return dot_cross_terms(x0, x1, y0, ysum, width)

    def runtime(layout, on):
        return LocalMooseRuntime(ids, layout=layout, use_jit=False,
                                 device=on)

    saved = _fixed_keys(os)
    rk.dot_cross_terms = logged
    try:
        for path, layout, family, x, y, k1, shape in cases:
            args = {"x": x, "y": y}
            card_rt = runtime(layout, device)
            card_rt.evaluate_computation(comps[family], args)  # warm
            rk.reset_launches()
            del calls[:]
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = card_rt.evaluate_computation(comps[family], args)
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[path] = dict(rk.LAUNCHES)
            seen = list(calls)
            z = out["output_0"]
            cpu = runtime(layout, "cpu").evaluate_computation(
                comps[family], args)["output_0"]
            want = np.tensordot(x, y, 1)
            err = float(np.abs(z - want).max()) if z.shape == want.shape \
                else float("inf")
            row = {
                "layout": card_rt.last_plan["layout"],
                "x": list(np.shape(x)), "y": list(np.shape(y)),
                "out": list(z.shape), "wall_ms": wall * 1e3,
                "max_abs_err": err,
                "equal_to_cpu": bool(np.array_equal(z, cpu)),
                "k1_calls": [list(c) for c in seen],
                "k1_launches": launches[path]["dot_cross_terms"],
            }
            record[path] = row
            log(f"ranks {path} [{card}]: {json.dumps(row)}")
            if z.shape != want.shape or not np.all(np.isfinite(z)):
                raise AssertionError(f"{path}: output {z.shape}, not "
                                     f"{want.shape}")
            if err >= RANKS_TOL:
                raise AssertionError(f"{path}: error {err} >= {RANKS_TOL}")
            if not row["equal_to_cpu"]:
                raise AssertionError(f"{path}: words differ from the CPU's")
            if on_card and (seen != [shape] * k1
                            or row["k1_launches"] != k1):
                raise AssertionError(
                    f"{path}: K1 ran {seen} ({row['k1_launches']} "
                    f"launches), not {k1} x {shape}")

        # (e) a pair the JAX package refuses is refused on both layouts,
        # before any K1 launch
        xs, ys = (rng.normal(size=s) for s in RANKS_REFUSED)
        refused = {}
        for layout in ("stacked", "per-host"):
            rk.reset_launches()
            try:
                runtime(layout, device).evaluate_computation(
                    comps["rep"], {"x": xs, "y": ys})
            except ValueError as e:
                refused[layout] = str(e)
            else:
                raise AssertionError(f"{layout}: {RANKS_REFUSED} was not "
                                     "refused")
            if "cannot contract" not in refused[layout] \
                    or rk.LAUNCHES["dot_cross_terms"]:
                raise AssertionError(f"{layout}: refused as "
                                     f"{refused[layout]!r}")
        record["refused"] = refused
        log(f"ranks refused [{card}]: {json.dumps(refused)}")
    finally:
        rk.dot_cross_terms = dot_cross_terms
        _restore(os, saved)

    if on_card:
        # K1 at (a)'s folded shape on its own, CUDA events
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 26)
        x0, x1 = (random_words(torch, gen, (3, m, k), 128)
                  for _ in range(2))
        y0, y1 = (random_words(torch, gen, (3, k, n), 128)
                  for _ in range(2))
        ys_ = ring.add(*y0, *y1)
        k1_ms = cuda_time_ms(torch, lambda: rk.dot_cross_terms(
            x0, x1, y0, ys_, 128), reps=20)
        record["k1_ms"] = k1_ms
        log(f"ranks K1 (3,{m},{k})@(3,{k},{n}) ring128 {k1_ms:.4f} ms "
            f"[{card}]")
    return record, launches


def run_fabric(torch, rk, pm, classifier, logreg, x6, chaos_digest, card,
               device="cuda", dot_n=DOT_N):
    """Phase 25: (a) to (c) of the module's docstring with the port on
    ``device`` (on the CPU, as a dry run, the secure dot at ``dot_n``).
    ``classifier``/``logreg`` are phase 6's model and graph, ``x6`` phase
    6's first request, ``chaos_digest`` phase 24 (b)'s drop schedule.
    Every number logged carries ``card``.  Returns (record, launches by
    path); raises on any failed check."""
    import json as _json
    import os
    import threading

    import numpy as np

    from moose_tpu_torch import devices, metrics
    from moose_tpu_torch.compilation import (
        DEFAULT_PASSES,
        compile_computation,
    )
    from moose_tpu_torch.compilation.analysis import cost_report
    from moose_tpu_torch.compilation.lowering import arg_specs_from_arguments
    from moose_tpu_torch.dialects import host
    from moose_tpu_torch.distributed.chaos import ChaosConfig
    from moose_tpu_torch.distributed.choreography import start_local_cluster
    from moose_tpu_torch.distributed.client import GrpcClientRuntime
    from moose_tpu_torch.distributed.fabric import FabricDomain
    from moose_tpu_torch.distributed.networking import LocalNetworking
    from moose_tpu_torch.distributed.worker import execute_role
    from moose_tpu_torch.edsl import tracer
    from moose_tpu_torch.parallel import spmd
    from moose_tpu_torch.runtime import LocalMooseRuntime

    ids = ("alice", "bob", "carole")
    on_card = torch.device(device).type == "cuda"
    record, launches = {"card": card}, {}

    def say(what, payload):
        log(f"fabric/mesh {what} [{card}]: {_json.dumps(payload)}")

    def clock(fn):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same(a, b):
        return set(a) == set(b) and all(
            np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)

    def counted(path, fn):
        rk.reset_launches()
        out = fn()
        launches[path] = dict(rk.LAUNCHES)
        return out

    # (a) the mesh: config 3 on the stacked layout over make_mesh(), and
    # logreg_train_step at phase 20's width, each word-equal to its
    # mesh-less run under the same keys
    mesh = spmd.make_mesh(device=device)
    meshed = LocalMooseRuntime(ids, layout="stacked", mesh=mesh,
                               device=device)
    plain = LocalMooseRuntime(ids, layout="stacked", device=device)
    meshed.evaluate_computation(logreg, {"x": x6})
    saved = _fixed_keys(os)
    try:
        want6 = plain.evaluate_computation(logreg, {"x": x6})
        got6, mesh_s = clock(lambda: counted(
            "mesh_logistic_regression",
            lambda: meshed.evaluate_computation(logreg, {"x": x6})))
    finally:
        _restore(os, saved)
    err6 = float(np.abs(got6["output_0"]
                        - logistic_reference(classifier, x6)).max())
    if not same(got6, want6) or meshed.last_plan["layout"] != "stacked":
        raise AssertionError("config 3 on the mesh differs from phase 6's")
    if err6 > LOGREG_TOL:
        raise AssertionError(f"config 3 on the mesh: error {err6}")
    xt, yt = training_data(np.random.default_rng(SEED),
                           SESSION_BATCH * SESSION_STEPS, SESSION_FEATURES)
    w_plain = spmd_training(torch, spmd, xt, yt, SESSION_BATCH, SESSION_LR,
                            device)
    w_mesh, steps_s = clock(lambda: counted(
        "mesh_logreg_train_step", lambda: spmd_training(
            torch, spmd, xt, yt, SESSION_BATCH, SESSION_LR, device,
            mesh=mesh)))
    if not np.array_equal(w_mesh, w_plain):
        raise AssertionError("logreg_train_step on the mesh differs")
    record["mesh"] = {
        "shape": mesh.shape, "torch_device": str(mesh.torch_device),
        "logistic_regression": {"wall_ms": mesh_s * 1e3,
                                "max_abs_err": err6, "words_equal": True},
        "logreg_train_step": {"steps": SESSION_STEPS,
                              "ms_per_step": steps_s * 1e3 / SESSION_STEPS,
                              "weights_equal": True},
    }
    say("mesh", record["mesh"])

    # (b) the fabric: config 1's secure dot and config 3 on three
    # in-process workers whose parties are three handles over the card,
    # against the same sessions over LocalNetworking and gRPC
    x_dot = np.random.default_rng(SEED + 25).normal(size=(dot_n, dot_n))
    y_dot = np.random.default_rng(SEED + 26).normal(size=(dot_n, dot_n))
    graphs = {
        "secure_dot": (tracer.trace(secure_dot_computation(pm)),
                       {"x": x_dot, "y": y_dot}, x_dot @ y_dot, DOT_TOL),
        "logistic_regression": (tracer.trace(logreg), {"x": x6},
                                logistic_reference(classifier, x6),
                                LOGREG_TOL),
    }
    domain = FabricDomain(dict(zip(
        ids, ([h] for h in devices.virtual_devices(device, 3)))),
        "simulation")
    fabric_names = {
        "sends": ("moose_tpu_net_sends_total", {"transport": "fabric"}),
        "fabric_permutes": ("moose_tpu_fabric_permutes_total", {}),
        "fabric_batched_permutes":
            ("moose_tpu_fabric_batched_permutes_total", {}),
        "fabric_permute_payloads":
            ("moose_tpu_fabric_permute_payloads_total", {}),
        "fabric_tx_bytes": ("moose_tpu_fabric_tx_bytes_total", {}),
    }

    def value(name, **labels):
        return metrics.REGISTRY.value(name, **labels)

    def fabric_counts():
        return {k: int(value(n, **lb)) for k, (n, lb) in
                fabric_names.items()}

    def wire_sends():
        return int(sum(value(n, transport=t) for t in ("grpc", "local")
                       for n in ("moose_tpu_net_sends_total",
                                 "moose_tpu_net_send_many_total")))

    def local_session(comp, args):
        net, results = LocalNetworking(device=device), {}

        def work(identity):
            results[identity] = execute_role(
                comp, identity, {}, args, net, "local-25", timeout=300.0,
                device=device)

        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in ids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if len(results) != len(ids):
            raise AssertionError("the LocalNetworking workers failed")
        return {k: v for r in results.values()
                for k, v in r["outputs"].items()}

    def cluster(fabric_domain, runs, chaos=None, **kw):
        """``runs(client)`` against three in-process gRPC workers."""
        servers, endpoints = start_local_cluster(
            ids, device=device, fabric_domain=fabric_domain, chaos=chaos,
            **kw)
        try:
            return runs(GrpcClientRuntime(endpoints, **(
                {} if chaos is None else dict(
                    max_attempts=FAULT_ATTEMPTS, backoff_base_s=0.05,
                    backoff_cap_s=0.2))))
        finally:
            for srv in servers.values():
                srv.stop()

    def session(client, comp, args):
        with host.deterministic_sync_keys(SEED):
            out, _ = client.run_computation(comp, args, timeout=600)
        return out

    wire = {}
    saved = _fixed_keys(os)
    try:
        for name, (comp, args, reference, tol) in graphs.items():
            with host.deterministic_sync_keys(SEED):
                lowered = compile_computation(
                    comp, DEFAULT_PASSES, arg_specs_from_arguments(args))
            local, local_s = clock(lambda: local_session(lowered, args))

            def wire_runs(client):
                return [clock(lambda: session(client, comp, args))
                        for _ in range(2)]

            (wire[name], _), (_, wire_s) = cluster(None, wire_runs)

            def fabric_runs(client):
                runs = [clock(lambda: session(client, comp, args))]
                before, sends = fabric_counts(), wire_sends()
                runs.append(clock(lambda: counted(
                    f"fabric_{name}", lambda: session(client, comp,
                                                      args))))
                measured = {k: v - before[k]
                            for k, v in fabric_counts().items()}
                return runs, measured, wire_sends() - sends, \
                    client.last_session_report

            runs, measured, wired, report = cluster(domain, fabric_runs)
            (_, fabric_cold_s), (out, fabric_s) = runs
            model = cost_report(lowered, session_id="0" * 32,
                                transport="fabric", fabric_parties=ids)
            predicted = {k: int(model["totals"][k]) for k in fabric_names}
            err = float(np.abs(out["output_0"] - reference).max())
            if not (same(out, local) and same(out, wire[name])):
                raise AssertionError(f"fabric {name}: words differ from "
                                     "the wire sessions'")
            if wired or not model["resolved"] or measured != predicted:
                raise AssertionError(
                    f"fabric {name}: {wired} wire sends, measured "
                    f"{measured}, cost model {predicted}")
            if report["transport"] != "fabric" or \
                    report["trust_model"] != "simulation":
                raise AssertionError(f"fabric {name}: report {report}")
            if err > tol:
                raise AssertionError(f"fabric {name}: error {err}")
            record[f"fabric_{name}"] = {
                "local_ms": local_s * 1e3, "grpc_warm_ms": wire_s * 1e3,
                "fabric_cold_ms": fabric_cold_s * 1e3,
                "fabric_warm_ms": fabric_s * 1e3, "max_abs_err": err,
                "counters": measured, "equal_to_cost_model": True,
                "wire_sends": wired, "words_equal_to_local_and_grpc": True,
                "transport": report["transport"],
                "trust_model": report["trust_model"],
            }
            say(f"fabric {name}", record[f"fabric_{name}"])
        comp, args, _, _ = graphs["logistic_regression"]

        # two more warm fabric sessions under torch.profiler: the card's
        # busy time, and the copies inside the permutes
        def profiled_runs(client):
            session(client, comp, args)
            before = fabric_counts()["fabric_permutes"]

            def run():
                return clock(lambda: session(client, comp, args))[1]

            s, events = profiled(torch, run) if on_card else (run(), [])
            permutes = fabric_counts()["fabric_permutes"] - before
            # and one with every thread's CPU traced: the device work
            # launched inside the permutes alone, one copy a non-empty
            # tensor leaf.  The profiler ties a device event to its range
            # through the launching thread, and now and then loses that
            # tie for a copy made on a thread the worker pool has just
            # started (a copy_ left with no device event, seen outside
            # the permutes too): a count short of the leaves is read
            # again, at most PERMUTE_READS times in all, and every short
            # read is logged.  A count above the leaves fails at once.
            short = []
            for _ in range(PERMUTE_READS):
                _, copies, leaves, ranges, calls = permute_copies(
                    torch, domain, lambda: session(client, comp, args))
                if ranges != permutes or not on_card or \
                        len(copies) >= leaves:
                    break
                short.append([len(copies), leaves, calls[:4]])
            return s, events, permutes, copies, leaves, ranges, short

        # a count that stays short through a cluster's reads is read
        # again on a fresh cluster (new worker and session threads), once
        prof_s, events, permutes, copies, leaves, ranges, short = cluster(
            domain, profiled_runs)
        if on_card and ranges == permutes and len(copies) < leaves:
            prof_s, events, permutes, copies, leaves, ranges, again = \
                cluster(domain, profiled_runs)
            short = short + ["fresh cluster"] + again
        busy_ms = sum(e.device_time_total for e in events) / 1e3
        if ranges != permutes or (on_card and len(copies) != leaves):
            raise AssertionError(
                f"fabric permutes: {ranges} ranges of {permutes} "
                f"permutes, {len(copies)} device copies of {leaves} "
                f"leaves (short reads before: {short})")
        copy_ms = sum(k.duration for k in copies) / 1e3
        record["fabric_profiled"] = {
            "wall_ms": prof_s * 1e3, "permutes": permutes,
            "permuted_leaves": leaves, "short_reads": short,
            "permute_copies": sorted({k.name for k in copies}),
            "permute_copy_ms": copy_ms,
            "copy_ms_per_permute": copy_ms / max(permutes, 1),
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (prof_s * 1e3),
        }
        say("a profiled fabric session of config 3",
            record["fabric_profiled"])

        # (b) a mixed domain: carole outside it keeps the wire
        mixed = FabricDomain(dict(zip(
            ids[:2], ([h] for h in devices.virtual_devices(device, 2)))),
            "simulation")

        def mixed_runs(client):
            before = value("moose_tpu_fabric_fallbacks_total",
                           reason="trust_boundary")
            out = counted("fabric_mixed", lambda: session(client, comp,
                                                          args))
            return out, int(value("moose_tpu_fabric_fallbacks_total",
                                  reason="trust_boundary") - before), \
                client.last_session_report

        out, crossed, report = cluster(mixed, mixed_runs)
        with host.deterministic_sync_keys(SEED):
            lowered = compile_computation(
                comp, DEFAULT_PASSES, arg_specs_from_arguments(args))
        model = cost_report(lowered, session_id="0" * 32,
                            transport="fabric", fabric_parties=ids[:2])
        fallbacks = sum(model["per_party"][p]["fallback_sends"]
                        for p in ids[:2])
        wire3 = wire["logistic_regression"]
        if not same(out, wire3) or crossed != fallbacks or not crossed \
                or report["transport"] != "mixed":
            raise AssertionError(
                f"mixed fabric: words equal {same(out, wire3)}, "
                f"{crossed} trust_boundary fallbacks, model {fallbacks}, "
                f"transport {report['transport']}")
        record["fabric_mixed"] = {
            "trust_boundary_fallbacks": crossed,
            "cost_model_fallback_sends": fallbacks,
            "transport": report["transport"], "words_equal": True}
        say("mixed fabric (carole outside)", record["fabric_mixed"])

        # (c) chaos over the fabric: phase 24 (b)'s schedule; the dropped
        # keys' replays ride the wire
        spec = f"seed:{SEED},{FAULT_CHAOS}"
        chaos = ChaosConfig.from_env(spec)
        forced = value("moose_tpu_fabric_fallbacks_total",
                       reason="forced_wire")

        def chaos_runs(client):
            out = counted("fabric_chaos", lambda: session(client, comp,
                                                          args))
            return out, client.last_session_report

        (out, report), chaos_s = clock(lambda: cluster(
            FabricDomain(dict(zip(ids, ([h] for h in
                                        devices.virtual_devices(device, 3)))),
                         "simulation"),
            chaos_runs, chaos=chaos, ping_interval=0.25, ping_misses=3,
            startup_grace=10.0, receive_timeout=FAULT_RECEIVE_S,
            stall_grace=1.0))
        forced = int(value("moose_tpu_fabric_fallbacks_total",
                           reason="forced_wire") - forced)
        digest = chaos.schedule_digest(kinds={"drop_send"})
        drops = sum(f["kind"] == "drop_send" for f in chaos.faults)
    finally:
        _restore(os, saved)
    if not report["ok"] or not same(out, wire["logistic_regression"]):
        raise AssertionError("chaos over the fabric: outputs differ")
    if digest != chaos_digest:
        raise AssertionError("chaos over the fabric: another schedule")
    if drops and (forced < drops or report["n_attempts"] < 2):
        raise AssertionError(f"chaos over the fabric: {drops} drops, "
                             f"{forced} forced_wire fallbacks")
    record["fabric_chaos"] = {
        "spec": spec, "drops": drops, "forced_wire_fallbacks": forced,
        "attempts": report["n_attempts"], "wall_ms": chaos_s * 1e3,
        "schedule_digest": digest, "equal_to_phase_24": True,
        "words_equal": True, "transport": report["transport"]}
    say("chaos over the fabric", record["fabric_chaos"])
    return record, launches


def plain_on_card(torch, rk):
    """Wrap every plain version of ``rk`` so that a call reaching it with
    a CUDA tensor or device (in any argument, through tuples, lists and
    dicts) is counted; returns (the count by name, a function that
    restores the originals)."""
    seen = {}
    originals = {name: getattr(rk, name) for name in dir(rk)
                 if name.endswith("_plain") and callable(getattr(rk, name))}

    def on_card(value):
        if isinstance(value, torch.Tensor):
            return value.device.type == "cuda"
        if isinstance(value, torch.device):
            return value.type == "cuda"
        if isinstance(value, (tuple, list)):
            return any(on_card(v) for v in value)
        if isinstance(value, dict):
            return any(on_card(v) for v in value.values())
        return False

    def counted(name, fn):
        def plain(*args, **kwargs):
            if on_card(args) or on_card(kwargs):
                seen[name] = seen.get(name, 0) + 1
            return fn(*args, **kwargs)
        return plain

    for name, fn in originals.items():
        setattr(rk, name, counted(name, fn))

    def restore():
        for name, fn in originals.items():
            setattr(rk, name, fn)

    return seen, restore


def run_programs(torch, rk, card, device="cuda"):
    """Phase 27: the port's programs of the reference's examples and
    tutorials.  The seven of ``PROGRAMS`` are imported and their
    ``main([..., "--device", device])`` called at the JAX scripts'
    defaults, each counted on its own (wall, launches; no plain version
    may see a card tensor); the three of ``PROGRAM_PROCESSES`` run
    ``PROGRAM_AT_ONCE`` at a time as ``python -m``, each in a session of
    its own, which must exit
    0, print the line, and leave no process of the session behind.
    Every number logged carries ``card``.  Returns (record, launches by
    path); raises on any failed check."""
    import contextlib
    import importlib
    import io
    import os
    import signal
    import tempfile
    from pathlib import Path

    import numpy as np

    on_card = torch.device(device).type == "cuda"
    record, launches = {"card": card}, {}
    seen, restore = plain_on_card(torch, rk)
    try:
        for name, ok_line in PROGRAMS.items():
            module = importlib.import_module(f"moose_tpu_torch.{name}")
            printed = io.StringIO()
            rk.reset_launches()
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                result = module.main(["--device", device])
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            path = "program_" + name.split(".")[1]
            launches[path] = dict(rk.LAUNCHES)
            lines = printed.getvalue().splitlines()
            for line in lines:
                log(f"  {name}: {line}")
            row = {"wall_s": wall, "launches": launches[path]}
            if ok_line is not None and ok_line not in lines:
                raise AssertionError(f"{name} did not print {ok_line!r}")
            if name == "examples.logistic_regression":
                # the same 8 SGD steps in float64, exact sigmoid
                lr = module
                rng = np.random.default_rng(0)
                x = rng.normal(size=(lr.BATCH, lr.N_FEATURES))
                y = (x @ rng.normal(size=(lr.N_FEATURES, 1)) > 0) \
                    .astype(np.float64)
                w = np.zeros((lr.N_FEATURES, 1))
                for _ in range(lr.STEPS):
                    w = w - lr.LR * x.T @ (1 / (1 + np.exp(-(x @ w))) - y) \
                        / lr.BATCH
                row["train_err"] = float(np.abs(result["w"] - w).max())
                row["score_err"] = float(
                    np.abs(result["scores"] - result["plain"]).max())
                if not (row["train_err"] < PROGRAM_TRAIN_TOL
                        and row["score_err"] < PROGRAM_SCORE_TOL):
                    raise AssertionError(f"{name}: {row}")
            elif name == "examples.resnet_inference":
                want = resnet_reference(result["params"], result["x"])
                probs = result["probs"]
                row["max_abs_err"] = float(np.abs(probs - want).max()) \
                    if probs.shape == want.shape else float("inf")
                if not row["max_abs_err"] < RESNET_TOL:
                    raise AssertionError(f"{name}: {row}")
            record[path] = row
            log(f"program {name}: wall {wall:.3f} s [{card}] "
                f"{json.dumps(row)}")
    finally:
        restore()
    if seen:
        raise AssertionError(f"plain versions ran on card tensors: {seen}")

    # the three process programs, PROGRAM_AT_ONCE at a time (the next
    # starts when one ends), each in a session of its own
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as files:
        pending = list(PROGRAM_PROCESSES.items())

        def start():
            name, (flags, ok_line) = pending.pop(0)
            path = "process_" + name.split(".")[1] + "".join(
                f"_{f.lstrip('-')}" for f in flags)
            out, err = (files.enter_context(open(Path(tmp) / f"{path}.{e}",
                                                 "w+"))
                        for e in ("out", "err"))
            proc = subprocess.Popen(
                [sys.executable, "-m", f"moose_tpu_torch.{name}", *flags,
                 "--device", device],
                cwd=root, env=env, stdout=out, stderr=err, text=True,
                start_new_session=True)
            runs[path] = (ok_line, proc, out, err, time.perf_counter())

        walls = {}
        deadline = time.perf_counter() + PROGRAM_TIMEOUT_S
        try:
            while (pending or len(walls) < len(runs)) and \
                    time.perf_counter() < deadline:
                while pending and len(runs) - len(walls) < PROGRAM_AT_ONCE:
                    start()
                for path, (_, proc, _, _, t0) in runs.items():
                    if path not in walls and proc.poll() is not None:
                        walls[path] = time.perf_counter() - t0
                time.sleep(0.05)
        finally:
            left = {}
            for path, (_, proc, _, _, _) in runs.items():
                # a process still in the program's session outlived it
                # (or the program outlived the deadline)
                try:
                    os.killpg(proc.pid, 0)
                    left[path] = True
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    left[path] = False
                proc.wait()
        if pending:
            raise AssertionError(
                f"programs never started within {PROGRAM_TIMEOUT_S} s: "
                f"{[name for name, _ in pending]}")
        for path, (ok_line, proc, out, err, _) in runs.items():
            out.seek(0)
            err.seek(0)
            lines = out.read().splitlines()
            row = {"wall_s": walls.get(path), "exit_code": proc.returncode,
                   "processes_left": left[path]}
            record[path] = row
            for line in lines:
                log(f"  {path}: {line}")
            log(f"program {path}: wall {row['wall_s']} s [{card}] "
                f"{json.dumps(row)}")
            if proc.returncode != 0 or left[path] or not any(
                    line.startswith(ok_line) for line in lines):
                raise AssertionError(f"{path}: {row}\n{err.read()[-3000:]}")
    return record, launches


def settle(runtime, comp, args, most=12, evaluate=None):
    """Evaluate ``comp`` on ``args`` (through ``evaluate``, by default
    the runtime's ``evaluate_computation``) until its plan leaves
    validation, as the serving registry warms a bucket: what is counted
    or timed after this is the steady state later requests get (on the
    card, replayed CUDA graphs).  Returns the walls of those
    evaluations."""
    if not runtime.use_jit:  # an eager runtime never validates
        return []
    evaluate = evaluate or runtime.evaluate_computation
    walls = []
    for _ in range(most):
        t0 = time.perf_counter()
        evaluate(comp, args)
        walls.append(time.perf_counter() - t0)
        if runtime.last_plan.get("plan_state") != "validating":
            return walls
    raise AssertionError(f"plan still validating after {most} evaluations")


def private_pool_bytes(torch):
    """Device bytes held by private memory pools (the CUDA graphs'),
    from the caching allocator's snapshot; 0 off the card."""
    if not torch.cuda.is_available():
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def run_plans(torch, rk, ring, card, configs, device="cuda"):
    """Phase 28: the stacked layout's compiled plans.  ``configs`` maps a
    name to (computation, arguments, float64 reference of arguments,
    tolerance); ``"secure_dot"`` and ``"logistic_regression"`` must be
    among them, the latter's one argument its rows.  (a) each config's
    plan validates on its first evaluations and settles promoted
    (``plan_state`` "jit", not eager, no pinned op), its results within
    tolerance; under the two fixed keys
    of PLAN_KEYS, PLAN_REPLAYS replays of the secure dot and the logistic
    regression each equal the eager walk's words under the same key, and
    the eager words of the two keys differ; (b) beside each: the median
    wall of PLAN_WALLS eager and replayed requests, the validating
    evaluations' walls, the launches a request (host counters), device
    launches, busy ms and idle share of one request each, and the bytes
    of the plan's private pools; (c) ``MOOSE_TPU_SELFCHECK_FORCE=1`` with
    ``MOOSE_TPU_SELFCHECK_FAULT=Dot`` on the secure dot descends to the
    per-op rung and pins exactly its Dot; each validating evaluation
    returns the eager reference's words (the whole-graph walk's on the
    segment rungs), and the promoted mixed plan returns the per-op
    reference's; (d) aes-ctr under ``use_jit`` raises the JAX package's
    ConfigurationError; (e) PLAN_THREADS threads of PLAN_THREAD_REQUESTS
    logistic-regression requests each on one runtime, every result equal
    to the single-thread run's under fixed keys and within tolerance.
    Every number logged carries ``card``.  Returns the record."""
    import contextlib
    import gc
    import os
    import threading

    import numpy as np

    from moose_tpu_torch.errors import ConfigurationError
    from moose_tpu_torch.runtime import LocalMooseRuntime

    ids = ["alice", "bob", "carole"]
    on_card = torch.device(device).type == "cuda"
    record = {"card": card}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def env(**values):
        saved = {k: os.environ.get(k) for k in values}
        os.environ.update(values)
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def fixed(key):
        return env(MOOSE_TPU_FIXED_KEYS=key, MOOSE_TPU_ALLOW_WEAK_PRF="1")

    def runtimes():
        return (LocalMooseRuntime(ids, use_jit=True, device=device),
                LocalMooseRuntime(ids, use_jit=False, device=device))

    def words(out):
        return out["output_0"]

    def max_err(got, want):
        return float(np.abs(got - want).max()) if got.shape == want.shape \
            else float("inf")

    def wall(rt, comp, args):
        sync()
        t0 = time.perf_counter()
        out = rt.evaluate_computation(comp, args)
        sync()
        return out, time.perf_counter() - t0

    def launches_of(rt, comp, args):
        before = dict(rk.LAUNCHES)
        rt.evaluate_computation(comp, args)
        return sum(rk.LAUNCHES[c] - before[c] for c in before)

    # (a) and (b)
    for name, (comp, args, reference, tol) in configs.items():
        want = reference(args)
        plan, eager = runtimes()
        pools = private_pool_bytes(torch)
        validating = settle(plan, comp, args)
        pool_bytes = private_pool_bytes(torch) - pools
        settled = {k: plan.last_plan.get(k)
                   for k in ("plan_mode", "pinned_ops", "plan_state")}
        if settled["plan_state"] != "jit" or \
                settled["plan_mode"] == "eager" or settled["pinned_ops"]:
            raise AssertionError(f"{name}: the plan settled on {settled}")
        if len(validating) < 2:
            raise AssertionError(f"{name}: the plan promoted unvalidated")
        walls = {"eager": [], "replayed": []}
        for _ in range(PLAN_WALLS):
            for mode, rt in (("eager", eager), ("replayed", plan)):
                out, s = wall(rt, comp, args)
                walls[mode].append(s)
                err = max_err(words(out), want)
                if not err < tol:
                    raise AssertionError(f"{name} {mode}: error {err}")
        graphs = plan.last_plan["cuda_graphs"]
        if on_card and graphs < 1:
            raise AssertionError(f"{name}: no CUDA graph replayed")
        row = {
            "plan": settled,
            "cuda_graphs": graphs,
            "validating_walls_ms": [s * 1e3 for s in validating],
            "eager_ms": statistics.median(walls["eager"]) * 1e3,
            "replayed_ms": statistics.median(walls["replayed"]) * 1e3,
            "launches_eager": launches_of(eager, comp, args),
            "launches_replayed": launches_of(plan, comp, args),
            "pool_bytes": pool_bytes,
            "max_abs_err": err,
        }
        if on_card:
            for mode, rt in (("eager", eager), ("replayed", plan)):
                n, busy = device_busy(
                    torch, lambda: rt.evaluate_computation(comp, args))
                row[f"device_launches_{mode}"] = n
                row[f"busy_ms_{mode}"] = busy
                row[f"idle_share_{mode}"] = max(
                    0.0, 1.0 - busy / row[f"{mode}_ms"])
        if row["launches_eager"] != row["launches_replayed"]:
            raise AssertionError(
                f"{name}: a replay counted {row['launches_replayed']} "
                f"launches, the eager walk {row['launches_eager']}")
        if name in ("secure_dot", "logistic_regression"):
            keyed = {}
            for key in PLAN_KEYS:
                with fixed(key):
                    keyed[key] = words(eager.evaluate_computation(comp, args))
                    for _ in range(PLAN_REPLAYS):
                        got = words(plan.evaluate_computation(comp, args))
                        if plan.last_plan["plan_state"] != "jit" or \
                                not np.array_equal(got, keyed[key]):
                            raise AssertionError(
                                f"{name}: a replay under {key} differs "
                                "from the eager walk's words")
            a, b = (keyed[k] for k in PLAN_KEYS)
            row["keys_differ"] = bool(not np.array_equal(a, b))
            if not row["keys_differ"]:
                raise AssertionError(
                    f"{name}: the eager words of two keys are equal")
        record[name] = row
        log(f"plans {name} [{card}]: {json.dumps(row)}")
        del plan, eager
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    # (c) the ladder under the fault knob
    comp, args, reference, tol = configs["secure_dot"]
    plan, eager = runtimes()
    with fixed(PLAN_KEYS[0]):
        want = words(eager.evaluate_computation(comp, args))
        with env(MOOSE_TPU_SELFCHECK_FORCE="1",
                 MOOSE_TPU_SELFCHECK_FAULT="Dot"):
            # (the rung an evaluation ran on, its plan after the run, its
            # words): a run reports its plan after a descent
            steps, rung = [], "start"
            for _ in range(12):
                got = words(plan.evaluate_computation(comp, args))
                state = {k: plan.last_plan[k] for k in
                         ("plan_mode", "pinned_ops", "plan_state")}
                steps.append((rung, state, got))
                rung = state["plan_mode"]
                if state["plan_state"] != "validating":
                    break
            mixed = [words(plan.evaluate_computation(comp, args))
                     for _ in range(2)]
    traced = plan._trace_cache[comp]
    dots = sorted(n for n, op in traced.operations.items()
                  if op.kind == "Dot")
    final = steps[-1][1]
    per_op = [got for rung, _, got in steps if rung == "per-op"]
    ladder = {
        "descent": [rung for rung, _, _ in steps] + [final["plan_mode"]],
        "settled": final,
        "segment_rungs_eager_words": all(
            np.array_equal(got, want) for rung, _, got in steps
            if rung != "per-op"),
        "per_op_words": all(np.array_equal(got, per_op[0])
                            for got in per_op + mixed),
        "max_abs_err": max(max_err(g, reference(args))
                           for g in per_op + mixed),
    }
    record["ladder"] = ladder
    log(f"plans ladder [{card}]: {json.dumps(ladder)}")
    if final["plan_state"] != "per-op" or final["pinned_ops"] != dots \
            or len(dots) != 1:
        raise AssertionError(f"the fault ladder settled on {final}, the "
                             f"graph's Dots {dots}")
    if not (ladder["segment_rungs_eager_words"] and ladder["per_op_words"]
            and ladder["max_abs_err"] < tol):
        raise AssertionError(f"the fault ladder's words: {ladder}")
    del plan, eager

    # (d) aes-ctr refused under use_jit
    comp, args, reference, tol = configs["logistic_regression"]
    prev = ring.get_prf_impl()
    ring.set_prf_impl("aes-ctr")
    try:
        LocalMooseRuntime(ids, use_jit=True, device=device) \
            .evaluate_computation(comp, args)
    except ConfigurationError as e:
        refused = str(e)
    else:
        refused = None
    finally:
        ring.set_prf_impl(prev)
    record["aes_ctr_refused"] = refused
    if refused != ring.AES_CTR_UNDER_JIT:
        raise AssertionError(f"aes-ctr under use_jit: {refused!r}")

    # (e) two threads on one runtime's plan
    plan, _ = runtimes()
    rows = next(iter(args.values())).shape
    rng = np.random.default_rng(SEED)
    inputs = [[{"x": rng.normal(size=rows)}
               for _ in range(PLAN_THREAD_REQUESTS)]
              for _ in range(PLAN_THREADS)]
    with fixed(PLAN_KEYS[1]):
        settle(plan, comp, inputs[0][0])
        single = [[words(plan.evaluate_computation(comp, a)) for a in mine]
                  for mine in inputs]
        results = [[None] * PLAN_THREAD_REQUESTS for _ in inputs]
        failures = []

        def serve(t):
            try:
                for i, a in enumerate(inputs[t]):
                    results[t][i] = words(plan.evaluate_computation(comp, a))
            except Exception as e:  # noqa: BLE001 - reported below
                failures.append(repr(e))

        threads = [threading.Thread(target=serve, args=(t,))
                   for t in range(PLAN_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        threads_s = time.perf_counter() - t0
    if failures:
        raise AssertionError(f"a thread failed: {failures}")
    errs = [max_err(r, reference(a)) for mine, given in zip(results, inputs)
            for r, a in zip(mine, given)]
    concurrent = {
        "threads": PLAN_THREADS, "requests": PLAN_THREADS
        * PLAN_THREAD_REQUESTS, "wall_ms": threads_s * 1e3,
        "equal_to_single_thread": all(
            np.array_equal(r, s) for mine, ones in zip(results, single)
            for r, s in zip(mine, ones)),
        "max_abs_err": max(errs),
    }
    record["threads"] = concurrent
    log(f"plans threads [{card}]: {json.dumps(concurrent)}")
    if not concurrent["equal_to_single_thread"] or not max(errs) < tol:
        raise AssertionError(f"concurrent plans: {concurrent}")
    return record


def run_lowered_plans(torch, rk, ring, pm, classifier, logreg, rng, card,
                      training_lowered, device="cuda", rows=LOGREG_ROWS,
                      dot_n=DOT_N):
    """Phase 29: the physical executor's compiled plans, (a) to (e) of
    the module's docstring.  ``training_lowered`` is phase 20 (c)'s
    record of its lowered epochs.  Every number logged carries ``card``.
    Returns (record, launches by path); raises on any failed check.  On
    the CPU (``device="cpu"``, small ``rows`` and ``dot_n``) the plans
    run uncaptured, validated under ``MOOSE_TPU_SELFCHECK_FORCE=1``."""
    import contextlib
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
    from moose_tpu_torch.dialects import host
    from moose_tpu_torch.edsl import tracer
    from moose_tpu_torch.runtime import LocalMooseRuntime

    import gc

    ids = ["alice", "bob", "carole"]
    on_card = torch.device(device).type == "cuda"
    record, launches = {"card": card}, {}
    seeds = [0]
    mix_seed = ring.mix_seed

    def counted_mix_seed(*args, **kwargs):
        seeds[0] += 1
        return mix_seed(*args, **kwargs)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def env(**values):
        saved = {k: os.environ.get(k) for k in values}
        os.environ.update(values)
        try:
            yield
        finally:
            _restore(os, saved)

    def fixed(key):
        return env(MOOSE_TPU_FIXED_KEYS=key, MOOSE_TPU_ALLOW_WEAK_PRF="1")

    def lowered_of(comp, args):
        # one lowering, inside the pinned nonce stream, for every runtime
        with host.deterministic_sync_keys(SEED):
            return compile_computation(tracer.trace(comp), DEFAULT_PASSES,
                                       arg_specs_from_arguments(args))

    def wall(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def counted(fn):
        """``fn()``, the launches and host seeds it made."""
        before = dict(rk.LAUNCHES)
        seeds[0] = 0
        out = fn()
        sync()
        return out, {c: rk.LAUNCHES[c] - before[c] for c in before}, \
            seeds[0]

    def state(rt):
        return {k: rt.last_plan.get(k) for k in (
            "lowered", "plan_mode", "pinned_ops", "plan_state",
            "cuda_graphs")}

    ring.mix_seed = counted_mix_seed
    try:
        # (a) config 3 lowered: settle and hold
        x = rng.normal(size=(rows, LOGREG_FEATURES))
        args = {"x": x}
        want = logistic_reference(classifier, x)
        lowered = lowered_of(logreg, args)
        plan = LocalMooseRuntime(ids, layout="per-host", use_jit=True,
                                 device=device)
        eager = LocalMooseRuntime(ids, layout="per-host", use_jit=False,
                                  device=device)
        cpu = LocalMooseRuntime(ids, layout="per-host", use_jit=True,
                                device="cpu")
        # earlier phases' plans freed first, so the pools' growth is this
        # plan's
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        pools = private_pool_bytes(torch)
        rk.reset_launches()
        validating = settle(plan, lowered, args)
        launches["lowered_plan_validating"] = dict(rk.LAUNCHES)
        pool_bytes = private_pool_bytes(torch) - pools
        settled = state(plan)
        if not (settled["lowered"] and settled["plan_state"] == "jit"
                and settled["plan_mode"] != "eager"
                and not settled["pinned_ops"]
                and (settled["cuda_graphs"] >= 1 or not on_card)):
            raise AssertionError(f"config 3's lowered plan settled on "
                                 f"{settled}")
        if len(validating) < 2:
            raise AssertionError("the lowered plan promoted unvalidated")
        keyed, replays_equal, cpu_equal = {}, True, True
        for key in PLAN_KEYS:
            with fixed(key):
                keyed[key] = eager.evaluate_computation(lowered, args)[
                    "output_0"]
                on_cpu = cpu.evaluate_computation(lowered, args)["output_0"]
                cpu_equal &= bool(np.array_equal(on_cpu, keyed[key]))
                for _ in range(PLAN_REPLAYS):
                    got = plan.evaluate_computation(lowered, args)[
                        "output_0"]
                    replays_equal &= bool(
                        plan.last_plan["plan_state"] == "jit"
                        and np.array_equal(got, keyed[key]))
        keys_differ = bool(not np.array_equal(*keyed.values()))
        err = float(np.abs(got - want).max())
        record["settle"] = {
            "rows": rows, "features": LOGREG_FEATURES,
            "ops": len(lowered.operations), "plan": settled,
            "validating_walls_ms": [s * 1e3 for s in validating],
            "pool_bytes": pool_bytes, "replays_equal_to_eager":
            replays_equal, "eager_equal_to_cpu": cpu_equal,
            "keys_differ": keys_differ, "max_abs_err": err,
        }
        log(f"lowered plans settle [{card}]: "
            f"{json.dumps(record['settle'])}")
        if not (replays_equal and cpu_equal and keys_differ):
            raise AssertionError(f"lowered plan words: {record['settle']}")
        if not err < LOGREG_TOL:
            raise AssertionError(f"lowered plan error {err}")

        # (b) the same plan through evaluate_compiled of the blob
        blob = serde.serialize_computation(lowered)
        from_bytes = LocalMooseRuntime(ids, layout="per-host", use_jit=True,
                                       device=device)
        bytes_walls = settle(from_bytes, blob, args,
                             evaluate=from_bytes.evaluate_compiled)
        with fixed(PLAN_KEYS[0]):
            got = from_bytes.evaluate_compiled(blob, args)["output_0"]
        record["from_bytes"] = {
            "blob_bytes": len(blob), "plan": state(from_bytes),
            "validating_walls_ms": [s * 1e3 for s in bytes_walls],
            "equal_to_eager": bool(np.array_equal(got, keyed[PLAN_KEYS[0]])),
        }
        log(f"lowered plans from bytes [{card}]: "
            f"{json.dumps(record['from_bytes'])}")
        if record["from_bytes"]["plan"]["plan_state"] != "jit" or \
                not record["from_bytes"]["equal_to_eager"]:
            raise AssertionError(f"evaluate_compiled's plan: "
                                 f"{record['from_bytes']}")

        # (e) eager and replayed requests in turns, launches, host seeds,
        # the profiler's view
        walls = {"eager": [], "replayed": []}
        for _ in range(PLAN_WALLS):
            for mode, rt in (("eager", eager), ("replayed", plan)):
                out, s = wall(lambda: rt.evaluate_computation(lowered, args))
                walls[mode].append(s)
                if not np.abs(out["output_0"] - want).max() < LOGREG_TOL:
                    raise AssertionError(f"lowered {mode} request error")
        _, eager_counts, eager_seeds = counted(
            lambda: eager.evaluate_computation(lowered, args))
        _, counts, replay_seeds = counted(
            lambda: plan.evaluate_computation(lowered, args))
        launches["lowered_plan_replayed"] = counts
        row = {
            "eager_ms": statistics.median(walls["eager"]) * 1e3,
            "replayed_ms": statistics.median(walls["replayed"]) * 1e3,
            "launches_eager": eager_counts, "launches_replayed": counts,
            "host_seeds_eager": eager_seeds,
            "host_seeds_replayed": replay_seeds,
            "cuda_graphs": plan.last_plan["cuda_graphs"],
        }
        if on_card:
            for mode, rt in (("eager", eager), ("replayed", plan)):
                n, busy = device_busy(
                    torch, lambda: rt.evaluate_computation(lowered, args))
                row[f"device_launches_{mode}"] = n
                row[f"busy_ms_{mode}"] = busy
                row[f"idle_share_{mode}"] = max(
                    0.0, 1.0 - busy / row[f"{mode}_ms"])
        record["requests"] = row
        log(f"lowered plans requests [{card}]: {json.dumps(row)}")
        if counts != eager_counts:
            raise AssertionError(f"a replay counted {counts}, the eager run "
                                 f"{eager_counts}")
        lowered_only = ("dot_cross_terms", "ring_mul", "prf_threefry")
        if on_card and (any(counts[c] < 1 for c in lowered_only) or any(
                n for c, n in counts.items() if c not in lowered_only)):
            raise AssertionError(f"a lowered request launched {counts}")
        # (the CPU's plain K7 derives each seed on the host)
        if on_card and replay_seeds:
            raise AssertionError(
                f"a replayed request derived {replay_seeds} host seeds")
    finally:
        ring.mix_seed = mix_seed

    # (c) a lowered secure dot down the ladder to the per-op rung
    xd = rng.normal(size=(dot_n, dot_n))
    yd = rng.normal(size=(dot_n, dot_n))
    dargs = {"x": xd, "y": yd}
    dot = lowered_of(secure_dot_computation(pm), dargs)
    dots = sorted(n for n, op in dot.operations.items() if op.kind == "Dot")
    ladder_rt = LocalMooseRuntime(ids, layout="per-host", use_jit=True,
                                  device=device)
    with fixed(PLAN_KEYS[0]):
        dot_want = LocalMooseRuntime(
            ids, layout="per-host", use_jit=False,
            device=device).evaluate_computation(dot, dargs)["output_0"]
        with env(MOOSE_TPU_SELFCHECK_FORCE="1",
                 MOOSE_TPU_SELFCHECK_FAULT="Dot"):
            steps = []
            for _ in range(12):
                got = ladder_rt.evaluate_computation(dot, dargs)["output_0"]
                steps.append((state(ladder_rt),
                              bool(np.array_equal(got, dot_want))))
                if steps[-1][0]["plan_state"] != "validating":
                    break
            mixed = ladder_rt.evaluate_computation(dot, dargs)["output_0"]
    final = steps[-1][0]
    ladder = {
        "descent": [st["plan_mode"] for st, _ in steps],
        "settled": final, "dots": dots,
        "words_equal_to_eager": all(eq for _, eq in steps)
        and bool(np.array_equal(mixed, dot_want)),
        "max_abs_err": float(np.abs(mixed - xd @ yd).max()),
    }
    record["ladder"] = ladder
    log(f"lowered plans ladder [{card}]: {json.dumps(ladder)}")
    if final["plan_state"] != "per-op" or final["pinned_ops"] != dots \
            or not dots:
        raise AssertionError(f"the lowered fault ladder settled on {final}, "
                             f"the graph's Dots {dots}")
    if not (ladder["words_equal_to_eager"] and ladder["max_abs_err"] < DOT_TOL):
        raise AssertionError(f"the lowered fault ladder's words: {ladder}")

    # (d) phase 20 (c)'s lowered epochs ran under plans
    record["training"] = {k: training_lowered[k] for k in (
        "plan", "words_equal_to_cpu", "weights_equal_to_cpu")}
    log(f"lowered plans training [{card}]: "
        f"{json.dumps(record['training'])}")
    if training_lowered["plan"]["plan_state"] not in (
            "validating", "jit") or not (
            training_lowered["words_equal_to_cpu"]
            and training_lowered["weights_equal_to_cpu"]):
        raise AssertionError(f"phase 20 (c)'s lowered epochs: "
                             f"{record['training']}")
    return record, launches


def pool_bytes(torch, handle):
    """Device bytes held by one private memory pool (a role plan's CUDA
    graphs), from the caching allocator's snapshot; 0 off the card."""
    if handle is None or not torch.cuda.is_available():
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) == tuple(handle))


def run_worker_plans(torch, rk, ring, pm, classifier, logreg, rng, card,
                     device="cuda", rows=LOGREG_ROWS, dot_n=DOT_N,
                     walls=WORKER_WALLS, keyed=WORKER_KEYED):
    """Phase 30: the distributed workers' fast path, (a) to (e) of the
    module's docstring: config 3 lowered on three in-process workers whose
    roles run validated segments, CUDA graphs once settled.  Every number
    logged carries ``card``.  Returns (record, launches by path); raises
    on any failed check.  On the CPU (``device="cpu"``, small ``rows``
    and ``dot_n``) the segments run uncaptured through the same code."""
    import contextlib
    import copy
    import gc
    import os
    import threading

    import numpy as np

    from moose_tpu_torch import devices, metrics
    from moose_tpu_torch.compilation import (
        DEFAULT_PASSES,
        compile_computation,
    )
    from moose_tpu_torch.compilation.analysis import cost_report
    from moose_tpu_torch.compilation.lowering import arg_specs_from_arguments
    from moose_tpu_torch.dialects import host
    from moose_tpu_torch.distributed import worker_plan
    from moose_tpu_torch.distributed.choreography import start_local_cluster
    from moose_tpu_torch.distributed.fabric import (
        FabricDomain,
        FabricNetworking,
    )
    from moose_tpu_torch.distributed.networking import LocalNetworking
    from moose_tpu_torch.distributed.worker import (
        execute_role,
        execute_role_legacy,
    )
    from moose_tpu_torch.edsl import tracer
    from moose_tpu_torch.execution import drawledger, graphs
    from moose_tpu_torch.execution.interpreter import _selfcheck_runs
    from moose_tpu_torch.runtime import GrpcMooseRuntime

    ids = ("alice", "bob", "carole")
    on_card = torch.device(device).type == "cuda"
    record, launches = {"card": card}, {}
    checks = _selfcheck_runs()
    settled_modes = ("segmented", "full-jit")
    seeds = [0]
    mix_seed = ring.mix_seed

    def counted_mix_seed(*args, **kwargs):
        seeds[0] += 1
        return mix_seed(*args, **kwargs)

    def say(what, payload):
        log(f"worker plans {what} [{card}]: {json.dumps(payload)}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def env(**values):
        saved = {k: os.environ.get(k) for k in values}
        os.environ.update(values)
        try:
            yield
        finally:
            _restore(os, saved)

    def fixed(key):
        return env(MOOSE_TPU_FIXED_KEYS=key, MOOSE_TPU_ALLOW_WEAK_PRF="1")

    def lowered_of(comp, args):
        with host.deterministic_sync_keys(SEED):
            return compile_computation(tracer.trace(comp), DEFAULT_PASSES,
                                       arg_specs_from_arguments(args))

    def session(comp, args, run_role=execute_role, fabric=None,
                dev=device):
        """One session of ``comp`` on three in-process workers (over the
        fabric ``fabric`` when given): each role's result, launch tally,
        graph replays and draw events, the outputs, the wire payloads
        and the wall."""
        inner = LocalNetworking(device=dev)
        wire = {}
        put = inner._store.put

        def keep(key, value):
            wire[key] = value
            put(key, value)

        inner._store.put = keep
        nets = ({i: FabricNetworking(fabric, i, inner) for i in ids}
                if fabric is not None else dict.fromkeys(ids, inner))
        results, tallies, replays, errors = {}, {}, {}, {}

        def work(identity):
            try:
                with rk.launch_tally() as tally:
                    r0 = graphs.replays()
                    results[identity] = run_role(
                        comp, identity, {}, args, nets[identity], "w30",
                        timeout=300.0, device=dev)
                    replays[identity] = graphs.replays() - r0
                tallies[identity] = dict(tally)
            except Exception as e:  # noqa: BLE001 — raised below
                errors[identity] = e

        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in ids]
        with drawledger.recording() as ledger:
            sync()
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            sync()
            s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"phase 30 workers failed: {errors}")
        draws = {i: sum(e.placement == i for e in ledger.events)
                 for i in ids}
        outputs = {k: v for r in results.values()
                   for k, v in r["outputs"].items()}
        return SimpleNamespace(
            results=results, tallies=tallies, replays=replays, draws=draws,
            outputs=outputs, wire=wire, s=s,
            modes={i: r["plan_mode"] for i, r in results.items()},
            pinned={i: list(r["pinned_segments"])
                    for i, r in results.items()})

    def same(a, b):
        return set(a) == set(b) and all(
            np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)

    def settle(comp, args, reference, tol, fabric=None):
        """Sessions until no role validates: their walls and errors, the
        plan statistics' delta, the last session."""
        before = worker_plan.plan_stats()
        runs = []
        for _ in range(checks + 2):
            run = session(comp, args, fabric=fabric)
            err = float(np.abs(run.outputs["output_0"] - reference).max())
            if not err < tol:
                raise AssertionError(f"phase 30 session error {err} > {tol}")
            runs.append((run.s, err))
            if "validating" not in run.modes.values():
                break
        stats = {k: v - before[k] for k, v in worker_plan.plan_stats().items()}
        return runs, stats, run

    def role_plans(comp):
        return {i: worker_plan.get_plan(comp, i, device=device) for i in ids}

    def pins_of_dots(comp):
        return {i: [s.index for s in plan.segments if s.validatable and any(
                    comp.operations[n].kind == "Dot" for n in s.names)]
                for i, plan in role_plans(comp).items()}

    started = time.perf_counter()
    parts = record["seconds"] = {}

    def part(name):
        parts[name] = time.perf_counter() - started - sum(parts.values())

    ring.mix_seed = counted_mix_seed
    saved_jit = os.environ.get("MOOSE_TPU_WORKER_JIT")
    os.environ["MOOSE_TPU_WORKER_JIT"] = "1"
    try:
        # (a) config 3 lowered: settle, then hold under two fixed keys
        x = rng.normal(size=(rows, LOGREG_FEATURES))
        args = {"x": x}
        want = logistic_reference(classifier, x)
        lowered = lowered_of(logreg, args)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        rk.reset_launches()
        runs, stats, last = settle(lowered, args, want, LOGREG_TOL)
        launches["worker_plan_validating"] = dict(rk.LAUNCHES)
        if not (set(last.modes.values()) <= set(settled_modes)
                and not any(last.pinned.values())
                and len(runs) == checks
                and stats["validating_evaluations"] == len(ids) * checks
                and stats["segments_pinned"] == 0):
            raise AssertionError(f"config 3's role plans settled on "
                                 f"{last.modes}, pins {last.pinned}, "
                                 f"{len(runs)} sessions, {stats}")
        part("a_settle")
        # the CPU's words: phase 23 (a) holds a settled card session of
        # this graph equal to the CPU's under fixed keys (a CPU session of
        # this size takes half a minute on the card's host)
        words, rows_a = {}, []
        for key in PLAN_KEYS:
            with fixed(key):
                legacy = session(lowered, args, run_role=execute_role_legacy)
                seeds[0] = 0
                held = []
                for _ in range(keyed):
                    rk.reset_launches()
                    run = session(lowered, args)
                    held.append(run)
                launches["worker_plan_settled"] = dict(rk.LAUNCHES)
                settled_seeds = seeds[0]
            words[key] = legacy.outputs["output_0"]
            rows_a.append({
                "key": key,
                "settled_equal_to_legacy": all(
                    same(r.outputs, legacy.outputs) and r.wire == legacy.wire
                    for r in held),
                "roles_count_their_own_launches": all(
                    r.tallies == legacy.tallies for r in held),
                "roles_count_their_own_draws": all(
                    r.draws == legacy.draws for r in held),
                "launches_sum_to_the_counters": all(
                    sum(t[c] for t in held[-1].tallies.values()) == n
                    for c, n in launches["worker_plan_settled"].items()),
                "host_seeds_settled": settled_seeds,
                "settled_modes": held[-1].modes,
            })
        part("a_keys")
        keys_differ = not np.array_equal(*words.values())
        record["settle"] = {
            "rows": rows, "features": LOGREG_FEATURES,
            "ops": len(lowered.operations),
            "validating_walls_ms": [s * 1e3 for s, _ in runs],
            "max_abs_err": max(e for _, e in runs),
            "plan_stats": stats, "modes": last.modes,
            "keys": rows_a, "keys_differ": keys_differ,
            "legacy_launches_by_role": legacy.tallies,
            "legacy_draws_by_role": legacy.draws,
        }
        say("settle", record["settle"])
        for row in rows_a:
            if not (row["settled_equal_to_legacy"]
                    and row["roles_count_their_own_launches"]
                    and row["roles_count_their_own_draws"]
                    and row["launches_sum_to_the_counters"]
                    and set(row["settled_modes"].values())
                    <= set(settled_modes)):
                raise AssertionError(f"phase 30 (a) under {row['key']}: "
                                     f"{row}")
            if on_card and row["host_seeds_settled"]:
                raise AssertionError(
                    f"settled sessions derived {row['host_seeds_settled']} "
                    "seeds on the host")
        if not keys_differ:
            raise AssertionError("two fixed keys gave the same words")

        # (b) the fabric of three handles over the card, and three
        # in-process gRPC WorkerServers under GrpcMooseRuntime
        domain = FabricDomain(dict(zip(
            ids, ([h] for h in devices.virtual_devices(device, 3)))),
            "simulation")
        fabric_names = {
            "sends": ("moose_tpu_net_sends_total", {"transport": "fabric"}),
            "fabric_permutes": ("moose_tpu_fabric_permutes_total", {}),
            "fabric_batched_permutes":
                ("moose_tpu_fabric_batched_permutes_total", {}),
            "fabric_permute_payloads":
                ("moose_tpu_fabric_permute_payloads_total", {}),
            "fabric_tx_bytes": ("moose_tpu_fabric_tx_bytes_total", {}),
        }

        def fabric_counts():
            return {k: int(metrics.REGISTRY.value(n, **lb))
                    for k, (n, lb) in fabric_names.items()}

        # a role plan is the transport's to choose nothing in: the fabric
        # sessions replay (a)'s settled plans
        before = fabric_counts()
        with fixed(PLAN_KEYS[0]):
            rk.reset_launches()
            fab = session(lowered, args, fabric=domain)
            launches["worker_plan_fabric"] = dict(rk.LAUNCHES)
        measured = {k: v - before[k] for k, v in fabric_counts().items()}
        model = cost_report(lowered, session_id="w30", transport="fabric",
                            fabric_parties=ids, coalesce=True)
        predicted = {k: int(model["totals"][k]) for k in fabric_names}
        record["fabric"] = {
            "wall_ms": fab.s * 1e3, "modes": fab.modes,
            "equal_to_legacy": same(fab.outputs, {"output_0":
                                                  words[PLAN_KEYS[0]]}),
            "counters": measured, "equal_to_cost_model":
                model["resolved"] and measured == predicted,
        }
        part("b_fabric")
        say("fabric", record["fabric"])
        if not (record["fabric"]["equal_to_legacy"]
                and record["fabric"]["equal_to_cost_model"]
                and set(fab.modes.values()) <= set(settled_modes)):
            raise AssertionError(f"phase 30 (b) fabric: {record['fabric']}")

        net_names = {
            "tx_bytes": "moose_tpu_net_tx_bytes_total",
            "rx_bytes": "moose_tpu_net_rx_bytes_total",
            "sends": "moose_tpu_net_sends_total",
            "send_many_envelopes": "moose_tpu_net_send_many_total",
            "send_many_payloads": "moose_tpu_net_send_many_payloads_total",
            "receives": "moose_tpu_net_receives_total",
        }

        def wire_counts():
            return {k: metrics.REGISTRY.value(v, transport="grpc")
                    for k, v in net_names.items()}

        traced = tracer.trace(logreg)
        servers, endpoints = start_local_cluster(ids, device=device)
        try:
            client = GrpcMooseRuntime(endpoints, device=device)
            grpc_walls = []
            for _ in range(checks + 2):
                before = wire_counts()
                (out, _), s = timed(torch, lambda: client.evaluate_computation(
                    traced, args, timeout=600)) if on_card else (
                    client.evaluate_computation(traced, args, timeout=600),
                    0.0)
                grpc_walls.append(s)
                grpc_modes = dict(client.last_plan_modes)
                if all(m["plan_mode"] in settled_modes
                       for m in grpc_modes.values()):
                    break
            measured = {key: int(v - before[key])
                        for key, v in wire_counts().items()}
            grpc_err = float(np.abs(out["output_0"] - want).max())
            (compiled, _), = client._client._compile_cache[traced].values()
            model = cost_report(compiled, session_id="0" * 32,
                                transport="grpc")
            predicted = {k: int(model["totals"][k]) for k in net_names}
        finally:
            for srv in servers.values():
                srv.stop()
        record["grpc"] = {
            "walls_ms": [s * 1e3 for s in grpc_walls],
            "last_plan_modes": grpc_modes, "max_abs_err": grpc_err,
            "wire": measured,
            "equal_to_cost_model": model["resolved"] and measured == predicted,
        }
        part("b_grpc")
        say("grpc", record["grpc"])
        if not (record["grpc"]["equal_to_cost_model"]
                and grpc_err < LOGREG_TOL and len(grpc_modes) == len(ids)
                and all(m["plan_mode"] in settled_modes
                        and not m["pinned_segments"]
                        for m in grpc_modes.values())):
            raise AssertionError(f"phase 30 (b) gRPC: {record['grpc']}")

        # (c) MOOSE_TPU_SELFCHECK_FAULT=Dot pins exactly the segments
        # that hold a Dot, and every session goes on from the eager run
        faulty = copy.deepcopy(lowered)
        with env(MOOSE_TPU_SELFCHECK_FAULT="Dot"):
            fault_runs, fault_stats, fault_last = settle(
                faulty, args, want, LOGREG_TOL)
        part("c_fault")
        dot_segments = pins_of_dots(faulty)
        record["fault"] = {
            "pinned": fault_last.pinned, "dot_segments": dot_segments,
            "modes": fault_last.modes, "plan_stats": fault_stats,
            "max_abs_err": max(e for _, e in fault_runs),
        }
        say("fault", record["fault"])
        if fault_last.pinned != dot_segments or not any(
                dot_segments.values()) or not set(
                fault_last.modes.values()) <= set(settled_modes):
            raise AssertionError(f"phase 30 (c): {record['fault']}")

        # (d) config 1's secure dot settles within its limit
        xd = rng.normal(size=(dot_n, dot_n))
        yd = rng.normal(size=(dot_n, dot_n))
        dargs = {"x": xd, "y": yd}
        dot = lowered_of(secure_dot_computation(pm), dargs)
        dot_runs, dot_stats, _ = settle(dot, dargs, xd @ yd, DOT_TOL)
        dot_run = session(dot, dargs)
        dot_err = float(np.abs(dot_run.outputs["output_0"] - xd @ yd).max())
        part("d_secure_dot")
        record["secure_dot"] = {
            "n": dot_n, "validating_walls_ms": [s * 1e3 for s, _ in dot_runs],
            "settled_ms": dot_run.s * 1e3, "modes": dot_run.modes,
            "max_abs_err": dot_err, "plan_stats": dot_stats,
        }
        say("secure dot", record["secure_dot"])
        if not (dot_err < DOT_TOL and set(dot_run.modes.values())
                <= set(settled_modes)):
            raise AssertionError(f"phase 30 (d): {record['secure_dot']}")

        # (e) legacy and settled sessions in turns, over LocalNetworking
        # and over the fabric; each role's plan; one profiled session
        # each way
        timing = {}
        for name, fabric in (("local", None), ("fabric", domain)):
            turns = {"legacy": [], "settled": []}
            for _ in range(walls):
                for way, run_role in (("legacy", execute_role_legacy),
                                      ("settled", execute_role)):
                    run = session(lowered, args, run_role=run_role,
                                  fabric=fabric)
                    turns[way].append(run.s)
                    if not np.abs(run.outputs["output_0"]
                                  - want).max() < LOGREG_TOL:
                        raise AssertionError(f"phase 30 (e) {name} {way}")
            timing[name] = {
                "legacy_ms": statistics.median(turns["legacy"]) * 1e3,
                "settled_ms": statistics.median(turns["settled"]) * 1e3,
                "legacy_walls_ms": [s * 1e3 for s in turns["legacy"]],
                "settled_walls_ms": [s * 1e3 for s in turns["settled"]],
            }
            if name == "local":
                last_local = run
        part("e_walls")
        plans = role_plans(lowered)
        run = last_local  # a settled session over LocalNetworking
        roles = {
            i: {"segments": len(p.segments),
                "validatable": sum(s.validatable for s in p.segments),
                "captured_graphs": p.captured_graphs,
                "replays_a_session": run.replays[i],
                "pool_bytes": pool_bytes(torch, p.pool.handle
                                         if p.pool is not None else None),
                "receives": len(p.recv_names),
                "launches_a_session": run.tallies[i]}
            for i, p in plans.items()
        }
        per_session = {c: sum(t[c] for t in run.tallies.values())
                       for c in ("dot_cross_terms", "ring_mul",
                                 "prf_threefry")}
        profile = {}
        if on_card:
            for way, run_role in (("legacy", execute_role_legacy),
                                  ("settled", execute_role)):
                got, events = profiled(torch, lambda: session(
                    lowered, args, run_role=run_role))
                busy = sum(e.device_time_total for e in events) / 1e3
                profile[way] = {
                    "device_launches": len(events), "busy_ms": busy,
                    "wall_ms": got.s * 1e3,
                    "idle_share": max(0.0, 1.0 - busy / (got.s * 1e3))}
        part("e_roles_profile")
        record["walls"] = timing
        record["roles"] = roles
        record["kernel_launches_a_session"] = per_session
        record["profile"] = profile
        say("walls", timing)
        say("roles", roles)
        say("launches a session", per_session)
        say("profiled sessions", profile)
        say("seconds", parts)
        if on_card and (per_session["dot_cross_terms"] < 1
                        or per_session["ring_mul"] < 1
                        or per_session["prf_threefry"] < 1):
            raise AssertionError(f"a settled session launched {per_session}")
        if on_card and any(r["captured_graphs"] != r["validatable"]
                           for r in roles.values()):
            raise AssertionError(f"role plans hold {roles}")
    finally:
        ring.mix_seed = mix_seed
        _restore(os, {"MOOSE_TPU_WORKER_JIT": saved_jit})
    return record, launches


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    started = time.perf_counter()
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
        # phase 26's folds: the per-host Dot of a batched x at one party,
        # the host Dots of a matrix and of a vector against a rank-3 y
        compare_party_dot(torch, rk, ring, gen, MLPC_ROWS, MLPC_FEATURES,
                          MLPC_HIDDEN[0], 128, reps=20,
                          label="per-host rank-3 Dot, one party"),
        compare_ring_matmul(torch, rk, gen, MLPC_ROWS, MLPC_FEATURES,
                            MLPC_HIDDEN[0], 128, reps=20,
                            label="host rank-3 Dot"),
        compare_ring_matmul(torch, rk, gen, 1, MLPC_FEATURES,
                            MLPC_HIDDEN[0], 128, reps=20,
                            label="host vector @ rank-3 Dot"),
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
    # phase 29's draws: a lowered request's SampleSeeded under a key of
    # its plan's table, its seed made in the kernel (mode (b): the
    # DeriveSeed's sync key mixed in; mode (c): an unseeded Sample)
    threefry_rows += [
        compare_seeded(torch, rk, 2 * PATH_N, layout, False,
                       LOWERED_NONCE, 20, "lowered draw at (1024,1) ring128")
        for layout in ("threefry", "threefry-pallas")
    ] + [
        compare_seeded(torch, rk, 128 * PATH_N, "threefry", True,
                       LOWERED_NONCE, 20,
                       "lowered zero-share bits at (128,1024,1)",
                       untagged=True),
        compare_seeded(torch, rk, 128 * PATH_N, "threefry-pallas", True,
                       LOWERED_NONCE, 20, "lowered bits at (128,1024,1)"),
        compare_seeded(torch, rk, 2 * PATH_N, "threefry", False, None, 20,
                       "unseeded Sample at (1024,1) ring128"),
    ]
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
    log(f"phase 4 at {time.perf_counter() - started:.1f} s")
    # phase 4: the eDSL secure dot through the runtime (main path)
    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(DOT_N, DOT_N))
    y = rng.normal(size=(DOT_N, DOT_N))
    runtime = LocalMooseRuntime(["alice", "bob", "carole"])
    comp = secure_dot_computation(pm)
    # each main-path phase counts and times its requests once the plan
    # has validated (phase 28 reports the validating evaluations)
    settle(runtime, comp, {"x": x, "y": y})
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
    log(f"phase 5 at {time.perf_counter() - started:.1f} s")
    # phase 5: ONNX LinearRegressor, three requests (main path)
    predictor = linear_regressor(rng, LINREG_FEATURES)
    linreg = predictor.predictor_factory()
    requests = [
        rng.normal(size=(LINREG_ROWS, LINREG_FEATURES))
        for _ in range(LINREG_REQUESTS)
    ]
    settle(runtime, linreg, {"x": requests[0]})
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
    log(f"phase 6 at {time.perf_counter() - started:.1f} s")
    # phase 6: ONNX logistic regression, three requests (main path)
    classifier = logistic_regression(rng, LOGREG_FEATURES)
    logreg = classifier.predictor_factory()
    requests = [
        rng.normal(size=(LOGREG_ROWS, LOGREG_FEATURES))
        for _ in range(LOGREG_REQUESTS)
    ]
    settle(runtime, logreg, {"x": requests[0]})
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
    log(f"phase 7 at {time.perf_counter() - started:.1f} s")
    # phase 7: secure training under threefry-pallas (main path)
    ring.set_prf_impl("threefry-pallas")
    try:
        training = run_training(torch, rk, runtime, rng)
        training["logreg_device_launches"] = step_device_launches(
            torch, runtime, rng)
    finally:
        ring.set_prf_impl("threefry")

    phase[0] = 8
    log(f"phase 8 at {time.perf_counter() - started:.1f} s")
    # phase 8: ONNX multinomial logistic regression, three requests (main
    # path)
    multi = multinomial_regression(rng, MULTI_FEATURES)
    multi_comp = multi.predictor_factory()
    requests = [
        rng.normal(size=(MULTI_ROWS, MULTI_FEATURES))
        for _ in range(MULTI_REQUESTS)
    ]
    settle(runtime, multi_comp, {"x": requests[0]})
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
    log(f"phase 9 at {time.perf_counter() - started:.1f} s")
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
    log(f"phase 10 at {time.perf_counter() - started:.1f} s")
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
    log(f"phase 11 at {time.perf_counter() - started:.1f} s")
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
    settle(runtime, mlp_comp, {"x": requests[0]})
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
    log(f"phase 12 at {time.perf_counter() - started:.1f} s")
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
    log(f"phase 13 at {time.perf_counter() - started:.1f} s")
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
    log(f"phase 14 at {time.perf_counter() - started:.1f} s")
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
    settle(runtime, resnet_comp, {"x": requests[0]})
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
    log(f"phase 15 at {time.perf_counter() - started:.1f} s")
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

    settle(runtime, aes_comp, aes_args(wires[0]))
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
    log(f"phase 16 at {time.perf_counter() - started:.1f} s")
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
        # aes-ctr expands on the host: no compiled plan runs it, as the
        # JAX package refuses it under jit (phase 28 (d))
        eager = LocalMooseRuntime(["alice", "bob", "carole"], use_jit=False)
        rk.reset_launches()
        out, ctr_s = timed(torch, lambda: eager.evaluate_computation(
            logreg, {"x": xr}))
        ctr_launches = dict(rk.LAUNCHES)
        ctr_host = dict(rk.AES_CTR_HOST)
        cpu_out = LocalMooseRuntime(
            ["alice", "bob", "carole"], use_jit=False, device="cpu",
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
    log(f"phase 17 at {time.perf_counter() - started:.1f} s")
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
    log(f"phase 18 at {time.perf_counter() - started:.1f} s")
    per_host_record, per_host_launches = run_per_host(
        torch, rk, ring, pm, LocalMooseRuntime, classifier, logreg, rng)

    # phase 19: the lowered route and the per-host Decrypt (main path)
    phase[0] = 19
    log(f"phase 19 at {time.perf_counter() - started:.1f} s")
    lowered_record, lowered_launches = run_lowered(
        torch, rk, ring, pm, LocalMooseRuntime, classifier, logreg,
        aes_model, aes_comp, aes_key, rng)

    # phase 20: secure training sessions (main path, each of (a) to (e)
    # counted on its own)
    phase[0] = 20
    log(f"phase 20 at {time.perf_counter() - started:.1f} s")
    session_record, session_launches = run_training_sessions(
        torch, rk, ring, pm, LocalMooseRuntime)

    # phase 21: the static analyzer (main path, each of (a) to (d)
    # counted on its own)
    phase[0] = 21
    log(f"phase 21 at {time.perf_counter() - started:.1f} s")
    analyzer_record, analyzer_launches = run_analyzer(
        torch, rk, pm, LocalMooseRuntime, classifier, logreg, rng)

    # phase 22: secure-inference serving of phase 6's model (main path,
    # each of its paths counted on its own); a bucket-1024 batch must
    # launch what a phase-6 request does
    phase[0] = 22
    log(f"phase 22 at {time.perf_counter() - started:.1f} s")
    per_request = {k: v // LOGREG_REQUESTS
                   for k, v in logreg_launches.items()}
    serving_record, serving_launches = run_serving(
        torch, rk, pm, classifier,
        np.asarray(session_record["trained_predictor"]["weights"]).reshape(
            -1, 1),
        rng, smi, per_request=per_request)
    LocalMooseRuntime.evaluate_computation = evaluate
    log(f"layouts by phase: "
        f"{json.dumps({p: sorted(v) for p, v in layouts.items()})}")
    for p in range(4, 23):
        # phase 20: the sessions per-host, the trained model stacked;
        # phase 21: a draw oracle on each layout; phase 22 stacked
        want = ({"per-host", "stacked"} if 20 <= p <= 21
                else {"per-host" if 18 <= p <= 19 else "stacked"})
        if layouts.get(p) != want:
            raise AssertionError(
                f"phase {p} ran on {layouts.get(p)}, not {want}")

    # phase 23: distributed secure execution (main path, each of its
    # in-process paths counted on its own; the comet processes count in
    # their own processes)
    phase[0] = 23
    log(f"phase 23 at {time.perf_counter() - started:.1f} s")
    distributed_record, distributed_launches = run_distributed(
        torch, rk, ring, pm, classifier, logreg, runtime, rng, smi)

    # phase 24: secret integers, chaos over gRPC and a chaos-resumed
    # training, vixen over TCP, rudolph, the native parser (main path,
    # each in-process part counted on its own; the vixen and rudolph
    # processes count in their own processes)
    phase[0] = 24
    log(f"phase 24 at {time.perf_counter() - started:.1f} s")
    fault_record, fault_launches = run_faults(
        torch, rk, pm, classifier, logreg, smi)

    # phase 25: the device mesh and the fabric transport (main path, each
    # part counted on its own)
    phase[0] = 25
    log(f"phase 25 at {time.perf_counter() - started:.1f} s")
    fabric_record, fabric_launches = run_fabric(
        torch, rk, pm, classifier, logreg, requests[0],
        fault_record["chaos_grpc"]["schedule_digest"], smi)

    # phase 26: the ring Dot at ranks past 2 (main path, each Dot
    # counted on its own)
    phase[0] = 26
    log(f"phase 26 at {time.perf_counter() - started:.1f} s")
    ranks_record, ranks_launches = run_ranks(torch, rk, pm, smi)

    # phase 27: the reference's examples and tutorials as the port's
    # programs (main path, each in-process program counted on its own;
    # the three that start processes count in those processes)
    phase[0] = 27
    log(f"phase 27 at {time.perf_counter() - started:.1f} s")
    programs_record, programs_launches = run_programs(torch, rk, smi)

    phase[0] = 28
    log(f"phase 28 at {time.perf_counter() - started:.1f} s")
    # phase 28: the stacked layout's compiled plans, CUDA graphs replayed
    # against the eager walk (main path)
    from moose_tpu_torch.dialects import aes

    plan_x = rng.normal(size=(DOT_N, DOT_N))
    plan_y = rng.normal(size=(DOT_N, DOT_N))
    plan_rows = rng.normal(size=(LOGREG_ROWS, LOGREG_FEATURES))
    plan_aes = rng.normal(size=(AES_ROWS, AES_FEATURES))
    plan_mlp = rng.normal(size=(MLPC_ROWS, MLPC_FEATURES))
    plan_resnet = rng.normal(size=(RESNET_ROWS, RESNET_CH, RESNET_SIZE,
                                   RESNET_SIZE)) * 0.5

    plans_record = run_plans(torch, rk, ring, smi, {
        "secure_dot": (secure_dot_computation(pm),
                       {"x": plan_x, "y": plan_y},
                       lambda a: a["x"] @ a["y"], DOT_TOL),
        "logistic_regression": (
            logreg, {"x": plan_rows},
            lambda a: logistic_reference(classifier, a["x"]), LOGREG_TOL),
        "aes_inference": (aes_comp, aes_args(aes.encrypt_fixed_array(
            *aes_key_nonce(), plan_aes, AES_PRECISION[1])),
            lambda a: logistic_reference(aes_model, plan_aes), AES_TOL),
        "mlp_classifier": (mlp_comp, {"x": plan_mlp},
                           lambda a: dense_reference(mlp, a["x"]), MLPC_TOL),
        "resnet": (resnet_comp, {"x": plan_resnet},
                   lambda a: resnet_reference(resnet_params, a["x"]),
                   RESNET_TOL),
    })

    phase[0] = 29
    log(f"phase 29 at {time.perf_counter() - started:.1f} s")
    # phase 29: the physical executor's compiled plans, the lowered
    # route's CUDA graphs replayed against its eager run (main path)
    lowered_plans_record, lowered_plans_launches = run_lowered_plans(
        torch, rk, ring, pm, classifier, logreg, rng, smi,
        session_record["lowered"])

    phase[0] = 30
    log(f"phase 30 at {time.perf_counter() - started:.1f} s")
    # phase 30: the distributed workers' fast path, each role's segments
    # CUDA graphs replayed against its eager run (main path)
    worker_plans_record, worker_plans_launches = run_worker_plans(
        torch, rk, ring, pm, classifier, logreg, rng, smi)

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
        **analyzer_launches,
        **serving_launches,
        **distributed_launches,
        **fault_launches,
        **fabric_launches,
        **ranks_launches,
        **programs_launches,
        **lowered_plans_launches,
        **worker_plans_launches,
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
        # phase 21: the stacked oracle's request (phase 6's), the
        # per-host oracle's (phase 18's) and the strict compile served
        # lowered (phase 19's)
        "analyzer_stacked_request": protocol + ("prf_threefry",),
        "analyzer_per_host_request": per_host_kernels + ("prf_threefry",),
        "analyzer_strict_compiled": lowered_kernels,
        # phase 22: every path serves phase 6's graph on the stacked
        # layout, one batch at a time on the scheduler thread
        **{path: protocol + ("prf_threefry",) for path in serving_launches},
        # phase 23: the workers run lowered graphs (K1 product-only, K4,
        # K7 single draws)
        **{path: lowered_kernels for path in distributed_launches},
        # phase 24: the secret-integer Add, Mul and Dot (K3's reshare,
        # K1 at ring64, no truncation), then lowered graphs on workers
        "secret_uint64": ("dot_cross_terms", "cross_terms_reshare",
                          "prf_threefry"),
        "chaos_grpc": lowered_kernels,
        "chaos_training": lowered_kernels,
        # phase 25: config 3 on the stacked layout over the card's mesh
        # (phase 6's kernels), logreg_train_step on it (phase 20 (d)'s),
        # then lowered graphs on workers over the fabric
        "mesh_logistic_regression": protocol + ("prf_threefry",),
        "mesh_logreg_train_step": ("dot_cross_terms", "trunc_pairs",
                                   "cross_terms_reshare", "ring_mul",
                                   "prf_threefry"),
        **{path: lowered_kernels for path in fabric_launches
           if path.startswith("fabric_")},
        # phase 26: each Dot one K1 product (one a party per-host), then
        # the truncation; a host fixed-point Dot K1 product-only, no draw
        **{path: ("dot_cross_terms", "trunc_pairs", "prf_threefry")
           for path in ranks_launches if path.startswith("ranks_stacked")},
        **{path: ("dot_cross_terms", "trunc_combine", "prf_threefry")
           for path in ranks_launches if path.startswith("ranks_per_host")},
        **{path: ("dot_cross_terms",)
           for path in ranks_launches if path.startswith("ranks_host")},
        # phase 27: each program's graph on the stacked layout (the
        # multichip tutorial's step and softmax on the protocol layer);
        # the correlation holds no matrix product, as phase 10
        **{path: protocol + ("prf_threefry",) for path in programs_launches},
        "program_scientific_computing_multiple_players":
            protocol[1:] + ("prf_threefry",),
        # phase 29: the lowered route's plans, validating and replayed
        **{path: lowered_kernels for path in lowered_plans_launches},
        # phase 30: the workers' segments, validating and replayed
        **{path: lowered_kernels for path in worker_plans_launches},
    }
    for name in ("trunc_pairs", "trunc_combine"):
        if launches_by_path["secret_uint64"][name]:
            raise AssertionError(f"secret integers launched {name}")
    # the lowered graph holds the reference's composition: no fused step
    for path in ("lowered_logistic_regression", "lowered_from_bytes",
                 "analyzer_strict_compiled", *lowered_plans_launches,
                 *worker_plans_launches, *distributed_launches,
                 "chaos_grpc", "chaos_training",
                 *(p for p in fabric_launches if p.startswith("fabric_"))):
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
            # phase 22: one bucket-1024 batch, phase 6's counts
            "launches_per_serving_batch": by_path["serving_fixed_batch"],
            # phase 23: the workers' warm sessions
            "launches_distributed": {
                path: by_path[path] for path in distributed_launches},
            # phase 24's in-process parts
            "launches_faults": {
                path: by_path[path] for path in fault_launches},
            # phase 25's parts
            "launches_fabric_mesh": {
                path: by_path[path] for path in fabric_launches},
            # phase 26's Dots
            "launches_ranks": {
                path: by_path[path] for path in ranks_launches},
            # phase 27's programs in this process
            "launches_programs": {
                path: by_path[path] for path in programs_launches},
            # phase 29's lowered plans
            "launches_lowered_plans": {
                path: by_path[path] for path in lowered_plans_launches},
            # phase 30's workers
            "launches_worker_plans": {
                path: by_path[path] for path in worker_plans_launches},
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
        "analyzer": analyzer_record,
        "serving": serving_record,
        "distributed": distributed_record,
        "faults": fault_record,
        "fabric_mesh": fabric_record,
        "ranks": ranks_record,
        "programs": programs_record,
        "plans": plans_record,
        "lowered_plans": lowered_plans_record,
        "worker_plans": worker_plans_record,
        "seconds": time.perf_counter() - started,
    }
    log(f"chip_smoke: {record['seconds']:.1f} s in all [{smi}]")
    import threading

    log("threads alive at the end: " + json.dumps(sorted(
        t.name + (" (daemon)" if t.daemon else "")
        for t in threading.enumerate() if t is not threading.main_thread())))
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
