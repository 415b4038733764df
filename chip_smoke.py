"""Drive the PyTorch/CUDA port on one GPU: the FedBack round (slice 1),
zamba2-2.7b serving (slice 2), the paper's baselines (slice 6), the
tree client-state layout and the paper's CIFAR-10 workload (slice 7),
the client-sharded round (slice 8), K1's leaf-table kernel behind the
tree trigger, the sharded trigger and bf16 trigger inputs (slice 9),
FL serving over arrival traces with stale-tolerant rounds (slice 10),
compressed consensus with checkpoints (slice 11), ragged clients on
one pooled buffer (slice 12), seed × gain sweeps with the
host-offloaded client state (slice 13), the static-invariant checker
(slice 14), granite-3-2b: the dense family, its training loss, the
cross-pod FedBack engine and dense serving (slice 15), and the
SSM-bearing families: zamba2-2.7b's training loss through the cross-pod
engine, mamba2-2.7b served and trained, phi3-medium-14b served (slice
16), and the last three families: moonshot-v1-16b-a3b (MoE) served at
full size and trained, mixtral-8x7b reduced, paligemma-3b (prefix-LM
vlm) served and hubert-xlarge (audio encoder) trained (slice 17), and
the last slice: K2 and K3 on bf16, the H100 roofline model, the
one-card dry-run of every architecture × shape, the example twins and
the paper's claims (slice 18), the model mesh: granite-3-2b served
on a data × model mesh in fsdp and tp mode (slice 19), the cross-pod
FedBack trainer on a pod × data × model mesh (slice 20),
tensor-parallel serving for every family in modes tp, fsdp_tp and ep
(slice 21), tensor-parallel training for every family in the same
modes, with the MoE on a data axis above 1 (slice 22), and the dry-run
over the reference's meshes, held against the card's runs of the same
mesh steps (slice 23).

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught; any failure exits
non-zero; every phase prints its seconds).  The CPU references of 7a,
8a and 12a run on one worker thread (6 of the host's 8 cores) while the
card goes on with the next phases — 7b–7c, 8b–8e, 12b–13c — and are
held against the card's kept results when those phases are done; the
listeners that count 12b's, 13b–13c's and 14's copies leave the
worker's out:

1. print the card (``nvidia-smi`` name and power limit) and versions;
2. build the hand-written CUDA kernels from ``src/repro_torch/csrc``
   (one nvcc per source, started together);
3. hold each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and at odd ones — bit-exact for the
   elementwise kernels (K3 with the first slot valid and not, and at an
   odd D) and the SSD scan (K5), rtol 1e-5 for the trigger's sum over D
   (taken in another order, with each square-and-add fused; the same
   row bit-equal at N = 100, at N = 1, at a 4-byte-offset view and with
   ω off 16 bytes), and for flash attention (K4) atol/rtol 2e-2
   in bf16 (the tensor-core instance) at the serve shape (4, 32, 2048,
   80), with a window of 1024, at hd 64 and 128, with GQA 4:1 and a
   window of 100 in the (B, H, S, hd) layout and at a ragged S = 2000,
   and rtol 1e-4 (atol 1e-5) in fp32 — the 3xTF32 tensor-core instance
   at the serve shape, a ragged S = 2000, a window of 1024, GQA 4:1
   with a window of 100 in (B, H, S, hd) and hd 64 and 128, and the
   SIMT instance on a view 4 bytes off its storage — and time the
   kernel, its plain version and, where one PyTorch call computes the
   same function, that call, all as device time
   (``repro_torch.launch.time_kernels.device_ms``: calls captured in a
   CUDA graph and replayed) — K1–K3 cold, over input sets that the L2
   cannot hold (the kernels line's ``ms``), and warm, and K4's fp32
   instances beside ``scaled_dot_product_attention`` in fp32; print
   nvcc's -Xptxas -v lines for the K1, K3, K4 (bf16 and 3xTF32) and K5
   instances and, where cuobjdump is at hand, the count of HGMMA
   instructions in K4's hd = 80 instances (none in the 3xTF32 one
   fails the run); K1a (bf16 z and ω, and each alone, through K1's
   leaf-table kernel) bit-equal to K1 on fp32 copies at (100, 159010)
   and (7, 1001); K1c (``trigger_sq_norms_pytree``: one launch of the
   leaf-table kernel over the stacked tree's leaves in place) on the
   MLP's 4 and the CNN's 12 leaves stacked for N = 100, and with the
   MLP's fc1/w in bf16 — one launch, K1 not launched, no leaf copied,
   the leaf-table kernel the only CUDA kernel of the call
   (torch.profiler), bit-equal to K1 on the concatenated fp32 copy and
   within rtol 1e-5 of the plain version — timed cold at both (the row:
   the CNN's); K1b and K2b (``trigger_sq_norms_sharded``: the card's
   shards in one leaf-table launch; ``admm_update_sharded``: K2's
   kernel once per shard) on P = 2 and 4 shards of (100, 159010) on the
   card, every shard's rows bit-equal to the unsharded kernel's, K1b's
   whole call timed cold at both P (the row: P = 4) and a lone launch
   on one shard's rows beside it, K2b's launch alone at (N/P, D) (the
   row: P = 2);
4. form A at the paper-MNIST width (N=100 clients, the 784-200-10 MLP,
   D=159,010): compacted rounds with the fused commit, 1 warm-up and 5
   timed, asserting one trigger and one fused_gss launch per round and
   no host sync inside the rounds;
5. form B at the same width: dense rounds, 1 warm-up and 3 timed,
   asserting one trigger and one admm_update launch per round;
   before each form's run, its second round from ``init_state`` (one
   that commits clients) is held against the same round on the CPU's
   plain path: the same events and state (rtol 1e-4);
5b. the paper's baselines at the same width and L̄ = 0.1, each 1 warm-up
   and 3 timed rounds with its launches per round asserted and its
   second round held against the CPU's plain path (events and
   ``committed`` equal, state at rtol 1e-4, the AVG family's ω at rtol
   1e-6 / atol 1e-7): C1 FedADMM compact + fused (K1, K3), C2 FedADMM
   dense (K1, K2), C3 FedAvg dense (K1), C4 FedProx compact with
   μ = 0.01 (K1), C5 FedBack with the bernoulli selection, dense (K1,
   K2), C6 FedADMM with the round-robin selection, compact and unfused
   (K1, K2 on the gathered rows), C7 SCAFFOLD (no kernel);
5c. the tree client-state layout at the paper-MNIST width, 1 warm-up
   and 3 timed rounds each, launches per round asserted, the second
   round held against the CPU's plain path as in 5b: TA compact and TB
   dense (each: K1c once, neither K1, K2 nor K3); TB's second round
   also against form B's from the same state, flattened (events equal,
   ω at rtol 1e-5 / atol 1e-7);
5d. the paper's CIFAR-10 workload at full width (N = 100, the CNN, D =
   196,426, Dirichlet β = 0.5 over 12,000 synthetic examples, 33 per
   client).  First, a round built for the card must switch TF32 off
   (set on just before), and the solve's convolutions, batched over a
   round's 16 slots × 20 images by ``vmap`` as the solve batches them,
   must lie within 5e-5 of float64 in every pass (forward, data and
   weight gradients) at the CNN's three layer shapes; the same passes
   with cuDNN's TF32 on are printed beside.  Then 1 warm-up and 3 timed
   rounds each: CF-A flat, compact + fused (K1, K3) and CF-T tree,
   compact (K1c); the second round repeated from its state on the card
   bit for bit (cuDNN's algorithms made deterministic where the round
   is built), and held against the CPU's plain
   path with events and the committed set equal and each state field
   within 1e-2 of the norm of the round's update (two values of a
   max-pool window, or a pre-activation and 0, within a rounding of
   each other may send a gradient another way on the two paths and move
   that client's later steps, so not element by element: on an H100
   such flips moved the fields by up to 8.8e-3 of their update norm,
   with cuDNN on or off; a wrong kernel or layout moves them by ~1);
   test accuracy printed, not gated;
5e. the client-sharded round at the paper-MNIST width, P shards of one
   card (``configs.paper_mnist.FORMS``' ``shards``), 1 warm-up and 3
   timed rounds each under the sync debug mode, launches per round
   asserted, the second round held against the same sharded round on P
   CPU shards (as in 5b): SA FedBack compact + fused at P = 2, ⌈16/2⌉ =
   8 slots a shard (K1b ×1 for the card's shards, K3 ×2), SB FedBack
   dense at P = 2 (K1b ×1, K2b ×2), ST FedBack on the tree layout,
   dense, at P = 2 (K1c ×1), SR FedADMM compact + fused at P = 4, 4
   slots a shard (K1b ×1, K3 ×4); in every form of 4–5e the trigger
   copies no state leaf to read it; SB's and ST's second rounds also
   against forms B and TB from the same state (events equal, ω at rtol
   1e-5 / atol 1e-7, as TB against B in 5c);
5f. FL serving at the paper-MNIST width: first one all-ones tick of
   SVA's configuration at ``max_staleness=0`` against form A's round
   from the same state (events equal, ω bit-equal); then the serve
   forms of ``configs.paper_mnist.SERVE_FORMS`` — FedBack with
   ``max_staleness=2`` (delays 0, 1, 2 round robin) over a 24-tick
   trace at L̄ = 0.1: SVA compact + fused over a bursty trace (K1 ×1, K3
   ×1 per tick), SVB dense over a Poisson trace (K1 ×1, K2 ×1), SVS as
   SVA on 2 client shards of the card, 8 slots a shard (K1b ×1, K3 ×2).
   Each: ticks 1 and 2, the first burst's second tick and the one after
   it (clients landing, in flight and queued), each held against the
   CPU's plain path from the same state
   (events, ``committed``, the deferred, in-flight and landed counts,
   countdowns, event ring and queue equal; state, ω and parked payloads
   within 1e-4 of the larger of each element and its field's largest
   magnitude); then 1 warm-up tick on a deep copy and the 24 ticks
   through ``core.schedule.serve`` under the sync debug mode inside each
   step, launches per tick asserted, the books balanced
   (``conservation_ok``); ms/tick, p50/p99 admission→commit latency in
   ticks and µs and commits/s printed.  Before the serve forms, the
   staleness commit (six selects, and the fused commit's slot-wise form)
   on the same full-width rows on the card and the CPU: equal bits;
5g. compressed consensus at the paper-MNIST width: first the EF
   aggregation (``core.compress.ef_consensus`` and
   ``ef_participant_mean``) at (100, 159010), block 256, int8 and bf16,
   on one device and on 2 client shards, card against CPU on the same
   inputs — ω and the residual bit-equal — and its device time beside
   its byte bound, the windowed column sum's and ``torch.sum``'s; then
   the forms QA (A + int8: K1, K3), QB (B + bf16: K1, K2), QC (C3 +
   int8: K1) and QS (SA + int8 on 2 shards: K1b, K3 ×2), 1 warm-up and 3
   timed rounds each, launches per round asserted, no host sync, the
   second round held against the CPU's plain path (events and
   ``committed`` equal, θ/λ/z at rtol 1e-4 — in QB and QS one client
   row that took another ReLU branch within 1e-2 of its update's norm,
   its cause shown: in a CPU replay of its solve, a pre-activation of
   the hidden unit whose weights moved within 1e-5 of its terms'
   magnitude of 0 —, ω and the residual by
   ``check_ef_round``: bit-equal to the CPU's aggregation of the card's
   z, and against the CPU's round within a bound built from the
   measured z gap plus a level-1 or level-2 step where a sent code
   flipped, at most 1e-4·D flips beyond twice those the gap predicts),
   their ms/round printed beside A's, B's, C3's and SA's; then
   checkpoints: QA and QS (under ``mesh=``) 3 rounds, saved, loaded into
   a fresh template on the card, round 4 bit-equal to the
   uninterrupted one, and QA's file loaded on the CPU's plain path,
   whose round 4 agrees with the card's as in 4–5; file size and save /
   load times printed;
5h. ragged clients: first form A on its trimmed data pooled uniformly
   (``pool_data`` of its 100 equal shards) against form A on the same
   data stacked, 3 rounds from ``init_state``: events and ω bit for bit;
   then the forms of ``RAGGED_FORMS``, each on its module's
   ``pooled_workload()`` (Σnᵢ = 12,000 asserted, pool sizes and buckets
   printed), 1 warm-up and 5 timed rounds for RA, 3 for the others,
   launches per round asserted, no host sync, the second round held
   against the CPU's plain path: RA (form A on the label-shard split
   kept whole, 114–123 a client, 4 padded buckets: K1, K3), RB (form B
   on it, 4 bucket solves: K1, K2), RS (RA on 2 client shards, the
   clients reordered by ``balanced_permutation``: K1b, K3 ×2), each
   element by element with 5g's ReLU-flip rule (at most one row, its
   cause shown by a replay of its masked solve), and RC (CF-A on the
   Dirichlet split kept whole, 33–255 a client, 48 SGD steps a slot:
   K1, K3; its round 2 repeated bit for bit, as 5d's): its slots'
   solve over its first 4 SGD steps, card against
   CPU, within CF-A's 1e-2 of its update, and its round within the
   distance the CPU's own round moves when ω starts one ulp off (48
   steps through ReLUs and max-pools amplify any rounding); their
   ms/round printed
   beside A's, B's, SA's and CF-A's.  Phase 5d's convolution check also
   holds the ragged solve's form (each image alone under a second
   ``vmap``) within 5e-5 of float64;
5i. sweeps (``launch/sweep.py``): WA, form A's configuration over seeds
   0–3 × K 2.0, 0.5 (8 runs stacked, 1.53 GB of θ/λ/z_prev), and WB,
   form B's over seeds 0–1 × L̄ 0.1, 0.2 (4 runs), 3 rounds each under
   the sync debug mode, launches asserted (K1 and K3, K1 and K2, once
   per run a round); every run's metrics each round and final state
   bit-equal to the run stepped alone by ``make_round_fn`` with its
   seed, K and L̄ in its config; in WA the realized rate differs
   between the gains; ms per sweep round printed beside A's and B's;
5j. the host-offloaded state (``core/hoststate.py``): HA (form A with
   ``state_backend="host"``) at ``stream_tiles`` 2 and 4, HS (A with
   ``max_staleness=2``), HQ (QA) and HR (RA, on the pooled workload),
   4 rounds each from ``init_state`` beside the device form of the same
   config: every ``RoundMetrics`` field each round (``train_loss``
   included) and the final state (θ, λ, z_prev, ω, the residual, the
   park buffers, the vectors) bit-equal; launches asserted (K1 once a
   round and once more in the first, K3 once a round on the working
   set); the bytes each leg moved equal to ``planned_bytes``; the live
   device memory after the rounds within 8·C·D·4 +
   ``device_state_bytes()`` + the data + 1 MiB; HQ's checkpoint after
   round 2, saved from host memory, resumed on the device backend and
   its round 4 bit-equal to the host's; ms/round beside the device
   form's, bytes a round, device and host state bytes, and the copy
   stream's busy ms and overlap share (CUDA events) printed;
5k. the static-invariant checker (``repro_torch.analysis``) with the
   kernels: its fast matrix (the toy legs, 2-shard legs on two shards of
   the card), every rule passing or skipping as on the CPU, the AST
   lint clean, the signature and transfer-guard checks passing (the
   guard under the sync debug mode's "error"), and the report gating
   clean against the committed CPU baseline
   (``src/repro_torch/analysis/baseline_fast_cpu.json``: the same
   kernel calls and bytes between shards); then forms A, B, HA and one
   SVA tick (bursty trace) at the paper-MNIST width, 2 rounds each (1
   for SVA) after a warm-up, through the same rules: kernel calls as
   phases 4–5j assert, each leg's CUDA kernels in the profiler's trace
   its wrappers' launches, no sync op (HA: its plan read-back only), no
   float64 op, no stray (N, D) sweep, A's θ/λ/z_prev written in place
   with no (N, D) block allocated, and A's ``max_memory_allocated`` over
   a round less its start within its own terms (13 (C, D) fp32 blocks
   + the C slots' data + 1 MiB; one stray (N, D) block exceeds it),
   printed beside B's and one (N, D) fp32 matrix; one line per leg
   with its facts and the card, and the fast matrix's toy-shape
   launches on a line of their own (only the paper-width forms'
   launches join the kernels line);
6. zamba2-2.7b at full width cut to one group (6 mamba layers and the
   shared block), fp32 with TF32 off: 1 request × 256 tokens, prefill
   and 4 greedy decode steps on the card (kernels) against the CPU's
   plain path on the same weights — logits at rtol/atol 1e-3, the
   greedy tokens equal, 1 flash_attention (the 3xTF32 instance) and 6
   ssd_scan launches in the prefill and none in decode;
7. zamba2-2.7b at full width and depth (54 layers), bf16, weights of
   the reference's seeded init (drawn on the card, its wall time
   printed): 4 requests × 2048 prompt tokens, 32 new tokens,
   greedy, through ``repro_torch.launch.serve_lm.serve`` (warm-up off
   the clock), asserting 9 flash_attention and 54 ssd_scan launches per
   prefill and none in decode; then prefill(t₀..tₙ)'s last logits
   against decode of tₙ after prefill(t₀..tₙ₋₁) on the card, within
   8% of the largest logit (bf16 activations through 54 layers; the
   two paths round at different places);
7a. granite-3-2b at 2 layers and every published width (d_model 2048,
   GQA 32:8 at head_dim 64, d_ff 8192, vocab 49155 padded to 49408),
   fp32: one cross-pod round (``core/crosspod.py``; P = 2 pods, 2 local
   steps of 2 × 64 tokens, K 0.05, α 0.9, L̄ 0.5, ρ 1e-3, lr 5e-3) on
   the card, held against the same round on the CPU from the card's
   state before it: events equal, δ within one ulp, distances at rtol
   1e-5, θ/λ/z_prev at the solve grade (rtol 1e-4 / atol 1e-6, held on
   the card), ``train_loss`` at rtol 1e-5; no kernel launches (the
   distances stay plain, the attention is the differentiable blockwise
   path);
7b. granite-3-2b at full size, bf16, seed 0's init, both pods on the
   card: 5 rounds of 2 local steps of 4 × 512 tokens, the second under
   torch.profiler (the card's activity: device busy ms, launches, idle
   share, the longest kernels); round 0 fires both pods, every state leaf finite,
   z_prev = θ + λ bit for bit on every pod that fired; ms/round and
   ``max_memory_allocated`` printed beside the card;
7c. granite-3-2b serving: one 2-layer fp32 group against the CPU as in
   phase 6 (2 launches of K4's 3xTF32 instance), then full size in
   bf16 through ``serve`` as in phase 7, 40 K4 launches a prefill
   (GQA 32:8 at head_dim 64), none in decode, prefill against decode
   within 8% of the largest logit;
8a. zamba2-2.7b at every published width cut to one group (6 mamba
   layers and the shared block), fp32: one cross-pod round on the
   card at 7a's settings, held against the same round on the CPU as in
   7a (the hybrid stack's gradient on the card: the SSD's scan
   through ``ssd_scan_ref``, no kernel launched);
8b. zamba2-2.7b at full size, bf16, both pods on the card: 2 rounds of
   2 local steps of 4 × 512 tokens, the second profiled, checked and
   printed as 7b (peak memory beside the card's, ms for rounds that
   fire both pods and none);
8c. mamba2-2.7b: a 2-layer fp32 slice against the CPU as in phase 6 (2
   K5 launches in its prefill), then full size in bf16 through
   ``serve`` as in phase 7, 64 K5 launches a prefill at states (4, 32,
   80, 64, 128), none in decode;
8d. mamba2-2.7b cut to 2 layers, fp32: the training loss and its
   gradients on 2 × 64 tokens, card against CPU at the solve grade, then
   one cross-pod round held against the CPU as in 7a;
8e. phi3-medium-14b at full size, bf16 (its init drawn on the card,
   timed): 4 × 2048 prompt tokens, 4 new, 40 K4 launches a prefill at
   (4, 2048, 40:10, 128), none in decode, prefill against decode as in
   phase 7;
9a. moonshot-v1-16b-a3b at every published width (d_model 2048, 64
   experts top-6 of d_ff 1408, vocab 163,840) cut to 1 layer, fp32 with
   TF32 off: greedy serving against the CPU as in phase 6 (1 launch of
   K4's 3xTF32 instance), the tokens whose k-th and (k+1)-th router
   probabilities lie within 1e-5 counted, the loss and its gradients on
   2 × 64 tokens against the CPU at the solve grade and twice bit for
   bit on the card, and one cross-pod round (1 local step) held
   against the CPU as in 7a;
9b. moonshot at full size (48 layers, 28.1 B parameters), bf16: 4 ×
   2048 prompt tokens, 4 new, through ``serve``, 48 K4 launches a
   prefill at (4, 2048, 16:16, 128), none in decode; the share of rows
   dropped at its capacity factor 1.25; prefill against decode within
   8% of the largest logit on a drop-free copy (capacity factor 64) of
   the same weights at 1 × 256 tokens (prefill's per-group count drops
   the latest tokens first, decode never drops);
9c. mixtral-8x7b ``.reduced()`` (a window of 16): prefill and decode
   against the CPU as in phase 6 (2 launches of K4's 3xTF32 instance
   with the window), and ``moe_apply`` on the card against its CPU run
   at the cases of tests/test_torch_moe.py: ids and keep masks equal,
   out and aux at rtol 1e-5, gradients at the solve grade and repeated
   bit for bit;
9d. paligemma-3b: 2 layers at full width, fp32, 256 patches + 256
   text tokens, greedy against the CPU (logits and tokens; no K4
   launch: the prefix mask goes through ``blockwise_attention``); then
   full size in bf16 through ``serve``, 4 × (256 patches + 512 text
   tokens), 4 new, 0 K4 launches asserted, prefill against decode on a
   cache sized for the prefix, and a decode past a cache sized without
   it refused (ROADMAP D11);
9e. hubert-xlarge: 2 layers at full width, fp32, the loss and its
   gradients on 2 × 64 frames against the CPU at the solve grade; then
   full size in bf16: the loss, its gradients and one SGD step on 4 ×
   1024 frames, finite, the parameters moved, no kernel launched; each
   of 7a–9e prints its seconds;
10a. K2a and K3a, the bf16 instances of K2 and K3 (slice 18): the
   public API (``ops.admm_update`` without z, ``ops.fused_gss`` with C =
   16 slots, 14 valid) on bf16 operands at (100, 159010), counts set to
   0 before and read after, one launch each (the kernels line's
   ``admm_update_bf16`` and ``fused_gss_bf16`` rows); then bit-equal to
   their plain versions at the reference test's shapes (4, 64), (8,
   1024), (5, 2049), at (100, 159010) and (3, 7), with and without z
   and 2 bytes off their storage, K2b on 2 and 4 shards, K3a with slots
   invalid, at an odd D and 2 bytes off; timed cold and warm as K2 and
   K3 are, bounds from their bytes at 2 an element;
10b. the roofline model's rates (``launch/roofline.py``) resolve for
   this card's name, printed with its H100 SXM constants beside the
   ``nvidia-smi`` name and power limit;
10c. the full one-card dry-run, ``python -m repro_torch.launch.dryrun
   --arch all --shape all --mesh card`` on the host's cores (6
   processes, started before 10a and waited for after phase 11, which
   runs after 10e beside it): exit 0, 80
   records under ``build/dryrun/``, none in error, each ``ok``
   record's summarize line printed; and the dry-run on the reference's
   meshes for granite-3-2b, zamba2-2.7b and moonshot-v1-16b-a3b, every
   shape, ``--mesh both``, one niced process a ``--sharding`` mode
   (fsdp, tp, fsdp_tp; 2 workers each), started after phase 5k and
   waited for in phase 15: exit 0, 24 records a mode under
   ``build/dryrun_mesh/``, none in error, only long_500k skipped;
10d. each example twin (``examples/*_torch.py``) at a short setting on
   the card — quickstart 20 rounds, federated_image's four algorithms
   for 3 rounds and FedBack's round-2 checkpoint resumed to the straight
   run's round-3 accuracy bit for bit, serve_lm as its defaults
   (8 × 64 prompt tokens, 32 new), sharded_sweep (8 shards of the card,
   events equal to one device's) with a 20-round sweep,
   fedback_transformer 6 rounds;
10e. tests/test_system.py's FedBack and FedADMM at N = 16 over 90
   rounds on the card: FedBack's accuracy above 0.85, its rate in
   [0.15, 0.45], round 0 firing all 16, 0.93 reached; the events to
   0.93 of both and their ratio (the claim: at most 1.2) and the final
   accuracies printed; 10a–10e print their seconds;
11a. the model mesh (``launch/mesh.py``, ``sharding/specs.py``,
   ``sharding/params.py``, the serving steps of ``launch/steps.py``
   with ``mesh=``): granite-3-2b at every published width cut to 2
   layers, fp32, on mesh (data 2, model 2) of the visible cards (all
   four coordinates on one card where there is one), in fsdp and in
   tp: 2 × 256 prompt tokens, prefill and 4 greedy decode steps, the
   tokens equal and the logits within rtol/atol 1e-3 of the unsharded
   port on the card and on the CPU; K4's 3xTF32 instance 4 times a
   prefill under fsdp (per data shard and layer), 8 under tp (per model
   shard too), none in decode;
11b. granite-3-2b at full size, bf16, from the seeded init, 4 × 2048
   prompt tokens and 32 new: first unsharded (its prefill and decode
   timed), then under tp on mesh (1, 4) (160 K4 launches a prefill at
   (4, 2048, 8:2, 64), the kernels line's ``flash_attention_tp4``) and
   under fsdp on mesh (2, 2) (80 at (2, 2048, 32:8, 64),
   ``flash_attention_fsdp2``), none in decode: each coordinate's
   resident parameter bytes equal to ``per_device_bytes``, the bytes
   each collective kind moved in a prefill and a decode step (a warm-up
   step), prefill ms, decode ms a step, tok/s and peak memory per card
   of a timed greedy run, the prefill logits within rtol/atol 2e-2 of
   the unsharded serve's and each request's first token equal to it
   (unless the unsharded top-two margin is under twice that request's
   largest logit gap: a near tie, printed), the number of cards used;
   11a–11b print their seconds;
12a. the cross-pod trainer on a pod × data × model mesh
   (``sharding/train.py``, ``launch/steps.py``'s training steps with
   ``mesh=``): granite-3-2b at every published width cut to 2 layers,
   fp32, P = 2 on mesh (2, 2, 2) of the visible cards (every coordinate
   on one card where there is one), phase 7a's settings and 2 × 64
   tokens a step, 2 rounds, each from the card's state against the same
   mesh round on the CPU and the one-device round on the card: events
   equal, distances at rtol 1e-5, ``train_loss`` at rtol 1e-5, θ / λ /
   z_prev at the solve grade; then ``make_train_step`` on mesh (2, 2)
   against the unsharded step on the card, 4 × 64 tokens: the loss at
   rtol 1e-5, the first moment at the solve grade, the parameters at it
   where the gradient is firm (within lr elsewhere: Adam's first step);
   no kernel launches;
12b. granite-3-2b whole, bf16, P = 2 on mesh (2, 2, 2), phase 7b's 4 ×
   512 tokens a step: a warm-up round that fires both pods, then 3
   rounds, the first under torch.profiler: every leaf finite, z_prev
   equal to θ + λ bit for bit on every pod that fired, each
   coordinate's resident state bytes equal to ``per_device_bytes`` of
   the pod-stacked specs, no kernel launches; ms a round, peak memory
   against the card's, GB a round by collective kind, the profiled
   round's launches, busy ms and idle share, beside phase 7b's
   unsharded ms a round from the same run; 12a–12b print their
   seconds;
13a. tensor-parallel serving (``sharding/serve.py``, the serving steps
   in modes tp, fsdp_tp and ep): moonshot-v1-16b-a3b (2 layers),
   mamba2-2.7b (2), zamba2-2.7b (one group: 6 mamba layers and the
   shared block) and paligemma-3b (2, its 256 prefix positions) at
   every published width in fp32, 2 × 64 prompt tokens and 4 greedy
   decode steps, each on mesh (1, 4) under tp and (2, 2) under fsdp_tp,
   moonshot also on (1, 4) under ep (every coordinate on one card where
   there is one): the logits within rtol/atol 2e-4 and the tokens equal
   to the unsharded port's on the card, which is held once a family
   against the CPU (1e-3, tokens equal); each coordinate's resident
   bytes equal to ``per_device_bytes``; K4's 3xTF32 instance once per
   model shard (data × model) and attention layer under the causal mask
   (none for the vlm's prefix mask) and K5 once per model shard and
   mamba layer in a prefill, none in decode; moonshot's routing on
   every shard equal to the unsharded one, its drops a layer equal;
13b. zamba2-2.7b whole, bf16, 4 × 2048 prompt tokens and 32 new,
   unsharded and under tp on mesh (1, 4) as 11b (``serve_on_meshes``):
   K4 at the shard shape (4, 2048, 8:8, 80) 36 times a prefill (9
   groups × 4 shards, ``flash_attention_zamba2_tp4``) and K5 at (4, 32,
   20, 64, 64) 216 times (54 × 4, ``ssd_scan_zamba2_tp4``), none in
   decode; resident bytes, GB by collective kind, prefill ms, decode ms
   a step, peak memory against the card's; the prefill logits of each
   request as close to the fp32 prefill of the same weights as the
   unsharded bf16 prefill's (its largest gap to fp32 within 1.25× the
   unsharded one's) and within 0.08 of its largest logit from the
   unsharded ones (zamba2's bf16 prefill is itself ~0.065 from fp32, so
   11b's 2e-2 between two bf16 roundings cannot hold), 11b's near-tie
   rule for the first tokens;
13c. moonshot-v1-16b-a3b at every published width cut to 4 layers,
   bf16, 4 × 2048 prompt tokens and 8 new, unsharded and under tp and
   ep on mesh (1, 4) as 13b: K4 at (4, 2048, 4:4, 128) 16 times a
   prefill in each mode (``flash_attention_moonshot_tp4``); each
   layer's routing on every model shard alike, and its drops equal to
   the unsharded prefill's but for 2k rows a token whose expert set
   changed at a near tie (its k-th and (k + 1)-th probabilities within
   twice its largest probability gap); 13a–13c print their seconds;
14a. tensor-parallel training (``sharding/train.py``'s tp executor,
   ``make_train_step`` / ``make_cross_pod_step`` with ``mode=``):
   granite-3-2b (2 layers), mamba2-2.7b (2), zamba2-2.7b (one group),
   moonshot-v1-16b-a3b (2, its 64 experts), paligemma-3b (2, its 256
   prefix positions) and hubert-xlarge (2) at every published width in
   fp32, one step of 2 × 64 positions (the vlm's after its prefix) on
   mesh (1, 4) under tp and (2, 2) under fsdp_tp, moonshot also on (1,
   4) under ep and (2, 2) under fsdp (the MoE on a data axis of 2),
   against the unsharded step on the card: the loss at rtol 1e-5, the
   first moment at rtol 1e-4 / atol 1e-7, the parameters at it where
   |μ| > 1e-6 (within 2·lr elsewhere: Adam's first step), each
   coordinate's resident bytes equal to ``per_device_bytes``; then one
   cross-pod round of granite (2 layers) on (2, 1, 2) under tp and of
   moonshot (one layer, its vocabulary cut to 32,768: a data axis of 2
   holds the embedding and head twice) on (2, 2, 1) under fsdp against
   the one-device round: events equal, distances at rtol 1e-5,
   ``train_loss`` at rtol 1e-5, θ / λ / z_prev at the solve grade; no
   kernel launches;
14b. granite-3-2b whole, bf16, one step of 2 × 2048 tokens with the
   centre at the parameters, unsharded, then on (1, 4) under tp and
   (2, 2) under fsdp_tp under torch.profiler: each coordinate's
   resident bytes equal to ``per_device_bytes``, GB by collective kind
   equal to ``sharding.train.step_bytes``, the loss within 1e-2 of the
   unsharded step's, each leaf's ‖μ − μ_unsharded‖ / ‖μ_unsharded‖
   within 3e-2 (a leaf past it must be as close to the fp32 gradient's
   first moment of the same weights as the unsharded step's, within
   1.25×), no kernel launches; ms a step wall and busy, launches, idle
   share and peak memory against the card's;
14c. moonshot-v1-16b-a3b at every published width cut to 2 layers,
   bf16, as 14b on (2, 2) under fsdp and (1, 4) under ep, each layer's
   routing held to the unsharded step's as 13c holds it, the aux of
   each beside the unsharded one; 14a–14c print their seconds;
15. the dry-run's count held against the card's runs of the same mesh
   steps (started after phase 5k in a niced process of its own, on the
   meta device: the configuration, mesh shape, mode, batch and positions of
   12b's cross-pod round on (2, 2, 2), 13b's tp prefill and decode on
   (1, 4) and 14b's tp and fsdp_tp steps): the bytes by collective kind
   equal to each phase's listener's, byte for byte (an argument the
   phase cut onto the mesh inside its listener, counted as its
   "scatter" from its resident bytes); each argument's bytes a
   coordinate equal to every coordinate's resident bytes; K4's and
   K5's counted calls equal to 13b's launches (none in decode); each
   step's counted bound a card × its coordinates printed beside the
   phase's measured ms, no gate; and 10c's mesh sweeps finished;
16. print the serve line, the kernels line (K4's bf16 instance as
   ``flash_attention``, launched in phase 7, at granite's GQA shape
   as ``flash_attention_gqa``, launched in phase 7c, and at phi3's as
   ``flash_attention_phi3``, launched in phase 8e, and at moonshot's as
   ``flash_attention_moonshot``, launched in phase 9b, at granite's
   shard shapes as ``flash_attention_tp4`` and
   ``flash_attention_fsdp2``, launched in phase 11b, at zamba2's and
   moonshot's tp shard shapes as ``flash_attention_zamba2_tp4`` and
   ``flash_attention_moonshot_tp4``, launched in phases 13b and 13c —
   phase 3 holds the seven shapes, (4, 2048, 32:8, 64), (4, 2048,
   40:10, 128), (4, 2048, 16:16, 128), (4, 2048, 8:2, 64), (2, 2048,
   32:8, 64), (4, 2048, 8:8, 80) and (4, 2048, 4:4, 128), against the
   plain version at 2e-2 and times them beside
   ``scaled_dot_product_attention`` —, its 3xTF32 instance as
   ``flash_attention_fp32``, launched in phases 6, 7c, 9a, 9c, 11a and
   13a, and K5 at
   mamba2's shape as ``ssd_scan_mamba2``, launched in phases 8c and
   13a, and at a zamba2 tp shard's as ``ssd_scan_zamba2_tp4``, launched
   in phase 13b, each held bit for bit by phase 3; K1–K3's launches are
   those of phases 4–5k (5k: its paper-width forms), K1c's those of
   5c–5e, K1b's those of 5e–5h, K2b's those of 5e, K2a's and K3a's
   those of 10a), the card line and,
   last, the ok
   line.

Exits non-zero without a result where no CUDA device is visible, or
where the port's package is missing next to this script.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import math
import statistics
import warnings
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
CUDA_SRC = "src/repro_torch/csrc/fedback_kernels.cu"
MODEL_SRC = "src/repro_torch/csrc/model_kernels.cu"
# zamba2-2.7b serving: the main path of slice 2.
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
SLICE_TOKENS, SLICE_DECODE = 256, 4
# Calls per CUDA graph when a plain version is timed: each can allocate
# gigabytes (K4's plain version holds the (B, H, S, S) scores).
PLAIN_CALLS = 2
CONSISTENCY_REL = 0.08  # |Δ logit| / max |logit|, bf16 through 54 layers


def log(*a):
    print(*a, flush=True)


def check_kernels(dev, ops, n, d, c):
    """Phase 3: every kernel against its plain version; returns rows of
    the kernels line (launches filled in later).  K1–K3 are timed at the
    round's shapes by ``time_kernels.round_kernel_ms``: cold (``ms``,
    the calls rotating over input sets that L2 cannot hold, as the
    round finds its rows, so that ``ms`` and the HBM bound describe the
    same traffic) and warm (``warm_ms``, one set of inputs, the measure
    of earlier records; K3's 36 MB then sits in L2)."""
    from repro_torch.launch.roofline import PEAK_FP32_FLOPS
    from repro_torch.launch.time_kernels import (device_ms, peak_bandwidth,
                                                 round_kernel_ms)
    rng = np.random.default_rng(SEED)

    def mk(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    bw = peak_bandwidth(torch.cuda.get_device_name(0))
    rows = {}

    # K1 trigger_sq_norms.
    err = 0.0
    for nn_, dd in ((n, d), (1, 130), (7, 1001)):
        z, w = mk(nn_, dd), mk(dd)
        got = ops.trigger_sq_norms(z, w)
        want = ops.trigger_sq_norms_ref(z, w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        err = max(err, float((got - want).abs().max()))
    # Identical rows (every never-served client's z_prev is the initial
    # weights) must give bit-equal distances whatever their alignment,
    # N, or ω's alignment, or the plan breaks priority ties unlike the
    # reference.
    row, w = mk(d), mk(d)
    z = row[None].repeat(n, 1)
    got = ops.trigger_sq_norms(z, w)
    if not torch.equal(got, got[:1].expand(n)):
        raise AssertionError("trigger_sq_norms: identical rows give "
                             f"{int(torch.unique(got).numel())} distinct "
                             "sums")
    flat = torch.empty(n * d + 1, device=dev)
    flat[1:] = z.reshape(-1)
    w_off = torch.empty(d + 1, device=dev)
    w_off[1:] = w
    for label, other in (
            ("N = 1", ops.trigger_sq_norms(row[None].contiguous(), w)),
            ("a 4-byte-offset view", ops.trigger_sq_norms(
                flat[1:].view(n, d), w)),
            ("ω off 16 bytes", ops.trigger_sq_norms(z, w_off[1:]))):
        if not torch.equal(other, got[:other.shape[0]]):
            raise AssertionError(f"trigger_sq_norms: the same row at {label} "
                                 f"gives {other[0].item()!r}, at N = {n} "
                                 f"{got[0].item()!r}")
    # K1a: bf16 z and ω (and each alone) take the leaf-table kernel,
    # counted under K1, bit-equal to K1 on fp32 copies.
    for nn_, dd in ((n, d), (7, 1001)):
        z, w = mk(nn_, dd), mk(dd)
        zb, wb = z.to(torch.bfloat16), w.to(torch.bfloat16)
        for label, a, b in (("z and ω", zb, wb), ("z", zb, w),
                            ("ω", z, wb)):
            before = ops.trigger_sq_norms.launches
            got = ops.trigger_sq_norms(a, b)
            if ops.trigger_sq_norms.launches != before + 1:
                raise AssertionError("trigger_sq_norms (bf16) did not "
                                     "launch once")
            if not torch.equal(got, ops.trigger_sq_norms(a.float(),
                                                         b.float())):
                raise AssertionError(f"trigger_sq_norms with {label} in "
                                     f"bf16 at ({nn_}, {dd}) is not K1's "
                                     "bits on fp32 copies")
            torch.testing.assert_close(
                got, ops.trigger_sq_norms_ref(a, b), rtol=1e-5, atol=0)
    log(f"trigger_sq_norms, bf16 (K1a, the leaf-table kernel): z and ω, z "
        f"alone and ω alone in bf16 at ({n}, {d}) and (7, 1001) bit-equal "
        "to K1 on fp32 copies, rtol 1e-5 to the plain version held")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timed = round_kernel_ms(ops, dev, gen)
    z, w = mk(n, d), mk(d)
    rows["trigger_sq_norms"] = dict(
        replaces="src/repro/kernels/trigger_norms.py:59", max_abs_err=err,
        plain_ms=device_ms(lambda: ops.trigger_sq_norms_ref(z, w),
                           calls=PLAIN_CALLS),
        library_ms=device_ms(lambda: torch.cdist(
            z, w[None], compute_mode="donot_use_mm_for_euclid_dist")),
        nflop=3 * n * d)
    log(f"trigger_sq_norms: max_abs_err {err:.3e} (rtol 1e-5 held) "
        f"at ({n}, {d}), (1, 130), (7, 1001); identical rows bit-equal at "
        f"N = {n}, at N = 1, at a 4-byte-offset view and with ω off 16 "
        "bytes")

    # K2 admm_update, both forms, bit-exact.
    for with_z in (True, False):
        for nn_, dd in ((n, d), (1, 130)):
            th, la, w = mk(nn_, dd), mk(nn_, dd), mk(dd)
            got = ops.admm_update(th, la, w, with_z=with_z)
            want = ops.admm_update_ref(th, la, w, with_z=with_z)
            for g, x in zip(got, want, strict=True):
                if not torch.equal(g, x):
                    raise AssertionError(f"admm_update(with_z={with_z}) at "
                                         f"({nn_}, {dd}) is not bit-exact")
    th, la, w = mk(n, d), mk(n, d), mk(d)
    rows["admm_update"] = dict(
        replaces="src/repro/kernels/admm_update.py:88", max_abs_err=0.0,
        plain_ms=device_ms(lambda: ops.admm_update_ref(th, la, w,
                                                       with_z=False),
                           calls=PLAIN_CALLS),
        library_ms=None, nflop=2 * n * d)
    log("admm_update: bit-exact, with and without z, at "
        f"({n}, {d}) and (1, 130)")

    # K3 fused_gss, both forms, some invalid lanes (the first slot valid
    # or not, the last one not), odd D (the 4-byte path), bit-exact over
    # the whole state, so rows outside the plan must stay untouched.
    for with_z in (True, False):
        for nn_, cc, dd, first in ((n, c, d, True), (n, c, d, False),
                                   (7, 3, 1001, False), (1, 1, 130, True)):
            state = [mk(nn_, dd) for _ in range(3)]
            solved, w = mk(cc, dd), mk(dd)
            idx = torch.from_numpy(rng.permutation(nn_)[:cc].astype(
                np.int32)).to(dev)
            valid = torch.from_numpy(rng.random(cc) < 0.75).to(dev)
            valid[0] = first
            if cc > 1:
                valid[-1] = False
            got = ops.fused_gss(idx, valid, solved, w,
                                *[s.clone() for s in state], with_z=with_z)
            want = ops.fused_gss_ref(idx, valid, solved, w,
                                     *[s.clone() for s in state],
                                     with_z=with_z)
            for g, x in zip(got, want, strict=True):
                if not torch.equal(g, x):
                    raise AssertionError(f"fused_gss(with_z={with_z}) at "
                                         f"({nn_}, {cc}, {dd}) is not "
                                         "bit-exact")
    th, la, zp = mk(n, d), mk(n, d), mk(n, d)
    solved, w = mk(c, d), mk(d)
    idx = torch.from_numpy(rng.permutation(n)[:c].astype(np.int32)).to(dev)
    valid = torch.arange(c, device=dev) < c - 2  # two invalid lanes
    n_valid = int(valid.sum())
    rows["fused_gss"] = dict(
        replaces="src/repro/kernels/fused_gss.py:148", max_abs_err=0.0,
        plain_ms=device_ms(lambda: ops.fused_gss_ref(idx, valid, solved, w,
                                                     th, la, zp),
                           calls=PLAIN_CALLS),
        library_ms=None, nflop=3 * n_valid * d)
    log(f"fused_gss: bit-exact, with and without z, at ({n}, {c}, {d}) "
        "with the first slot valid and not, at (7, 3, 1001) (odd D) and "
        "(1, 1, 130); invalid lanes and unplanned rows untouched")

    for name, r in rows.items():
        r.update(ms=timed[name]["cold"], warm_ms=timed[name]["warm"],
                 nbytes=timed[name]["bytes"])
        t_bytes = r["nbytes"] / bw * 1e3 if bw else None
        t_ops = r["nflop"] / PEAK_FP32_FLOPS * 1e3
        r["bound_ms"] = None if t_bytes is None else max(t_bytes, t_ops)
        r["bound_by"] = ("bytes" if t_bytes is None or t_bytes >= t_ops
                         else "operations")
        lib = r["library_ms"]
        share = (f"{r['bound_ms'] / r['ms']:.1%} cold, "
                 f"{r['bound_ms'] / r['warm_ms']:.1%} warm"
                 if r["bound_ms"] else "n/a")
        log(f"  {name}: ms {r['ms']:.4f} (cold)  warm_ms {r['warm_ms']:.4f}  "
            f"plain_ms {r['plain_ms']:.4f}  "
            f"library_ms {'null' if lib is None else f'{lib:.4f}'}  "
            f"bound_ms {r['bound_ms']} ({share} of it reached)  "
            f"bytes {r['nbytes']}")
    return rows


def _stacked_leaves(params, n, gen):
    """A stacked tree of ``params``' structure, every leaf (n, ...) drawn
    from ``gen``, and an unstacked ω tree: K1c's operands."""
    from repro_torch.utils.pytree import tree_map

    def draw(shape, like):
        return torch.randn(shape, generator=gen, device=like.device)

    return (tree_map(lambda w: draw((n,) + tuple(w.shape), w), params),
            tree_map(lambda w: draw(tuple(w.shape), w), params))


def _k1_on_the_concatenation(ops, z, w):
    """K1's kernel on the fp32 matrix the reference's front end builds."""
    from repro_torch.utils.pytree import flatten, flatten_stacked
    return ops.trigger_sq_norms(flatten_stacked(z), flatten(w))


def check_pytree_kernel(dev, ops, trees):
    """Phase 3, slices 7 and 9: K1c (``trigger_sq_norms_pytree``: one
    launch of K1's leaf-table kernel over the stacked tree's leaves in
    place) at the main path's leaf shapes — ``trees`` maps a workload's
    name to its params (the MLP's 4 leaves, the CNN's 12) — and at the
    MLP's with fc1/w in bf16: one launch, counted under K1c and not K1,
    one CUDA kernel in the call (torch.profiler: no concatenation, no
    cast), bit-equal to K1 on the concatenated fp32 copy, rtol 1e-5 to
    the plain version; timed cold (the graph rotates over input sets L2
    cannot hold) at each workload's shape.  Returns the kernels line's
    row (timed at the CNN's shapes, the larger)."""
    from repro_torch.launch.time_kernels import (COLD_COPIES, cycle,
                                                 device_ms, kernel_breakdown,
                                                 peak_bandwidth)
    from repro_torch.launch.roofline import PEAK_FP32_FLOPS
    from repro_torch.utils.pytree import tree_size

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bw = peak_bandwidth(torch.cuda.get_device_name(0))
    err, times = 0.0, {}
    cases = [(name, False) for name in trees] + [("mlp", True)]
    for name, bf16 in cases:
        z, w = _stacked_leaves(trees[name], 100, gen)
        if bf16:
            z["fc1"]["w"] = z["fc1"]["w"].to(torch.bfloat16)
            w["fc1"]["w"] = w["fc1"]["w"].to(torch.bfloat16)
        ops.reset_launch_counts()
        got = ops.trigger_sq_norms_pytree(z, w)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if (counts["trigger_sq_norms_pytree"], counts["trigger_sq_norms"],
                ops.trigger_sq_norms_pytree.leaf_copies) != (1, 0, 0):
            raise AssertionError("trigger_sq_norms_pytree launched "
                                 f"{counts}, copied "
                                 f"{ops.trigger_sq_norms_pytree.leaf_copies}"
                                 " leaves; expected one table launch, no K1 "
                                 "and no copy")
        kernels = kernel_breakdown(lambda: ops.trigger_sq_norms_pytree(z, w),
                                   calls=2)
        if len(kernels) != 1 or "trigger_table_kernel" not in next(
                iter(kernels)):
            raise AssertionError("trigger_sq_norms_pytree ran the kernels "
                                 f"{list(kernels)}, expected the leaf-table "
                                 "kernel alone")
        if not torch.equal(got, _k1_on_the_concatenation(ops, z, w)):
            raise AssertionError(f"trigger_sq_norms_pytree at the {name}'s "
                                 "leaves is not K1's bits on the "
                                 "concatenation")
        want = ops.trigger_sq_norms_pytree_ref(z, w)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        err = max(err, float((got - want).abs().max()))
        label = f"{name}{' (fc1/w bf16)' if bf16 else ''}"
        log(f"trigger_sq_norms_pytree, the {label}'s leaves at N = 100 "
            f"(D = {tree_size(w)}): one launch of the leaf-table kernel and "
            "no other kernel, bit-equal to K1 on the concatenated fp32 "
            f"copy; max_abs_err {float((got - want).abs().max()):.3e} to "
            "the plain version (rtol 1e-5 held)")
        if bf16:
            continue
        sets = [(z, w)] + [_stacked_leaves(trees[name], 100, gen)
                           for _ in range(COLD_COPIES - 1)]
        nbytes = ops.trigger_sq_norms_pytree_hbm_bytes(z, w)
        times[name] = dict(
            ms=device_ms(cycle([lambda a=a, b=b: ops.trigger_sq_norms_pytree(
                a, b) for a, b in sets])),
            warm_ms=device_ms(lambda: ops.trigger_sq_norms_pytree(z, w)),
            plain_ms=device_ms(lambda: ops.trigger_sq_norms_pytree_ref(z, w),
                               calls=PLAIN_CALLS),
            nbytes=nbytes, bound_ms=nbytes / bw * 1e3 if bw else None)
        t = times[name]
        log(f"  trigger_sq_norms_pytree at the {name}'s leaves: ms "
            f"{t['ms']:.4f} (cold)  warm_ms {t['warm_ms']:.4f}  plain_ms "
            f"{t['plain_ms']:.4f}  bound_ms {t['bound_ms']} (the leaves "
            f"read once: {nbytes} bytes; "
            f"{t['bound_ms'] / t['ms']:.1%} of it reached)")
        del sets
    row = times["cnn"]
    t_bytes = row["bound_ms"]
    t_ops = 3 * 100 * tree_size(trees["cnn"]) / PEAK_FP32_FLOPS * 1e3
    return dict(replaces="src/repro/kernels/ops.py:89",
                max_abs_err=err, ms=row["ms"], warm_ms=row["warm_ms"],
                plain_ms=row["plain_ms"], library_ms=None,
                bound_ms=None if t_bytes is None else max(t_bytes, t_ops),
                bound_by=None if t_bytes is None else
                ("bytes" if t_bytes >= t_ops else "operations"),
                nbytes=row["nbytes"])


def _bound(r, bw):
    """Fill ``r``'s bound_ms / bound_by from its bytes and fp32 operations
    (bound_ms None on a card the bandwidth table does not name)."""
    t_bytes = r["nbytes"] / bw * 1e3 if bw else None
    from repro_torch.launch.roofline import PEAK_FP32_FLOPS
    t_ops = r["nflop"] / PEAK_FP32_FLOPS * 1e3
    r["bound_ms"] = None if t_bytes is None else max(t_bytes, t_ops)
    r["bound_by"] = ("bytes" if t_bytes is None or t_bytes >= t_ops
                     else "operations")
    return r


def _share(r):
    return (f"{r['bound_ms'] / r['ms']:.1%} of it reached" if r["bound_ms"]
            else "n/a")


def check_sharded_kernels(dev, ops, n, d):
    """Phase 3, slices 8 and 9: K1b and K2b at the sharded forms' shapes,
    N = 100 rows of D in P = 2 and P = 4 shards on the card: each shard's
    results bit-equal to the unsharded kernel's on the same rows (and
    K1b within rtol 1e-5 of its plain version); K1b in one launch of the
    leaf-table kernel for the card's P shards, K2b one launch of K2's
    kernel per shard, counted under K1b / K2b and not under K1 / K2.
    K1b's whole call is timed cold at both P (the N rows' bytes, as K1),
    beside its plain version and ``torch.cdist`` on all the rows; a lone
    launch on one shard's N/P rows is timed too (the table kernel with
    one row block).  K2b's launch is timed alone at (N/P, D).  Returns
    the kernels line's rows: K1b's whole call at P = 4 (SR's), K2b's
    launch at P = 2 (SB's)."""
    from repro_torch.launch.time_kernels import (COLD_COPIES, cycle,
                                                 device_ms, peak_bandwidth)
    from repro_torch.sharding import make_client_mesh, replicate_data, \
        shard_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bw = peak_bandwidth(torch.cuda.get_device_name(0))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def log_row(label, r):
        lib = r["library_ms"]
        log(f"  {label}: ms {r['ms']:.4f} (cold)  warm_ms {r['warm_ms']:.4f}"
            f"  plain_ms {r['plain_ms']:.4f}  library_ms "
            f"{'null' if lib is None else f'{lib:.4f}'}  bound_ms "
            f"{r['bound_ms']} ({_share(r)})  bytes {r['nbytes']}")

    rows, err = {}, 0.0
    for p in (2, 4):
        mesh, n_local = make_client_mesh(p, [dev]), n // p
        z, th, la, w = randn(n, d), randn(n, d), randn(n, d), randn(d)
        ws = replicate_data(mesh, w)
        ops.reset_launch_counts()
        sq = ops.trigger_sq_norms_sharded(shard_rows(z, mesh), ws, mesh)
        outs = [ops.admm_update(shard_rows(th, mesh), shard_rows(la, mesh),
                                ws, with_z=with_z, mesh=mesh)
                for with_z in (True, False)]
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = {"trigger_sq_norms_sharded": 1, "admm_update_sharded": 2 * p,
                "trigger_sq_norms": 0, "admm_update": 0}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"K1b/K2b at P = {p} launched {counts}, "
                                 f"expected {want}")
        if not torch.equal(torch.cat(sq), ops.trigger_sq_norms(z, w)):
            raise AssertionError(f"trigger_sq_norms_sharded at P = {p}: a "
                                 "shard's rows differ from K1's bits")
        plain = ops.trigger_sq_norms_sharded_ref(shard_rows(z, mesh), ws)
        torch.testing.assert_close(torch.cat(sq), torch.cat(plain),
                                   rtol=1e-5, atol=0)
        err = max(err, float((torch.cat(sq) - torch.cat(plain)).abs().max()))
        for with_z, got in zip((True, False), outs, strict=True):
            for part, whole in zip(got, ops.admm_update(th, la, w,
                                                        with_z=with_z),
                                   strict=True):
                if not torch.equal(torch.cat(part), whole):
                    raise AssertionError(
                        f"admm_update_sharded(with_z={with_z}) at P = {p}: "
                        "a shard's rows differ from K2's bits")
        log(f"trigger_sq_norms_sharded, admm_update_sharded: P = {p} shards "
            f"of ({n}, {d}) on one card, K1b in one launch, K2b one launch "
            "per shard, every row bit-equal to the unsharded kernel's (K2b "
            "with and without z); K1b within rtol 1e-5 of its plain version")
        del z, th, la, sq, outs, plain
        # K1b's whole call on the card's P shards, cold.
        sets = [(shard_rows(randn(n, d), mesh),
                 replicate_data(mesh, randn(d))) for _ in range(COLD_COPIES)]
        z0, w0 = sets[0]
        whole = torch.cat(z0)
        k1b = _bound(dict(
            ms=device_ms(cycle([lambda s=s: ops.trigger_sq_norms_sharded(
                s[0], s[1], mesh) for s in sets])),
            warm_ms=device_ms(lambda: ops.trigger_sq_norms_sharded(
                z0, w0, mesh)),
            plain_ms=device_ms(lambda: ops.trigger_sq_norms_sharded_ref(
                z0, w0), calls=PLAIN_CALLS),
            library_ms=device_ms(lambda: torch.cdist(
                whole, w0[0][None],
                compute_mode="donot_use_mm_for_euclid_dist")),
            nbytes=ops.trigger_sq_norms_hbm_bytes(n, d),  # one ω tensor
            nflop=3 * n * d), bw)
        log_row(f"trigger_sq_norms_sharded at P = {p}, the whole call (one "
                f"launch over {p} shards of ({n_local}, {d}))", k1b)
        del sets, z0, w0, whole
        # A lone launch on one shard's rows, and K2b's launch.
        one = make_client_mesh(1, [dev])
        sets = [(randn(n_local, d), randn(n_local, d), randn(n_local, d),
                 randn(d)) for _ in range(COLD_COPIES)]
        z0, th0, la0, w0 = sets[0]
        lone = _bound(dict(
            ms=device_ms(cycle([lambda s=s: ops.trigger_sq_norms_sharded(
                [s[0]], [s[3]], one) for s in sets])),
            warm_ms=device_ms(lambda: ops.trigger_sq_norms_sharded(
                [z0], [w0], one)),
            plain_ms=device_ms(lambda: ops.trigger_sq_norms_sharded_ref(
                [z0], [w0]), calls=PLAIN_CALLS),
            library_ms=device_ms(lambda: torch.cdist(
                z0, w0[None], compute_mode="donot_use_mm_for_euclid_dist")),
            nbytes=ops.trigger_sq_norms_hbm_bytes(n_local, d),
            nflop=3 * n_local * d), bw)
        log_row(f"trigger_sq_norms_sharded, a lone launch on ({n_local}, "
                f"{d})", lone)
        k2b = _bound(dict(
            ms=device_ms(cycle([lambda s=s: ops.admm_update_sharded(
                [s[1]], [s[2]], [s[3]], one, with_z=False) for s in sets])),
            warm_ms=device_ms(lambda: ops.admm_update_sharded(
                [th0], [la0], [w0], one, with_z=False)),
            plain_ms=device_ms(lambda: ops.admm_update_sharded_ref(
                [th0], [la0], [w0], with_z=False), calls=PLAIN_CALLS),
            library_ms=None,
            nbytes=ops.admm_update_hbm_bytes(n_local, d, with_z=False),
            nflop=2 * n_local * d), bw)
        log_row(f"admm_update_sharded at P = {p}, one launch on ({n_local}, "
                f"{d})", k2b)
        del sets, z0, th0, la0, w0
        if p == 4:
            rows["trigger_sq_norms_sharded"] = dict(
                k1b, replaces="src/repro/kernels/trigger_norms.py:74",
                max_abs_err=0.0)
        if p == 2:
            rows["admm_update_sharded"] = dict(
                k2b, replaces="src/repro/kernels/admm_update.py:100",
                max_abs_err=0.0)
    rows["trigger_sq_norms_sharded"]["max_abs_err"] = err
    return rows


# K4's bf16 rows at the models' shapes: (B, H, KvH, hd) at S = 2048.
K4_SHAPE_ROWS = {
    "flash_attention_gqa": (SERVE_BATCH, 32, 8, 64),
    "flash_attention_phi3": (SERVE_BATCH, 40, 10, 128),
    "flash_attention_moonshot": (SERVE_BATCH, 16, 16, 128),
    "flash_attention_tp4": (SERVE_BATCH, 8, 2, 64),
    "flash_attention_fsdp2": (SERVE_BATCH // 2, 32, 8, 64),
    "flash_attention_zamba2_tp4": (SERVE_BATCH, 8, 8, 80),
    "flash_attention_moonshot_tp4": (SERVE_BATCH, 4, 4, 128),
}


def k4_shape_row(ops, randn, b, h, kvh, hd, peak):
    """K4's bf16 instance at (b, SERVE_PROMPT, h:kvh, hd), causal, the
    (B, S, H, hd) layout: held against its plain version at rtol/atol
    2e-2, then timed beside it and ``scaled_dot_product_attention``; a
    row of the kernels line (its bound filled in later)."""
    from repro_torch.launch.time_kernels import device_ms
    s = SERVE_PROMPT
    q = randn(b, s, h, hd, dtype=torch.bfloat16)
    k, v = (randn(b, s, kvh, hd, dtype=torch.bfloat16) for _ in range(2))
    got = ops.flash_attention(q, k, v, layout="bshd")
    want = ops.flash_attention_ref(q, k, v, layout="bshd")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    err = float((got.float() - want.float()).abs().max())
    kind = "MHA" if h == kvh else "GQA"
    log(f"flash_attention bf16 ({b}, {s}, {h}:{kvh}, {hd}) {kind} causal, "
        f"(B, S, H, hd): max_abs_err {err:.3e} (rtol/atol 2e-2 held)")
    del got, want
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return dict(
        replaces="src/repro/kernels/flash_attention.py:112",
        source=MODEL_SRC, max_abs_err=err,
        ms=device_ms(lambda: ops.flash_attention(q, k, v, layout="bshd")),
        plain_ms=device_ms(lambda: ops.flash_attention_ref(
            q, k, v, layout="bshd"), calls=PLAIN_CALLS),
        library_ms=device_ms(lambda: torch.nn.functional.
                             scaled_dot_product_attention(
                                 qt, kt, vt, is_causal=True,
                                 enable_gqa=h != kvh)),
        nbytes=ops.flash_attention_hbm_bytes(b, h, kvh, s, hd, 2),
        nflop=ops.flash_attention_flops(b, h, s, hd), peak_flops=peak)


def check_model_kernels(dev, ops):
    """Phase 3, slices 2 and 5: K4 (its bf16 and 3xTF32 instances) and
    K5 against their plain versions at the serve shapes; returns rows
    of the kernels line.  Also times K4's SIMT instance on the same
    fp32 inputs, 4 bytes off their storage, for a log line."""
    from repro_torch.launch.roofline import PEAK_BF16_FLOPS, \
        PEAK_FP32_FLOPS, PEAK_TF32_FLOPS_BY_CARD, peak_for
    from repro_torch.launch.time_kernels import device_ms, peak_bandwidth
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    name = torch.cuda.get_device_name(0)
    bw = peak_bandwidth(name)
    rows = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # K4 flash_attention, the model's (B, S, H, hd) layout.
    b, h, s, hd = SERVE_BATCH, 32, SERVE_PROMPT, 80
    err = err32 = 0.0
    for dtype, seq, window, tol in (
            (torch.bfloat16, s, 0, 2e-2), (torch.float32, s, 0, 1e-4),
            (torch.float32, 2000, 0, 1e-4), (torch.float32, s, 1024, 1e-4),
            (torch.bfloat16, s, 1024, 2e-2)):
        q, k, v = (randn(b, seq, h, hd, dtype=dtype) for _ in range(3))
        got = ops.flash_attention(q, k, v, window=window, layout="bshd")
        want = ops.flash_attention_ref(q, k, v, window=window,
                                       layout="bshd")
        torch.cuda.synchronize()
        atol = tol if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=atol)
        e = float((got.float() - want.float()).abs().max())
        if window == 0 and seq == s:
            if dtype == torch.bfloat16:
                err = e
            else:
                err32 = e
        log(f"flash_attention {str(dtype).split('.')[-1]} ({b}, {h}, "
            f"{seq}, {hd}) window {window}: max_abs_err {e:.3e} "
            f"(rtol {tol} held)")
    # fp32 in the Pallas kernel's (B, H, S, hd) layout: GQA 4:1 with a
    # window, hd 64 and 128 (the 32-key tiles), all on the 3xTF32
    # instance; then one view 4 bytes into its storage, which suits no
    # tensor map and takes the SIMT instance.  rtol 1e-4, atol 1e-5.
    for label, qs, kvs, window, offset in (
            ("GQA 4:1 window 100", (2, 8, 300, 80), (2, 2, 300, 80), 100, 0),
            ("hd 64 causal", (2, 8, 1000, 64), (2, 8, 1000, 64), 0, 0),
            ("hd 128 causal", (2, 8, 1000, 128), (2, 8, 1000, 128), 0, 0),
            ("GQA 4:1 window 100, q 4 bytes off its storage",
             (2, 8, 300, 80), (2, 2, 300, 80), 100, 1)):
        q = randn(math.prod(qs) + offset)[offset:].view(qs)
        k, v = randn(*kvs), randn(*kvs)
        want_instance = "simt" if offset else "tf32x3"
        before = ops.flash_attention.instance_launches[want_instance]
        got = ops.flash_attention(q, k, v, window=window)
        want = ops.flash_attention_ref(q, k, v, window=window)
        torch.cuda.synchronize()
        if ops.flash_attention.instance_launches[want_instance] != \
                before + 1:
            raise AssertionError(f"flash_attention fp32 {qs} {label} did not "
                                 f"take the {want_instance} instance")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        e = float((got - want).abs().max())
        log(f"flash_attention fp32 {qs} {label}, (B, H, S, hd), "
            f"{want_instance} instance: max_abs_err {e:.3e} (rtol 1e-4 "
            "held)")
    # The bf16 (tensor-core) instance at other head dims, GQA, a window
    # and a ragged S, against the plain version at 2e-2.
    for label, qs, kvs, window, layout in (
            ("hd 64 causal, (B, H, S, hd)", (2, 8, 1000, 64),
             (2, 8, 1000, 64), 0, "bhsd"),
            ("hd 128 causal, (B, H, S, hd)", (2, 8, 1000, 128),
             (2, 8, 1000, 128), 0, "bhsd"),
            ("GQA 4:1 window 100, (B, H, S, hd)", (2, 8, 300, 80),
             (2, 2, 300, 80), 100, "bhsd"),
            ("ragged S = 2000 causal, (B, S, H, hd)", (b, 2000, h, hd),
             (b, 2000, h, hd), 0, "bshd")):
        q = randn(*qs, dtype=torch.bfloat16)
        k, v = (randn(*kvs, dtype=torch.bfloat16) for _ in range(2))
        got = ops.flash_attention(q, k, v, window=window, layout=layout)
        want = ops.flash_attention_ref(q, k, v, window=window,
                                       layout=layout)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        e = float((got.float() - want.float()).abs().max())
        log(f"flash_attention bf16 {qs} {label}: max_abs_err {e:.3e} "
            "(rtol/atol 2e-2 held)")
    q, k, v = (randn(b, s, h, hd, dtype=torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    peak = peak_for(PEAK_BF16_FLOPS, name)
    rows["flash_attention"] = dict(
        replaces="src/repro/kernels/flash_attention.py:112",
        source=MODEL_SRC, max_abs_err=err,
        ms=device_ms(lambda: ops.flash_attention(q, k, v, layout="bshd")),
        plain_ms=device_ms(lambda: ops.flash_attention_ref(q, k, v,
                                                           layout="bshd"),
                           calls=PLAIN_CALLS),
        library_ms=device_ms(lambda: torch.nn.functional.
                           scaled_dot_product_attention(
                               qt, kt, vt, is_causal=True, enable_gqa=True)),
        nbytes=ops.flash_attention_hbm_bytes(b, h, h, s, hd, 2),
        nflop=ops.flash_attention_flops(b, h, s, hd), peak_flops=peak)
    # K4's 3xTF32 instance at the same shape in fp32: on the path of
    # phase 6 (the fp32 one-group check), a row of the kernels line.
    # Its operations are counted three times (three TF32 products) at
    # the TF32 tensor-core peak.  The SIMT instance is timed on the same
    # values 4 bytes off their storage, against its own bound (one
    # product at 67 TFLOP/s fp32).
    q, k, v = (randn(b, s, h, hd) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    nflop = ops.flash_attention_flops(b, h, s, hd)
    rows["flash_attention_fp32"] = dict(
        replaces="src/repro/kernels/flash_attention.py:112",
        source=MODEL_SRC, max_abs_err=err32,
        ms=device_ms(lambda: ops.flash_attention(q, k, v, layout="bshd")),
        plain_ms=device_ms(lambda: ops.flash_attention_ref(q, k, v,
                                                           layout="bshd"),
                           calls=PLAIN_CALLS),
        library_ms=device_ms(lambda: torch.nn.functional.
                             scaled_dot_product_attention(
                                 qt, kt, vt, is_causal=True,
                                 enable_gqa=True)),
        nbytes=ops.flash_attention_hbm_bytes(b, h, h, s, hd, 4),
        nflop=3 * nflop, peak_flops=peak_for(PEAK_TF32_FLOPS_BY_CARD, name))
    # K4's bf16 instance at the models' prefill shapes in the (B, S, H,
    # hd) layout, each held at 2e-2 and timed beside
    # ``scaled_dot_product_attention``: granite-3-2b's GQA 32:8 at
    # head_dim 64 (phase 7c's 40 launches a prefill), phi3-medium-14b's
    # 40:10 at 128 (8e's 40), moonshot-v1-16b-a3b's MHA 16:16 at 128
    # (9b's 48), and granite's shards on a model mesh (phase 11b): 8:2
    # on one model shard of four under tp (160 a prefill), (2, 2048,
    # 32:8, 64) on one data shard of two under fsdp (80); the tp shards
    # of phase 13: zamba2's shared block 8:8 at 80 (13b, 36 a prefill)
    # and moonshot's 4:4 at 128 (13c, 16 a prefill in each mode).
    for row, shape in K4_SHAPE_ROWS.items():
        rows[row] = k4_shape_row(ops, randn, *shape, peak)
    off = [randn(b * s * h * hd + 1)[1:].view(b, s, h, hd) for _ in range(3)]
    for t, src in zip(off, (q, k, v), strict=True):
        t.copy_(src)
    simt_ms = device_ms(lambda: ops.flash_attention(*off, layout="bshd"))
    simt_bound = nflop / PEAK_FP32_FLOPS * 1e3
    log(f"  flash_attention fp32, SIMT instance (4 bytes off): ms "
        f"{simt_ms:.4f}  bound_ms {simt_bound} (operations at "
        f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s fp32, "
        f"{simt_bound / simt_ms:.1%} of it reached)")
    del q, k, v, qt, kt, vt, off

    # K5 ssd_scan: bf16 states, fp32 decays, bit-exact.
    shape = (SERVE_BATCH, SERVE_PROMPT // 64, 80, 64, 64)
    for dtype, shp in ((torch.bfloat16, shape), (torch.float32, shape),
                       (torch.bfloat16, (2, 5, 3, 7, 9))):
        st = randn(*shp, dtype=dtype)
        dec = torch.rand(shp[:3], generator=gen, device=dev)
        got = ops.ssd_scan(st, dec)
        want = ops.ssd_scan_ref(st, dec)
        for g, w in zip(got, want, strict=True):
            if not torch.equal(g, w):
                raise AssertionError(f"ssd_scan {dtype} {shp} is not "
                                     "bit-exact")
    log(f"ssd_scan: bit-exact, bf16 and fp32 states at {shape} and bf16 "
        "at (2, 5, 3, 7, 9)")
    st = randn(*shape, dtype=torch.bfloat16)
    dec = torch.rand(shape[:3], generator=gen, device=dev)
    rows["ssd_scan"] = dict(
        replaces="src/repro/kernels/ssd_scan.py:55", source=MODEL_SRC,
        max_abs_err=0.0, ms=device_ms(lambda: ops.ssd_scan(st, dec)),
        plain_ms=device_ms(lambda: ops.ssd_scan_ref(st, dec),
                           calls=PLAIN_CALLS),
        # No single PyTorch call computes an exclusive linear recurrence
        # with a per-step decay (cumsum/cumprod do not), so there is no
        # library yardstick.
        library_ms=None, nbytes=ops.ssd_scan_hbm_bytes(*shape),
        nflop=2 * math.prod(shape), peak_flops=PEAK_FP32_FLOPS)
    # K5 at mamba2-2.7b's prefill shape: ssm_state 128, a plane twice
    # zamba2's (phase 8c's 64 launches a prefill), bit-exact.
    shape = (SERVE_BATCH, SERVE_PROMPT // 64, 80, 64, 128)
    st = randn(*shape, dtype=torch.bfloat16)
    dec = torch.rand(shape[:3], generator=gen, device=dev)
    got, want = ops.ssd_scan(st, dec), ops.ssd_scan_ref(st, dec)
    for g, w in zip(got, want, strict=True):
        if not torch.equal(g, w):
            raise AssertionError(f"ssd_scan bf16 {shape} is not bit-exact")
    log(f"ssd_scan: bit-exact, bf16 states at {shape} (mamba2-2.7b)")
    del got, want
    rows["ssd_scan_mamba2"] = dict(
        replaces="src/repro/kernels/ssd_scan.py:55", source=MODEL_SRC,
        max_abs_err=0.0, ms=device_ms(lambda: ops.ssd_scan(st, dec)),
        plain_ms=device_ms(lambda: ops.ssd_scan_ref(st, dec),
                           calls=PLAIN_CALLS),
        library_ms=None, nbytes=ops.ssd_scan_hbm_bytes(*shape),
        nflop=2 * math.prod(shape), peak_flops=PEAK_FP32_FLOPS)
    # K5 on one model shard of zamba2 under tp (1, 4): 20 of its 80
    # heads (phase 13b's 216 launches a prefill), bit-exact.
    shape = (SERVE_BATCH, SERVE_PROMPT // 64, 20, 64, 64)
    st = randn(*shape, dtype=torch.bfloat16)
    dec = torch.rand(shape[:3], generator=gen, device=dev)
    got, want = ops.ssd_scan(st, dec), ops.ssd_scan_ref(st, dec)
    for g, w in zip(got, want, strict=True):
        if not torch.equal(g, w):
            raise AssertionError(f"ssd_scan bf16 {shape} is not bit-exact")
    log(f"ssd_scan: bit-exact, bf16 states at {shape} (a zamba2-2.7b tp "
        "shard)")
    del got, want
    rows["ssd_scan_zamba2_tp4"] = dict(
        replaces="src/repro/kernels/ssd_scan.py:55", source=MODEL_SRC,
        max_abs_err=0.0, ms=device_ms(lambda: ops.ssd_scan(st, dec)),
        plain_ms=device_ms(lambda: ops.ssd_scan_ref(st, dec),
                           calls=PLAIN_CALLS),
        library_ms=None, nbytes=ops.ssd_scan_hbm_bytes(*shape),
        nflop=2 * math.prod(shape), peak_flops=PEAK_FP32_FLOPS)

    return model_bounds(rows, bw)


def model_bounds(rows, bw):
    """Fill each row's bound_ms / bound_by from its bytes at ``bw`` and
    its operations at its own peak, and log the row."""
    for kname, r in rows.items():
        t_bytes = r["nbytes"] / bw * 1e3 if bw else None
        t_ops = r["nflop"] / r["peak_flops"] * 1e3 if r["peak_flops"] \
            else None
        if t_bytes is None or t_ops is None:
            r["bound_ms"], r["bound_by"] = None, None
        else:
            r["bound_ms"] = max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib = r["library_ms"]
        share = (f"{r['bound_ms'] / r['ms']:.1%}" if r["bound_ms"]
                 else "n/a")
        log(f"  {kname}: ms {r['ms']:.4f}  plain_ms {r['plain_ms']:.4f}  "
            f"library_ms {'null' if lib is None else f'{lib:.4f}'}  "
            f"bound_ms {r['bound_ms']} ({r['bound_by']}, {share} of it "
            f"reached)  bytes {r['nbytes']}  ops {r['nflop']}  "
            f"{r['nflop'] / r['ms'] / 1e9:.1f} TFLOP/s  "
            f"{r['nbytes'] / r['ms'] / 1e9:.3f} TB/s")
    return rows


def kernel_facts(build):
    """Print what was compiled for the redesigned K1 (and its leaf-table
    form), K3, K4 (bf16 and 3xTF32) and K5: nvcc's -Xptxas -v lines
    (registers, spills) for each of their instances, and the count of
    HGMMA (wgmma) instructions in K4's hd = 80 instances, from the
    library's SASS, where cuobjdump is at hand; raises if the 3xTF32 hd
    = 80 instance has none."""
    lines = build.build_log().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or not any(
                name in line for name in ("trigger_sq_norms",
                                          "trigger_table_kernel",
                                          "fused_gss",
                                          "admm_update_bf16",
                                          "flash_attention_tc_kernel",
                                          "flash_attention_tf32x3_kernel",
                                          "tf32x3_split_kernel",
                                          "ssd_scan")):
            continue
        name = line.split("'")[1]
        facts = [x.replace("ptxas info    :", "").strip()
                 for x in lines[i + 1:i + 5] if "spill" in x or "Used" in x]
        log(f"ptxas: {name}: {'; '.join(facts)}")
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    if not cuobjdump.is_file():
        log("cuobjdump: not found beside nvcc; HGMMA counts not taken")
        return
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path())], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
            counts[current] = 0
        elif current is not None and "HGMMA" in line:
            counts[current] += 1
    for label, key in (("K4 bf16 hd 80 (flash_attention_tc_kernel<5>)",
                        "flash_attention_tc_kernelILi5E"),
                       ("K4 fp32 3xTF32 hd 80 "
                        "(flash_attention_tf32x3_kernel<5>)",
                        "flash_attention_tf32x3_kernelILi5E"),
                       ("K4 fp32 SIMT hd 80 (flash_attention_kernel<float, "
                        "5>)", "flash_attention_kernelIfLi5E")):
        found = {n: c for n, c in counts.items() if key in n}
        log(f"cuobjdump: {label}: "
            + (", ".join(f"{c} HGMMA in {n}" for n, c in found.items())
               if found else "function not found in the SASS"))
        if "tf32x3" in key and not any(found.values()):
            raise AssertionError(f"{label}: no HGMMA instruction in the SASS")


# Rows of the kernels line that hold one kernel at one model's shape.
SHAPE_ROWS = ("flash_attention", *K4_SHAPE_ROWS, "ssd_scan",
              "ssd_scan_mamba2", "ssd_scan_zamba2_tp4")


def path_counts(ops, bf16_row="flash_attention", ssd_row="ssd_scan"):
    """The launch counts of a phase by row of the kernels line: K4's
    bf16 (tensor-core) instance as ``bf16_row`` (``flash_attention``,
    zamba2's shape, or a row of ``K4_SHAPE_ROWS``), its 3xTF32 one as
    ``flash_attention_fp32`` (the SIMT instance is on no path), K5 as
    ``ssd_row`` (``ssd_scan``, zamba2's shape, or ``ssd_scan_mamba2``)."""
    counts = ops.launch_counts()
    by = ops.flash_attention.instance_launches
    ssd = counts["ssd_scan"]
    counts.update(dict.fromkeys(SHAPE_ROWS, 0))
    counts[bf16_row] = by["bf16_tc"]
    counts["flash_attention_fp32"] = by["tf32x3"]
    counts[ssd_row] = ssd
    return counts


def _greedy(model, params, request, steps):
    """Prefill ``request`` (``serve_lm.make_request``'s batch) into a
    cache with room for ``steps`` more (and the vlm's prefix), then
    ``steps`` greedy decode steps → (logits per step, tokens (B, steps +
    1))."""
    from repro_torch.launch.serve_lm import cache_len

    seq = cache_len(model.config, request["tokens"].shape[1], steps)
    logits, tokens, _, _ = timed_greedy(
        lambda: model.prefill(params, request, seq),
        lambda t, c: model.decode_step(params, t, c), steps)
    return logits, tokens


def check_slice_against_cpu(dev, ops, cfg, expect, ssd_row="ssd_scan",
                            k4_total=None):
    """Phases 6, 7c, 8c, 9a, 9c and 9d: one full-width group in fp32,
    card (kernels) against the CPU's plain path on the same weights (a
    vlm's request carries its patches); ``expect`` the launches of the
    prefill by row of the kernels line, ``k4_total`` (where given) K4's
    launches over all its instances."""
    from repro_torch.launch.serve_lm import make_request
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_map

    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    params_cpu = tree_map(lambda x: x.cpu(), params)
    request = make_request(cfg, 1, SLICE_TOKENS, SEED, dev)
    ops.reset_launch_counts()
    got_logits, got_tok = _greedy(model, params, request, SLICE_DECODE)
    torch.cuda.synchronize()
    counts = path_counts(ops, ssd_row=ssd_row)
    k4 = ops.flash_attention.launches
    want_logits, want_tok = _greedy(
        model, params_cpu, {k: v.cpu() for k, v in request.items()},
        SLICE_DECODE)
    if any(counts[k] != n for k, n in expect.items()) or (
            k4_total is not None and k4 != k4_total):
        raise AssertionError(f"one-group prefill launched {counts} (K4 "
                             f"{k4} in all), expected {expect}")
    np.testing.assert_array_equal(got_tok.cpu().numpy(), want_tok.numpy(),
                                  err_msg="greedy tokens differ")
    err = 0.0
    for g, w in zip(got_logits, want_logits, strict=True):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-3)
        err = max(err, float((g.cpu() - w).abs().max()))
    log(f"slice ({cfg.name} width, {cfg.num_layers} layers, fp32, 1 × "
        f"{SLICE_TOKENS} tokens + {SLICE_DECODE} decode steps): card agrees "
        f"with the CPU plain path (logits max_abs_err {err:.3e}, rtol/atol "
        f"1e-3 held; tokens {got_tok.cpu().tolist()[0]} equal); launches "
        f"{counts}")
    return dict(max_abs_err=err, tokens=got_tok.cpu().tolist()[0]), counts


def serve_full(dev, ops, smi, cfg, expect, bf16_row="flash_attention",
               ssd_row="ssd_scan", new_tokens=SERVE_NEW,
               prompt_len=SERVE_PROMPT, check=None, after=None):
    """Phases 7, 7c, 8c, 8e, 9b and 9d: a model at full width and depth,
    bf16, 4 requests × ``prompt_len`` prompt tokens (and a vlm's patches),
    ``new_tokens`` new; ``expect`` the prefill's launches by kernel (none
    in decode).  Then prefill against decode on ``check`` = (a config of
    the same weights, batch, prompt length), by default the served one;
    ``after(model, params)`` adds its dict to the report while the
    weights are on the card."""
    from repro_torch.launch.serve_lm import cache_len, make_request, serve
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"init {cfg.name}: {sum(p.numel() for p in tree_leaves(params))} "
        f"parameters drawn on the card by the jax.random twin in "
        f"{init_s:.2f} s")
    ops.reset_launch_counts()
    report = serve(cfg, batch=SERVE_BATCH, prompt_len=prompt_len,
                   new_tokens=new_tokens, seed=SEED, device=dev,
                   params=params)
    torch.cuda.synchronize()
    counts = path_counts(ops, bf16_row, ssd_row)
    per = report["launches"]
    for phase, want in (("prefill", expect),
                        ("decode", dict.fromkeys(expect, 0))):
        for kname, n in want.items():
            if per[phase][kname] != n:
                raise AssertionError(f"{phase} launched {kname} "
                                     f"{per[phase][kname]} times, expected "
                                     f"{n}")
    tokens = np.asarray(report.pop("tokens"))
    if tokens.shape != (SERVE_BATCH, new_tokens) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"serve returned tokens of shape "
                             f"{tokens.shape} in [{tokens.min()}, "
                             f"{tokens.max()}]")
    # prefill(t0..tn) against decode of tn after prefill(t0..tn-1)
    ccfg, cb, cs = check or (cfg, SERVE_BATCH, prompt_len)
    cmodel = build_model(ccfg)
    request = make_request(ccfg, cb, cs, SEED, dev)
    room = cache_len(ccfg, cs, 0)
    full, _ = cmodel.prefill(params, request, room)
    _, cache = cmodel.prefill(params, dict(
        request, tokens=request["tokens"][:, :-1]), room)
    dec, _ = cmodel.decode_step(params, request["tokens"][:, -1:], cache)
    del cache
    if full.shape != (cb, 1, cfg.vocab_size) or not bool(
            torch.isfinite(full).all() and torch.isfinite(dec).all()):
        raise AssertionError("prefill/decode logits are not finite "
                             f"{(cb, 1, cfg.vocab_size)}")
    diff = (full - dec).abs().amax(dim=(1, 2))
    scale = full.abs().amax(dim=(1, 2))
    rel = (diff / scale).cpu().tolist()
    if max(rel) > CONSISTENCY_REL:
        raise AssertionError(f"prefill/decode disagree: max |Δ logit| / "
                             f"max |logit| = {rel} > {CONSISTENCY_REL}")
    report.update(
        card=smi, init_s=init_s, tokens_request0=tokens[0].tolist(),
        consistency_rel=rel, consistency_on=dict(
            capacity_factor=ccfg.capacity_factor, batch=cb, prompt_len=cs),
        argmax_equal=(full.argmax(-1) == dec.argmax(-1)).flatten().tolist(),
        launches_total=counts)
    if after is not None:
        report.update(after(model, params))
    log(f"serve {cfg.name}: prefill {report['prefill_ms']:.1f} ms, decode "
        f"{report['decode_ms_per_step']:.2f} ms/step "
        f"({report['decode_tok_per_s']:.1f} tok/s), peak "
        f"{report['peak_memory_bytes'] / 2**30:.2f} GiB; prefill/decode "
        f"consistency {rel} on {cb} × {cs} (limit {CONSISTENCY_REL}); "
        f"launches {counts}; on {smi}")
    return report, counts


def _max_abs_diff(got, want):
    from repro_torch.utils.pytree import tree_leaves
    return max(float(np.abs(g - w).max())
               for g, w in zip(tree_leaves(got), tree_leaves(want),
                               strict=True))


def _kink_rows(got, want, before, fields, limit, label,
               cause=None) -> tuple[list, str]:
    """The client rows of the flat state off rtol 1e-4 / atol 1e-6 in
    any of ``fields``, at most ``limit``, each within ``CNN_UPDATE_TOL``
    of its row's update norm and each with its cause shown by
    ``cause(before, got, want, row)`` (:func:`relu_flip_cause`), which
    asserts and returns its reading (:func:`compare_with_cpu`).  Returns
    (the rows, the readings)."""
    if not limit:
        return [], ""
    from repro_torch.launch.conv_precision import update_ratio

    off = set()
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        off |= set(np.nonzero((~np.isclose(g, w, rtol=1e-4, atol=1e-6))
                              .any(axis=1))[0].tolist())
    if len(off) > limit:
        raise AssertionError(f"{label}: {len(off)} client rows off rtol "
                             f"1e-4, more than the {limit} a ReLU flip "
                             "explains")
    for i in sorted(off):
        for f in fields:
            r = update_ratio(getattr(got, f)[i], getattr(want, f)[i],
                             getattr(before, f)[i])
            if r > CNN_UPDATE_TOL:
                raise AssertionError(f"{label}: client {i}'s {f} is off the "
                                     f"CPU's by {r:.2e} of its update")
    return sorted(off), "; ".join(cause(before, got, want, i)
                                  for i in sorted(off))


# A client row that took another ReLU branch on the card than on the CPU
# (``compare_with_cpu``'s ``kink_rows``) must show the cause: in a replay
# of its solve on the CPU, a pre-activation of the hidden unit whose
# weights moved came within this share of the sum of its terms'
# magnitudes of 0.  The two paths' trajectories differ by the solve's
# rounding, ~1e-7 of θ (θ's largest gap in the forms without a flip), so
# a flip needs a pre-activation within about that of 0; over a client's
# 4 steps × 42 examples a unit's smallest share is ~1e-4 by chance (the
# reading prints the median over the 200 units beside it).
KINK_PRE_TOL = 1e-5


def relu_flip_cause(ctx, cfg):
    """``cause(before, got, want, row)`` for :func:`_kink_rows` on the
    paper MLP's flat rows: replays client ``row``'s solve of the round
    from ``before`` on the CPU, one client at a time (its minibatch key
    split from the state's rng as the round splits it, λ⁺ and the prox
    centre from ``core.engine``, warm start at ω, ``sgd_step``), takes
    the hidden unit whose fc1 weights hold the most elements off rtol
    1e-4 between the card (``got``) and the CPU (``want``), and asserts
    that the replay ends within ``CNN_UPDATE_TOL`` of the CPU round's θ
    row (it is that solve) and that one of the unit's pre-activations,
    x·w + b over the solve's steps and examples, came within
    ``KINK_PRE_TOL`` of Σ|x·w| + |b| of 0.  Returns the reading: the
    unit, its smallest share and its rank among the 200 units."""
    from repro_torch import prng
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.engine import dual_ascent, masked_batch_loss, \
        prox_center
    from repro_torch.core.fedback import _epoch_indices
    from repro_torch.launch.conv_precision import update_ratio
    from repro_torch.models import make_loss_fn
    from repro_torch.optim.sgd import sgd_step

    spec, ragged = ctx["spec"], ctx.get("ragged")
    loss_fn = make_loss_fn(ctx["logits"])
    grad = torch.func.grad(loss_fn)
    masked_grad = torch.func.grad(
        lambda p, xb, yb, w: masked_batch_loss(loss_fn, p, xb, yb, w))
    rho = cfg.local_rho()

    def client_rows(row):
        """The client's rows and the epoch length its solve drew at: its
        shard, or on ragged clients its CSR slice of the pool and the
        slots' max(nᵢ) (compact) or its bucket's capacity (dense)."""
        if ragged is None:
            x, y = ctx["data"]["x"][row], ctx["data"]["y"][row]
            return x.cpu(), y.cpu(), x.shape[0]
        rows = ragged.client_slice(row)
        length = ragged.max_size if cfg.compact else next(
            b.capacity for b in ragged.buckets if row in b.members)
        return (ctx["data"]["x"][rows].cpu(), ctx["data"]["y"][rows].cpu(),
                length)

    def cause(before, got, want, row):
        n = before.theta.shape[0]
        _, _, data_rng = prng.split(
            state_from_numpy(before, device="cpu").rng, 3)
        x, y, length = client_rows(row)
        size = x.shape[0]
        idx = _epoch_indices(prng.split(data_rng, n)[row:row + 1],
                             length, cfg.batch_size, cfg.epochs)[0]
        omega = torch.from_numpy(before.omega)
        lam = dual_ascent(torch.from_numpy(before.lam[row:row + 1]),
                          torch.from_numpy(before.theta[row:row + 1]), omega)
        center = prox_center(omega, lam)[0]
        theta = (omega if cfg.warm_start
                 else torch.from_numpy(before.theta[row])).clone()
        buf = torch.zeros_like(theta)
        share = []
        for step in range(idx.shape[0]):
            # A ragged client's padding reads its last row with weight 0,
            # and a step of all padding is skipped (the masked solve).
            live = idx[step] < size
            if not bool(live.any()):
                continue
            p = spec.unflatten(theta)
            xb = x[torch.clamp(idx[step], max=size - 1)]
            yb = y[torch.clamp(idx[step], max=size - 1)]
            w, b = p["fc1"]["w"], p["fc1"]["b"]
            share.append(((xb[live] @ w + b).abs()
                          / (xb[live].abs() @ w.abs() + b.abs())).amin(dim=0))
            g = spec.flatten(grad(p, xb, yb) if bool(live.all()) else
                             masked_grad(p, xb, yb, live.to(torch.float32)))
            g = g + rho * (theta - center)
            theta, buf = sgd_step(theta, g, buf, cfg.lr, cfg.momentum)
        share = torch.stack(share).amin(dim=0)
        off = spec.unflatten(torch.from_numpy(~np.isclose(
            got.theta[row], want.theta[row], rtol=1e-4, atol=1e-6))
            .to(torch.float32))
        unit = int(torch.argmax(off["fc1"]["w"].sum(dim=0)
                                + off["fc1"]["b"]))
        replay = update_ratio(theta.numpy(), want.theta[row],
                              before.theta[row])
        low = float(share[unit])
        rank = int((share < low).sum()) + 1
        typical = float(share.median())
        reading = (f"row {row}: unit {unit} (fc1 {int(off['fc1']['w'][:, unit].sum())}"
                   f" of 784 weights off) came within {low:.2e} of its "
                   f"terms' magnitude of 0, rank {rank} of {share.numel()} "
                   f"units (their median {typical:.2e}); replay within "
                   f"{replay:.2e} of the CPU's row")
        if replay > CNN_UPDATE_TOL:
            raise AssertionError(f"the replay of {reading} is not the "
                                 "round's solve")
        if low > KINK_PRE_TOL:
            raise AssertionError(f"no ReLU flip explains {reading}: more "
                                 f"than {KINK_PRE_TOL}")
        return reading

    return cause


def solve_horizon(ctx, cfg, steps):
    """``check(before, m)`` for :func:`compare_with_cpu`'s ``horizon`` on
    a compact ragged form: the masked solve of the checked round's
    committed clients (their keys split from the state's rng as the
    round splits them, λ⁺ and the prox centers from ``core.engine``,
    warm start at ω, their CSR slices at the slots' max(nᵢ)) over its
    first ``steps`` SGD steps, run on the card and on the CPU from the
    same inputs.  Returns the θ gap over the θ update's norm."""
    from repro_torch import prng
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.engine import dual_ascent, prox_center
    from repro_torch.core.fedback import _epoch_indices, _masked_local_solve
    from repro_torch.launch.conv_precision import update_ratio
    from repro_torch.models import make_loss_fn

    ragged = ctx["ragged"]
    loss_fn = make_loss_fn(ctx["logits"])

    def check(before, m):
        rows = torch.from_numpy(np.nonzero(m.committed.cpu().numpy())[0])
        _, _, data_rng = prng.split(
            state_from_numpy(before, device="cpu").rng, 3)
        keys = prng.split(data_rng, before.theta.shape[0])[rows]
        idx = _epoch_indices(keys, ragged.max_size, cfg.batch_size,
                             cfg.epochs)[:, :steps]
        omega = torch.from_numpy(before.omega)
        theta = torch.from_numpy(before.theta)[rows]
        center = prox_center(omega, dual_ascent(
            torch.from_numpy(before.lam)[rows], theta, omega))
        theta0 = (omega.expand(len(rows), -1) if cfg.warm_start
                  else theta).contiguous()
        inputs = (theta0, center, ctx["data"]["x"].cpu(),
                  ctx["data"]["y"].cpu(), ragged.offsets_array("cpu")[rows],
                  ragged.sizes_array("cpu")[rows], idx)
        out = [_masked_local_solve(
            loss_fn, ctx["spec"], *(t.to(dev) for t in inputs),
            rho=cfg.local_rho(), lr=cfg.lr, momentum=cfg.momentum)[0].cpu()
            for dev in (ctx["dev"], torch.device("cpu"))]
        return update_ratio(out[0].numpy(), out[1].numpy(), theta0.numpy())

    return check


def nudged_spread(round_fn_cpu, before, want, events, fields, placement,
                  draws=4):
    """How far the CPU's own round moves when it starts from ω one ulp
    off (each element nudged up or down at random): per field, the
    largest gap from ``want`` (the round from ``before``, whose events
    were ``events``) over the round's update norm, over ``draws``
    nudges that leave the events as they were."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.launch.conv_precision import update_ratio

    rng = np.random.default_rng(SEED)
    spread = dict.fromkeys(fields, 0.0)
    kept = 0
    for _ in range(draws):
        away = np.where(rng.random(before.omega.shape) < 0.5, -np.inf,
                        np.inf).astype(np.float32)
        start = before._replace(omega=np.nextafter(before.omega, away))
        got, gm = round_fn_cpu(state_from_numpy(start, **placement))
        if not torch.equal(gm.events, events):
            continue
        got = state_to_numpy(got)
        kept += 1
        for f in fields:
            spread[f] = max(spread[f], update_ratio(
                getattr(got, f), getattr(want, f), getattr(before, f)))
    if not kept:
        raise AssertionError("every nudge of ω moved the events")
    return spread


def compare_with_cpu(round_fn_cpu, state_before, state_after, m_after,
                     label, *, exact_events=False, omega_tol=None,
                     update_tol=None, cpu_placement=None, cfg=None,
                     kink_rows=0, kink_cause=None, horizon=None):
    """One round from the same state on the CPU's plain path must agree
    with the card's: events (off a 1e-5 margin around δ, or everywhere
    with ``exact_events``: a random draw is integer math) and, when the
    events agree, the committed set and the state at rtol 1e-4 / atol
    1e-6 (ω at ``omega_tol`` = (rtol, atol) too), leaf by leaf in either
    layout.  With ``update_tol`` (the CNN, whose max-pools can route a
    gradient to another pixel when two values lie within a rounding of
    each other) each state field is held by the norm of its difference
    instead, at most ``update_tol`` of the norm of the round's update.
    ``cpu_placement`` (``Form.placement("cpu")``) puts a sharded form's
    state on a client mesh of CPU shards.  Under compressed consensus
    (``cfg.consensus_compress``) ω and the residual are held by
    :func:`check_ef_round` instead.  ``kink_rows`` (the flat layout)
    lets up to that many client rows off rtol 1e-4 / atol 1e-6 in θ, λ
    or z_prev, each within ``CNN_UPDATE_TOL`` of the norm of its row's
    update and each with its cause shown by ``kink_cause``
    (:func:`relu_flip_cause`): one pre-activation of the MLP within a
    rounding of 0 sends a client's later SGD steps down the other ReLU
    branch, which moved one hidden unit's 785 fc1 weights of one client
    by up to 8.7e-5 in QB's round 2 on an H100; every
    other row is held element by element.  ``horizon`` (with
    ``update_tol``: RC, whose slots run 48 SGD steps through the CNN's
    ReLUs and max-pools) is :func:`solve_horizon`'s check: the slots'
    solve over its first steps, card against CPU, within ``update_tol``
    of its update (CF-A's 4 steps' grade); the whole round's state is
    then held within :func:`nudged_spread`, the distance the CPU's own
    round moves when ω starts one ulp off (and at least
    ``update_tol``).  The round must commit a client, or the state
    check would hold whatever the solve and the commit computed.  θ's
    largest gap is printed (ROADMAP W1)."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.launch.conv_precision import update_ratio
    from repro_torch.utils.pytree import tree_leaves

    committed = int(m_after.committed.sum())
    if committed == 0:
        raise AssertionError(f"{label}: the checked round commits no "
                             "client")
    before = state_to_numpy(state_before)
    ref, rm = round_fn_cpu(state_from_numpy(
        before, **(cpu_placement or {"device": "cpu"})))
    dist = rm.distances.numpy()
    delta = before.ctrl.delta
    margin = np.abs(dist - delta) <= 1e-5 * np.maximum(1.0, np.abs(delta))
    if exact_events:
        margin[:] = False
    ev_gpu = m_after.events.cpu().numpy()
    ev_cpu = rm.events.numpy()
    if (ev_gpu[~margin] != ev_cpu[~margin]).any():
        raise AssertionError(f"{label}: events differ from the CPU path")
    torch.testing.assert_close(m_after.distances.cpu(), rm.distances,
                               rtol=1e-5, atol=1e-6)
    if (ev_gpu != ev_cpu).any():
        log(f"{label}: a client within the margin flipped; state not "
            "compared")
        return
    np.testing.assert_array_equal(m_after.committed.cpu().numpy(),
                                  rm.committed.numpy(), err_msg=label)
    got = state_to_numpy(state_after)
    want = state_to_numpy(ref)
    compressed = got.comm is not None
    fields = ("theta", "lam", "z_prev") + (() if compressed else ("omega",))
    kinks = []
    if update_tol is not None:
        ratios = {f: update_ratio(getattr(got, f), getattr(want, f),
                                  getattr(before, f)) for f in fields}
        limits = dict.fromkeys(fields, update_tol)
        held = ""
        if horizon is not None:
            steps = horizon(before, m_after)
            if steps > update_tol:
                raise AssertionError(f"{label}: the slots' solve over its "
                                     f"first steps is off the CPU's by "
                                     f"{steps:.2e} of its update, more "
                                     f"than {update_tol}")
            spread = nudged_spread(round_fn_cpu, before, want, rm.events,
                                   fields, cpu_placement or {"device": "cpu"})
            limits = {f: max(update_tol, spread[f]) for f in fields}
            held = (f"the slots' solve over its first steps within "
                    f"{steps:.2e} of its update; the CPU's own round from "
                    "ω one ulp off moves "
                    + ", ".join(f"{f} {r:.2e}" for f, r in spread.items())
                    + "; ")
        if any(ratios[f] > limits[f] for f in fields):
            raise AssertionError(f"{label}: state off the CPU's by "
                                 f"{ratios} of the round's update, more "
                                 f"than {limits}")
        held += (f"state within {max(limits.values()):.2e} of the update's "
                 "norm: "
                 + ", ".join(f"{f} {r:.2e}" for f, r in ratios.items())
                + "; largest element difference "
                + ", ".join(f"{f} {_max_abs_diff(getattr(got, f), getattr(want, f)):.3e}"
                            for f in fields))
    else:
        kinks, causes = _kink_rows(got, want, before,
                                   [f for f in fields if f != "omega"],
                                   kink_rows, label, kink_cause)
        rest = np.ones(got.ctrl.delta.shape[0], bool)
        rest[kinks] = False
        for f in fields:
            for g, w in zip(tree_leaves(getattr(got, f)),
                            tree_leaves(getattr(want, f)), strict=True):
                if kinks and f != "omega":
                    g, w = g[rest], w[rest]
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                           err_msg=f)
        held = "state rtol 1e-4" + (
            f" off {len(kinks)} ReLU-flip rows ({causes})" if kinks else "")
    if compressed:
        held += "; " + check_ef_round(before, got, want, m_after, cfg,
                                      cpu_placement or {}, label,
                                      kinks=kinks)
    theta_gap = _max_abs_diff(got.theta, want.theta)
    theta_max = max(float(np.abs(w).max()) for w in tree_leaves(want.theta))
    held += (f"; θ largest gap {theta_gap:.3e} ({theta_gap / theta_max:.2e} "
             "of its largest magnitude)")
    omega_err = _max_abs_diff(got.omega, want.omega)
    if omega_tol is not None:
        for g, w in zip(tree_leaves(got.omega), tree_leaves(want.omega),
                        strict=True):
            np.testing.assert_allclose(g, w, rtol=omega_tol[0],
                                       atol=omega_tol[1], err_msg="omega")
    np.testing.assert_array_equal(got.queue.age, want.queue.age)
    log(f"{label}: round {int(before.round) + 1} ({committed} clients "
        f"committed) agrees with the CPU plain path (events equal, {held}, "
        f"ω max_abs_err {omega_err:.3e}"
        + (f", ω rtol {omega_tol[0]} / atol {omega_tol[1]} held"
           if omega_tol else "") + ")")


# Phase 5g: compressed consensus.  Flips of a sent code allowed against
# the CPU's round beyond twice those the z gap predicts, as a fraction
# of D (``check_ef_round``).
EF_FLIP_FRAC = 1e-4


def _ef_cut(x, mesh):
    """An (N, ...) array as a CPU tensor, or per-shard tensors."""
    from repro_torch.sharding import shard_rows

    t = torch.from_numpy(np.asarray(x))
    return list(shard_rows(t, mesh)) if mesh is not None else t


def _blockmax(x, block):
    """Each coordinate's block maximum of |x| over (N, D) (the int8
    blocks of the compressed consensus)."""
    n, d = x.shape
    nb = -(-d // block)
    padded = np.zeros((n, nb * block))
    padded[:, :d] = np.abs(x)
    return np.repeat(padded.reshape(n, nb, block).max(axis=2), block,
                     axis=1)[:, :d]


def check_ef_round(before, got, want, m_after, cfg, cpu_placement, label,
                   kinks=()):
    """The compressed consensus of one card round (numpy states before,
    after on the card, after on the CPU's plain path):

    1. the card's ω and residual are the CPU's aggregation of the card's
       own z_prev, bit for bit (every operation of the aggregation is
       elementwise or the fixed-order column sum);
    2. against the CPU's round, whose z_prev differs by the solve's
       rounding: a client's δ = z − ω + e moves by its z gap Δz, and its
       sent value code·scale by at most the block's largest |Δz| while
       the code holds; where the two runs' δ fall on different codes, by
       one level-1 step more, and where a shard's partial does, the
       level-2 step ÷ m (the shard's senders).  So the residual lies
       within |Δz| + max_block |Δz| + that step, plus the shard's
       partial's move (its rows' bounds summed, plus the block maximum
       of that sum for the shared scale, plus a level-2 step where its
       code flipped) ÷ m, plus 1e-6; ω within rtol 1e-4 / atol 1e-6 plus
       the partials' moves summed ÷ the denominator (N, or the committed
       count).  Flipped codes are counted, except in ``kinks`` (client
       rows whose solve took another ReLU branch,
       :func:`compare_with_cpu`) and, on the wire, in the blocks those
       rows moved.  A value the z gap moves by Δ crosses a code boundary
       with probability Δ / step, so the count is a sum of Bernoulli
       draws whose mean μ the measured gap gives, with a variance ≤ μ;
       more than ``EF_FLIP_FRAC``·D + 2μ fails.  (QB, dense with 100
       senders, flipped 416 bf16 values where its gap predicted ~305 on
       an H100, past 1e-4·D alone; QA flipped 9 + 2 int8
       codes where 4 were predicted.)
    Rows that sent nothing keep their residual on both.  Returns the
    summary for the log."""
    from repro_torch.core.compress import ef_codes, ef_consensus, \
        ef_participant_mean
    from repro_torch.core.fedback import ADMM_FAMILY

    mode, block = cfg.consensus_compress, cfg.compress_block
    mesh = cpu_placement.get("mesh")
    admm = cfg.algorithm in ADMM_FAMILY
    ef = dict(mode=mode, block=block, mesh=mesh)
    omega0, comm0 = torch.from_numpy(before.omega), _ef_cut(before.comm, mesh)
    sent = m_after.committed.cpu().numpy() if not admm else np.ones(
        before.comm.shape[0], bool)
    committed = None if admm else _ef_cut(sent, mesh)
    if admm:
        w, e = ef_consensus(_ef_cut(got.z_prev, mesh), omega0, comm0, **ef)
    else:
        w, e = ef_participant_mean(
            _ef_cut(got.z_prev, mesh), committed, omega0, comm0,
            torch.tensor(int(sent.sum()), dtype=torch.int32), **ef)
    e = torch.cat(e) if mesh is not None else e
    if w.numpy().tobytes() != got.omega.tobytes() or \
            e.numpy().tobytes() != got.comm.tobytes():
        raise AssertionError(f"{label}: the card's compressed consensus is "
                             "not the CPU's on the card's z_prev, bit for "
                             "bit")
    codes = [ef_codes(_ef_cut(z, mesh), omega0, comm0, committed, **ef)
             for z in (got.z_prev, want.z_prev)]
    n_shards = len(codes[0]["codes1"])
    rows = before.comm.shape[0] // n_shards
    flips1 = np.concatenate([(a != b).numpy() for a, b in zip(
        codes[0]["codes1"], codes[1]["codes1"], strict=True)]) & sent[:, None]
    step1 = np.concatenate([s.numpy() for s in codes[1]["step1"]])
    flips2 = np.stack([(a != b).numpy() for a, b in zip(
        codes[0]["codes2"], codes[1]["codes2"], strict=True)])
    step2 = np.stack([s.numpy() for s in codes[1]["step2"]])
    m = np.maximum(sent.reshape(n_shards, rows).sum(axis=1), 1)
    dz = np.abs(got.z_prev.astype(np.float64) - want.z_prev) * sent[:, None]
    blk = block if mode == "int8" else 1
    moved = dz + _blockmax(dz, blk) + np.where(flips1, step1, 0.0)
    # each shard's partial moves by its rows' sent values, and its wire
    # error by that, the shared scale's share of it, and a step where
    # its code flipped; the share is 1/m of it
    part = moved.reshape(n_shards, rows, -1).sum(axis=1)
    wire = np.where(flips2, step2, 0.0) + part + _blockmax(part, blk)
    bound_e = moved + np.repeat(wire / m[:, None], rows, axis=0) + 1e-6
    gap_e = np.abs(got.comm.astype(np.float64) - want.comm)
    if (gap_e[~sent] != 0).any() or not np.array_equal(
            want.comm[~sent], before.comm[~sent]):
        raise AssertionError(f"{label}: a row that sent nothing changed "
                             "its residual")
    denom = before.comm.shape[0] if admm else max(int(sent.sum()), 1)
    bound_w = (1e-4 * np.abs(want.omega) + 1e-6
               + wire.sum(axis=0) / denom)
    gap_w = np.abs(got.omega.astype(np.float64) - want.omega)
    keep = np.ones(flips1.shape[0], bool)
    keep[list(kinks)] = False
    # a partial's block moved by a ReLU-flip row (its values or its
    # shared scale): the level-2 flips there are that row's
    quiet = _blockmax(dz[~keep].sum(axis=0)[None], blk)[0] == 0
    n_flips2 = int((flips2 & quiet).sum())
    n_flips = int(flips1[keep].sum()) + n_flips2
    dim = before.omega.shape[0]
    # Flips to expect from the measured z gap (a partial moves by at most
    # its rows' bound).
    expected = float(
        np.minimum(dz[keep] / np.maximum(step1[keep], 1e-30), 1.0).sum()
        + np.minimum(part / np.maximum(step2, 1e-30), 1.0)[
            np.broadcast_to(quiet, part.shape)].sum())
    limit = EF_FLIP_FRAC * dim + 2 * expected
    if n_flips > limit:
        raise AssertionError(f"{label}: {n_flips} sent codes differ from "
                             f"the CPU's, more than {limit:.1f} ({EF_FLIP_FRAC}"
                             f" of D plus twice the {expected:.1f} the z gap "
                             "predicts)")
    if (gap_e > bound_e).any() or (gap_w > bound_w).any():
        raise AssertionError(
            f"{label}: compressed ω or residual off the CPU's beyond the "
            f"bound (residual {float((gap_e - bound_e).max()):.3e}, ω "
            f"{float((gap_w - bound_w).max()):.3e} over)")
    return (f"{mode} consensus the CPU's on the card's z bit for bit; "
            f"{int(flips1[keep].sum())} level-1 and {n_flips2} level-2 codes "
            f"flipped (the z gap predicts {expected:.1f}; limit "
            f"{limit:.1f})"
            + (f", {int(flips1[~keep].sum())} level-1 and "
               f"{int(flips2.sum()) - n_flips2} level-2 more where the "
               "ReLU-flip rows moved" if kinks else "")
            + f"; residual gap {float(gap_e.max()):.3e}, ω gap "
            f"{float(gap_w.max()):.3e} within the bound")


def drive(form, n_rounds, warmup, ctx, ops, expect, against=None, **check):
    """Run ``warmup`` + ``n_rounds`` rounds of one of the ``FORMS`` (or
    ``RAGGED_FORMS``, on ``ctx["data"]`` pooled as ``ctx["ragged"]``
    says) of ``ctx["cfgs"]`` (``configs.paper_mnist`` or
    ``paper_cifar``), on the
    flat or the tree layout and on one device or a client mesh of its
    shards on the card, as the form says, with the launch counts set
    to 0 just before; ``check`` goes to :func:`compare_with_cpu`, which
    holds a sharded form against the same sharded round on CPU shards.
    With ``against`` (a one-device form of the same configuration), the
    form's second round is also held against that form's round on the
    card from the same state (put together from the shards, flattened
    where the layouts differ): events equal, ω at rtol 1e-5 / atol
    1e-7.  Returns (timing, counts)."""
    from repro_torch.convert import flat_state, state_from_numpy, \
        state_to_numpy
    from repro_torch.core import make_eval_fn
    from repro_torch.models import make_loss_and_acc_fn, make_loss_fn

    dev, cfgs = ctx["dev"], ctx["cfgs"]
    f = {**cfgs.FORMS, **cfgs.RAGGED_FORMS}[form]
    cfg = cfgs.form_config(form)
    spec = f.spec(ctx["spec"])
    loss_fn = make_loss_fn(ctx["logits"])
    placement = f.placement(dev)
    # A ragged form's data is a pool with its spec (``ctx["ragged"]``).
    pooled = {"ragged": ctx["ragged"]} if ctx.get("ragged") else {}
    state = f.init(cfg, ctx["params0"], spec=spec, **placement)
    round_fn = f.make_round(cfg, loss_fn, ctx["data"], spec=spec,
                            **placement, **pooled)

    def copy(s, **where):  # the fused round updates its input in place
        return state_from_numpy(state_to_numpy(s), **(where or placement))

    def omega_vec(s):  # ω of a state or a shard list, flat
        w = (s if hasattr(s, "omega") else s[0]).omega
        return w if isinstance(w, torch.Tensor) else ctx["spec"].flatten(w)

    # Reference: the second round from init_state (in the first, every
    # client sits at distance 0 from ω) on the card and on the CPU's
    # plain path, from copies, before the counted run.
    before, _ = round_fn(copy(state))
    after, m = round_fn(copy(before))
    if "update_tol" in check:
        # The CNN's forms: cuDNN's algorithms are deterministic
        # (``device.fp32_products``), so the round repeats bit for bit.
        again, _ = round_fn(copy(before))
        if not _state_bytes_equal(again, after):
            raise AssertionError(f"form {form}: round 2 from one state "
                                 "differs between two calls on the card")
        del again
        log(f"form {form}: round 2 from one state repeats bit for bit on "
            "the card")
    cpu_round = f.make_round(cfg, loss_fn, {
        k: v.cpu() for k, v in ctx["data"].items()}, spec=spec,
        **f.placement("cpu"), **pooled)
    if check.get("kink_rows"):
        check = dict(check, kink_cause=relu_flip_cause(ctx, cfg))
    if check.get("horizon"):
        check = dict(check, horizon=solve_horizon(ctx, cfg, check["horizon"]))
    compare_with_cpu(cpu_round, before, after, m, f"form {form}",
                     cpu_placement=f.placement("cpu"), cfg=cfg, **check)
    if against is not None:
        other = cfgs.FORMS[against]
        other_spec = other.spec(ctx["spec"])
        other_round = other.make_round(cfgs.form_config(against), loss_fn,
                                       ctx["data"], spec=other_spec,
                                       device=dev)
        single = copy(before, device=dev)
        if other.layout != f.layout:
            single = flat_state(single, ctx["spec"])
        other_after, fm = other_round(single)
        if not torch.equal(fm.events, m.events):
            raise AssertionError(f"form {form}: events differ from form "
                                 f"{against}'s from the same state")
        got, want = omega_vec(after), omega_vec(other_after)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
        log(f"form {form}: round {int(state_to_numpy(before).round) + 1} "
            f"agrees with form {against}'s from the same state "
            f"(events equal, ω max_abs_err "
            f"{float((got - want).abs().max()):.3e}, rtol 1e-5 / atol "
            "1e-7 held)")
        del other_after, fm, single
    del before, after, m
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    state, history, ms_round = timed_rounds(form, round_fn, state, warmup,
                                            n_rounds)
    counts = path_counts(ops)
    if ops.trigger_sq_norms_pytree.leaf_copies:
        raise AssertionError(f"form {form}: the trigger copied "
                             f"{ops.trigger_sq_norms_pytree.leaf_copies} "
                             "state leaves to read them")
    total = warmup + n_rounds
    for name, per_round in expect.items():
        if counts[name] != per_round * total:
            raise AssertionError(f"form {form}: {name} launched "
                                 f"{counts[name]} times in {total} rounds, "
                                 f"expected {per_round * total}")
    omega = omega_vec(state)
    if omega.shape != (ctx["spec"].dim,) or not bool(
            torch.isfinite(omega).all()):
        raise AssertionError(f"form {form}: ω is not a finite "
                             f"({ctx['spec'].dim},) vector")
    eval_fn = make_eval_fn(make_loss_and_acc_fn(ctx["logits"]), spec=spec,
                           device=dev)
    loss, acc = eval_fn(state, ctx["test"]["x"], ctx["test"]["y"])
    loss, acc = float(loss), float(acc)
    if not (math.isfinite(loss) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"form {form}: eval gave loss {loss}, "
                             f"acc {acc}")
    events = [int(m.num_events) for m in history]
    deferred = [int(m.num_deferred) for m in history]
    log(f"form {form}: {ms_round:.3f} ms/round over {n_rounds} rounds "
        f"(after {warmup} warm-up) on {ctx['smi']}; events/round {events}; "
        f"num_deferred {deferred}; test loss {loss:.4f} acc {acc:.4f}; "
        f"launches {counts}")
    return dict(ms_per_round=ms_round, events=events, deferred=deferred,
                acc=acc, loss=loss), counts


def timed_rounds(form, round_fn, state, warmup, n_rounds):
    """``warmup`` rounds, then ``n_rounds`` timed by the host clock to a
    synchronize, all under CUDA's sync debug mode: the round must never
    make the host wait for the card (a read-back, a pageable host→device
    copy), and any such warning fails the phase.  Returns (state, the
    timed rounds' metrics, ms per round)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for _ in range(warmup):
            state, _ = round_fn(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = []
        for _ in range(n_rounds):
            state, m = round_fn(state)
            history.append(m)
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ms_round = (time.perf_counter() - t0) / n_rounds * 1e3
    # (The mode's one-time notice that it is a prototype is not a sync.)
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()
             and "prototype" not in str(w.message)]
    if syncs:
        raise AssertionError(f"form {form}: {len(syncs)} host syncs inside "
                             f"the rounds, e.g. {syncs[:3]}")
    return state, history, ms_round


# Phase 5b: the baseline forms C1–C6 of ``configs.paper_mnist.FORMS``
# as (form, launches per round, ``compare_with_cpu`` options); C7,
# SCAFFOLD, launches none and has its own driver.
AVG_OMEGA_TOL = (1e-6, 1e-7)
EXACT = {"exact_events": True}
AVG = {"exact_events": True, "omega_tol": AVG_OMEGA_TOL}
BASELINE_FORMS = (
    ("C1", {"trigger_sq_norms": 1, "fused_gss": 1, "admm_update": 0}, EXACT),
    ("C2", {"trigger_sq_norms": 1, "admm_update": 1, "fused_gss": 0}, EXACT),
    ("C3", {"trigger_sq_norms": 1, "admm_update": 0, "fused_gss": 0}, AVG),
    ("C4", {"trigger_sq_norms": 1, "admm_update": 0, "fused_gss": 0}, AVG),
    ("C5", {"trigger_sq_norms": 1, "admm_update": 1, "fused_gss": 0}, EXACT),
    ("C6", {"trigger_sq_norms": 1, "admm_update": 1, "fused_gss": 0}, EXACT),
)
# Phases 5c and 5d: the tree forms (TB's second round also against form
# B's) and the CIFAR forms.  The CNN's states are held by the norm of
# their difference from the CPU's relative to the round's update
# (``compare_with_cpu``): ReLU and max-pool flips moved it by up to
# 8.8e-3 over 4 rounds of CF-A and CF-T with cuDNN on or off on an H100
# (``launch/conv_precision.py --rounds 4``); a fault moves it by ~1.
CNN_UPDATE_TOL = 1e-2
TREE = {"trigger_sq_norms_pytree": 1, "trigger_sq_norms": 0,
        "admm_update": 0, "fused_gss": 0}
TREE_FORMS = (("TA", TREE, {}), ("TB", TREE, {"against": "B"}))
CIFAR_FORMS = (
    ("CF-A", {"trigger_sq_norms_pytree": 0, "trigger_sq_norms": 1,
              "admm_update": 0, "fused_gss": 1},
     {"update_tol": CNN_UPDATE_TOL}),
    ("CF-T", TREE, {"update_tol": CNN_UPDATE_TOL}),
)
# Phase 5e: the client-sharded forms, P shards of N = 100 on the card.
# Per round: K1b once for the card's shards in the flat forms, K1c once
# for them in ST (the tree layout), K3 once per shard in the compact
# forms, K2b once per shard in the dense flat one; no unsharded K1 or
# K2.  SB's and ST's second rounds are also held against
# forms B and TB from the same state (per-shard capacity can defer
# other clients in SA and SR, so those are held to the CPU alone).
NO_SINGLE = {"trigger_sq_norms": 0, "admm_update": 0}
SHARDED_FORMS = (
    ("SA", dict(NO_SINGLE, trigger_sq_norms_sharded=1, fused_gss=2,
                admm_update_sharded=0), {}),
    ("SB", dict(NO_SINGLE, trigger_sq_norms_sharded=1, fused_gss=0,
                admm_update_sharded=2), {"against": "B"}),
    ("ST", dict(NO_SINGLE, trigger_sq_norms_pytree=1,
                trigger_sq_norms_sharded=0, fused_gss=0,
                admm_update_sharded=0), {"against": "TB"}),
    ("SR", dict(NO_SINGLE, trigger_sq_norms_sharded=1, fused_gss=4,
                admm_update_sharded=0), EXACT),
)


def drive_forms(ctx, ops, table):
    """Drive each (form, launches per round, check options) of ``table``
    over 1 warm-up and 3 timed rounds (:func:`drive`); returns (a report
    per form, the launch counts summed over the table)."""
    reports, total = {}, {}
    for form, expect, check in table:
        report, counts = drive(form, 3, 1, ctx, ops, expect, **check)
        reports[form] = dict(report, what=ctx["cfgs"].FORMS[form].what)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return reports, total


def drive_scaffold(ctx, ops, n_rounds, warmup):
    """Form C7: SCAFFOLD at the paper width, its second round held
    against the CPU's plain path; it launches no kernel."""
    from repro_torch.configs import paper_mnist
    from repro_torch.convert import scaffold_state_to_numpy
    from repro_torch.core import ScaffoldState
    from repro_torch.models import make_loss_fn

    dev, spec, f = ctx["dev"], ctx["spec"], paper_mnist.FORMS["C7"]
    cfg = paper_mnist.form_config("C7")
    state = f.init(cfg, ctx["params0"], spec=spec, device=dev)
    round_fn = f.make_round(cfg, make_loss_fn(), ctx["data"], spec=spec,
                            device=dev)
    cpu_round = f.make_round(cfg, make_loss_fn(), {
        k: v.cpu() for k, v in ctx["data"].items()}, spec=spec,
        device="cpu")
    before, _ = round_fn(state)
    after, m = round_fn(before)
    want, wm = cpu_round(ScaffoldState(*(t.cpu() for t in before)))
    np.testing.assert_array_equal(m["events"].cpu().numpy(),
                                  wm["events"].numpy(), err_msg="form C7")
    got, want = scaffold_state_to_numpy(after), scaffold_state_to_numpy(want)
    for f in ("c_server", "c_clients", "omega"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-4, atol=1e-6, err_msg=f"C7 {f}")
    log(f"form C7: round 2 ({int(m['num_events'])} clients) agrees with "
        "the CPU plain path (events equal, c, c_i and ω at rtol 1e-4)")
    del before, after, m, want, wm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    state, history, ms_round = timed_rounds("C7", round_fn, state, warmup,
                                            n_rounds)
    counts = path_counts(ops)
    if any(counts.values()):
        raise AssertionError(f"form C7 launched {counts}; SCAFFOLD runs no "
                             "kernel")
    if not bool(torch.isfinite(state.omega).all()):
        raise AssertionError("form C7: ω is not finite")
    loss, acc = (float(v) for v in ctx["eval_fn"](
        state, ctx["test"]["x"], ctx["test"]["y"]))
    if not (math.isfinite(loss) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"form C7: eval gave loss {loss}, acc {acc}")
    events = [int(m["num_events"]) for m in history]
    log(f"form C7: {ms_round:.3f} ms/round over {n_rounds} rounds (after "
        f"{warmup} warm-up) on {ctx['smi']}; events/round {events}; test "
        f"loss {loss:.4f} acc {acc:.4f}; launches {counts}")
    return dict(ms_per_round=ms_round, events=events, acc=acc, loss=loss)


# Phase 5f: the serve forms of ``configs.paper_mnist.SERVE_FORMS`` — the
# stale-tolerant round (max_staleness 2) over an arrival trace — with
# their launches per tick.  The card-against-CPU check takes ticks 1 and
# 2, the second tick of the bursty trace's first burst (ticks 0 and 1)
# and the one after it: clients parked at ticks 0 and 1 land there,
# others are still in flight, and the compact forms' queue holds the
# burst; tick 1 brings fresh events too.
SERVE_CHECK_TICKS = (1, 2)
# The solve sums in another order on the card, so a state element that
# cancels to near 0 is off by the rounding of its summands, not of
# itself: one θ element of 6.4e-5 in SVA's tick 1 differed by 1.05e-6
# (an H100 against the CPU), past rtol 1e-4 / atol 1e-6.  The check
# takes SERVE_RTOL of the larger of the element and its field's largest
# magnitude.  The staleness commit gives the CPU's bits on the same
# rows (``check_staleness_commit_bits``), so the gap is the solve's:
# SVA's tick 1 reads 3.03e-6 of z_prev's largest magnitude (1.049e-6)
# in every H100 run so far, the other checked ticks ≤ 2.7e-7, so 1e-5
# (it was 1e-4) keeps a 3.3× margin.
SERVE_RTOL = 1e-5
SERVE_FORMS = (
    ("SVA", {"trigger_sq_norms": 1, "fused_gss": 1, "admm_update": 0}),
    ("SVB", {"trigger_sq_norms": 1, "admm_update": 1, "fused_gss": 0}),
    ("SVS", dict(NO_SINGLE, trigger_sq_norms_sharded=1, fused_gss=2,
                 admm_update_sharded=0)),
)


def compare_serve_tick(label, after, m, rm, ref, compact):
    """The card's serve tick against the CPU's plain path from the same
    state: events, ``committed``, the deferred, in-flight and landed
    counts, the countdowns, the event ring and the queue equal (each
    count non-zero, so the tick exercises the pipeline and the queue);
    θ/λ/z_prev, ω and the parked payloads within ``SERVE_RTOL`` of the
    larger of each element and its field's largest magnitude."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.utils.pytree import tree_leaves

    for f in ("events", "committed"):
        np.testing.assert_array_equal(getattr(m, f).cpu().numpy(),
                                      getattr(rm, f).numpy(),
                                      err_msg=f"{label} {f}")
    counts = {f: int(getattr(m, f)) for f in ("num_deferred",
                                                "num_inflight",
                                                "num_landed")}
    for f, v in counts.items():
        if v != int(getattr(rm, f)):
            raise AssertionError(f"{label}: {f} {v} on the card, "
                                 f"{int(getattr(rm, f))} on the CPU")
    if not (counts["num_inflight"] and counts["num_landed"]
            and (counts["num_deferred"] or not compact)):
        raise AssertionError(f"{label} does not exercise the pipeline "
                             f"and queue: {counts}")
    got, want = state_to_numpy(after), state_to_numpy(ref)
    for f in ("ttl", "hist", "delay"):
        np.testing.assert_array_equal(getattr(got.inflight, f),
                                      getattr(want.inflight, f),
                                      err_msg=f"{label} {f}")
    np.testing.assert_array_equal(got.queue.age, want.queue.age)
    fields = [(f, getattr(got, f), getattr(want, f))
              for f in ("theta", "lam", "z_prev", "omega")]
    fields += [(f"parked {f}", getattr(got.inflight, f),
                getattr(want.inflight, f)) for f in ("theta", "lam", "z")]
    worst = (0.0, "", 0.0)  # largest |card − CPU| / the field's largest
    #                         magnitude, its field, the gap itself
    for f, g, w in fields:
        for a, b in zip(tree_leaves(g), tree_leaves(w), strict=True):
            gap = float(np.abs(a - b).max())
            worst = max(worst, (gap / max(float(np.abs(b).max()), 1e-30),
                                f, gap))
            np.testing.assert_allclose(
                a, b, rtol=SERVE_RTOL,
                atol=SERVE_RTOL * float(np.abs(b).max()),
                err_msg=f"{label} {f}")
    log(f"{label} ({int(m.num_events)} events, "
        f"{int(m.committed.sum())} committed, {counts}) agrees with the "
        "CPU plain path (events, committed, counts, ttl, ring and queue "
        f"equal; state and parked payloads within SERVE_RTOL, worst "
        f"{worst[0]:.2e} of a field's largest magnitude, in {worst[1]} "
        f"({worst[2]:.3e}); ω max_abs_err "
        f"{_max_abs_diff(got.omega, want.omega):.3e})")


def sync_guarded(round_fn):
    """The serve step under CUDA's sync debug mode ("warn"), switched on
    for the step only: the serve loop's own read-back per tick stays
    outside it."""
    def step(state, arrivals):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return round_fn(state, arrivals)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return step


def drive_serve(form, expect, ctx, ops):
    """One serve form at the paper-MNIST width: ticks 1 and 2 held
    against the CPU's plain path (:func:`compare_serve_tick`),
    then 1 warm-up tick on a deep copy and the trace's ticks through
    ``core.schedule.serve`` with the launch counts set to 0 just before,
    no host sync inside a step, ``expect`` launches per tick, balanced
    books and a finite ω.  Returns (report, counts)."""
    from repro_torch.configs import paper_mnist
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core.schedule import clone_state, make_trace, serve
    from repro_torch.models import make_loss_fn

    dev = ctx["dev"]
    f, cfg = paper_mnist.SERVE_FORMS[form], paper_mnist.form_config(form)
    spec, loss_fn = ctx["spec"], make_loss_fn(ctx["logits"])
    state = f.init(cfg, ctx["params0"], spec=spec, **f.placement(dev))
    round_fn = f.make_round(cfg, loss_fn, ctx["data"], spec=spec,
                            arrivals_arg=True, **f.placement(dev))
    trace = make_trace(f.trace)
    rows = torch.from_numpy(trace).to(dev)

    cpu_round = f.make_round(cfg, loss_fn, {
        k: v.cpu() for k, v in ctx["data"].items()}, spec=spec,
        arrivals_arg=True, **f.placement("cpu"))
    s, events = clone_state(state), 0
    for t in range(max(SERVE_CHECK_TICKS) + 1):
        if t not in SERVE_CHECK_TICKS:
            s, _ = round_fn(s, rows[t])
            continue
        before = state_to_numpy(clone_state(s))  # the step writes s
        s, m = round_fn(s, rows[t])
        ref, rm = cpu_round(state_from_numpy(before, **f.placement("cpu")),
                            torch.from_numpy(trace[t]))
        compare_serve_tick(f"form {form}: tick {t}", s, m, rm, ref,
                           cfg.compact)
        events += int(m.num_events)
    if not events:
        raise AssertionError(f"form {form}: no event in the checked ticks")
    del s, before, m, ref, rm
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, report = serve(sync_guarded(round_fn), state, trace,
                              warmup=True)
    counts = path_counts(ops)
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()
             and "prototype" not in str(w.message)]
    if syncs:
        raise AssertionError(f"form {form}: {len(syncs)} host syncs inside "
                             f"the serve steps, e.g. {syncs[:3]}")
    ticks = trace.shape[0] + 1  # the warm-up tick launches too
    for name, per_tick in expect.items():
        if counts[name] != per_tick * ticks:
            raise AssertionError(f"form {form}: {name} launched "
                                 f"{counts[name]} times in {ticks} ticks, "
                                 f"expected {per_tick * ticks}")
    if not report.conservation_ok:
        raise AssertionError(f"form {form}: the serve books do not "
                             f"balance: {report.summary()}")
    omega = (state if hasattr(state, "omega") else state[0]).omega
    if omega.shape != (spec.dim,) or not bool(torch.isfinite(omega).all()):
        raise AssertionError(f"form {form}: ω is not a finite "
                             f"({spec.dim},) vector")
    summary = report.summary()
    ms_tick = report.wall_s / report.ticks * 1e3
    out = dict(what=f.what, ms_per_tick=ms_tick,
               p50_latency_ticks=summary["p50_latency_ticks"],
               p99_latency_ticks=summary["p99_latency_ticks"],
               p50_latency_us=summary["p50_latency_us"],
               p99_latency_us=summary["p99_latency_us"],
               commits_per_sec=summary["commits_per_sec"],
               arrivals=report.arrivals_total,
               admitted=report.admitted_total,
               commits=report.commits_total, pending=report.pending_final)
    log(f"form {form}: {ms_tick:.3f} ms/tick over {report.ticks} ticks "
        f"(after 1 warm-up) on {ctx['smi']}; latency p50 / p99 "
        f"{summary['p50_latency_ticks']:.1f} / "
        f"{summary['p99_latency_ticks']:.1f} ticks, "
        f"{summary['p50_latency_us']:.1f} / {summary['p99_latency_us']:.1f}"
        f" µs; {summary['commits_per_sec']:.1f} commits/s; arrivals "
        f"{report.arrivals_total}, admitted {report.admitted_total}, "
        f"committed {report.commits_total}, pending {report.pending_final} "
        f"(conservation ok); launches {counts}")
    return out, counts


def check_serve_sync_anchor(ctx):
    """One all-ones tick of SVA's configuration at ``max_staleness=0``
    against form A's round from the same state (its second, after one
    round from ``init_state``): events equal, ω bit-equal."""
    from repro_torch.configs import paper_mnist
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core import init_state, make_round_fn
    from repro_torch.models import make_loss_fn

    dev, spec = ctx["dev"], ctx["spec"]
    loss_fn = make_loss_fn(ctx["logits"])
    cfg_a = paper_mnist.form_config("A")
    cfg_0 = dataclasses.replace(paper_mnist.form_config("SVA"),
                                max_staleness=0)
    round_a = make_round_fn(cfg_a, loss_fn, ctx["data"], spec=spec,
                            device=dev)
    step_0 = make_round_fn(cfg_0, loss_fn, ctx["data"], spec=spec,
                           device=dev, arrivals_arg=True)
    first, _ = round_a(init_state(cfg_a, ctx["params0"], spec=spec,
                                  device=dev))
    snapshot = state_to_numpy(first)
    after_a, ma = round_a(state_from_numpy(snapshot, device=dev))
    pipeline = init_state(cfg_0, ctx["params0"], spec=spec,
                          device=dev).inflight
    after_0, m0 = step_0(state_from_numpy(snapshot, device=dev)._replace(
        inflight=pipeline), torch.ones(cfg_0.n_clients, dtype=torch.bool,
                                       device=dev))
    if not torch.equal(ma.events, m0.events):
        raise AssertionError("SVA at max_staleness 0: events differ from "
                             "form A's from the same state")
    if not torch.equal(after_a.omega.view(torch.int32),
                       after_0.omega.view(torch.int32)):
        raise AssertionError("SVA at max_staleness 0: ω is not form A's "
                             "bit for bit")
    log(f"SVA at max_staleness 0, one all-ones tick: round "
        f"{int(snapshot.round) + 1} of form A from the same state "
        f"({int(ma.num_events)} events equal, ω bit-equal)")


def check_staleness_commit_bits(ctx):
    """ROADMAP W1: the staleness commit is selects only, so the card's
    and the CPU's give the same bits on the same inputs.  Full-width
    stand-ins for the solved rows (seeded), the pipeline's masks from the
    round-robin delays (0, 1, 2) and a random countdown: the six-select
    commit (``engine.staleness_commit``) and the fused commit's slot-wise
    one (``engine.staleness_commit_slots``, C = 16 slots, 14 valid), each
    run on the card and the CPU, must agree bit for bit."""
    from repro_torch.core.engine import staleness_commit, \
        staleness_commit_slots, staleness_masks

    n, d, c = 100, ctx["spec"].dim, 16
    rng = np.random.default_rng(SEED)

    def rows(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    current, proposed, parked, old = rows(n, d), rows(n, d), rows(n, d), \
        rows(c, d)
    delay = torch.arange(n, dtype=torch.int32) % 3
    ttl = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    ttl = torch.where(delay > 0, torch.minimum(ttl, delay), 0)
    idx = torch.from_numpy(rng.choice(n, c, replace=False).astype(np.int32))
    valid = torch.arange(c) < 14
    serviced = torch.zeros(n, dtype=torch.bool)
    serviced[idx[valid].long()] = True
    serviced &= ttl == 0

    def run(dev):
        t = [x.to(dev) for x in (current, proposed, parked, old, delay, ttl,
                                 idx, valid, serviced)]
        cur, prop, park, old_rows, dl, tt, ix, vl, sv = t
        land, direct, defer, _ = staleness_masks(sv, dl, tt)
        full = staleness_commit(cur, prop, park, land, direct, defer)
        live, slots = prop.clone(), park.clone()
        slot = staleness_commit_slots(live, slots, old_rows, ix, vl, land,
                                      defer)
        return [x.cpu() for x in (*full, *slot)], int(land.sum()), \
            int(defer.sum())

    card, landing, deferring = run(ctx["dev"])
    cpu, _, _ = run(torch.device("cpu"))
    for a, b in zip(card, cpu, strict=True):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError("the staleness commit differs between the "
                                 "card and the CPU on the same rows")
    log(f"staleness commit at (100, {d}): the six-select and the slot-wise "
        f"commit bit-equal on the card and the CPU ({landing} rows landing, "
        f"{deferring} parking, {int(serviced.sum())} serviced)")


# Phase 5g: the compressed forms of ``configs.paper_mnist.FORMS`` — A, B,
# C3 and SA with the consensus sent as int8 or bf16 — with their launches
# per round (the aggregation launches none of the kernels).
# Their second rounds are held as form A's, except that in QB and QS,
# where one client row took another ReLU branch on the card than on the
# CPU (row 89 of QB, row 59 of QS, the same rows in every run on an
# H100), one row may, with its cause shown
# (``compare_with_cpu``'s ``kink_rows``, :func:`relu_flip_cause`).
KINK = {"kink_rows": 1}
COMPRESSED_FORMS = (
    ("QA", {"trigger_sq_norms": 1, "fused_gss": 1, "admm_update": 0}, {}),
    ("QB", {"trigger_sq_norms": 1, "admm_update": 1, "fused_gss": 0}, KINK),
    ("QC", {"trigger_sq_norms": 1, "admm_update": 0, "fused_gss": 0},
     EXACT),
    ("QS", dict(NO_SINGLE, trigger_sq_norms_sharded=1, fused_gss=2,
                admm_update_sharded=0), KINK),
)
EF_BLOCK = 256


def check_ef_aggregation(ctx):
    """The EF aggregation at full width, card against CPU: seeded z, ω
    and residuals at (100, D), block 256, ``ef_consensus`` and
    ``ef_participant_mean`` (40 senders), int8 and bf16, on one device
    and on 2 client shards — ω and the residual bit-equal.  Then its
    device time on the card (a CUDA graph of calls), its launches
    (torch.profiler), its byte bound (z and e read, e written, ω read and
    written: (3·N·D + 2·D)·4 bytes over the card's rate) and, beside it,
    the windowed column sum alone and ``torch.sum(dim=0)``.  Returns the
    timings."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compact import sum_in_xla_cpu_order
    from repro_torch.core.compress import ef_consensus, ef_participant_mean
    from repro_torch.launch.time_kernels import device_ms, peak_bandwidth
    from repro_torch.sharding import make_client_mesh, shard_rows
    from repro_torch.utils.spans import is_span

    dev, d = ctx["dev"], ctx["spec"].dim
    n = 100
    rng = np.random.default_rng(SEED)
    host = {"z": rng.standard_normal((n, d)).astype(np.float32) * 0.05,
            "omega": rng.standard_normal(d).astype(np.float32) * 0.05,
            "resid": rng.standard_normal((n, d)).astype(np.float32) * 1e-3,
            "mask": rng.permutation(n) < 40}

    def call(where, shards, mode, masked):
        t = {k: torch.from_numpy(v).to(where) for k, v in host.items()}
        mesh = make_client_mesh(shards, [where]) if shards > 1 else None
        z, e, m = ((list(shard_rows(t[k], mesh)) if mesh else t[k])
                   for k in ("z", "resid", "mask"))
        ef = dict(mode=mode, block=EF_BLOCK, mesh=mesh)
        if masked:
            cnt = torch.tensor(int(host["mask"].sum()), dtype=torch.int32,
                               device=where)
            return lambda: ef_participant_mean(z, m, t["omega"], e, cnt,
                                               **ef)
        return lambda: ef_consensus(z, t["omega"], e, **ef)

    def flat(out):
        w, e = out
        return w.cpu(), (torch.cat(e) if isinstance(e, list) else e).cpu()

    checked = 0
    for shards in (1, 2):
        for mode in ("int8", "bf16"):
            for masked in (False, True):
                got = flat(call(dev, shards, mode, masked)())
                want = flat(call("cpu", shards, mode, masked)())
                for a, b in zip(got, want, strict=True):
                    if not torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)):
                        raise AssertionError(
                            f"EF aggregation ({mode}, P={shards}, "
                            f"{'participant' if masked else 'consensus'}) "
                            "differs between the card and the CPU")
                checked += 1
    bw = peak_bandwidth(torch.cuda.get_device_name(0))
    bound = (3 * n * d + 2 * d) * 4 / bw * 1e3 if bw else None
    report = {}
    for mode in ("int8", "bf16"):
        fn = call(dev, 1, mode, False)
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_time_total > 0 and not is_span(e.key))
        report[mode] = {"ms": device_ms(fn, calls=5), "launches": launches}
    x = torch.from_numpy(host["z"]).to(dev)
    report["column_sum_ms"] = device_ms(lambda: sum_in_xla_cpu_order(x),
                                        calls=5)
    report["torch_sum_ms"] = device_ms(lambda: torch.sum(x, dim=0), calls=5)
    report["bound_ms"] = bound
    log(f"EF aggregation at (100, {d}), block {EF_BLOCK}: card bit-equal to "
        f"the CPU in {checked} cases (int8/bf16, consensus/participant, 1 "
        f"and 2 shards); ef_consensus int8 {report['int8']['ms']:.4f} ms "
        f"({report['int8']['launches']} launches), bf16 "
        f"{report['bf16']['ms']:.4f} ms ({report['bf16']['launches']} "
        f"launches), bound {bound if bound is None else f'{bound:.4f}'} ms "
        f"(bytes); the windowed column sum alone "
        f"{report['column_sum_ms']:.4f} ms, torch.sum(dim=0) "
        f"{report['torch_sum_ms']:.4f} ms, on {ctx['smi']}")
    return report


def _state_bytes_equal(a, b) -> bool:
    from repro_torch.convert import state_to_numpy
    from repro_torch.utils.pytree import tree_leaves

    def leaves(s):
        s = state_to_numpy(s)
        out = []
        for f in s._fields:
            v = getattr(s, f)
            if v is None:
                continue
            out += [x for part in (v if isinstance(v, tuple) else (v,))
                    for x in tree_leaves(part) if x is not None]
        return out
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.tobytes() == y.tobytes()
        for x, y in zip(la, lb, strict=True))


def check_checkpoints(ctx, ops):
    """Checkpoints on the card: QA for 3 rounds, ``save_checkpoint``,
    ``load_checkpoint`` into a fresh ``init_state`` template on the card,
    round 4 bit-equal to the uninterrupted round 4; the same for QS under
    its 2-shard ``mesh=``; the card's QA file loaded on the CPU's plain
    path, whose round 4 agrees with the card's as form A's rounds do
    (:func:`compare_with_cpu`).  Prints the file's size and the save and
    load wall times.  Each file is removed once its checks pass."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import paper_mnist
    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core.schedule import clone_state
    from repro_torch.models import make_loss_fn

    directory = ROOT / "build" / "chip_smoke_checkpoints"
    spec, loss_fn = ctx["spec"], make_loss_fn(ctx["logits"])
    out = {}
    for form in ("QA", "QS"):
        f, cfg = paper_mnist.FORMS[form], paper_mnist.form_config(form)
        where = f.placement(ctx["dev"])
        round_fn = f.make_round(cfg, loss_fn, ctx["data"], spec=spec,
                                **where)
        state = f.init(cfg, ctx["params0"], spec=spec, **where)
        for _ in range(3):
            state, _ = round_fn(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(str(directory), 3, state, prefix=form)
        t_save = time.perf_counter() - t0
        # the fused round writes its input in place
        snapshot = state_to_numpy(clone_state(state))
        uninterrupted, m_a = round_fn(state)
        template = f.init(cfg, ctx["params0"], spec=spec, **where)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = load_checkpoint(path, template)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        if not _state_bytes_equal(resumed, state_from_numpy(snapshot,
                                                            **where)):
            raise AssertionError(f"form {form}: the loaded state is not the "
                                 "saved one bit for bit")
        after, m_b = round_fn(resumed)
        if not (torch.equal(m_a.events, m_b.events)
                and _state_bytes_equal(after, uninterrupted)):
            raise AssertionError(f"form {form}: round 4 from the checkpoint "
                                 "is not the uninterrupted round 4 bit for "
                                 "bit")
        size = Path(path).stat().st_size
        out[form] = {"bytes": size, "save_s": t_save, "load_s": t_load}
        log(f"form {form}: checkpoint after round 3 ({size} bytes; save "
            f"{t_save:.3f} s, load {t_load:.3f} s); round 4 from it "
            f"bit-equal to the uninterrupted round 4 "
            f"({int(m_b.num_events)} events)")
        if form == "QA":
            cpu_round = f.make_round(cfg, loss_fn, {
                k: v.cpu() for k, v in ctx["data"].items()}, spec=spec,
                device="cpu")
            cpu_state = load_checkpoint(path, f.init(
                cfg, ctx["params0"], spec=spec, device="cpu"))
            compare_with_cpu(lambda s, st=cpu_state: cpu_round(st),
                             state_from_numpy(snapshot, **where), after,
                             m_b, f"form {form}: the card's checkpoint on "
                             "the CPU", cfg=cfg)
        Path(path).unlink()
    if not any(directory.iterdir()):
        directory.rmdir()
    return out


# Phase 5d's first check: the solve's batched convolutions against
# float64.  cuDNN in fp32 read at most 6.2e-6 of the largest value on an
# H100 (Winograd in the weight gradient; a cuBLAS GEMM of the unfolded
# images 5.2e-6); TF32 rounds products to 11 bits, ~1e-3.
CONV_REL_TOL = 5e-5


# Phase 5h: the ragged forms (``RAGGED_FORMS`` of ``configs.paper_mnist``
# and ``paper_cifar``), each on its module's pooled workload, with its
# timed rounds and launches per round.  RA, RB and RS are held element
# by element, with 5g's rule for a client row that took another ReLU
# branch (at most one, its cause shown).  RC's slots run 48 SGD steps
# through the CNN's ReLUs and max-pools, over which a one-ulp change of
# the start moves the CPU's own round by far more than 1e-2 of its
# update (``nudged_spread`` prints how far): its solve is held over its
# first 4 steps by CF-A's update-norm ratio, and its round within that
# spread (``compare_with_cpu``'s ``horizon``).
RAGGED_FORMS = (
    ("RA", 5, {"trigger_sq_norms": 1, "fused_gss": 1, "admm_update": 0},
     KINK),
    ("RB", 3, {"trigger_sq_norms": 1, "admm_update": 1, "fused_gss": 0},
     KINK),
    ("RS", 3, dict(NO_SINGLE, trigger_sq_norms_sharded=1, fused_gss=2,
                   admm_update_sharded=0), KINK),
    ("RC", 3, {"trigger_sq_norms_pytree": 0, "trigger_sq_norms": 1,
               "admm_update": 0, "fused_gss": 1},
     {"update_tol": CNN_UPDATE_TOL, "horizon": 4}),
)
UNIFORM_POOL_ROUNDS = 3


def check_uniform_pool_bits(ctx):
    """Form A on the trimmed paper-MNIST data pooled uniformly
    (``pool_data`` of its 100 equal shards) against form A on the same
    data stacked, from ``init_state``, on the card: the events and ω
    bit for bit in each of 3 rounds (a uniform spec takes the plain
    solve, on each slot's block of the pool)."""
    from repro_torch.configs import paper_mnist
    from repro_torch.core import init_state, make_round_fn
    from repro_torch.models import make_loss_fn
    from repro_torch.utils.ragged import pool_data

    dev, spec = ctx["dev"], ctx["spec"]
    cfg = paper_mnist.form_config("A")
    loss_fn = make_loss_fn(ctx["logits"])
    x, y = ctx["data"]["x"].cpu(), ctx["data"]["y"].cpu()
    pooled, ragged = pool_data(list(x), list(y), device=dev)
    if not ragged.uniform or ragged.total != x.shape[0] * x.shape[1]:
        raise AssertionError(f"the stacked data pooled as {ragged.sizes}")
    rect = make_round_fn(cfg, loss_fn, ctx["data"], spec=spec, device=dev)
    pool = make_round_fn(cfg, loss_fn, pooled, spec=spec, device=dev,
                         ragged=ragged)
    a = init_state(cfg, ctx["params0"], spec=spec, device=dev)
    b = init_state(cfg, ctx["params0"], spec=spec, device=dev)
    events = []
    for r in range(UNIFORM_POOL_ROUNDS):
        a, ma = rect(a)
        b, mb = pool(b)
        if not torch.equal(ma.events, mb.events) or not torch.equal(
                a.omega.view(torch.int32), b.omega.view(torch.int32)):
            raise AssertionError(f"form A on the uniform pool differs from "
                                 f"form A in round {r + 1}")
        events.append(int(ma.num_events))
    log(f"form A on its data pooled uniformly ({ragged.total} rows, "
        f"{x.shape[1]} a client): events and ω bit-equal to form A in "
        f"each of {UNIFORM_POOL_ROUNDS} rounds (events {events})")


def drive_ragged(ctx, cifar_ctx, ops):
    """Phase 5h: the uniform pool's bits, then each form of
    :data:`RAGGED_FORMS` through :func:`drive` on its pooled workload
    (Σnᵢ = 12,000 asserted).  Returns (a report per form, the launch
    counts summed over the forms)."""
    from repro_torch.configs import paper_cifar, paper_mnist

    check_uniform_pool_bits(ctx)
    reports, total = {}, {}
    for form, n_rounds, expect, check in RAGGED_FORMS:
        base = cifar_ctx if form in paper_cifar.RAGGED_FORMS else ctx
        cfgs = base["cfgs"]
        f = cfgs.RAGGED_FORMS[form]
        data, test, params0, _, ragged = cfgs.pooled_workload(
            SEED, device=ctx["dev"], shards=f.shards)
        if ragged.total != 12000:
            raise AssertionError(f"form {form}: {ragged.total} pooled "
                                 "examples, not 12,000")
        pool = dict(sizes=[ragged.min_size, ragged.max_size],
                    padding=ragged.padding,
                    buckets=[[b.capacity, len(b.members), b.padded]
                             for b in ragged.buckets])
        log(f"form {form}: {ragged.total} examples pooled over "
            f"{ragged.n_clients} clients of {ragged.min_size}–"
            f"{ragged.max_size}, buckets (capacity, clients, padded) "
            f"{pool['buckets']}")
        report, counts = drive(form, n_rounds, 1, dict(
            base, data=data, test=test, params0=params0, ragged=ragged),
            ops, expect, **check)
        reports[form] = dict(report, what=f.what, pool=pool)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del data, test
        torch.cuda.empty_cache()
    return reports, total


# Phase 5i: the sweep forms of ``configs.paper_mnist.SWEEP_FORMS`` — form
# A's configuration over seeds 0–3 × K 2.0, 0.5 (WA) and form B's over
# seeds 0–1 × L̄ 0.1, 0.2 (WB), 3 rounds through ``launch/sweep.py`` —
# with their launches per run and round.
SWEEP_ROUNDS = 3
SWEEP_FORMS = (
    ("WA", {"trigger_sq_norms": 1, "fused_gss": 1, "admm_update": 0}),
    ("WB", {"trigger_sq_norms": 1, "admm_update": 1, "fused_gss": 0}),
)


def _assert_metrics_equal(label, got, want):
    for f in want._fields:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{label}: RoundMetrics.{f} differs")


def drive_sweep(form, expect, ctx, ops):
    """One sweep form: its rounds under the sync debug mode with the
    launch counts set to 0 just before, then every run stepped alone by
    ``make_round_fn`` with its seed, K and L̄ in its config (another L̄
    than the plan's as a 0-d target) — each round's metrics and the
    final state bit-equal to the sweep's.  Returns (report, counts)."""
    from repro_torch.configs import paper_mnist
    from repro_torch.core import init_state, make_round_fn
    from repro_torch.launch.sweep import SweepGrid, _run, init_sweep, \
        make_sweep_fn
    from repro_torch.models import make_loss_fn

    dev, spec, params0 = ctx["dev"], ctx["spec"], ctx["params0"]
    f, cfg = paper_mnist.SWEEP_FORMS[form], paper_mnist.form_config(form)
    loss_fn = make_loss_fn(ctx["logits"])
    states, overrides, runs = init_sweep(cfg, params0, SweepGrid(**f.sweep),
                                         spec=spec, device=dev)
    sweep_fn = make_sweep_fn(cfg, loss_fn, ctx["data"], rounds=SWEEP_ROUNDS,
                             spec=spec, device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        states, hist = sweep_fn(states, overrides)
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ms_round = (time.perf_counter() - t0) / SWEEP_ROUNDS * 1e3
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()
             and "prototype" not in str(w.message)]
    if syncs:
        raise AssertionError(f"form {form}: {len(syncs)} host syncs inside "
                             f"the sweep, e.g. {syncs[:3]}")
    counts = path_counts(ops)
    for name, per_run in expect.items():
        want = per_run * len(runs) * SWEEP_ROUNDS
        if counts[name] != want:
            raise AssertionError(f"form {form}: {name} launched "
                                 f"{counts[name]} times, expected {want}")
    for r, (seed, k, t) in enumerate(runs):
        ctrl = cfg.controller._replace(K=k)
        if t != cfg.participation:
            ctrl = ctrl._replace(target_rate=torch.tensor(t, device=dev))
        rcfg = dataclasses.replace(cfg, seed=seed, controller=ctrl)
        state = init_state(rcfg, params0, spec=spec, device=dev)
        round_fn = make_round_fn(rcfg, loss_fn, ctx["data"], spec=spec,
                                 device=dev)
        for i in range(SWEEP_ROUNDS):
            state, m = round_fn(state)
            _assert_metrics_equal(f"form {form} run {r} round {i}",
                                  type(hist)(*(x[i, r] for x in hist)), m)
        if not _state_bytes_equal(_run(states, r), state):
            raise AssertionError(f"form {form}: run {r}'s final state is "
                                 "not the run's alone bit for bit")
        del state, round_fn
    rates = hist.events.to(torch.float32).mean(dim=(0, 2)).tolist()
    by_gain = {}
    for (_, k, _), rate in zip(runs, rates, strict=True):
        by_gain.setdefault(k, []).append(rate)
    by_gain = {k: sum(v) / len(v) for k, v in by_gain.items()}
    if len(by_gain) > 1 and len(set(by_gain.values())) == 1:
        raise AssertionError(f"form {form}: the realized rate is the same "
                             f"for every gain: {by_gain}")
    log(f"form {form}: {len(runs)} runs {runs}, {ms_round:.3f} ms per sweep "
        f"round ({ms_round / len(runs):.3f} a run) over {SWEEP_ROUNDS} "
        f"rounds on {ctx['smi']}; every run's metrics and final state "
        f"bit-equal to the run alone; realized rate by run {rates}, by "
        f"gain {by_gain}; launches {counts}")
    del states, hist
    torch.cuda.empty_cache()
    return dict(ms_per_round=ms_round, runs=[list(r) for r in runs],
                rates=rates, rate_by_gain=by_gain,
                what=f.what), counts


# Phase 5j: the host-offloaded forms of ``configs.paper_mnist.HOST_FORMS``
# (HA at stream_tiles 2 and 4, HS, HQ, HR), 4 rounds each from
# ``init_state`` beside their device form from the same config: every
# metric each round and the final state bit-equal.  Per round K1 once
# (the aggregate leg's trigger; twice in the first round, whose
# distances start empty) and K3 once (the fused commit on the (C, D)
# working set).
HOST_ROUNDS = 4
HOST_EXPECT = {"trigger_sq_norms": 1, "fused_gss": 1, "admm_update": 0}
HOST_RUNS = (("HA", 2), ("HA", 4), ("HS", 2), ("HQ", 2), ("HR", 2))


def _timed(round_fn, state, rounds):
    """(state, metrics by round, ms per round after the first)."""
    history, times = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = round_fn(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        history.append(m)
    return state, history, sum(times[1:]) / (rounds - 1) * 1e3


def drive_host(form, tiles, ctx, ops, device_ref=None):
    """One host form at ``stream_tiles`` = ``tiles``: its rounds with the
    launch counts set to 0 just before, the bytes each leg moved against
    ``round_fn.planned_bytes``, the live device memory after the rounds
    against 8·C·D·4 + ``device_state_bytes()`` + the data + 1 MiB, then
    the device form of the same config (or ``device_ref``, its earlier
    run) — metrics each round and the final state bit-equal.  HQ also
    saves a checkpoint after round 2 from host memory, resumes it on the
    device backend and holds round 4 to the host's bit for bit.
    Returns (report, counts, the device form's run)."""
    import gc

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import paper_mnist
    from repro_torch.core import init_state, make_round_fn
    from repro_torch.models import make_loss_fn

    dev, spec = ctx["dev"], ctx["spec"]
    f = paper_mnist.HOST_FORMS[form]
    hcfg = dataclasses.replace(paper_mnist.form_config(form),
                               stream_tiles=tiles)
    dcfg = dataclasses.replace(hcfg, state_backend="device")
    data, params0, extra = ctx["data"], ctx["params0"], {}
    if f.pooled:
        data, _, params0, _, extra["ragged"] = paper_mnist.pooled_workload(
            SEED, device=dev)
    loss_fn = make_loss_fn(ctx["logits"])
    label = f"form {form} (stream_tiles {tiles})"

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = init_state(hcfg, params0, spec=spec, device=dev)
    round_fn = make_round_fn(hcfg, loss_fn, data, spec=spec, device=dev,
                             **extra)
    ops.reset_launch_counts()
    ckpt = None
    if form == "HQ":
        state, head, _ = _timed(round_fn, state, 2)
        ckpt = save_checkpoint(str(ROOT / "build" / "chip_smoke_checkpoints"),
                               2, state, prefix=form)
        state, tail, ms_host = _timed(round_fn, state, HOST_ROUNDS - 2)
        history = head + tail
    else:
        state, history, ms_host = _timed(round_fn, state, HOST_ROUNDS)
    torch.cuda.synchronize()
    counts = path_counts(ops)
    live = torch.cuda.memory_allocated() - base
    for name, per_round in HOST_EXPECT.items():
        want = per_round * HOST_ROUNDS + (name == "trigger_sq_norms")
        if counts[name] != want:
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times in {HOST_ROUNDS} rounds, expected "
                                 f"{want}")
    planned, stats = round_fn.planned_bytes, round_fn.stats
    n, d = hcfg.n_clients, spec.dim
    want_bytes = {
        "h2d_row_bytes": HOST_ROUNDS * planned["row_stream_h2d"],
        "d2h_row_bytes": HOST_ROUNDS * planned["row_stream_d2h"],
        "h2d_full_bytes": HOST_ROUNDS * planned["server_pass_h2d"]
        + n * d * 4,  # the first round's trigger pass
        "d2h_full_bytes": HOST_ROUNDS * planned["server_pass_d2h"],
        "d2h_plan_bytes": HOST_ROUNDS * planned["plan_d2h"]}
    for k, v in want_bytes.items():
        if stats[k] != v:
            raise AssertionError(f"{label}: {k} {stats[k]}, planned {v}")
    cap = round_fn.static_info["capacity"]
    data_bytes = sum(v.numel() * v.element_size() for v in data.values())
    bound = (8 * cap * d * 4 + state.device_state_bytes() + data_bytes
             + (1 << 20))
    if live > bound:
        raise AssertionError(f"{label}: {live} live device bytes after the "
                             f"rounds, bound {bound}")

    if device_ref is None:
        dstate = init_state(dcfg, params0, spec=spec, device=dev)
        dround = make_round_fn(dcfg, loss_fn, data, spec=spec, device=dev,
                               **extra)
        dstate, dhist, ms_dev = _timed(dround, dstate, HOST_ROUNDS)
        device_ref = (dstate, dhist, ms_dev)
    dstate, dhist, ms_dev = device_ref
    for i, (a, b) in enumerate(zip(history, dhist, strict=True)):
        _assert_metrics_equal(f"{label} round {i + 1}", a, b)
    if not _state_bytes_equal(state, dstate):
        raise AssertionError(f"{label}: the final state is not the device "
                             "form's bit for bit")
    if ckpt is not None:
        resumed = load_checkpoint(ckpt, init_state(dcfg, params0, spec=spec,
                                                   device=dev))
        dround = make_round_fn(dcfg, loss_fn, data, spec=spec, device=dev)
        for i in (2, 3):
            resumed, m = dround(resumed)
            _assert_metrics_equal(f"{label}: round {i + 1} resumed on the "
                                  "device backend", m, history[i])
        if not _state_bytes_equal(resumed, state):
            raise AssertionError(f"{label}: round 4 from the host checkpoint "
                                 "on the device backend is not the host's")
        Path(ckpt).unlink()
        log(f"{label}: checkpoint after round 2 saved from host memory "
            "and resumed on the device backend; rounds 3 and 4 bit-equal "
            "to the host's")
    per = {k: stats[k] / HOST_ROUNDS for k in (
        "h2d_row_bytes", "d2h_row_bytes", "d2h_full_bytes",
        "d2h_plan_bytes")}
    per["h2d_full_bytes"] = planned["server_pass_h2d"]
    copy_ms = stats["h2d_ms"] + stats["d2h_ms"]
    report = dict(
        ms_per_round=ms_host, device_form_ms_per_round=ms_dev,
        bytes_per_round=per, planned_bytes=planned,
        device_state_bytes=state.device_state_bytes(),
        host_state_bytes=state.host_state_bytes(), live_device_bytes=live,
        live_bound=bound, copy_ms_per_round=copy_ms / HOST_ROUNDS,
        overlap_share=stats["overlap_ms"] / copy_ms if copy_ms else None,
        legs_ms_per_round={k[:-2]: stats[k] / HOST_ROUNDS * 1e3 for k in (
            "plan_s", "h2d_s", "solve_s", "d2h_s", "scatter_s", "agg_s")},
        events=[int(m.num_events) for m in history], what=f.what)
    log(f"{label}: {ms_host:.3f} ms/round (rounds 2-{HOST_ROUNDS}; its "
        f"device form {ms_dev:.3f}) on {ctx['smi']}; every metric of "
        f"{HOST_ROUNDS} rounds and the final state bit-equal to the device "
        f"form's; bytes a round {per}; device_state_bytes "
        f"{report['device_state_bytes']} (host {report['host_state_bytes']})"
        f"; live device bytes after the rounds {live} (bound {bound}); copy "
        f"stream {report['copy_ms_per_round']:.3f} ms a round, overlap share "
        f"{report['overlap_share']}; legs (host ms a round) "
        f"{report['legs_ms_per_round']}; launches {counts}")
    del state, round_fn
    torch.cuda.empty_cache()
    return report, counts, device_ref


def drive_sweeps_and_hosts(ctx, ops):
    """Phases 5i and 5j.  Returns (sweep reports, host reports, the
    launch counts summed over both)."""
    total, sweeps, hosts = {}, {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    for form, expect in SWEEP_FORMS:
        sweeps[form], counts = drive_sweep(form, expect, ctx, ops)
        add(counts)
    device_runs = {}
    for form, tiles in HOST_RUNS:
        hosts[f"{form}/{tiles}"], counts, device_runs[form] = drive_host(
            form, tiles, ctx, ops, device_runs.get(form))
        add(counts)
    directory = ROOT / "build" / "chip_smoke_checkpoints"
    if directory.is_dir() and not any(directory.iterdir()):
        directory.rmdir()
    return sweeps, hosts, total


# Phase 5k's paper-width forms: the checker's key (the policy the rules
# hold the round to) and the rounds recorded after one warm-up.
CHECKER_FORMS = (("A", ("compact", "flat", "sync", "uniform", 1), 2),
                 ("B", ("dense", "flat", "sync", "uniform", 1), 2),
                 ("HA", ("compact", "flat", "sync", "uniform", 1, "none",
                         "host"), 2),
                 ("SVA", ("compact", "flat", "serve", "uniform", 1), 1))
CHECKER_BASELINE = "src/repro_torch/analysis/baseline_fast_cpu.json"
# (C, D) fp32 blocks form A's round may hold at once beyond its slots'
# data (the solve's θ, momentum, stacked and flat gradients, prox term,
# new θ and momentum, the slots' λ and z_prev): 11.3 at the peak
# measured on the H100 (PERF.md), 13 allowed.  One stray (N, D) block
# is N/C = 6.25 of them at C = 16.
CHECKER_SOLVE_BLOCKS = 13


def _leg_facts(res) -> str:
    """One line of a checked leg's facts from its rule results."""
    m = {name: r["metrics"] for name, r in res.items()}
    calls = m["fused-admm-pass"]
    facts = [f"calls {calls['kernel_calls']}"]
    if "cuda_kernels" in calls:
        facts.append(f"CUDA kernels {calls['cuda_kernels']}")
    sw = m["no-full-width-sweeps"]
    if "full_width_sweeps" in sw:
        facts.append(f"(N, D) sweeps {sw['full_width_sweeps']}/"
                     f"{sw['budget']}")
    dn = m["donated-state-aliases"]
    if "fields" in dn:
        written = "/".join(dn["fields"][f]
                           for f in ("theta", "lam", "z_prev"))
        facts.append(f"state blocks allocated {dn['state_allocations']}/"
                     f"{dn['budget']}, θ/λ/z_prev {written}")
    if "peak_bytes" in dn:
        facts.append(f"peak {dn['peak_bytes']} B")
    cb = m["collective-budget"]
    if "total_bytes" in cb:
        facts.append(f"bytes between shards {cb['total_bytes']}/"
                     f"{cb['budget_bytes']}")
    ht = m["host-transfer-budget"]
    facts.append(f"syncs {ht['syncs']} (plan read-backs "
                 f"{ht['plan_readbacks']}, sync debug mode "
                 f"{ht.get('cuda_syncs')})")
    if "planned_row_stream_bytes" in ht:
        facts.append(f"row stream {ht['planned_row_stream_bytes']}/"
                     f"{ht['row_stream_budget']} B")
    facts.append(f"float64 ops (D6) {m['no-f64-ops']['d6_fma_f64_ops']}")
    return ", ".join(facts)


def check_static_invariants(ctx, ops):
    """Phase 5k (see the module docstring).  Returns (report, the
    launch counts of the phase)."""
    from repro_torch.analysis import cli
    from repro_torch.analysis.artifacts import ConfigKey, record_artifact
    from repro_torch.analysis.rules import evaluate
    from repro_torch.configs import paper_mnist
    from repro_torch.core.schedule import make_trace
    from repro_torch.models import make_loss_fn

    dev, smi, spec = ctx["dev"], ctx["smi"], ctx["spec"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report = cli.run_matrix("fast", device=dev, log=log)
    base = json.loads((ROOT / CHECKER_BASELINE).read_text())
    failures = (cli.report_failures(report)
                + cli.compare_to_baseline(base, report))
    if failures:
        raise AssertionError(f"checker, fast matrix on the card: {failures}")
    for name, res in report["configs"].items():
        log(f"5k {name}: {_leg_facts(res)}")
    log(f"5k fast matrix: {len(report['configs'])} legs pass on the card "
        f"and gate clean against the CPU baseline in "
        f"{time.perf_counter() - t0:.2f} s on {smi}")
    toy = {k: v for k, v in ops.launch_counts().items() if v}
    log(f"5k fast matrix launches (toy shapes, not on the kernels line): "
        f"{toy}")

    # Only the paper-width forms' launches join the kernels line.
    ops.reset_launch_counts()

    loss_fn = make_loss_fn(ctx["logits"])
    forms = {**paper_mnist.FORMS, **paper_mnist.HOST_FORMS,
             **paper_mnist.SERVE_FORMS}
    nd_bytes = paper_mnist.N_CLIENTS * spec.dim * 4
    facts, capacity = {}, {}
    for form, key, rounds in CHECKER_FORMS:
        key = ConfigKey(*key)
        f, cfg = forms[form], paper_mnist.form_config(form)
        serve = f.trace is not None
        extra, round_args = {}, None
        if serve:
            rows = torch.from_numpy(make_trace(f.trace)).to(dev)
            extra = {"arrivals_arg": True}

            def round_args(i, rows=rows):
                return (rows[i],)
        state = f.init(cfg, ctx["params0"], spec=spec, device=dev)
        round_fn = f.make_round(cfg, loss_fn, ctx["data"], spec=spec,
                                device=dev, **extra)
        art = record_artifact(key, cfg, round_fn, state, device=dev,
                              spec=spec, params0=ctx["params0"],
                              rounds=rounds, round_args=round_args)
        res = {r.rule: r.to_json() for r in evaluate(art)}
        bad = {k: r["violations"] for k, r in res.items()
               if r["status"] == "fail"}
        if bad:
            raise AssertionError(f"checker, form {form}: {bad}")
        facts[form] = {k: r["metrics"] for k, r in res.items()}
        capacity[form] = art.capacity
        log(f"5k form {form} ({f.what}, N = {cfg.n_clients}, D = "
            f"{spec.dim}): {_leg_facts(res)} on {smi}")
        del art, state, round_fn
        torch.cuda.empty_cache()
    peak_a, peak_b = (facts[k]["donated-state-aliases"]["peak_bytes"]
                      for k in ("A", "B"))
    # A's round at its own terms: C slots' client data, the (C, D) fp32
    # blocks of CHECKER_SOLVE_BLOCKS and 1 MiB.
    c = capacity["A"]
    slot_data = c * sum(t[0].numel() * t.element_size()
                        for t in ctx["data"].values())
    limit_a = CHECKER_SOLVE_BLOCKS * c * spec.dim * 4 + slot_data + 2**20
    log(f"5k max_memory_allocated over a round less its start: form A "
        f"{peak_a} B (limit {limit_a} B: {CHECKER_SOLVE_BLOCKS} (C, D) "
        f"blocks at C = {c} + {slot_data} B of slot data + 1 MiB), form B "
        f"{peak_b} B = {peak_a / nd_bytes:.3f}, {limit_a / nd_bytes:.3f} "
        f"and {peak_b / nd_bytes:.3f} of one (N, D) fp32 matrix "
        f"({nd_bytes} B) on {smi}")
    if not peak_a <= limit_a:
        raise AssertionError(f"form A's round peaks at {peak_a} B, over "
                             f"its own terms' {limit_a} B")
    counts = path_counts(ops)
    return {"fast_matrix": {k: {r: v["status"] for r, v in res.items()}
                            for k, res in report["configs"].items()},
            "exec": {k: v["status"] for k, v in report["exec"].items()},
            "forms": facts}, counts


def check_conv_precision(ctx):
    """A round built for the card switches TF32 off (the flags are set on
    first), and then the CNN's convolutions (``models.mlp.conv3x3_same``),
    batched over a CIFAR round's slots by ``vmap`` as the solve batches
    them — forward, data and weight gradients at the three layers'
    shapes — lie within ``CONV_REL_TOL`` of float64 (max |error| / max
    |value|).  The same passes with cuDNN's TF32 on are printed beside.
    So are the ragged solve's (phase 5h): each image convolved alone under
    a second ``vmap`` (``conv_precision.per_example``), held to the same
    limit."""
    from repro_torch.core.compact import capacity_bounds
    from repro_torch.launch.conv_precision import (cudnn_flags,
                                                   layer_inputs,
                                                   pass_errors, per_example,
                                                   worst)
    from repro_torch.models import make_loss_fn
    from repro_torch.models.mlp import conv3x3_same

    cfgs, dev = ctx["cfgs"], ctx["dev"]
    f, cfg = cfgs.FORMS["CF-T"], cfgs.form_config("CF-T")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    f.make_round(cfg, make_loss_fn(ctx["logits"]), ctx["data"], spec=None,
                 device=dev)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("a round built for the card left TF32 on")
    _, slots = capacity_bounds(cfg.n_clients, cfg.participation,
                               cfg.capacity_slack, cfg.capacity)
    inputs = layer_inputs(slots, cfg.batch_size, dev)
    errs = pass_errors(conv3x3_same, inputs)
    with cudnn_flags(allow_tf32=True):
        tf32 = pass_errors(conv3x3_same, inputs)
    each = pass_errors(per_example(conv3x3_same), inputs)

    def fmt(errs):
        return "; ".join(f"{layer} " + " ".join(
            f"{p} {e:.2e}" for p, e in errs[layer].items()) for layer in errs)

    for label, e in (("", errs), (" image by image", each)):
        if worst(e) > CONV_REL_TOL:
            raise AssertionError(f"the solve's convolutions{label} lie "
                                 f"{fmt(e)} off float64, more than "
                                 f"{CONV_REL_TOL}")
    log(f"CNN convolutions, {slots} clients x {cfg.batch_size} images "
        f"batched by vmap, against float64 (max |error| / max |value|): "
        f"{fmt(errs)}; worst {worst(errs):.2e} (limit {CONV_REL_TOL}); "
        f"with cuDNN's TF32 on, worst {worst(tf32):.2e}; each image alone "
        f"under a second vmap (the ragged solve): {fmt(each)}, worst "
        f"{worst(each):.2e}")


# Phases 7a–7c (slice 15): granite-3-2b, the dense family.  The cross-pod
# round of ``core/crosspod.py`` (the reference's test and example
# settings: K 0.05, α 0.9, L̄ 0.5, ρ 1e-3, lr 5e-3, 2 local steps, P = 2)
# runs no hand-written kernel (its distances stay plain, its attention
# is the differentiable blockwise path, its SSD scan ``ssd_scan_ref``);
# the dense prefill launches K4 once a layer.
GRANITE = "granite-3-2b"
CROSSPOD_CP = dict(n_pods=2, rho=1e-3, lr=5e-3, local_steps=2)
CROSSPOD_CTRL = dict(K=0.05, alpha=0.9, target_rate=0.5)
# (a), fp32; one round: each costs ~20 s of the host's CPU, and phase
# 12a runs the same round twice more against the mesh's
GRANITE_A = dict(layers=2, batch=2, seq=64, rounds=1)
# (b), bf16, full size; one round (the second) under torch.profiler
GRANITE_B = dict(batch=4, seq=512, rounds=5, profiled=1)
# Phases 8a–8e (slice 16): the SSM-bearing families and phi3.  (a) zamba2
# cut to one group (6 mamba layers and the shared block), fp32, against
# the CPU; (b) zamba2 at full size, bf16; (d) mamba2 cut to 2 layers,
# fp32, against the CPU; (e) phi3's new tokens.  8a–8e took 238.5 s on
# an H100 with 3 rounds in (a) and (b) and 8 new tokens in (e): each is
# cut to keep the script near half its time limit ((a) to one round, ~38
# s of the host's CPU, when phase 12 came).
ZAMBA, MAMBA, PHI3 = "zamba2-2.7b", "mamba2-2.7b", "phi3-medium-14b"
ZAMBA_A = dict(layers=6, batch=2, seq=64, rounds=1)
ZAMBA_B = dict(batch=4, seq=512, rounds=2, profiled=1)
MAMBA_D = dict(layers=2, batch=2, seq=64, rounds=1)
PHI3_NEW = 4
# The solve grade (ROADMAP): two SGD steps from the same state, cuBLAS
# in fp32 against the CPU's matmuls.  Gradients are held to it too.
SOLVE_TOL = dict(rtol=1e-4, atol=1e-6)
# The CPU references of 7a, 8a and 12a run on one worker thread while the
# card goes on with the next phases, and are held when they are done;
# the worker's parallel regions take CPU_REF_THREADS of the machine's 8
# cores, leaving two to drive the card.
CPU_REF_THREADS = 6
_BACKGROUND = []
_CHILDREN = []  # the processes this script starts


def background():
    """The worker that computes CPU references beside the card's work."""
    if not _BACKGROUND:
        _BACKGROUND.append(concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="cpu-reference",
            initializer=torch.set_num_threads, initargs=(CPU_REF_THREADS,)))
    return _BACKGROUND[0]


def _but_the_worker(count):
    """A ``collectives`` listener that leaves out the worker's copies
    (autograd's own threads, which run a CUDA backward, count)."""
    def listen(kind, t):
        if not threading.current_thread().name.startswith("cpu-reference"):
            count(kind, t)

    return listen


def _crosspod_round(cfg, **overrides):
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.crosspod import CrossPodConfig, \
        make_cross_pod_round
    from repro_torch.models import build_model

    cp = CrossPodConfig(controller=ControllerConfig(**CROSSPOD_CTRL),
                        **dict(CROSSPOD_CP, **overrides))
    model = build_model(cfg)
    return cp, model, make_cross_pod_round(cp, model.loss)


def _crosspod_batches(cfg, cp, batch, seq):
    """Next-token batches (pods, local_steps, batch, seq), made with
    numpy from the seed as the reference's launcher makes them."""
    rng = np.random.default_rng(SEED)
    while True:
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (cp.n_pods, cp.local_steps, batch, seq + 1)))
        yield {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _cross_pod_to(state, device):
    """A copy of a ``CrossPodState`` on ``device`` (the round writes its
    input's rows in place)."""
    from repro_torch.utils.pytree import tree_map

    def move(t):
        return tree_map(lambda x: x.to(device, copy=True), t)

    return state._replace(theta=move(state.theta), lam=move(state.lam),
                          z_prev=move(state.z_prev),
                          ctrl=type(state.ctrl)(*(move(x)
                                                  for x in state.ctrl)),
                          rng=move(state.rng), round=move(state.round))


def _held_on_card(dev, got, want, label, what):
    """Each leaf of ``got`` (on the card, or a host copy of the card's)
    within the solve grade of the CPU's ``want``, compared on the card;
    returns the largest |Δ|."""
    gap = 0.0
    for g, w in zip(got, want, strict=True):
        g, w = g.to(dev), w.to(dev)
        diff = (g - w).abs()
        if bool((diff > SOLVE_TOL["atol"]
                 + SOLVE_TOL["rtol"] * w.abs()).any()):
            raise AssertionError(
                f"{label}: {what} off rtol 1e-4 / atol 1e-6 of the CPU's, "
                f"max |Δ| {float(diff.max()):.3e}")
        gap = max(gap, float(diff.max()))
        del w, diff
    return gap


def check_crosspod_against_cpu(dev, ops, cfg, spec, label, defer=False):
    """Phases 7a, 8a and 8d: ``spec["rounds"]`` cross-pod rounds of
    ``cfg`` (fp32, cut in depth) on the card, each held against the same
    round on the CPU from the card's state before it: events equal, δ
    within one ulp, distances at rtol 1e-5, θ/λ/z_prev at the solve
    grade, ``train_loss`` at rtol 1e-5.  No kernel launches.
    ``spec["local_steps"]``, where given, replaces the settings' 2.
    With ``defer`` (one round) the CPU's round runs on the
    :func:`background` worker, the card's state is kept on the host, and
    a callable is returned that holds the two when the caller is ready
    (→ the report)."""
    from repro_torch.core.crosspod import init_cross_pod_state
    from repro_torch.utils.pytree import tree_leaves, tree_map

    cp, model, round_fn = _crosspod_round(
        cfg, local_steps=spec.get("local_steps",
                                  CROSSPOD_CP["local_steps"]))
    params0 = model.init(SEED, device=dev)
    state = init_cross_pod_state(cp, params0, device=dev)
    batches = _crosspod_batches(cfg, cp, spec["batch"], spec["seq"])
    if defer and spec["rounds"] != 1:
        raise ValueError("a deferred check runs one round")
    ops.reset_launch_counts()
    report = []
    for r in range(spec["rounds"]):
        batch = next(batches)
        t0 = time.perf_counter()
        if r == 0:
            # The card's first state is init_cross_pod_state of params0:
            # the CPU's is made from a copy of params0 (one replica's
            # bytes, not θ, λ and z_prev of every pod), the same values.
            before = init_cross_pod_state(
                cp, tree_map(lambda x: x.cpu(), params0), device="cpu")
            del params0
        else:
            before = _cross_pod_to(state, "cpu")
        copy_s = time.perf_counter() - t0
        cpu = background().submit(round_fn, before, batch) if defer \
            else None
        t0 = time.perf_counter()
        state, m = round_fn(state, batch)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        if any(ops.launch_counts().values()):
            raise AssertionError(f"{label} launched {ops.launch_counts()}")

        def held(state, m, before, batch, r, card_ms, copy_s, cpu):
            t0 = time.perf_counter()
            want, wm = round_fn(before, batch) if cpu is None \
                else cpu.result()
            cpu_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            where = f"{label} round {r}"
            np.testing.assert_array_equal(m.events.cpu().numpy(),
                                          wm.events.numpy(), err_msg=where)
            torch.testing.assert_close(m.distances.cpu(), wm.distances,
                                       rtol=1e-5, atol=1e-7)
            delta, wdelta = m.delta.cpu(), wm.delta
            scale = torch.maximum(torch.maximum(delta.abs(), wdelta.abs()),
                                  before.ctrl.delta.abs())
            if not bool(((delta - wdelta).abs() <= scale * 2.0 ** -23)
                        .all()):
                raise AssertionError(f"{where}: δ {delta} against {wdelta}")
            torch.testing.assert_close(m.train_loss.cpu(), wm.train_loss,
                                       rtol=1e-5, atol=0)
            # held on the card: the CPU's leaves copied there
            gap = max(_held_on_card(dev, tree_leaves(getattr(state, f)),
                                    tree_leaves(getattr(want, f)), where, f)
                      for f in ("theta", "lam", "z_prev"))
            check_s = time.perf_counter() - t0
            report.append(dict(events=m.events.tolist(),
                               train_loss=float(m.train_loss),
                               max_abs_err=gap, card_ms=card_ms,
                               cpu_s=cpu_s))
            log(f"{where} ({cfg.name}, {cfg.num_layers} layers, fp32): "
                f"events {m.events.tolist()} equal, train_loss "
                f"{float(m.train_loss):.6f} (CPU "
                f"{float(wm.train_loss):.6f}), state max_abs_err {gap:.3e} "
                f"(rtol 1e-4 / atol 1e-6 held); card {card_ms:.1f} ms, CPU "
                f"{cpu_s:.1f} s"
                + (" (the wait for the worker's round)" if defer else "")
                + f", the state's copy to the CPU {copy_s:.1f} s, the check "
                f"{check_s:.1f} s")
            return report

        if defer:
            kept = _cross_pod_to(state, "cpu")
            del state
            torch.cuda.empty_cache()
            return functools.partial(held, kept, m, before, batch, r,
                                     card_ms, copy_s, cpu)
        held(state, m, before, batch, r, card_ms, copy_s, cpu)
    return report


def _train_batch(cfg, batch, seq):
    """A training batch on the CPU, made with numpy from the seed:
    next-token pairs, or the audio family's frames (normal × 0.3) with
    their labels."""
    from repro_torch.launch.serve_lm import make_request

    if cfg.family == "audio":
        rng = np.random.default_rng(SEED)
        return {"features": torch.from_numpy(rng.normal(
                    size=(batch, seq, cfg.frontend_dim)) * 0.3).float(),
                "labels": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (batch, seq)))}
    toks = make_request(cfg, batch, seq + 1, SEED, "cpu")["tokens"]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def check_loss_grads_against_cpu(dev, ops, cfg, spec, label, repeat=False):
    """Phases 8d, 9a and 9e: the training loss and its gradients on the
    card against the CPU's on the same weights and batch: the loss at
    rtol 1e-5, every gradient at the solve grade; no kernel launches (the
    SSD's scan is ``ssd_scan_ref``, which autograd differentiates, the
    attention ``blockwise_attention``); with ``repeat`` the card's
    gradients computed twice, bit for bit."""
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_map

    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    params_cpu = tree_map(lambda x: x.cpu(), params)
    batch = _train_batch(cfg, spec["batch"], spec["seq"])
    on_card = {k: v.to(dev) for k, v in batch.items()}
    ops.reset_launch_counts()

    def card_grads():
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        it = iter(leaves)
        loss = model.loss(tree_map(lambda _: next(it), params), on_card)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    t0 = time.perf_counter()
    loss, grads = card_grads()
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    if repeat:
        again_loss, again = card_grads()
        if not (torch.equal(again_loss, loss) and all(
                torch.equal(a, g) for a, g in zip(again, grads,
                                                  strict=True))):
            raise AssertionError(f"{label}: the gradients on the card do "
                                 "not repeat bit for bit")
        del again
    if any(ops.launch_counts().values()):
        raise AssertionError(f"{label} launched {ops.launch_counts()}")
    t0 = time.perf_counter()
    wleaves = [x.requires_grad_(True) for x in tree_leaves(params_cpu)]
    want = model.loss(params_cpu, batch)
    wgrads = torch.autograd.grad(want, wleaves)
    cpu_s = time.perf_counter() - t0
    want = want.detach()
    torch.testing.assert_close(loss.cpu(), want, rtol=1e-5, atol=0)
    gap = _held_on_card(dev, grads, wgrads, label, "gradients")
    log(f"{label} ({cfg.name}, {cfg.num_layers} layers, fp32, "
        f"{spec['batch']} × {spec['seq']} "
        f"{'frames' if cfg.family == 'audio' else 'tokens'}): loss "
        f"{float(loss):.6f} (CPU {float(want):.6f}), {len(grads)} gradients "
        f"max_abs_err {gap:.3e} (rtol 1e-4 / atol 1e-6 held)"
        f"{'; repeated bit for bit on the card' if repeat else ''}; card "
        f"{card_ms:.1f} ms, CPU {cpu_s:.1f} s")
    return dict(loss=float(loss), max_abs_err=gap, card_ms=card_ms,
                repeated_bit_equal=repeat)


def _round_profile(prof, wall_ms) -> dict:
    """A profiled round's device busy time (the kernels' durations, one
    stream), kernel launches, idle share and longest kernels, read off
    the profiler's raw events: the device events but the spans.  (The
    same figures as ``key_averages()``'s, which builds the event tree
    first: 0.55 s against 0.03 s on a 2,990-launch step on an H100.)"""
    from repro_torch.utils.spans import is_span

    cuda = torch.autograd.DeviceType.CUDA
    by_name: dict = {}
    busy_ns = launches = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or is_span(e.name()):
            continue
        busy_ns += e.duration_ns()
        launches += 1
        by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    busy = busy_ns / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        wall_ms=wall_ms, device_busy_ms=busy,
        idle_share=1 - busy / wall_ms, launches=launches,
        top_kernels_ms={k[:60]: v / 1e6 for k, v in top})


def drive_crosspod_full(dev, smi, cfg, spec, label):
    """Phases 7b and 8b: ``cfg`` at full size in bf16 from seed 0's init,
    P = 2 pods on the card, 2 local steps of ``spec``'s tokens,
    ``spec["rounds"]`` rounds, one under torch.profiler: round 0 fires
    both pods, every state leaf finite, z_prev = θ + λ bit for bit on
    every pod that has fired; ms/round and the peak device memory
    printed beside the card."""
    from repro_torch.core.crosspod import init_cross_pod_state
    from repro_torch.utils.pytree import tree_leaves

    cp, model, round_fn = _crosspod_round(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params0 = model.init(SEED, device=dev)
    state = init_cross_pod_state(cp, params0, device=dev)
    del params0
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    state_bytes = sum(x.numel() * x.element_size() for f in
                      ("theta", "lam", "z_prev")
                      for x in tree_leaves(getattr(state, f)))
    n_params = sum(x[0].numel() for x in tree_leaves(state.theta))
    torch.cuda.reset_peak_memory_stats(dev)
    batches = _crosspod_batches(cfg, cp, spec["batch"], spec["seq"])
    ms, events, losses, fired = [], [], [], set()
    for r in range(spec["rounds"]):
        batch = next(batches)
        prof = None
        if r == spec["profiled"]:
            # The card's activity only: with the host's ops too, reading
            # back a round's ~200k events took ~40 s on an H100's host.
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        state, m = round_fn(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if prof is not None:
            prof.__exit__(None, None, None)
            profiled = _round_profile(prof, ms[-1])
        events.append(m.events.tolist())
        losses.append(float(m.train_loss))
        fired |= {i for i, e in enumerate(events[-1]) if e}
    peak = torch.cuda.max_memory_allocated(dev)
    if events[0] != [True] * cp.n_pods:
        raise AssertionError(f"{label}: round 0 fired {events[0]}")
    for f in ("theta", "lam", "z_prev"):
        for x in tree_leaves(getattr(state, f)):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{label}: {f} holds a value not "
                                     "finite")
    for t, lm, z in zip(tree_leaves(state.theta), tree_leaves(state.lam),
                        tree_leaves(state.z_prev), strict=True):
        for j in fired:
            if not torch.equal(z[j], t[j] + lm[j]):
                raise AssertionError(f"{label}: pod {j}'s z_prev is not "
                                     "θ + λ")
    unprofiled = [(t, e) for i, (t, e) in enumerate(zip(ms, events,
                                                        strict=True))
                  if i != spec["profiled"]]
    both = [t for t, e in unprofiled if all(e)]
    none = [t for t, e in unprofiled if not any(e)]
    report = dict(
        arch=cfg.name, params=n_params, dtype=cfg.dtype, pods=cp.n_pods,
        local_steps=cp.local_steps, tokens_per_step=spec["batch"]
        * spec["seq"], rounds=spec["rounds"], events=events,
        train_loss=losses, ms_per_round=ms,
        ms_per_round_both_fired=statistics.median(both) if both else None,
        ms_per_round_none_fired=statistics.median(none) if none else None,
        profiled_round=dict(profiled, index=spec["profiled"]),
        init_s=init_s, state_bytes=state_bytes, peak_memory_bytes=peak,
        card=smi)
    log(f"{label} {cfg.name} cross-pod, bf16, {n_params} parameters a "
        f"replica, P = {cp.n_pods}, {cp.local_steps} local steps of "
        f"{spec['batch']} × {spec['seq']} tokens: events {events}, "
        f"train_loss {losses}; ms/round {[round(x, 1) for x in ms]} (round "
        f"{spec['profiled']} under torch.profiler; median of the others "
        f"that fired both pods {report['ms_per_round_both_fired']}, none "
        f"{report['ms_per_round_none_fired']}); state "
        f"{state_bytes / 1e9:.2f} GB, peak {peak / 1e9:.2f} GB "
        f"({peak / 2**30:.2f} GiB) of the card's "
        f"{torch.cuda.get_device_properties(dev).total_memory / 1e9:.2f} "
        f"GB; init {init_s:.2f} s; on {smi}")
    log(f"{label} profiled round {spec['profiled']} (events "
        f"{events[spec['profiled']]}): {profiled}")
    del state
    torch.cuda.empty_cache()
    return report


# Phases 9a–9e (slice 17): the MoE, vlm and audio families.  (a)
# moonshot cut to 1 layer at every published width, fp32, against the
# CPU (its cross-pod round takes 1 local step: with 2 the CPU's round
# took 56.0 s and 9a 103.2 s on an H100's host); (b) moonshot at full size, bf16, its prefill/decode consistency
# on a drop-free copy of the same weights (capacity factor 64: prefill's
# per-group count drops the latest tokens, decode never drops; at 4 ×
# 2048 the drop-free buffers would take ~13 GB a layer, so 1 × 256);
# (c) mixtral .reduced() (a window of 16); (d) paligemma: 2 layers fp32
# against the CPU, then full size in bf16 on 512 text tokens after its
# 256 patches; (e) hubert: 2 layers fp32, then full size in bf16.
MOONSHOT, MIXTRAL = "moonshot-v1-16b-a3b", "mixtral-8x7b"
PALIGEMMA, HUBERT = "paligemma-3b", "hubert-xlarge"
MOON_A = dict(layers=1, batch=2, seq=64, rounds=1, local_steps=1)
MOON_NEW, MOON_CHECK = 4, (1, 256)
DROP_FREE_CF = 64.0
PALI_LAYERS, PALI_PROMPT, PALI_NEW = 2, 512, 4
HUBERT_A = dict(layers=2, batch=2, seq=64)
HUBERT_B = dict(batch=4, seq=1024, lr=1e-2)
ROUTER_MARGIN = 1e-5
# The MoE layer's card checks (phase 9c), weights from ``moe_init``:
# (seed, d, d_ff, experts, top_k, batch, seq, capacity factor, rigged
# router): drops at 64 experts top-6, decode's S = 1, and the rigged
# router of tests/test_models.py (every token to expert 0, 1–3 tied).
MOE_UNITS = ((2, 32, 16, 64, 6, 2, 40, 1.25, False),
             (3, 16, 32, 8, 2, 4, 1, 1.25, False),
             (0, 8, 16, 4, 2, 2, 16, 1.0, True))


@contextlib.contextmanager
def moe_plans():
    """Record the routing (``moe.routing``: probs, expert ids, keep
    mask, capacity) and the router's input ``x`` of every MoE layer the
    model runs, one dict a layer call."""
    from repro_torch.models import moe, transformer

    plans, apply = [], transformer.moe_apply

    def recorded(p, x, *, top_k, capacity_factor, **kw):
        plans.append(dict(moe.routing(p, x, top_k, capacity_factor), x=x))
        return apply(p, x, top_k=top_k, capacity_factor=capacity_factor,
                     **kw)

    transformer.moe_apply = recorded
    try:
        yield plans
    finally:
        transformer.moe_apply = apply


def router_margins(plans, top_k):
    """Tokens (over the recorded layers) whose k-th and (k+1)-th router
    probabilities lie within ``ROUTER_MARGIN`` (where the card and the
    CPU may pick different experts), of how many; and the smallest
    margin."""
    near, total, least = 0, 0, math.inf
    for plan in plans:
        top = torch.sort(plan["probs"], dim=-1, descending=True).values
        gap = top[..., top_k - 1] - top[..., top_k]
        near += int((gap < ROUTER_MARGIN).sum())
        total += gap.numel()
        least = min(least, float(gap.min()))
    return dict(near_ties=near, tokens=total, least_margin=least)


def check_moe_slice(dev, ops, cfg):
    """Phase 9a: moonshot at every published width cut to 1 layer, fp32:
    greedy serving against the CPU (1 launch of K4's 3xTF32 instance),
    the router's near ties counted on the prefill, the loss and its
    gradients against the CPU and twice bit for bit on the card, one
    cross-pod round against the CPU."""
    from repro_torch.launch.serve_lm import make_request
    from repro_torch.models import build_model

    cut = dataclasses.replace(cfg, num_layers=MOON_A["layers"],
                              dtype="float32")
    slice_report, counts = check_slice_against_cpu(
        dev, ops, cut, {"flash_attention_fp32": 1, "flash_attention": 0,
                        "ssd_scan": 0})
    model = build_model(cut)
    params = model.init(SEED, device=dev)
    with moe_plans() as plans:
        model.prefill(params, make_request(cut, 1, SLICE_TOKENS, SEED, dev))
    margins = router_margins(plans, cut.top_k)
    del params, plans
    torch.cuda.empty_cache()
    log(f"9a router: {margins['near_ties']} of {margins['tokens']} prefill "
        f"tokens with a k-th/(k+1)-th probability margin under "
        f"{ROUTER_MARGIN} (least {margins['least_margin']:.3e}); TF32 off")
    loss = check_loss_grads_against_cpu(dev, ops, cut, MOON_A, "9a loss",
                                        repeat=True)
    torch.cuda.empty_cache()
    crosspod = check_crosspod_against_cpu(dev, ops, cut, MOON_A, "9a")
    torch.cuda.empty_cache()
    return dict(slice=slice_report, router=margins, loss_grads=loss,
                crosspod=crosspod), counts


def _mean_cosine(x):
    """Mean over a batch of ‖mean_t x_t/‖x_t‖‖²: the mean cosine of a
    sequence's vectors to each other (self-pairs included; 1/S for
    independent directions, 1 for one shared direction)."""
    u = x.float() / x.float().norm(dim=-1, keepdim=True)
    return float((u.mean(1) ** 2).sum(-1).mean())


def moe_drop_share(cfg, dev):
    """``serve_full``'s ``after`` for phase 9b: one more prefill of the
    served requests with the routing recorded → the share of the rows
    (token × k) dropped at the config's capacity factor, in all and a
    layer, beside each layer's router inputs' mean cosine; and two
    figures for layer 0's shape: random ids (uniform routing) and its
    router on the embedding alone (before attention adds to it)."""
    from repro_torch.launch.serve_lm import make_request
    from repro_torch.models import moe
    from repro_torch.models.layers import rmsnorm

    def after(model, params):
        tokens = make_request(cfg, SERVE_BATCH, SERVE_PROMPT, SEED,
                              dev)["tokens"]
        with moe_plans() as plans:
            model.prefill(params, {"tokens": tokens})
            rows = plans[0]["keep"].numel()
            per_layer = [1 - int(p["keep"].sum()) / rows for p in plans]
            cosine = [_mean_cosine(p["x"]) for p in plans]
            del plans[:]
        share = sum(per_layer) / len(per_layer)
        lay = params["layers"]
        emb = rmsnorm(params["embed"][tokens], lay["ln2"][0], cfg.norm_eps)
        alone = moe.routing({"router": lay["moe"]["router"][0]}, emb,
                            cfg.top_k, cfg.capacity_factor)
        e, cap = cfg.num_experts, alone["cap"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        ids = torch.rand(tokens.shape + (e,), generator=gen,
                         device=dev).argsort(-1)[..., :cfg.top_k]
        uniform = 1 - float(moe.dispatch_plan(ids, e, cap)[2]
                            .float().mean())
        embedding = 1 - float(alone["keep"].float().mean())
        log(f"9b drops at capacity factor {cfg.capacity_factor} (capacity "
            f"{cap} rows an expert and group): {share:.4%} of "
            f"{rows * len(per_layer)} rows over {len(per_layer)} layers, "
            f"the worst layer {max(per_layer):.4%}; layer 0's shape with "
            f"uniform random ids {uniform:.4%}, its router on the "
            f"embedding alone {embedding:.4%} (router input mean cosine "
            f"{_mean_cosine(emb):.4f})")
        log("9b drops a layer: " + " ".join(f"{x:.4f}" for x in per_layer))
        log("9b router input mean cosine a layer: "
            + " ".join(f"{x:.4f}" for x in cosine))
        return dict(drop_share=share, drop_share_worst_layer=max(per_layer),
                    drop_share_by_layer=per_layer,
                    router_input_cosine_by_layer=cosine,
                    drop_share_uniform_ids=uniform,
                    drop_share_layer0_embedding_alone=embedding,
                    capacity=cap, rows=rows * len(per_layer))

    return after


def check_moe_units(dev):
    """Phase 9c: ``moe_apply`` on the card against its plain CPU run on
    the same inputs, at ``MOE_UNITS`` (drops at 64 experts top-6,
    decode's S = 1, the tied router): expert ids and keep
    mask equal, out and aux at rtol 1e-5 (fp32, TF32 off); the
    gradients (Σ out² + 0.01·aux) at the solve grade, and twice bit for
    bit on the card."""
    from repro_torch import prng
    from repro_torch.models import moe

    worst = 0.0
    for seed, d, f, e, k, b, s, cf, rigged in MOE_UNITS:
        p = moe.moe_init(prng.PRNGKey(seed, "cpu"), d, f, e, torch.float32,
                         "cpu")
        x = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(b, s, d))).float()
        if rigged:
            p["router"] = torch.zeros_like(p["router"])
            p["router"][:, 0] = 10.0
            x = x.abs() + 0.1

        def run(p, x):
            leaves = {n: v.clone().requires_grad_(True)
                      for n, v in p.items()}
            out, aux = moe.moe_apply(leaves, x, top_k=k, capacity_factor=cf)
            grads = torch.autograd.grad(torch.sum(out ** 2) + 0.01 * aux,
                                        list(leaves.values()))
            return (out.detach(), aux.detach(),
                    moe.routing(p, x, k, cf), grads)

        want = run(p, x)
        pc = {n: v.to(dev) for n, v in p.items()}
        got, again = run(pc, x.to(dev)), run(pc, x.to(dev))
        where = f"9c moe_apply (E {e}, k {k}, S {s}, cf {cf})"
        for key in ("eids", "keep"):
            if not torch.equal(got[2][key].cpu(), want[2][key]):
                raise AssertionError(f"{where}: {key} differ")
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=0)
        for g, a, w in zip(got[3], again[3], want[3], strict=True):
            if not torch.equal(g, a):
                raise AssertionError(f"{where}: gradients do not repeat")
            torch.testing.assert_close(g.cpu(), w, **SOLVE_TOL)
        worst = max(worst, float((got[0].cpu() - want[0]).abs().max()))
    log(f"9c moe_apply: {len(MOE_UNITS)} cases, card against the CPU: ids "
        f"and keep masks equal, out max_abs_err {worst:.3e} (rtol 1e-5 "
        "held), aux at rtol 1e-5, gradients at the solve grade and "
        "repeated bit for bit")
    return dict(cases=len(MOE_UNITS), out_max_abs_err=worst)


def d11_refusal(cfg, dev):
    """``serve_full``'s ``after`` for phase 9d: a vlm prefill with the
    reference's default ``max_seq`` (the text's length) leaves no room
    for decode; the port's decode must refuse it (ROADMAP D11)."""
    from repro_torch.launch.serve_lm import make_request

    def after(model, params):
        req = make_request(cfg, 1, 16, SEED, dev)
        _, cache = model.prefill(params, req)
        try:
            model.decode_step(params, req["tokens"][:, -1:], cache)
        except ValueError as err:
            log(f"9d D11 refused as it should be: {err}")
            return dict(d11_refused=str(err))
        raise AssertionError("9d: decode past a cache sized without the "
                             "prefix was not refused")

    return after


def train_step_full(dev, ops, smi, cfg, spec, label):
    """Phase 9e: a model at full size in bf16 (its init drawn on the
    card): the loss on ``spec``'s batch, its gradients, one SGD step
    (momentum 0.9 from zero), the loss again — finite, the parameters
    moved, no kernel launched; ms and peak memory beside the card."""
    from repro_torch.models import build_model
    from repro_torch.optim.sgd import sgd_step
    from repro_torch.utils.pytree import tree_leaves, tree_map, \
        tree_zeros_like

    model = build_model(cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {k: v.to(dev) for k, v in _train_batch(
        cfg, spec["batch"], spec["seq"]).items()}
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    it = iter(leaves)
    loss = model.loss(tree_map(lambda _: next(it), params), batch)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    new, _ = sgd_step(params, tree_map(lambda _: next(it), params),
                      tree_zeros_like(params), spec["lr"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        after = model.loss(new, batch)
    loss, after = float(loss.detach()), float(after)
    moved = sum(not torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(new), strict=True))
    if not (math.isfinite(loss) and math.isfinite(after)) or after == loss \
            or not moved or not all(bool(torch.isfinite(x).all())
                                    for x in tree_leaves(new)):
        raise AssertionError(f"{label}: loss {loss} → {after}, {moved} "
                             "leaves moved")
    if any(ops.launch_counts().values()):
        raise AssertionError(f"{label} launched {ops.launch_counts()}")
    n = sum(x.numel() for x in tree_leaves(params))
    log(f"{label} {cfg.name} train step, bf16, {n} parameters, "
        f"{spec['batch']} × {spec['seq']} frames: loss {loss:.6f} → "
        f"{after:.6f} after one SGD step (lr {spec['lr']}), {moved} of "
        f"{len(leaves)} leaves moved; loss + grads + step {step_ms:.1f} ms, "
        f"peak {peak / 1e9:.2f} GB; init {init_s:.2f} s; on {smi}")
    del params, new, grads, leaves
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, params=n, loss=loss, loss_after=after,
                leaves_moved=moved, step_ms=step_ms, peak_memory_bytes=peak,
                init_s=init_s, card=smi)


# ---------------------------------------------------------------------
# Phase 10: the last slice — K2a/K3a (bf16), the roofline tables, the
# one-card dry-run, the example twins and the paper's claims.
# ---------------------------------------------------------------------

# The reference test's bf16 shapes (tests/test_kernels.py:59).
BF16_REF_SHAPES = ((4, 64), (8, 1024), (5, 2049))
DRYRUN_JOBS = 6  # of the machine's 8 cores: two left to drive the card
EXAMPLE_RUNS = (
    ("quickstart", ["--rounds", "20"]),
    ("federated_image", ["--algorithm", "all", "--rounds", "3"]),
    ("serve_lm", []),
    ("sharded_sweep", ["--sweep-rounds", "20"]),
    ("fedback_transformer", ["--rounds", "6"]),
)


def check_bf16_kernels(dev, ops):
    """Phase 10a: K2a and K3a.  First the path: the public API
    (``ops.admm_update`` without z as the dense round calls it, and
    ``ops.fused_gss`` with C = 16 slots, 14 valid) on bf16 operands at
    the round's width, (100, 159010), counts set to 0 just before and
    read just after: one K2 and one K3 launch, each bf16 operand taken by
    the kernel (nothing gives way to the plain version).  Then each held
    bit for bit against its plain version: K2a at the reference test's
    shapes and at (100, 159010), with and without z, and on a θ 2 bytes
    off its storage (the element-by-element instance); K2b on 2 and 4
    shards of (100, 159010), every shard's rows K2a's; K3a with and
    without z at (100, 16, 159010) with the first and last slots
    invalid, at an odd D and on a θ 2 bytes off its storage, over the
    whole state.  Timed as the fp32 rows are (cold over input sets L2
    cannot hold, and warm), bounds from their bytes at 2 an element.
    Returns (the kernels line's rows, the path's counts by row)."""
    from repro_torch.launch.roofline import PEAK_FP32_FLOPS
    from repro_torch.launch.time_kernels import (ROUND_C, ROUND_D, ROUND_N,
                                                 ROUND_VALID, device_ms,
                                                 peak_bandwidth,
                                                 round_kernel_ms)
    from repro_torch.sharding import make_client_mesh, replicate_data, \
        shard_rows

    rng = np.random.default_rng(SEED)
    bf16 = torch.bfloat16
    n, d, c = ROUND_N, ROUND_D, ROUND_C

    def mk(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev).to(bf16)

    def plan(nn_, cc, invalid=()):
        idx = torch.from_numpy(rng.permutation(nn_)[:cc].astype(
            np.int32)).to(dev)
        valid = torch.ones(cc, dtype=torch.bool, device=dev)
        valid[list(invalid)] = False
        return idx, valid

    def off_by_one(t):  # the same values 2 bytes into a new storage
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    def same(label, got, want):
        for g, x in zip(got, want, strict=True):
            if g.dtype != bf16 or not torch.equal(g, x):
                raise AssertionError(f"{label} is not bit-equal to its "
                                     "plain version")

    # The path: the public API on bf16, counted.
    th, la, w, zp, solved = mk(n, d), mk(n, d), mk(d), mk(n, d), mk(c, d)
    idx, valid = plan(n, c, range(ROUND_VALID, c))
    state = [t.clone() for t in (th, la, zp)]
    ops.reset_launch_counts()
    path_k2 = ops.admm_update(th, la, w, with_z=False)
    ops.fused_gss(idx, valid, solved, w, *state)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if {k: counts[k] for k in ("admm_update", "fused_gss")} != {
            "admm_update": 1, "fused_gss": 1}:
        raise AssertionError(f"the bf16 path launched {counts}, expected "
                             "one admm_update and one fused_gss")
    path = {"admm_update_bf16": counts["admm_update"],
            "fused_gss_bf16": counts["fused_gss"]}
    same("admm_update (bf16, the path)", path_k2,
         ops.admm_update_ref(th, la, w, with_z=False))
    same("fused_gss (bf16, the path)", state, ops.fused_gss_ref(
        idx, valid, solved, w, th.clone(), la.clone(), zp.clone()))

    # K2a held.
    for with_z in (True, False):
        for nn_, dd in BF16_REF_SHAPES + ((n, d), (3, 7)):
            a, b, ww = mk(nn_, dd), mk(nn_, dd), mk(dd)
            want = ops.admm_update_ref(a, b, ww, with_z=with_z)
            same(f"admm_update(with_z={with_z}) bf16 at ({nn_}, {dd})",
                 ops.admm_update(a, b, ww, with_z=with_z), want)
            if nn_ * dd > 8:
                same(f"admm_update(with_z={with_z}) bf16 at ({nn_}, {dd}), "
                     "θ 2 bytes off", ops.admm_update(
                         off_by_one(a), b, ww, with_z=with_z), want)
    # K2b on bf16 shards.
    for p in (2, 4):
        mesh = make_client_mesh(p, [dev])
        before = ops.admm_update_sharded.launches
        for with_z in (True, False):
            parts = ops.admm_update(shard_rows(th, mesh),
                                    shard_rows(la, mesh),
                                    replicate_data(mesh, w), with_z=with_z,
                                    mesh=mesh)
            same(f"admm_update_sharded(with_z={with_z}) bf16 at P = {p}",
                 [torch.cat(x) for x in parts],
                 ops.admm_update(th, la, w, with_z=with_z))
        if ops.admm_update_sharded.launches != before + 2 * p:
            raise AssertionError(f"K2b bf16 at P = {p}: not one launch "
                                 "per shard")
    # K3a held over the whole state.
    for with_z in (True, False):
        for nn_, cc, dd, invalid, shift in (
                (n, c, d, (0, c - 1), False), (n, 7, d + 1, (3,), False),
                (12, 4, 2050, (1,), True)):
            st = [mk(nn_, dd) for _ in range(3)]
            s, ww = mk(cc, dd), mk(dd)
            ii, vv = plan(nn_, cc, invalid)
            want = ops.fused_gss_ref(ii, vv, s, ww,
                                     *[t.clone() for t in st],
                                     with_z=with_z)
            got = [t.clone() for t in st]
            if shift:
                got[0] = off_by_one(got[0])
            same(f"fused_gss(with_z={with_z}) bf16 at ({nn_}, {cc}, {dd})"
                 + (", θ 2 bytes off" if shift else ""),
                 ops.fused_gss(ii, vv, s, ww, *got, with_z=with_z), want)
    log("admm_update, admm_update_sharded, fused_gss in bf16 (K2a, K2b, "
        "K3a): the path launched K2 and K3 once each on bf16 operands; "
        f"bit-equal to the plain versions at {list(BF16_REF_SHAPES)}, "
        f"({n}, {d}) and (3, 7) with and without z and 2 bytes off, K2b "
        f"on 2 and 4 shards, K3a at ({n}, {c}, {d}) with slots 0 and "
        f"{c - 1} invalid, at D = {d + 1} and 2 bytes off")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timed = round_kernel_ms(ops, dev, gen, dtype=bf16)
    bw = peak_bandwidth(torch.cuda.get_device_name(0))
    rows = {
        "admm_update_bf16": dict(
            replaces="src/repro/kernels/admm_update.py:88",
            plain_ms=device_ms(lambda: ops.admm_update_ref(
                th, la, w, with_z=False), calls=PLAIN_CALLS),
            nflop=2 * n * d),
        "fused_gss_bf16": dict(
            replaces="src/repro/kernels/fused_gss.py:148",
            plain_ms=device_ms(lambda: ops.fused_gss_ref(
                idx, valid, solved, w, *state), calls=PLAIN_CALLS),
            nflop=3 * ROUND_VALID * d)}
    for name, r in rows.items():
        r.update(max_abs_err=0.0, library_ms=None, ms=timed[name]["cold"],
                 warm_ms=timed[name]["warm"], nbytes=timed[name]["bytes"])
        t_bytes = r["nbytes"] / bw * 1e3 if bw else None
        t_ops = r["nflop"] / PEAK_FP32_FLOPS * 1e3
        r["bound_ms"] = None if t_bytes is None else max(t_bytes, t_ops)
        r["bound_by"] = ("bytes" if t_bytes is None or t_bytes >= t_ops
                         else "operations")
        log(f"  {name}: ms {r['ms']:.4f} (cold)  warm_ms "
            f"{r['warm_ms']:.4f}  plain_ms {r['plain_ms']:.4f}  "
            f"library_ms null  bound_ms {r['bound_ms']} ({_share(r)}, "
            f"{r['bound_ms'] / r['warm_ms']:.1%} warm)  bytes "
            f"{r['nbytes']}")
    return rows, path


def check_roofline_tables(smi):
    """Phase 10b: the roofline model's by-card rates resolve for this
    card's name (none None); its H100 SXM constants printed beside the
    card's name and power limit."""
    from repro_torch.launch import roofline

    name = torch.cuda.get_device_name(0)
    peaks = roofline.card_peaks(name)
    missing = [k for k, v in peaks.items() if v is None]
    if missing:
        raise AssertionError(f"the roofline tables do not name {name!r}: "
                             f"{missing}")
    log(f"roofline: {name}: " + ", ".join(
        f"{k} {v:.4g}" for k, v in peaks.items()) + f"; the model's "
        f"constants PEAK_FLOPS {roofline.PEAK_FLOPS:.4g}, PEAK_TF32_FLOPS "
        f"{roofline.PEAK_TF32_FLOPS:.4g}, PEAK_FP32_FLOPS "
        f"{roofline.PEAK_FP32_FLOPS:.4g}, HBM_BW {roofline.HBM_BW:.4g}, "
        f"LINK_BW {roofline.LINK_BW:.4g}, PCIE_BW {roofline.PCIE_BW:.4g} "
        f"(H100 SXM data sheet) on {smi}")
    return peaks


def start_dryrun_sweep(out_dir):
    """Phase 10c, started: the full one-card dry-run (``--arch all
    --shape all --mesh both``) in a process of its own on the host's
    cores (it counts on the meta device and touches no card), its
    records under ``out_dir``."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return _child(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all",
         "--shape", "all", "--mesh", "card", "--card",
         torch.cuda.get_device_name(0), "--jobs", str(DRYRUN_JOBS),
         "--out", str(out_dir)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _child(*args, **kwargs):
    """A process this script starts (killed at its exit if it runs)."""
    proc = subprocess.Popen(*args, **kwargs)
    _CHILDREN.append(proc)
    return proc


# Phase 10c's mesh sweeps: three architectures (dense, hybrid, MoE),
# every shape, both of the reference's meshes, one process a --sharding
# mode, niced: started after phase 5k, they count on the host's cores
# beside phases 6–14 (the host-bound ones keep their cores) and are
# waited for in phase 15.
MESH_SWEEP_ARCHS = ("granite-3-2b", "zamba2-2.7b", "moonshot-v1-16b-a3b")
MESH_SWEEP_MODES = ("fsdp", "tp", "fsdp_tp")
MESH_SWEEP_JOBS = 2  # each mode's processes


def start_mesh_sweeps(out_dir):
    """Phase 10c's mesh sweeps, started (``--mesh both`` for each
    --sharding mode of MESH_SWEEP_MODES), their records under
    ``out_dir``/mode."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [_child(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         ",".join(MESH_SWEEP_ARCHS), "--shape", "all", "--mesh", "both",
         "--sharding", mode, "--card", torch.cuda.get_device_name(0),
         "--jobs", str(MESH_SWEEP_JOBS), "--out", str(out_dir / mode)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, preexec_fn=lambda: os.nice(19))
        for mode in MESH_SWEEP_MODES]


def finish_mesh_sweeps(procs, out_dir, t0):
    """Phase 10c's mesh sweeps, finished: each exit 0, one record per
    architecture × shape × mesh on the reference's meshes, none in error
    (only long_500k skipped: its batch of 1 does not split), each line
    printed."""
    from repro_torch.configs import INPUT_SHAPES

    report = {}
    for mode, proc in zip(MESH_SWEEP_MODES, procs, strict=True):
        out, _ = proc.communicate(timeout=900)
        for line in out.splitlines():
            log(f"dryrun {mode}: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"the {mode} mesh sweep exited "
                                 f"{proc.returncode}")
        records = [json.loads(p.read_text()) for p in sorted(
            (out_dir / mode).glob("*.json"))]
        status = [r["status"] for r in records]
        want = len(MESH_SWEEP_ARCHS) * len(INPUT_SHAPES) * 2
        if len(records) != want or "error" in status or any(
                r["status"] == "skipped" and r["shape"] != "long_500k"
                for r in records) or any(
                r["status"] == "ok" and (r["sharding_mode"] != mode
                                         or r["n_chips"] not in (256, 512))
                for r in records):
            raise AssertionError(f"the {mode} mesh sweep wrote "
                                 f"{len(records)} records, {status}")
        report[mode] = {"ok": status.count("ok"),
                        "skipped": status.count("skipped"),
                        "count_s": sum(r.get("count_s", 0)
                                       for r in records)}
    log(f"phase 10c's mesh sweeps: {report}, none in error, done "
        f"{time.perf_counter() - t0:.1f} s after they started")
    return report


def finish_dryrun_sweep(proc, out_dir, t0):
    """Phase 10c, finished: the sweep's exit code 0, its summarize lines
    printed, one record per architecture × shape × mesh and no error
    record."""
    out, _ = proc.communicate(timeout=600)
    for line in out.splitlines():
        log(f"dryrun: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the dry-run sweep exited {proc.returncode}")
    records = [json.loads(p.read_text()) for p in sorted(
        Path(out_dir).glob("*.json"))]
    status = [r["status"] for r in records]
    if len(records) != 80 or "error" in status:
        raise AssertionError(f"the dry-run wrote {len(records)} records, "
                             f"{status.count('error')} of them errors")
    log(f"phase 10c: {status.count('ok')} records counted, "
        f"{status.count('skipped')} skipped (the reference's reasons), "
        f"none in error, in {time.perf_counter() - t0:.1f} s")
    return {"ok": status.count("ok"), "skipped": status.count("skipped")}


def _load_example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def drive_examples():
    """Phase 10d: each example twin's ``main`` at a short setting on the
    card (no ``--device``: CUDA), its report checked: the quickstart's
    rate, the four algorithms of the federated-image example with a
    checkpoint of FedBack's round 2 resumed to its round-3 accuracy bit
    for bit, the served tokens, the sharded round's events equal to the
    single device's and the sweep's rates, the cross-pod rounds'
    finite losses."""
    import shutil

    reports = {}
    for name, argv in EXAMPLE_RUNS:
        t0 = time.perf_counter()
        rep = _load_example(name).main(argv)
        reports[name] = rep
        log(f"phase 10d: examples/{name}_torch.py {' '.join(argv)}: "
            f"{time.perf_counter() - t0:.1f} s")
    if not 0 < reports["quickstart"]["rate"] <= 1:
        raise AssertionError("quickstart: no participation")
    fi = reports["federated_image"]
    if [r["algorithm"] for r in fi] != ["fedback", "fedadmm", "fedavg",
                                        "fedprox"]:
        raise AssertionError("federated_image: not the four algorithms")
    ck = ROOT / "build" / "chip_smoke_examples"
    shutil.rmtree(ck, ignore_errors=True)
    mod = _load_example("federated_image")
    mod.main(["--rounds", "2", "--ckpt-dir", str(ck), "--ckpt-every", "1"])
    resumed = mod.main(["--rounds", "3", "--ckpt-dir", str(ck)])[0]
    shutil.rmtree(ck, ignore_errors=True)
    if resumed["start"] != 2 or resumed["accuracy"] != fi[0]["accuracy"]:
        raise AssertionError(f"federated_image: resumed from round "
                             f"{resumed['start']} to accuracy "
                             f"{resumed['accuracy']}, the straight run "
                             f"{fi[0]['accuracy']}")
    sv = reports["serve_lm"]
    if len(sv["tokens"]) != 8 or not sv["device"].startswith("cuda"):
        raise AssertionError("serve_lm: not 8 requests on the card")
    if not reports["sharded_sweep"]["events_equal"]:
        raise AssertionError("sharded_sweep: the mesh's events differ")
    if not all(math.isfinite(x)
               for x in reports["fedback_transformer"]["losses"]):
        raise AssertionError("fedback_transformer: a loss is not finite")
    log("phase 10d: federated_image's FedBack resumed from its round-2 "
        "checkpoint reached the straight run's round-3 accuracy "
        f"{resumed['accuracy']!r} bit for bit; sharded_sweep's events "
        f"equal (max |Δω| {reports['sharded_sweep']['omega_gap']:.2e})")
    return {name: {k: v for k, v in (rep if isinstance(rep, dict) else
                                     {"runs": rep}).items()
                   if k != "tokens"}
            for name, rep in reports.items()}


def check_system_claims(dev):
    """Phase 10e: tests/test_system.py's FedBack against FedADMM on the
    card, its configuration (``paper_mnist.ci_fl_config``: N = 16, 3360 /
    800 synthetic MNIST in label shards, L̄ = 0.25, 90 rounds, the tree
    layout): FedBack's accuracy above 0.85, its realized rate in [0.15,
    0.45], round 0 firing all 16, and its events to 0.93 printed beside
    FedADMM's with the final accuracies."""
    from repro_torch import prng
    from repro_torch.configs import paper_mnist
    from repro_torch.core import events_to_accuracy, init_state, \
        make_eval_fn, make_round_fn, realized_rate, run_evaluated
    from repro_torch.data import federated_arrays, make_synthetic_mnist
    from repro_torch.models import init_mlp, make_loss_and_acc_fn, \
        make_loss_fn

    n, target = paper_mnist.CI_CLIENTS, paper_mnist.CI_TARGET
    ds = make_synthetic_mnist(*paper_mnist.CI_SAMPLES)
    data, test = federated_arrays(ds, n_clients=n, scheme="label_shard",
                                  device=dev)
    params0 = init_mlp(prng.PRNGKey(0, device=dev), device=dev)
    eval_fn = make_eval_fn(make_loss_and_acc_fn(), device=dev)
    out = {}
    for alg in ("fedback", "fedadmm"):
        t0 = time.perf_counter()
        cfg = paper_mnist.ci_fl_config(alg)
        state = init_state(cfg, params0, device=dev)
        round_fn = make_round_fn(cfg, make_loss_fn(), data, device=dev)
        state, events, accs, _ = run_evaluated(
            round_fn, eval_fn, state, paper_mnist.CI_ROUNDS, test)
        out[alg] = dict(final_accuracy=accs[-1],
                        events_to_target=events_to_accuracy(events, accs,
                                                            target),
                        events=sum(events), first_round=events[0],
                        rate=float(realized_rate(state.ctrl).mean()),
                        seconds=time.perf_counter() - t0)
    fb = out["fedback"]
    if not (fb["final_accuracy"] > 0.85 and 0.15 <= fb["rate"] <= 0.45
            and fb["first_round"] == n
            and fb["events_to_target"] is not None):
        raise AssertionError(f"the paper's claims on the card: {out}")
    ratio = (fb["events_to_target"] / out["fedadmm"]["events_to_target"]
             if out["fedadmm"]["events_to_target"] else None)
    log(f"phase 10e: events to {target}: FedBack "
        f"{fb['events_to_target']}, FedADMM "
        f"{out['fedadmm']['events_to_target']} (ratio {ratio}, the claim "
        f"≤ 1.2); final accuracy FedBack {fb['final_accuracy']:.4f}, "
        f"FedADMM {out['fedadmm']['final_accuracy']:.4f}; FedBack's rate "
        f"{fb['rate']:.3f}")
    out["events_ratio"] = ratio
    return out


# Phase 11: granite-3-2b on a model mesh (slice 19).  11a: a 2-layer
# fp32 group on mesh (data 2, model 2) in both modes, against the
# unsharded port on the card and on the CPU; 11b: full size in bf16 in
# each (mode, mesh, K4's row) of MESH_SERVE.
MESH_GROUP = dict(layers=2, batch=2, mesh=(2, 2))
MESH_SERVE = (("tp", (1, 4), "flash_attention_tp4"),
              ("fsdp", (2, 2), "flash_attention_fsdp2"))
MESH_BF16_TOL = 2e-2  # prefill logits against the unsharded serve's
# zamba2's bf16 prefill is itself 0.060–0.067 of its largest logit from
# the fp32 prefill of the same weights (an H100 80GB HBM3 at 700 W), so two
# bf16 roundings of it (the unsharded and a mesh's) cannot agree to
# MESH_BF16_TOL: ``serve_on_meshes(anchor=True)`` holds each request's
# mesh prefill to ANCHOR_RATIO × the unsharded bf16 prefill's gap to
# fp32, and to CONSISTENCY_REL of the unsharded one.
ANCHOR_RATIO = 1.25


def timed_greedy(prefill, decode, steps):
    """Greedy on the card: ``prefill()`` → (logits, cache), then
    ``steps`` × ``decode(token, cache)``, each ending in a synchronize →
    (logits per step, tokens (B, steps + 1), prefill ms, decode ms a
    step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill()
    tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, toks = [logits], [tok]
    for _ in range(steps):
        logits, cache = decode(tok, cache)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(logits)
        toks.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return out, torch.cat(toks, 1), (t1 - t0) * 1e3, \
        (t2 - t1) * 1e3 / max(steps, 1)


def check_mesh_group(dev, ops, cfg):
    """Phase 11a: ``cfg`` (granite at every published width cut to
    MESH_GROUP's layers, fp32) served on a mesh of the card in fsdp and
    tp: MESH_GROUP's batch × SLICE_TOKENS, prefill and SLICE_DECODE
    greedy steps; the tokens equal and the logits within rtol/atol 1e-3
    of the unsharded port on the card and on the CPU; K4's 3xTF32
    instance once per data shard and layer (fsdp) or per model shard
    and layer (tp) in prefill, none in decode."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_mesh_serve_steps
    from repro_torch.launch.serve_lm import cache_len, make_request
    from repro_torch.models import build_model
    from repro_torch.sharding.params import shard_tree
    from repro_torch.sharding.specs import param_specs
    from repro_torch.utils.pytree import tree_map

    model = build_model(cfg)
    params = model.init(SEED, device=dev)
    request = make_request(cfg, MESH_GROUP["batch"], SLICE_TOKENS, SEED, dev)
    seq = cache_len(cfg, SLICE_TOKENS, SLICE_DECODE)
    card, card_tok = _greedy(model, params, request, SLICE_DECODE)
    cpu, cpu_tok = _greedy(model, tree_map(lambda x: x.cpu(), params),
                           {"tokens": request["tokens"].cpu()},
                           SLICE_DECODE)
    mesh = make_mesh(MESH_GROUP["mesh"])
    n_data, n_model = MESH_GROUP["mesh"]
    out, counts = {}, {}
    for mode, per_layer in (("fsdp", n_data), ("tp", n_data * n_model)):
        prefill, decode, _ = make_mesh_serve_steps(
            model, mesh, batch=MESH_GROUP["batch"], seq=seq, mode=mode)
        sharded = shard_tree(params, param_specs(params, mesh, mode=mode),
                             mesh)
        ops.reset_launch_counts()
        logits, cache = prefill(sharded, request)
        torch.cuda.synchronize()
        pre = path_counts(ops)
        got, tok, _, _ = timed_greedy(
            lambda: (logits, cache),
            lambda t, c: decode(sharded, t, c), SLICE_DECODE)
        counts[mode] = path_counts(ops)
        want = {"flash_attention_fp32": per_layer * cfg.num_layers,
                "flash_attention": 0, "ssd_scan": 0}
        if any(pre[k] != n or counts[mode][k] != n
               for k, n in want.items()):
            raise AssertionError(f"11a {mode}: prefill launched {pre}, "
                                 f"with decode {counts[mode]}; expected "
                                 f"{want} in prefill and none in decode")
        np.testing.assert_array_equal(tok.cpu().numpy(), cpu_tok.numpy(),
                                      err_msg=f"11a {mode}: tokens differ "
                                      "from the CPU's")
        np.testing.assert_array_equal(tok.cpu().numpy(),
                                      card_tok.cpu().numpy())
        err = dict(card=0.0, cpu=0.0)
        for g, c, w in zip(got, card, cpu, strict=True):
            torch.testing.assert_close(g, c, rtol=1e-3, atol=1e-3)
            torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-3)
            err["card"] = max(err["card"], float((g - c).abs().max()))
            err["cpu"] = max(err["cpu"], float((g.cpu() - w).abs().max()))
        out[mode] = dict(max_abs_err_vs_card=err["card"],
                         max_abs_err_vs_cpu=err["cpu"],
                         tokens=tok.cpu().tolist())
        log(f"11a {mode} on mesh {MESH_GROUP['mesh']} ({cfg.name} width, "
            f"{cfg.num_layers} layers, fp32, {MESH_GROUP['batch']} × "
            f"{SLICE_TOKENS} tokens + {SLICE_DECODE} decode steps): logits "
            f"max_abs_err {err['card']:.3e} against the unsharded port on "
            f"the card, {err['cpu']:.3e} against the CPU (rtol/atol 1e-3 "
            f"held), tokens equal; launches {counts[mode]}")
        del sharded, cache
    total = {k: counts["fsdp"][k] + counts["tp"][k] for k in counts["tp"]}
    return out, total


def _rel(got, want):
    """max |Δ| over max |want|, per request."""
    return ((got - want).abs().amax(dim=(1, 2))
            / want.abs().amax(dim=(1, 2))).cpu().tolist()


def _drops(plan) -> int:
    """Rows (token × k) a routing plan drops."""
    return int((~plan["keep"]).sum())


def hold_routing(label, want, got, mesh, top_k):
    """Each layer's routing on ``mesh`` (``got``: ``moe.routing``'s
    dicts in call order — data shard by data shard, layer by layer, the
    model shards in turn) against the unsharded prefill's (``want``, one
    a layer): a data shard's model shards route alike; a token whose
    expert set differs from the unsharded one must be a near tie there
    (its k-th and (k+1)-th probabilities within twice the token's
    largest probability gap); each layer's drops equal the unsharded
    ones but for 2k rows a token that changed experts (a moved row can
    keep one row and drop another) → per layer (drop share unsharded,
    on the mesh, tokens that changed experts)."""
    n_model = mesh.shape["model"]
    n_data, n = mesh.size // n_model, len(want)
    if len(got) != n_data * n * n_model:
        raise AssertionError(f"{label}: {len(got)} routings on the mesh, "
                             f"{n} layers × {mesh.size} shards")
    out = []
    for i, w in enumerate(want):
        parts = []
        for d in range(n_data):
            first = (d * n + i) * n_model
            shards = got[first:first + n_model]
            for p in shards[1:]:
                if not (torch.equal(p["eids"], shards[0]["eids"])
                        and torch.equal(p["keep"], shards[0]["keep"])):
                    raise AssertionError(f"{label} layer {i}: the model "
                                         "shards routed apart")
            parts.append(shards[0])
        g = {k: torch.cat([p[k] for p in parts]) for k in ("eids", "keep",
                                                            "probs")}
        ids_w = torch.sort(w["eids"], -1).values
        moved = (torch.sort(g["eids"], -1).values != ids_w).any(-1)
        top = torch.sort(w["probs"], -1, descending=True).values
        margin = top[..., top_k - 1] - top[..., top_k]
        gap = (g["probs"] - w["probs"]).abs().amax(-1)
        if bool((moved & (margin > 2 * gap)).any()):
            raise AssertionError(f"{label} layer {i}: a token changed "
                                 "experts away from a near tie")
        n_moved = int(moved.sum())
        if abs(_drops(g) - _drops(w)) > 2 * top_k * n_moved:
            raise AssertionError(f"{label} layer {i}: drops {_drops(g)}, "
                                 f"unsharded {_drops(w)}, {n_moved} tokens "
                                 "changed experts")
        rows = w["keep"].numel()
        out.append((_drops(w) / rows, _drops(g) / rows, n_moved))
    return out


@contextlib.contextmanager
def routing_plans():
    """Record every routing ``models.moe.routing`` makes — the unsharded
    MoE layer's and each model shard's under tp, fsdp_tp and ep — in
    call order."""
    from repro_torch.models import moe

    plans, routing = [], moe.routing

    def recorded(*args, **kw):
        plans.append(routing(*args, **kw))
        return plans[-1]

    moe.routing = recorded
    try:
        yield plans
    finally:
        moe.routing = routing


def serve_on_meshes(dev, ops, smi, cfg, label, meshes, plain_rows, expect,
                    new_tokens=SERVE_NEW, anchor=False):
    """Phases 11b, 13b and 13c: ``cfg`` in bf16 from the seeded init,
    SERVE_BATCH × SERVE_PROMPT prompt tokens and ``new_tokens`` new,
    first unsharded (K4 and K5 counted as the rows ``plain_rows``),
    then on each (mode, mesh shape, K4's row, K5's row) of ``meshes``
    (the visible cards, every shard on the one card where there is
    one): a warm-up prefill and decode step counting each collective
    kind's bytes, then a timed greedy run.  Checked: each coordinate's
    resident parameter bytes equal to ``per_device_bytes``; the
    launches of a prefill by row equal to ``expect(mode, mesh)``, none
    in decode; the prefill logits within rtol/atol MESH_BF16_TOL of the
    unsharded serve's — with ``anchor``, each request's largest gap to
    the fp32 prefill of the same weights within ANCHOR_RATIO × the
    unsharded bf16 prefill's and within CONSISTENCY_REL of its largest
    logit from the unsharded one — and each request's first token equal
    to it:
    strictly under fsdp, whose prefill runs the unsharded block on
    gathered layers; under tp, fsdp_tp and ep, whose partial sums round
    bf16 otherwise, unless the unsharded top-two margin is under twice
    the request's largest logit gap (a near tie, printed; at random init
    most requests are, so 11a's and 13a's fp32 tokens are the tp
    modes' token gate).  A MoE model's routing in the warm-up prefill
    is held to the unsharded one's (:func:`hold_routing`)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_decode_step, \
        make_mesh_serve_steps
    from repro_torch.launch.serve_lm import cache_len, make_request
    from repro_torch.models import abstract_params, build_model
    from repro_torch.sharding.clients import collectives
    from repro_torch.sharding.params import per_device_bytes, shard_tree, \
        tree_bytes_at
    from repro_torch.utils.pytree import tree_leaves, tree_map

    model = build_model(cfg)
    moe = cfg.family == "moe"
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    request = make_request(cfg, SERVE_BATCH, SERVE_PROMPT, SEED, dev)
    seq = cache_len(cfg, SERVE_PROMPT, new_tokens)
    steps = new_tokens - 1
    routed = contextlib.nullcontext([]) if not moe else routing_plans()

    def plain_prefill():
        return model.prefill(params, request, seq)

    def plain_decode(t, c):
        return model.decode_step(params, t, c)

    ops.reset_launch_counts()
    with routed as plans:
        timed_greedy(plain_prefill, plain_decode, 1)
        plain_routing = plans[:cfg.num_layers]
    torch.cuda.reset_peak_memory_stats(dev)
    want, want_tok, want_pre, want_dec = timed_greedy(
        plain_prefill, plain_decode, steps)
    counts = path_counts(ops, *plain_rows)
    total = torch.cuda.get_device_properties(dev).total_memory
    report = {"unsharded": dict(
        prefill_ms=want_pre, decode_ms_per_step=want_dec,
        decode_tok_per_s=SERVE_BATCH * steps / (want_dec * steps / 1e3),
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
        tokens_request0=want_tok[0].tolist(), init_s=init_s,
        parameter_bytes=sum(x.numel() * x.element_size()
                            for x in tree_leaves(params)))}
    log(f"{label} unsharded {cfg.name} ({cfg.num_layers} layers): prefill "
        f"{want_pre:.1f} ms, decode {want_dec:.2f} ms/step, peak "
        f"{report['unsharded']['peak_memory_bytes'] / 1e9:.2f} GB of "
        f"{total / 1e9:.2f}; init {init_s:.2f} s; on {smi}")
    host = tree_map(lambda x: x.cpu(), params)
    del params
    torch.cuda.empty_cache()
    ref = None
    if anchor:
        # the fp32 prefill of the same weights (K4's 3xTF32 instance and
        # K5 on fp32 states, counted in its rows)
        ops.reset_launch_counts()
        ref, _ = build_model(dataclasses.replace(cfg, dtype="float32")) \
            .prefill(tree_map(lambda x: x.to(dev, torch.float32), host),
                     request, seq)
        torch.cuda.synchronize()
        for k, n in path_counts(ops, ssd_row=plain_rows[1]).items():
            counts[k] += n
        plain_gap = (want[0] - ref).abs().amax(dim=(1, 2)).cpu().tolist()
        log(f"{label} unsharded bf16 prefill against fp32: largest gap a "
            f"request {plain_gap}, rel {_rel(want[0], ref)}")
        torch.cuda.empty_cache()
    p_abs = abstract_params(model)
    margin = want[0][:, -1].topk(2, dim=-1).values
    margin = (margin[:, 0] - margin[:, 1]).cpu().tolist()
    for mode, shape, row, ssd_row in meshes:
        mesh = make_mesh(shape)
        cards = sorted({str(d) for d in mesh.devices})
        prefill, decode, pargs = make_mesh_serve_steps(
            model, mesh, batch=SERVE_BATCH, seq=seq, mode=mode)
        specs = pargs.in_specs[0]
        sharded = shard_tree(host, specs, mesh)
        expect_bytes = per_device_bytes(p_abs, specs, mesh)
        resident = [tree_bytes_at(sharded, c) for c in mesh.coords()]
        if any(r != expect_bytes for r in resident):
            raise AssertionError(f"{label} {mode}: resident parameter "
                                 f"bytes {resident}, per_device_bytes "
                                 f"{expect_bytes}")
        moved, where = {"prefill": {}, "decode": {}}, ["prefill"]

        def count(kind, t):
            d = moved[where[0]]
            d[kind] = d.get(kind, 0) + t.numel() * t.element_size()

        ops.reset_launch_counts()
        listen = _but_the_worker(count)
        collectives.listeners.append(listen)
        try:
            with (routing_plans() if moe else contextlib.nullcontext(
                    [])) as plans:
                logits, cache = prefill(sharded, request)
            torch.cuda.synchronize()
            per_prefill = path_counts(ops, row, ssd_row)
            where[0] = "decode"
            token = logits[:, -1].argmax(-1)[:, None]
            decode(sharded, token, cache)
        finally:
            collectives.listeners.remove(listen)
        dargs = make_decode_step(model, mesh, batch=SERVE_BATCH, seq=seq,
                                 mode=mode)[1]
        args_resident = {
            "prefill": [resident, [tree_bytes_at(shard_tree(
                request, pargs.in_specs[1], mesh), c)
                for c in mesh.coords()]],
            "decode": [resident, [tree_bytes_at(shard_tree(
                token, dargs.in_specs[1], mesh), c)
                for c in mesh.coords()],
                [tree_bytes_at(cache, c) for c in mesh.coords()]]}
        del logits, cache, token, dargs
        drops = (hold_routing(f"{label} {mode}", plain_routing, plans, mesh,
                              cfg.top_k) if moe else None)
        del plans
        want_n = expect(mode, mesh)
        if any(per_prefill[k] != n for k, n in want_n.items()):
            raise AssertionError(f"{label} {mode}: launches a prefill "
                                 f"{per_prefill}, expected {want_n}")
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        got, tok, pre_ms, dec_ms = timed_greedy(
            lambda: prefill(sharded, request),
            lambda t, c: decode(sharded, t, c), steps)
        mode_counts = path_counts(ops, row, ssd_row)
        rows = (*SHAPE_ROWS, "flash_attention_fp32")
        if any(mode_counts[k] != 2 * want_n.get(k, 0) for k in rows):
            raise AssertionError(f"{label} {mode}: launches {mode_counts}, "
                                 f"expected {want_n} a prefill and none "
                                 "in decode")
        for k, n in mode_counts.items():
            counts[k] += n
        anchored = None
        if ref is None:
            torch.testing.assert_close(got[0], want[0], rtol=MESH_BF16_TOL,
                                       atol=MESH_BF16_TOL)
        else:
            anchored = (got[0] - ref).abs().amax(dim=(1, 2)).cpu().tolist()
            if any(a > ANCHOR_RATIO * p for a, p in zip(
                    anchored, plain_gap, strict=True)) or max(
                        _rel(got[0], want[0])) > CONSISTENCY_REL:
                raise AssertionError(
                    f"{label} {mode}: prefill logits' gap to fp32 "
                    f"{anchored} (the unsharded bf16's {plain_gap}, "
                    f"allowed ×{ANCHOR_RATIO}), rel to the unsharded "
                    f"{_rel(got[0], want[0])} (allowed {CONSISTENCY_REL})")
        gap = (got[0] - want[0]).abs().amax(dim=(1, 2)).cpu().tolist()
        first, want_first = tok[:, 0].tolist(), want_tok[:, 0].tolist()
        near = [r for r in range(SERVE_BATCH) if mode != "fsdp"
                and first[r] != want_first[r] and margin[r] <= 2 * gap[r]]
        if any(first[r] != want_first[r] and r not in near
               for r in range(SERVE_BATCH)):
            raise AssertionError(f"{label} {mode}: first tokens {first}, "
                                 f"the unsharded serve's {want_first} "
                                 f"(margins {margin}, gaps {gap})")
        equal = int((tok == want_tok).sum())
        report[f"{mode} {shape}"] = r = dict(
            cards=len(cards), prefill_ms=pre_ms, decode_ms_per_step=dec_ms,
            decode_tok_per_s=SERVE_BATCH * steps / (dec_ms * steps / 1e3),
            peak_memory_bytes={d: torch.cuda.max_memory_allocated(d)
                               for d in cards},
            card_memory_bytes=total, resident_parameter_bytes=resident,
            per_device_bytes=expect_bytes,
            collective_bytes_per_prefill=moved["prefill"],
            collective_bytes_per_decode_step=moved["decode"],
            resident_argument_bytes=args_resident,
            launches_per_prefill={k: per_prefill[k] for k in want_n},
            prefill_logits_max_abs_err=max(gap),
            prefill_logits_rel=_rel(got[0], want[0]),
            prefill_gap_to_fp32=anchored,
            unsharded_prefill_gap_to_fp32=plain_gap if anchor else None,
            first_tokens=first, unsharded_first_tokens=want_first,
            near_ties=near, unsharded_top2_margin=margin,
            tokens_equal=f"{equal} of {tok.numel()}",
            tokens_request0=tok[0].tolist(), drops_by_layer=drops)
        peaks = ", ".join(f"{d} {b / 1e9:.2f} GB"
                          for d, b in r["peak_memory_bytes"].items())
        gb = {k: {kind: n / 1e9 for kind, n in moved[k].items()}
              for k in moved}
        log(f"{label} {mode} on mesh {shape} over {len(cards)} card(s) "
            f"{cards}: prefill {pre_ms:.1f} ms (unsharded {want_pre:.1f}), "
            f"decode {dec_ms:.2f} ms/step (unsharded {want_dec:.2f}), "
            f"{r['decode_tok_per_s']:.1f} tok/s; peak memory {peaks} of "
            f"{total / 1e9:.2f} GB; resident parameter bytes per "
            f"coordinate {resident} (per_device_bytes {expect_bytes}); "
            f"collective GB per prefill {gb['prefill']}, per decode step "
            f"{gb['decode']}; launches a prefill "
            f"{r['launches_per_prefill']}; prefill logits max_abs_err "
            f"{max(gap):.3e}, rel {r['prefill_logits_rel']} ("
            + (f"gap to fp32 {anchored} against the unsharded bf16's "
               f"{plain_gap}, ×{ANCHOR_RATIO} and rel {CONSISTENCY_REL} "
               "held" if anchor else
               f"rtol/atol {MESH_BF16_TOL} held")
            + f"); first tokens {first} (unsharded "
            f"{want_first}, near ties {near}); tokens equal "
            f"{r['tokens_equal']}; on {smi}")
        if drops is not None:
            log(f"{label} {mode} drop share a layer, unsharded / mesh / "
                "tokens that changed experts: " + "; ".join(
                    f"{a:.4f} / {b:.4f} / {n}" for a, b, n in drops))
        del sharded
        torch.cuda.empty_cache()
    return report, counts


def serve_mesh_full(dev, ops, smi, cfg):
    """Phase 11b: ``cfg`` (granite-3-2b) at full size in bf16 on each
    (mode, mesh, K4's row) of MESH_SERVE (``serve_on_meshes``): K4's
    launches a prefill per model shard and layer under tp, per data
    shard and layer under fsdp."""
    def expect(mode, mesh):
        n_data = mesh.size // mesh.shape["model"]
        row = dict((m, r) for m, _, r in MESH_SERVE)[mode]
        return {row: n_data * (mesh.shape["model"] if mode == "tp" else 1)
                * cfg.num_layers}

    return serve_on_meshes(
        dev, ops, smi, cfg, "11b",
        [(mode, shape, row, "ssd_scan") for mode, shape, row in MESH_SERVE],
        ("flash_attention_gqa", "ssd_scan"), expect)


def phase11(dev, ops, smi, granite):
    """Phases 11a and 11b → (report, launches of 11a, of 11b)."""
    t0 = t1 = time.perf_counter()
    group, counts_a = check_mesh_group(dev, ops, dataclasses.replace(
        granite, num_layers=MESH_GROUP["layers"], dtype="float32"))
    torch.cuda.empty_cache()
    log(f"phase 11a took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    serve, counts_b = serve_mesh_full(dev, ops, smi, granite)
    log(f"phase 11b took {time.perf_counter() - t1:.1f} s; phases 11a–11b "
        f"{time.perf_counter() - t0:.1f} s")
    log(json.dumps({"model_mesh": {"group": group, "serve": serve},
                    "card": smi}))
    return counts_a, counts_b


# Phase 12: the cross-pod trainer on a pod × data × model mesh (slice
# 20), every coordinate on the card.  12a: a 2-layer fp32 cut at full
# width against the CPU and the one-device round, and the mesh training
# step against the unsharded; 12b: full size in bf16 at 7b's batch.
POD_AXES = ("pod", "data", "model")
POD_MESH = (2, 2, 2)
POD_GROUP = dict(layers=2, batch=2, seq=64, rounds=2)
POD_TRAIN = dict(batch=4, seq=64, rho=1e-2, lr=1e-3, mesh=(2, 2))
POD_FULL = dict(rounds=3, profiled=1)  # after a warm-up round (round 0)


def _state_leaves(state):
    from repro_torch.utils.pytree import tree_leaves

    return [x for f in ("theta", "lam", "z_prev")
            for x in tree_leaves(getattr(state, f))]


def check_pod_mesh_group(dev, ops, cfg):
    """Phase 12a → a callable that holds the rounds against the CPU's
    mesh rounds (run on the :func:`background` worker meanwhile) and
    returns the report."""
    from repro_torch.core.crosspod import init_cross_pod_state
    from repro_torch.launch.mesh import make_mesh, make_test_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adam import adam_init
    from repro_torch.sharding.params import gather_tree, shard_tree
    from repro_torch.sharding.train import cross_pod_batch_specs, \
        init_cross_pod_state_on_mesh, make_cross_pod_round_on_mesh
    from repro_torch.utils.pytree import tree_leaves, tree_map

    cp, model, round_one = _crosspod_round(cfg)
    mesh = make_mesh(POD_MESH, POD_AXES)
    cpu_mesh = make_test_mesh(POD_MESH, POD_AXES)
    round_card = make_cross_pod_round_on_mesh(cp, model, mesh)
    round_cpu = make_cross_pod_round_on_mesh(cp, model, cpu_mesh)
    params0 = model.init(SEED, device=dev)
    state = init_cross_pod_state_on_mesh(cp, params0, mesh)
    batches = _crosspod_batches(cfg, cp, POD_GROUP["batch"],
                                POD_GROUP["seq"])
    ops.reset_launch_counts()
    rounds, held = [], []
    for r in range(POD_GROUP["rounds"]):
        batch = next(batches)
        bspec = cross_pod_batch_specs(batch)
        if r == 0:
            # The first state is params0's (init_cross_pod_state_on_mesh):
            # the one-device and the CPU's are made from params0 (a copy
            # of one replica for the CPU), the same values, without the
            # whole state's round trip through the host.
            one_before = init_cross_pod_state(cp, params0, device=dev)
            cpu_before = init_cross_pod_state_on_mesh(
                cp, tree_map(lambda x: x.cpu(), params0), cpu_mesh)
            del params0
        else:
            one_before = _cross_pod_to(whole, dev)
            cpu_before = shard_tree(whole, state.specs, cpu_mesh)
            del whole
        cpu = background().submit(round_cpu, cpu_before, shard_tree(
            batch, bspec, cpu_mesh))
        del cpu_before
        t0 = time.perf_counter()
        state, m = round_card(state, shard_tree(batch, bspec, mesh))
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        one, m1 = round_one(one_before, batch)
        where = f"12a round {r}"
        np.testing.assert_array_equal(
            m.events.cpu().numpy(), m1.events.cpu().numpy(),
            err_msg=f"{where}: events against the one-device round")
        torch.testing.assert_close(m.distances.cpu(), m1.distances.cpu(),
                                   rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(m.train_loss.cpu(), m1.train_loss.cpu(),
                                   rtol=1e-5, atol=0)
        gap_one = _held_on_card(dev, _state_leaves(gather_tree(state)),
                                _state_leaves(one), where,
                                "state against the one-device round")
        del one, one_before
        # the card's state after the round, kept on the host for the
        # CPU's round (and the next round's start)
        whole = gather_tree(state, device="cpu")
        held.append((where, m, m1, whole, cpu, card_ms, gap_one))
    del state, whole

    def hold():
        for where, m, m1, got, cpu, card_ms, gap_one in held:
            t0 = time.perf_counter()
            want, wm = cpu.result()
            wait_s = time.perf_counter() - t0
            np.testing.assert_array_equal(
                m.events.cpu().numpy(), wm.events.cpu().numpy(),
                err_msg=f"{where}: events against the CPU's mesh round")
            torch.testing.assert_close(m.distances.cpu(), wm.distances.cpu(),
                                       rtol=1e-5, atol=1e-7)
            torch.testing.assert_close(m.train_loss.cpu(),
                                       wm.train_loss.cpu(), rtol=1e-5,
                                       atol=0)
            gap_cpu = _held_on_card(dev, _state_leaves(got),
                                    _state_leaves(gather_tree(want)), where,
                                    "state against the CPU's mesh round")
            rounds.append(dict(events=m.events.tolist(),
                               train_loss=float(m.train_loss),
                               max_abs_err_vs_cpu=gap_cpu,
                               max_abs_err_vs_one_device=gap_one,
                               card_ms=card_ms, cpu_wait_s=wait_s))
            log(f"{where} ({cfg.name} width, {cfg.num_layers} layers, fp32, "
                f"mesh {POD_MESH}): events {m.events.tolist()} equal to the "
                f"CPU's mesh round and the one-device round's; train_loss "
                f"{float(m.train_loss):.6f} (CPU {float(wm.train_loss):.6f}, "
                f"one device {float(m1.train_loss):.6f}); state max_abs_err "
                f"{gap_cpu:.3e} against the CPU, {gap_one:.3e} against one "
                f"device (rtol 1e-4 / atol 1e-6 held); card {card_ms:.1f} ms, "
                f"the wait for the worker's CPU round {wait_s:.1f} s")
            del want, got
        held.clear()
        return dict(rounds=rounds, train_step=train_step)

    params = model.init(SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    center = tree_map(lambda x: x + 0.01 * torch.randn(
        x.shape, generator=gen, device=dev, dtype=x.dtype), params)
    batch = {k: v.to(dev) for k, v in _train_batch(
        cfg, POD_TRAIN["batch"], POD_TRAIN["seq"]).items()}
    kw = dict(batch=POD_TRAIN["batch"], seq=POD_TRAIN["seq"],
              rho=POD_TRAIN["rho"], lr=POD_TRAIN["lr"])
    step, _ = make_train_step(model, **kw)
    want_p, want_o, want_loss = step(params, adam_init(params), center,
                                     batch)
    tmesh = make_mesh(POD_TRAIN["mesh"])
    mstep, args = make_train_step(model, tmesh, **kw)
    t0 = time.perf_counter()
    p, o, loss = mstep(*(shard_tree(x, sp, tmesh) for x, sp in zip(
        (params, adam_init(params), center, batch), args.in_specs,
        strict=True)))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    p, o = gather_tree(p), gather_tree(o)
    mu_gap = _held_on_card(dev, tree_leaves(o.mu), tree_leaves(want_o.mu),
                           "12a train step", "first moment")
    p_gap = 0.0
    for g, w, mu in zip(tree_leaves(p), tree_leaves(want_p),
                        tree_leaves(want_o.mu), strict=True):
        firm = mu.abs() > 1e-7
        diff = (g - w).abs()
        if bool((diff[firm] > SOLVE_TOL["atol"]
                 + SOLVE_TOL["rtol"] * w[firm].abs()).any()) or float(
                     diff.max()) > POD_TRAIN["lr"] * 1.0001:
            raise AssertionError("12a train step: parameters off the "
                                 "unsharded step's")
        if bool(firm.any()):
            p_gap = max(p_gap, float(diff[firm].max()))
    if any(ops.launch_counts().values()):
        raise AssertionError(f"12a launched {ops.launch_counts()}")
    log(f"12a train step on mesh {POD_TRAIN['mesh']} ({POD_TRAIN['batch']} "
        f"× {POD_TRAIN['seq']} tokens, fp32): loss {float(loss):.6f} "
        f"(unsharded {float(want_loss):.6f}), first moment max_abs_err "
        f"{mu_gap:.3e}, parameters {p_gap:.3e} where the gradient is firm "
        f"(rtol 1e-4 / atol 1e-6 held); {step_ms:.1f} ms")
    train_step = dict(
        loss=float(loss), unsharded_loss=float(want_loss),
        mu_max_abs_err=mu_gap, param_max_abs_err_firm=p_gap, ms=step_ms)
    return hold


def drive_pod_mesh_full(dev, ops, smi, cfg, unsharded):
    """Phase 12b → its report; ``unsharded`` is phase 7b's."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_cross_pod_step
    from repro_torch.sharding.clients import collectives
    from repro_torch.sharding.params import per_device_bytes, shard_tree, \
        tree_bytes_at
    from repro_torch.sharding.train import init_cross_pod_state_on_mesh, \
        make_cross_pod_round_on_mesh
    from repro_torch.utils.pytree import tree_leaves

    cp, model, _ = _crosspod_round(cfg)
    mesh = make_mesh(POD_MESH, POD_AXES)
    per_step = GRANITE_B["batch"]
    _, args = make_cross_pod_step(
        model, mesh, batch=per_step * cp.n_pods * cp.local_steps,
        seq=GRANITE_B["seq"], local_steps=cp.local_steps)
    round_fn = make_cross_pod_round_on_mesh(cp, model, mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = init_cross_pod_state_on_mesh(cp, model.init(SEED, device=dev),
                                         mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    if state.specs != args.in_specs[0]:
        raise AssertionError("12b: the state is not cut by the step's "
                             "in_specs")
    expect = per_device_bytes(args[0], args.in_specs[0], mesh)
    resident = [tree_bytes_at(state, c) for c in mesh.coords()]
    if any(b != expect for b in resident):
        raise AssertionError(f"12b: resident state bytes {resident}, "
                             f"per_device_bytes {expect}")
    batches = _crosspod_batches(cfg, cp, per_step, GRANITE_B["seq"])
    moved: list = []

    def count(kind, t):
        moved[-1][kind] = moved[-1].get(kind, 0) \
            + t.numel() * t.element_size()

    ops.reset_launch_counts()
    ms, events, losses, fired = [], [], [], set()
    batch_bytes = None
    listen = _but_the_worker(count)
    collectives.listeners.append(listen)
    try:
        for r in range(1 + POD_FULL["rounds"]):
            batch = next(batches)
            moved.append({})
            prof = None
            if r == POD_FULL["profiled"]:
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            sharded_batch = shard_tree(batch, args.in_specs[1], mesh)
            if batch_bytes is None:
                batch_bytes = [tree_bytes_at(sharded_batch, c)
                               for c in mesh.coords()]
            state, m = round_fn(state, sharded_batch)
            del sharded_batch
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if prof is not None:
                prof.__exit__(None, None, None)
                profiled = _round_profile(prof, ms[-1])
            events.append(m.events.tolist())
            losses.append(float(m.train_loss))
            fired |= {i for i, e in enumerate(events[-1]) if e}
    finally:
        collectives.listeners.remove(listen)
    peak = torch.cuda.max_memory_allocated(dev)
    if events[0] != [True] * cp.n_pods:
        raise AssertionError(f"12b: round 0 fired {events[0]}")
    if any(ops.launch_counts().values()):
        raise AssertionError(f"12b launched {ops.launch_counts()}")
    for b in state.blocks:
        if not all(bool(torch.isfinite(x).all()) for x in _state_leaves(b)):
            raise AssertionError("12b: a state leaf holds a value not "
                                 "finite")
    for c in mesh.coords():
        if c[0] not in fired:
            continue
        b = state.at(c)
        for t, lm, z in zip(tree_leaves(b.theta), tree_leaves(b.lam),
                            tree_leaves(b.z_prev), strict=True):
            if not torch.equal(z, t + lm):
                raise AssertionError(f"12b: pod {c[0]}'s z_prev at {c} is "
                                     "not θ + λ")
    both = [t for i, (t, e) in enumerate(zip(ms, events, strict=True))
            if i not in (0, POD_FULL["profiled"]) and all(e)]
    gb = [{k: v / 1e9 for k, v in d.items()} for d in moved]
    total = torch.cuda.get_device_properties(dev).total_memory
    report = dict(
        arch=cfg.name, dtype=cfg.dtype, mesh=POD_MESH, pods=cp.n_pods,
        local_steps=cp.local_steps, tokens_per_step=per_step
        * GRANITE_B["seq"], events=events, train_loss=losses,
        ms_per_round=ms, ms_per_round_both_fired=statistics.median(both)
        if both else None, gb_per_round_by_kind=gb,
        bytes_per_round_by_kind=moved,
        resident_argument_bytes=[resident, batch_bytes],
        profiled_round=dict(profiled, index=POD_FULL["profiled"]),
        unsharded_ms_per_round_both_fired=unsharded[
            "ms_per_round_both_fired"] if unsharded else None,
        peak_memory_bytes=peak, card_memory_bytes=total,
        resident_state_bytes=resident, per_device_bytes=expect,
        init_s=init_s, card=smi)
    gb_s = [{k: round(v, 3) for k, v in d.items()} for d in gb]
    log(f"12b {cfg.name} cross-pod on mesh {POD_MESH}, bf16, P = "
        f"{cp.n_pods}, {cp.local_steps} local steps of {per_step} × "
        f"{GRANITE_B['seq']} tokens: events {events}, train_loss {losses}; "
        f"ms/round {[round(x, 1) for x in ms]} (round 0 the warm-up, round "
        f"{POD_FULL['profiled']} under torch.profiler; median of the others "
        f"that fired both pods {report['ms_per_round_both_fired']}; 7b's "
        f"unsharded round in this run "
        f"{report['unsharded_ms_per_round_both_fired']}); GB a round by "
        f"kind {gb_s}; peak {peak / 1e9:.2f} GB of the card's "
        f"{total / 1e9:.2f} GB; resident state bytes a coordinate "
        f"{resident[0]} = per_device_bytes; init {init_s:.2f} s; on {smi}")
    log(f"12b profiled round {POD_FULL['profiled']} (events "
        f"{events[POD_FULL['profiled']]}): {profiled}")
    del state
    torch.cuda.empty_cache()
    return report


def phase12(dev, ops, smi, granite, unsharded):
    """Phases 12a and 12b; ``unsharded`` is phase 7b's report → (a
    callable that holds 12a's rounds against the CPU's mesh rounds (on
    the :func:`background` worker beside 12b and what follows) and logs
    the phase's report, 12b's report)."""
    t0 = t1 = time.perf_counter()
    hold = check_pod_mesh_group(dev, ops, dataclasses.replace(
        granite, num_layers=POD_GROUP["layers"], dtype="float32"))
    torch.cuda.empty_cache()
    log(f"phase 12a took {time.perf_counter() - t1:.1f} s on the card "
        "(its CPU rounds on the worker)")
    t1 = time.perf_counter()
    full = drive_pod_mesh_full(dev, ops, smi, granite, unsharded)
    log(f"phase 12b took {time.perf_counter() - t1:.1f} s; phases 12a–12b "
        f"{time.perf_counter() - t0:.1f} s")

    def finish():
        t0 = time.perf_counter()
        group = hold()
        log(f"phase 12a's CPU rounds held in {time.perf_counter() - t0:.1f}"
            " s")
        log(json.dumps({"pod_mesh": {"group": group, "full": full},
                        "card": smi}))

    return finish, full


# Phase 13: tensor-parallel serving for every family (slice 21), every
# model coordinate on the card (placement, the shards' kernels and the
# copies' bytes, not a link).  13a: fp32 cuts at every published width,
# TP_CUT's batch × prompt + decode steps, each family on TP_CUT_MESHES
# (moonshot also under ep), against the unsharded port on the card
# (TP_TOL) and that against the CPU (1e-3); 13b: zamba2-2.7b whole in
# bf16 on (1, 4) under tp; 13c: moonshot at full width cut to
# TP_MOON["layers"] layers, bf16, tp and ep on (1, 4).
TP_CUT = dict(batch=2, prompt=64, decode=4)
TP_CUT_MESHES = (("tp", (1, 4)), ("fsdp_tp", (2, 2)))
# (architecture, layers, K5's row, the modes beyond TP_CUT_MESHES)
TP_CUTS = (("moonshot-v1-16b-a3b", 2, "ssd_scan", (("ep", (1, 4)),)),
           ("mamba2-2.7b", 2, "ssd_scan_mamba2", ()),
           ("zamba2-2.7b", 6, "ssd_scan", ()),
           ("paligemma-3b", 2, "ssd_scan", ()))
TP_TOL = 2e-4  # fp32 logits, mesh against the unsharded port on the card
TP_ZAMBA = dict(mesh=(1, 4), new=32)
TP_MOON = dict(layers=4, new=8, meshes=(("tp", (1, 4)), ("ep", (1, 4))))


def prefill_launches(cfg, shards):
    """K4's and K5's launches in a prefill of ``cfg`` on ``shards``
    model shards in all (data × model): each attention layer under the
    causal mask (the vlm's prefix mask runs no kernel) and each mamba
    layer, once a shard → (K4, K5)."""
    attn = {"vlm": 0, "ssm": 0, "hybrid": cfg.num_layers // max(
        cfg.attn_every, 1)}.get(cfg.family, cfg.num_layers)
    ssm = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    return shards * attn, shards * ssm


def check_tp_cuts(dev, ops):
    """Phase 13a → (report, launches by row)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_mesh_serve_steps
    from repro_torch.launch.serve_lm import cache_len, make_request
    from repro_torch.models import abstract_params, build_model
    from repro_torch.sharding.params import per_device_bytes, shard_tree, \
        tree_bytes_at
    from repro_torch.utils.pytree import tree_map

    report, total = {}, {}
    b, prompt, steps = TP_CUT["batch"], TP_CUT["prompt"], TP_CUT["decode"]
    for arch, layers, ssd_row, more in TP_CUTS:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype="float32")
        model = build_model(cfg)
        params = model.init(SEED, device=dev)
        request = make_request(cfg, b, prompt, SEED, dev)
        moe = cfg.family == "moe"
        with (routing_plans() if moe else contextlib.nullcontext(
                [])) as plans:
            card, card_tok = _greedy(model, params, request, steps)
            plain_routing = plans[:layers]
        cpu, cpu_tok = _greedy(model, tree_map(lambda x: x.cpu(), params),
                               {k: v.cpu() for k, v in request.items()},
                               steps)
        np.testing.assert_array_equal(card_tok.cpu().numpy(), cpu_tok.numpy(),
                                      err_msg=f"13a {arch}: tokens differ "
                                      "from the CPU's")
        cpu_err = 0.0
        for g, w in zip(card, cpu, strict=True):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-3)
            cpu_err = max(cpu_err, float((g.cpu() - w).abs().max()))
        del cpu
        seq = cache_len(cfg, prompt, steps)
        p_abs = abstract_params(model)
        out = dict(unsharded_vs_cpu_max_abs_err=cpu_err,
                   tokens=card_tok.cpu().tolist())
        for mode, shape in TP_CUT_MESHES + more:
            mesh = make_mesh(shape)
            prefill, decode, pargs = make_mesh_serve_steps(
                model, mesh, batch=b, seq=seq, mode=mode)
            sharded = shard_tree(params, pargs.in_specs[0], mesh)
            expect_bytes = per_device_bytes(p_abs, pargs.in_specs[0], mesh)
            resident = [tree_bytes_at(sharded, c) for c in mesh.coords()]
            if any(r != expect_bytes for r in resident):
                raise AssertionError(f"13a {arch} {mode}: resident bytes "
                                     f"{resident}, per_device_bytes "
                                     f"{expect_bytes}")
            ops.reset_launch_counts()
            with (routing_plans() if moe else contextlib.nullcontext(
                    [])) as plans:
                logits, cache = prefill(sharded, request)
            torch.cuda.synchronize()
            pre = path_counts(ops, ssd_row=ssd_row)
            got, tok, _, _ = timed_greedy(
                lambda: (logits, cache),
                lambda t, c: decode(sharded, t, c), steps)
            counts = path_counts(ops, ssd_row=ssd_row)
            k4, k5 = prefill_launches(cfg, mesh.size)
            want = {"flash_attention_fp32": k4, ssd_row: k5,
                    "flash_attention": 0}
            if any(pre[k] != n or counts[k] != n for k, n in want.items()):
                raise AssertionError(f"13a {arch} {mode}: prefill launched "
                                     f"{pre}, with decode {counts}; "
                                     f"expected {want} in prefill and none "
                                     "in decode")
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            if moe:
                # fp32: the mesh's router input is the unsharded one's to
                # ~1e-6, so no token changes experts and every layer's
                # drops are the unsharded ones
                drops = hold_routing(f"13a {arch} {mode}", plain_routing,
                                     plans, mesh, cfg.top_k)
                if any(n for _, _, n in drops):
                    raise AssertionError(f"13a {arch} {mode}: tokens "
                                         f"changed experts: {drops}")
            np.testing.assert_array_equal(
                tok.cpu().numpy(), card_tok.cpu().numpy(),
                err_msg=f"13a {arch} {mode}: tokens differ from the "
                "unsharded port's")
            err = 0.0
            for g, w in zip(got, card, strict=True):
                torch.testing.assert_close(g, w, rtol=TP_TOL, atol=TP_TOL)
                err = max(err, float((g - w).abs().max()))
            out[f"{mode} {shape}"] = dict(
                max_abs_err_vs_unsharded=err,
                launches_per_prefill={k: pre[k] for k in want},
                drops_by_layer=drops if moe else None)
            log(f"13a {arch} ({layers} layers at full width, fp32, {b} × "
                f"{prompt} tokens + {steps} decode steps) {mode} on mesh "
                f"{shape}: logits max_abs_err {err:.3e} against the "
                f"unsharded port on the card (rtol/atol {TP_TOL} held), "
                f"tokens equal; launches a prefill "
                f"{out[f'{mode} {shape}']['launches_per_prefill']}, none in "
                f"decode; resident bytes {resident[0]} = per_device_bytes"
                + (f"; drops a layer {[round(a, 4) for a, _, _ in drops]} "
                   "equal" if moe else ""))
            del sharded, cache, logits, plans
        log(f"13a {arch}: the unsharded port on the card against the CPU: "
            f"logits max_abs_err {cpu_err:.3e} (rtol/atol 1e-3 held), "
            "tokens equal")
        report[arch] = out
        del params, card
        torch.cuda.empty_cache()
    return report, total


def phase13(dev, ops, smi):
    """Phases 13a–13c → (launches by row, 13b's report)."""
    from repro_torch.configs import get_config

    t0 = t1 = time.perf_counter()
    cuts, counts = check_tp_cuts(dev, ops)
    torch.cuda.empty_cache()
    log(f"phase 13a took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    zamba = get_config("zamba2-2.7b")

    def expect(mode, mesh):
        k4, k5 = prefill_launches(zamba, mesh.size)
        return {"flash_attention_zamba2_tp4": k4, "ssd_scan_zamba2_tp4": k5}

    zamba_report, zamba_counts = serve_on_meshes(
        dev, ops, smi, zamba, "13b", [("tp", TP_ZAMBA["mesh"],
                                       "flash_attention_zamba2_tp4",
                                       "ssd_scan_zamba2_tp4")],
        ("flash_attention", "ssd_scan"), expect, new_tokens=TP_ZAMBA["new"],
        anchor=True)
    torch.cuda.empty_cache()
    log(f"phase 13b took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    moon = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                               num_layers=TP_MOON["layers"])

    def expect_moon(mode, mesh):
        return {"flash_attention_moonshot_tp4":
                prefill_launches(moon, mesh.size)[0]}

    moon_report, moon_counts = serve_on_meshes(
        dev, ops, smi, moon, "13c", [
            (mode, shape, "flash_attention_moonshot_tp4", "ssd_scan")
            for mode, shape in TP_MOON["meshes"]],
        ("flash_attention_moonshot", "ssd_scan"), expect_moon,
        new_tokens=TP_MOON["new"])
    torch.cuda.empty_cache()
    log(f"phase 13c took {time.perf_counter() - t1:.1f} s; phases 13a–13c "
        f"{time.perf_counter() - t0:.1f} s")
    log(json.dumps({"tp_serving": {"cuts": cuts, "zamba2": zamba_report,
                                   "moonshot_cut": moon_report},
                    "card": smi}))
    for part in (zamba_counts, moon_counts):
        for k, n in part.items():
            counts[k] = counts.get(k, 0) + n
    return counts, zamba_report


# Phase 14: tensor-parallel training for every family and the MoE on a
# data axis above 1 (slice 22), every model coordinate on the card (the
# placement, the gradients and the copies' bytes, not a link).  14a: fp32
# cuts at every published width, each family's ``make_train_step`` on
# TRAIN_CUT_MESHES (moonshot also ep and fsdp) against the unsharded
# step on the card, and one cross-pod round of each of TRAIN_PODS
# against the one-device round; 14b: granite-3-2b whole in bf16; 14c:
# moonshot at full width cut to TRAIN_MOON["layers"] layers, bf16.
TRAIN_CUT = dict(batch=2, text=64, rho=1e-2, lr=1e-3)
TRAIN_CUT_MESHES = (("tp", (1, 4)), ("fsdp_tp", (2, 2)))
# (architecture, layers, the modes beyond TRAIN_CUT_MESHES)
TRAIN_CUTS = (("granite-3-2b", 2, ()), ("mamba2-2.7b", 2, ()),
              ("zamba2-2.7b", 6, ()),
              ("moonshot-v1-16b-a3b", 2, (("ep", (1, 4)), ("fsdp", (2, 2)))),
              ("paligemma-3b", 2, ()), ("hubert-xlarge", 2, ()))
TRAIN_TOL = dict(rtol=1e-4, atol=1e-7)  # μ; the parameters where firm
# A parameter's first Adam step is firm where |μ| > TRAIN_FIRM: ten times
# μ's atol, so that the gradient's sign cannot turn within μ's grade.
TRAIN_FIRM = 1e-6
# One cross-pod round each, (architecture, its cut, mode, mesh).  The
# reference's rule cuts the embedding and the head over the model axis
# only, so a data axis of 2 holds them twice: moonshot's fp32 state of 2
# pods at its 163,840-token vocabulary is 6 × 7.65 GB at one layer, past
# one card with the round's working set.  Its MoE round keeps every
# other width (d 2048, 16 heads, 64 experts of 1,408, top 6) and cuts the
# vocabulary to 32,768 and the depth to one layer (6 × 3.4 GB).
TRAIN_PODS = (("moonshot-v1-16b-a3b", dict(num_layers=1, vocab_size=32768),
               "fsdp", (2, 2, 1)),
              ("granite-3-2b", dict(num_layers=2), "tp", (2, 1, 2)))
TRAIN_FULL = dict(batch=2, text=2048, lr=1e-3)
TRAIN_GRANITE = (("tp", (1, 4)), ("fsdp_tp", (2, 2)))
TRAIN_MOON = dict(layers=2, meshes=(("fsdp", (2, 2)), ("ep", (1, 4))))
TRAIN_LOSS_REL = 1e-2  # bf16: the mesh step's loss against the unsharded
# bf16: each leaf's ‖μ_mesh − μ‖ / ‖μ‖ against the unsharded step's μ; a
# leaf past it must be as close to the fp32 step's μ as the unsharded
# step's is (within ANCHOR_RATIO of its gap) — PERF.md §6
TRAIN_BF16_REL = 3e-2


def _free():
    """Collect the cycles that hold tensors (autograd graphs under
    checkpoint, closures), then give the cache's free blocks back."""
    gc.collect()
    torch.cuda.empty_cache()


def _step_batch(cfg, batch, text):
    """A training batch on the CPU, made with numpy from the seed, and
    the step's ``seq``: ``text`` next-token pairs (after the vlm's
    prefix patches, which ``seq`` counts), or the audio family's
    frames."""
    from repro_torch.launch.serve_lm import make_request

    if cfg.family == "vlm":
        req = make_request(cfg, batch, text + 1, SEED, "cpu")
        return {"tokens": req["tokens"][:, :-1],
                "labels": req["tokens"][:, 1:],
                "patches": req["patches"]}, cfg.prefix_tokens + text
    return _train_batch(cfg, batch, text), text


# Phase 14's host copies are cut from one pinned buffer (a bump
# allocator, emptied between models): pinned, they go back to the card
# at the link's rate (pageable copies ran at ~3 GB/s here), and one
# buffer keeps the host's locked memory at its size (the pinned cache
# rounds each block up to a power of two and keeps it).
TRAIN_PINNED_BYTES = 30 * 2 ** 30
_PINNED = []


def _pinned(reset=False):
    """The pinned buffer and its fill, [buffer, bytes used], made at
    first use; ``reset`` empties it."""
    if reset:
        for slot in _PINNED:
            slot[1] = 0
        return None
    if not _PINNED:
        _PINNED.append([torch.empty(TRAIN_PINNED_BYTES, dtype=torch.uint8,
                                    pin_memory=True), 0])
    return _PINNED[0]


def _to(tree, device):
    """Each leaf of a tree (or a list) on ``device``; on the host, a copy
    in the pinned buffer (:func:`_pinned`)."""
    from repro_torch.utils.pytree import tree_map

    def one(x):
        if torch.device(device).type != "cpu" or \
                not torch.cuda.is_available():
            return x.to(device)
        slot = _pinned()
        start = -(-slot[1] // 256) * 256
        n = x.numel() * x.element_size()
        if start + n > slot[0].numel():
            raise AssertionError(f"the pinned buffer holds "
                                 f"{slot[0].numel()} bytes; {start + n} "
                                 "asked")
        slot[1] = start + n
        return slot[0][start:start + n].view(x.dtype).view(x.shape).copy_(x)

    if isinstance(tree, list):
        return [one(x) for x in tree]
    return tree_map(one, tree)


def _field(sharded, name, specs):
    """The ShardedTree of one field of a ShardedTree of records."""
    from repro_torch.sharding.params import ShardedTree

    return ShardedTree(tuple(getattr(b, name) for b in sharded.blocks),
                       specs, sharded.mesh)


def _held_blocks(dev, sharded, whole, label, what, tol, firm=None,
                 lr=None):
    """Each coordinate's block of each leaf of ``sharded`` (on the card)
    against its slice of ``whole`` (on the card or the host; each leaf
    copied to the card whole): at ``tol``; with ``firm`` (the whole
    first moment) at ``tol`` only where |μ| > TRAIN_FIRM and within 2·lr
    elsewhere (Adam's first step moves a weight by ±lr·g/(|g| + ε), its
    sign that of a gradient within μ's grade of 0 there) → the largest
    |Δ| held at ``tol``."""
    from repro_torch.sharding.params import block_slices
    from repro_torch.utils.pytree import tree_leaves

    mesh = sharded.mesh
    specs = tree_leaves(sharded.specs)
    wl = whole if isinstance(whole, list) else tree_leaves(whole)
    fl = None if firm is None else tree_leaves(firm)
    blocks = [tree_leaves(sharded.at(c)) for c in mesh.coords()]
    gap = 0.0
    for k, s in enumerate(specs):
        w_all = wl[k].to(dev, non_blocking=True)
        f_all = None if fl is None else fl[k].to(dev, non_blocking=True)
        for c, bl in zip(mesh.coords(), blocks, strict=True):
            sl = block_slices(w_all.shape, s, mesh, c)
            b, w = bl[k], w_all[sl]
            diff = (b - w).abs()
            bad = diff > tol["atol"] + tol["rtol"] * w.abs()
            if f_all is not None:
                f = f_all[sl].abs() > TRAIN_FIRM
                bad = (bad & f) | (diff > 2 * lr * 1.0001)
                diff = torch.where(f, diff, 0.0)
            if bool(bad.any()):
                raise AssertionError(
                    f"{label}: {what} leaf {k} at {c} off rtol "
                    f"{tol['rtol']} / atol {tol['atol']} (where firm), max "
                    f"|Δ| {float(diff.max()):.3e}, everywhere "
                    f"{float((b - w).abs().max()):.3e}")
            gap = max(gap, float(diff.max()))
        del w_all, f_all
    return gap


def _rel_gaps(dev, sharded, wholes):
    """Per leaf, ‖block − slice‖ over the coordinates that own the
    block (a replica counted once) over ‖whole‖, for each of ``wholes``
    (host leaf lists, each leaf copied to the card whole)."""
    from repro_torch.sharding.params import block_slices
    from repro_torch.sharding.train import _owns
    from repro_torch.utils.pytree import tree_leaves

    mesh = sharded.mesh
    specs = tree_leaves(sharded.specs)
    blocks = [tree_leaves(sharded.at(c)) for c in mesh.coords()]
    out = [[] for _ in wholes]
    for k, s in enumerate(specs):
        for i, whole in enumerate(wholes):
            w_all = whole[k].to(dev, torch.float32)
            sq = 0.0
            for c, bl in zip(mesh.coords(), blocks, strict=True):
                if _owns(s, mesh.axis_names, c):
                    d = bl[k].to(torch.float32) - w_all[
                        block_slices(w_all.shape, s, mesh, c)]
                    sq += float(torch.sum(d * d))
            out[i].append(math.sqrt(sq) / max(float(
                torch.linalg.vector_norm(w_all)), 1e-30))
            del w_all
    return out


def check_train_cuts(dev, ops):
    """Phase 14a's train steps → report."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import abstract_params, build_model
    from repro_torch.optim.adam import adam_init
    from repro_torch.sharding.params import ShardedTree, per_device_bytes, \
        shard_tree, tree_bytes_at
    from repro_torch.utils.pytree import tree_leaves, tree_map

    report = {}
    for arch, layers, more in TRAIN_CUTS:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype="float32")
        model = build_model(cfg)
        _pinned(reset=True)
        params = model.init(SEED, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        center = tree_map(lambda x: x + 0.01 * torch.randn(
            x.shape, generator=gen, device=dev, dtype=x.dtype), params)
        batch, seq = _step_batch(cfg, TRAIN_CUT["batch"], TRAIN_CUT["text"])
        kw = dict(batch=TRAIN_CUT["batch"], seq=seq, rho=TRAIN_CUT["rho"],
                  lr=TRAIN_CUT["lr"])
        step, _ = make_train_step(model, **kw)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        want_p, want_o, want_loss = step(params, adam_init(params), center,
                                         {k: v.to(dev)
                                          for k, v in batch.items()})
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        # on the host, so that the mesh step finds room (moonshot's fp32
        # cut is 7.25 GB, and fsdp_tp holds paligemma's embedding and
        # head twice)
        want_p, want_mu = _to(want_p, "cpu"), _to(want_o.mu, "cpu")
        params, center = _to(params, "cpu"), _to(center, "cpu")
        del want_o
        _free()
        p_abs = abstract_params(model)
        out = dict(unsharded_loss=float(want_loss), unsharded_ms=one_ms)
        for mode, shape in TRAIN_CUT_MESHES + more:
            mesh = make_mesh(shape)
            mstep, args = make_train_step(model, mesh, mode=mode, **kw)
            sp = shard_tree(_to(params, dev), args.in_specs[0], mesh)
            expect = per_device_bytes(p_abs, args.in_specs[0], mesh)
            resident = [tree_bytes_at(sp, c) for c in mesh.coords()]
            if any(r != expect for r in resident):
                raise AssertionError(f"14a {arch} {mode}: resident bytes "
                                     f"{resident}, per_device_bytes {expect}")
            so = ShardedTree(tuple(adam_init(b) for b in sp.blocks),
                             args.in_specs[1], mesh)
            sc = shard_tree(_to(center, dev), args.in_specs[2], mesh)
            sb = shard_tree(batch, args.in_specs[3], mesh)
            _free()
            t0 = time.perf_counter()
            p, o, loss = mstep(sp, so, sc, sb)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            del sp, so, sc, sb
            torch.testing.assert_close(loss.cpu(), want_loss.cpu(),
                                       rtol=1e-5, atol=0)
            where = f"14a {arch} {mode}"
            mu_gap = _held_blocks(dev, _field(o, "mu", args.in_specs[0]),
                                  want_mu, where, "first moment", TRAIN_TOL)
            p_gap = _held_blocks(dev, p, want_p, where, "parameters",
                                 TRAIN_TOL, firm=want_mu, lr=TRAIN_CUT["lr"])
            if int(o.blocks[0].step) != 1:
                raise AssertionError(f"{where}: step {o.blocks[0].step}")
            out[f"{mode} {shape}"] = dict(
                loss=float(loss), mu_max_abs_err=mu_gap,
                param_max_abs_err_firm=p_gap, ms=ms,
                resident_bytes=resident[0])
            log(f"{where} ({layers} layers at full width, fp32, "
                f"{TRAIN_CUT['batch']} × {seq} positions) on mesh {shape}: "
                f"loss {float(loss):.6f} (unsharded {float(want_loss):.6f}, "
                f"rtol 1e-5 held); first moment max_abs_err {mu_gap:.3e}, "
                f"parameters {p_gap:.3e} where |μ| > {TRAIN_FIRM} (rtol "
                f"1e-4 / atol 1e-7 held, within 2·lr elsewhere); resident "
                f"bytes {resident[0]} = per_device_bytes; step {ms:.1f} ms "
                f"(unsharded {one_ms:.1f})")
            del p, o, loss
            _free()
        if any(ops.launch_counts().values()):
            raise AssertionError(f"14a {arch} launched {ops.launch_counts()}")
        report[arch] = out
        del params, center, want_p, want_mu
    return report


def check_train_pods(dev, ops):
    """Phase 14a's cross-pod rounds → report."""
    from repro_torch.configs import get_config
    from repro_torch.core.crosspod import init_cross_pod_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.params import shard_tree
    from repro_torch.sharding.train import cross_pod_batch_specs, \
        init_cross_pod_state_on_mesh, make_cross_pod_round_on_mesh
    from repro_torch.utils.pytree import tree_leaves

    report = {}
    for arch, cut, mode, shape in TRAIN_PODS:
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut)
        cp, model, round_one = _crosspod_round(cfg)
        mesh = make_mesh(shape, POD_AXES)
        round_mesh = make_cross_pod_round_on_mesh(cp, model, mesh, mode=mode)
        _pinned(reset=True)
        params0 = model.init(SEED, device=dev)
        batch = next(_crosspod_batches(cfg, cp, TRAIN_CUT["batch"],
                                       TRAIN_CUT["text"]))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        one, m1 = round_one(init_cross_pod_state(cp, params0, device=dev),
                            batch)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        want = {f: _to(tree_leaves(getattr(one, f)), "cpu")
                for f in ("theta", "lam", "z_prev")}
        del one
        _free()
        state = init_cross_pod_state_on_mesh(cp, params0, mesh, mode=mode)
        del params0
        _free()
        before_gb = torch.cuda.memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state, m = round_mesh(state, shard_tree(
            batch, cross_pod_batch_specs(batch), mesh))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        where = f"14a {arch} cross-pod {mode}"
        np.testing.assert_array_equal(m.events.cpu().numpy(),
                                      m1.events.cpu().numpy(), err_msg=where)
        torch.testing.assert_close(m.distances.cpu(), m1.distances.cpu(),
                                   rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(m.train_loss.cpu(), m1.train_loss.cpu(),
                                   rtol=1e-5, atol=0)
        gap = max(_held_blocks(dev, _field(state, f, getattr(state.specs, f)),
                               want[f], where, f, SOLVE_TOL)
                  for f in want)
        if any(ops.launch_counts().values()):
            raise AssertionError(f"{where} launched {ops.launch_counts()}")
        report[f"{arch} {mode} {shape}"] = dict(
            events=m.events.tolist(), train_loss=float(m.train_loss),
            max_abs_err=gap, ms=ms, one_device_ms=one_ms,
            peak_memory_bytes=peak)
        log(f"{where} ({cfg.num_layers} layers, vocabulary "
            f"{cfg.vocab_size}, the other widths full, fp32) on mesh "
            f"{shape}: events {m.events.tolist()} equal to the one-device "
            f"round's, train_loss {float(m.train_loss):.6f} (one device "
            f"{float(m1.train_loss):.6f}); θ / λ / z_prev max_abs_err "
            f"{gap:.3e} (rtol 1e-4 / atol 1e-6 held); round {ms:.1f} ms "
            f"(one device {one_ms:.1f}); {before_gb:.2f} GB on the card "
            f"before it, peak {peak / 1e9:.2f}")
        del state, want
        _free()
    return report


def _moe_aux(cfg, plans, n_data, n_model):
    """The whole batch's load-balance aux from recorded forward routings
    (data shard by data shard, layer by layer, the model shards in
    turn; the first model shard's taken)."""
    from repro_torch.models import moe

    layers = cfg.num_layers
    total = None
    for d in range(n_data):
        st = torch.stack([moe.load_stats(plans[(d * layers + i) * n_model])
                          for i in range(layers)]).detach()
        total = st if total is None else total + st.to(total.device)
    tokens = sum(plans[d * layers * n_model]["probs"].shape[0]
                 * plans[d * layers * n_model]["probs"].shape[1]
                 for d in range(n_data))
    return float(moe.load_balance(total, tokens))


def _fp32_first_moment(cfg, params, batch, dev):
    """Adam's first moment after one step from 0 of the fp32 gradient of
    ``params`` (host leaves, cast) on ``batch``, the centre at the
    parameters: (1 − b1)·∇ (``optim/adam.py``'s fp32 constant)."""
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_map

    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    leaves = [x.to(dev, torch.float32).requires_grad_(True)
              for x in tree_leaves(params)]
    it = iter(leaves)
    loss = model.loss(tree_map(lambda _: next(it), params), batch)
    grads = torch.autograd.grad(loss, leaves)
    c1 = float(np.float32(1 - 0.9))
    out = _to([c1 * g for g in grads], "cpu")
    del leaves, grads, loss
    _free()
    return out


def train_full(dev, ops, smi, cfg, label, meshes):
    """Phases 14b and 14c: ``cfg`` in bf16 from the seeded init, one step
    of TRAIN_FULL's batch, the centre the parameters; unsharded, then on
    each (mode, mesh shape) of ``meshes`` under torch.profiler.  Checked:
    each coordinate's resident bytes equal to ``per_device_bytes``, GB
    by collective kind equal to ``sharding.train.step_bytes``, the loss
    within TRAIN_LOSS_REL of the unsharded step's, each leaf's first
    moment within TRAIN_BF16_REL of the unsharded one (past it, as close
    to the fp32 gradient's as the unsharded one, within ANCHOR_RATIO), no
    kernel launches; for the MoE each layer's routing held to the
    unsharded one's (``hold_routing``) and the aux printed."""
    import types

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import abstract_params, build_model
    from repro_torch.optim.adam import adam_init
    from repro_torch.sharding.clients import collectives
    from repro_torch.sharding.params import ShardedTree, per_device_bytes, \
        shard_tree, tree_bytes_at
    from repro_torch.sharding.train import step_bytes
    from repro_torch.utils.pytree import tree_leaves

    model = build_model(cfg)
    moe = cfg.family == "moe"
    _pinned(reset=True)
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch, seq = _step_batch(cfg, TRAIN_FULL["batch"], TRAIN_FULL["text"])
    on_card = {k: v.to(dev) for k, v in batch.items()}
    kw = dict(batch=TRAIN_FULL["batch"], seq=seq, lr=TRAIN_FULL["lr"])
    step, _ = make_train_step(model, **kw)
    routed = routing_plans if moe else (lambda: contextlib.nullcontext([]))
    ops.reset_launch_counts()
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    with routed() as plans:
        t0 = time.perf_counter()
        new_p, want_o, want_loss = step(params, adam_init(params), params,
                                        on_card)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        plain_routing = plans[:cfg.num_layers]
    one_peak = torch.cuda.max_memory_allocated(dev)
    want_mu = _to(tree_leaves(want_o.mu), "cpu")
    del want_o, new_p
    params = _to(params, "cpu")
    _free()
    t0 = time.perf_counter()
    anchor = _fp32_first_moment(cfg, params, on_card, dev)
    anchor_s = time.perf_counter() - t0
    plain_gap = [float(torch.linalg.vector_norm(u.to(dev, torch.float32)
                                                - a.to(dev)))
                 / max(float(torch.linalg.vector_norm(a.to(dev))), 1e-30)
                 for u, a in zip(want_mu, anchor, strict=True)]
    aux_one = _moe_aux(cfg, plain_routing, 1, 1) if moe else None
    total = torch.cuda.get_device_properties(dev).total_memory
    n = sum(x.numel() for x in tree_leaves(params))
    report = {"unsharded": dict(
        loss=float(want_loss), ms=one_ms, peak_memory_bytes=one_peak,
        init_s=init_s, parameters=n, mu_rel_to_fp32=plain_gap, aux=aux_one,
        fp32_anchor_s=anchor_s)}
    log(f"{label} unsharded {cfg.name} ({cfg.num_layers} layers, {n} "
        f"parameters, bf16, {TRAIN_FULL['batch']} × {seq} tokens): loss "
        f"{float(want_loss):.6f}, step {one_ms:.1f} ms, peak "
        f"{one_peak / 1e9:.2f} GB of {total / 1e9:.2f}; the first moment "
        f"a leaf against the fp32 gradient's: largest rel "
        f"{max(plain_gap):.3e} (fp32 anchor {anchor_s:.1f} s)"
        + (f"; aux {aux_one:.6f}" if moe else "") + f"; on {smi}")
    p_abs = abstract_params(model)
    for mode, shape in meshes:
        mesh = make_mesh(shape)
        mstep, args = make_train_step(model, mesh, mode=mode, **kw)
        sp = shard_tree(params, args.in_specs[0], mesh)
        expect = per_device_bytes(p_abs, args.in_specs[0], mesh)
        resident = [tree_bytes_at(sp, c) for c in mesh.coords()]
        if any(r != expect for r in resident):
            raise AssertionError(f"{label} {mode}: resident bytes "
                                 f"{resident}, per_device_bytes {expect}")
        so = ShardedTree(tuple(adam_init(b) for b in sp.blocks),
                         args.in_specs[1], mesh)
        sb = shard_tree(batch, args.in_specs[3], mesh)
        args_resident = [[tree_bytes_at(x, c) for c in mesh.coords()]
                         for x in (sp, so, sp, sb)]
        moved: dict = {}

        def count(kind, t):
            moved[kind] = moved.get(kind, 0) + t.numel() * t.element_size()

        _free()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        listen = _but_the_worker(count)
        collectives.listeners.append(listen)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        try:
            with routed() as plans:
                prof.__enter__()
                t0 = time.perf_counter()
                p, o, loss = mstep(sp, so, sp, sb)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                prof.__exit__(None, None, None)
        finally:
            collectives.listeners.remove(listen)
        peak = torch.cuda.max_memory_allocated(dev)
        profile = _round_profile(prof, wall)
        del prof, p, sp, so, sb
        where = f"{label} {mode}"
        if any(ops.launch_counts().values()):
            raise AssertionError(f"{where} launched {ops.launch_counts()}")
        want_bytes = {k: v for k, v in step_bytes(
            cfg, p_abs, args.in_specs[0], mesh, mode, batch=kw["batch"],
            seq=seq).items() if v}
        if moved != want_bytes:
            raise AssertionError(f"{where}: bytes by kind {moved}, the "
                                 f"formula's {want_bytes}")
        rel_loss = abs(float(loss) / float(want_loss) - 1)
        if rel_loss > TRAIN_LOSS_REL:
            raise AssertionError(f"{where}: loss {float(loss)} against "
                                 f"{float(want_loss)}")
        rel, to_fp32 = _rel_gaps(dev, _field(o, "mu", args.in_specs[0]),
                                 [want_mu, anchor])
        anchored = [k for k, r in enumerate(rel) if r > TRAIN_BF16_REL]
        if any(to_fp32[k] > ANCHOR_RATIO * plain_gap[k] for k in anchored):
            raise AssertionError(
                f"{where}: first moment a leaf rel to the unsharded {rel} "
                f"(allowed {TRAIN_BF16_REL}); to fp32 {to_fp32} against the "
                f"unsharded's {plain_gap} (×{ANCHOR_RATIO})")
        del o
        drops = aux = None
        if moe:
            n_data = mesh.size // mesh.shape["model"]
            n_model = 1 if mode == "fsdp" else mesh.shape["model"]
            fwd = plans[:n_data * cfg.num_layers * n_model]
            drops = hold_routing(where, plain_routing, fwd,
                                 types.SimpleNamespace(
                                     shape={"model": n_model},
                                     size=n_data * n_model), cfg.top_k)
            aux = _moe_aux(cfg, fwd, n_data, n_model)
        del plans
        gb = {k: v / 1e9 for k, v in moved.items()}
        report[f"{mode} {shape}"] = dict(
            loss=float(loss), loss_rel=rel_loss, mu_rel=rel,
            mu_rel_to_fp32=to_fp32, anchored_leaves=anchored,
            profile=profile, peak_memory_bytes=peak,
            card_memory_bytes=total, resident_bytes=resident[0],
            gb_by_kind=gb, bytes_by_kind=dict(moved),
            resident_argument_bytes=args_resident, aux=aux,
            drops_by_layer=drops)
        log(f"{where} on mesh {shape}: loss {float(loss):.6f} (rel "
            f"{rel_loss:.2e} to the unsharded, {TRAIN_LOSS_REL} held); "
            f"first moment a leaf rel to the unsharded: largest "
            f"{max(rel):.3e} ({TRAIN_BF16_REL} held"
            + (f"; leaves {anchored} past it held as close to fp32 as the "
               f"unsharded, ×{ANCHOR_RATIO}" if anchored else "")
            + f"); step {wall:.1f} ms wall under the profiler, "
            f"{profile['device_busy_ms']:.1f} busy, idle "
            f"{profile['idle_share']:.3f}, {profile['launches']} launches "
            f"(unsharded {one_ms:.1f} ms); peak {peak / 1e9:.2f} GB of "
            f"{total / 1e9:.2f}; resident bytes {resident[0]} = "
            f"per_device_bytes; GB by kind {gb} = the formula's"
            + (f"; aux {aux:.6f} (unsharded {aux_one:.6f}); drops a layer, "
               "unsharded / mesh / tokens that changed experts: "
               + "; ".join(f"{a:.4f} / {b:.4f} / {k}" for a, b, k in drops)
               if moe else "") + f"; on {smi}")
        log(f"{where} rel a leaf to the unsharded {[f'{x:.2e}' for x in rel]}"
            f", to fp32 {[f'{x:.2e}' for x in to_fp32]} (the unsharded's "
            f"{[f'{x:.2e}' for x in plain_gap]})")
        _free()
    del params, want_mu, anchor
    return report


def phase14(dev, ops, smi):
    """Phases 14a–14c → 14b's report."""
    from repro_torch.configs import get_config

    t0 = t1 = time.perf_counter()
    cuts = check_train_cuts(dev, ops)
    _free()
    pods = check_train_pods(dev, ops)
    _free()
    log(f"phase 14a took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    granite = train_full(dev, ops, smi, get_config("granite-3-2b"), "14b",
                         TRAIN_GRANITE)
    _free()
    log(f"phase 14b took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    moon = train_full(dev, ops, smi, dataclasses.replace(
        get_config("moonshot-v1-16b-a3b"), num_layers=TRAIN_MOON["layers"]),
        "14c", TRAIN_MOON["meshes"])
    _free()
    log(f"phase 14c took {time.perf_counter() - t1:.1f} s; phases 14a–14c "
        f"{time.perf_counter() - t0:.1f} s")
    log(json.dumps({"tp_training": {"cuts": cuts, "cross_pod": pods,
                                    "granite": granite, "moonshot_cut": moon},
                    "card": smi}))
    return granite


# Phase 15: the dry-run's count of the mesh steps that 12b, 13b and 14b
# run on the card, the same step (configuration, mesh shape, mode, batch
# and positions) counted on the meta device in a process of its own,
# started with 10c (``launch/dryrun.py``: the count at 1 and 2 layer
# units, extrapolated).
_COUNT_SCRIPT = r"""
import json, sys, time
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.sharding.params import per_device_bytes

cases, card = json.loads(sys.argv[1]), sys.argv[2]
out = {}
for c in cases:
    t0 = time.time()
    cfg = get_config(c["arch"])
    mesh = make_test_mesh(tuple(c["mesh"]), tuple(c["axes"]),
                          devices=("meta",))
    kw = dict(multi_pod=c["multi_pod"], mode=c["mode"], mesh=mesh,
              batch=c["batch"], seq=c["seq"])
    cost = dryrun.corrected_cost(cfg, c["shape"], **kw)
    built, _ = dryrun.build_step(cfg, c["shape"], **kw)
    args = built[3][1]
    rec = dryrun.make_record(c["arch"], c["shape"], cfg, cost,
                             multi_pod=c["multi_pod"], card=card,
                             mode=c["mode"], mesh=mesh)
    out[c["name"]] = dict(
        collectives={k: int(v) for k, v in cost["collectives"].items()},
        calls={k: int(sum(cost[k])) for k in ("flash_attention",
                                               "ssd_scan")},
        argument_bytes=[per_device_bytes(a, s, built[2]) for a, s in
                        zip(args, args.in_specs, strict=True)],
        bound_time_s=rec["roofline"]["bound_time_s"],
        dominant=rec["roofline"]["dominant"],
        busiest_coordinate=rec["busiest_coordinate"],
        coordinates=mesh.size, count_s=time.time() - t0)
print("RESULT:" + json.dumps(out))
"""


def held_steps():
    """Phase 15's steps: (name, architecture, dry-run shape, pods, mode,
    mesh, axes, batch, positions), each that of a phase's run."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_lm import cache_len

    dm = ["data", "model"]
    zamba = dict(arch=ZAMBA, multi_pod=False, mode="tp",
                 mesh=list(TP_ZAMBA["mesh"]), axes=dm, batch=SERVE_BATCH)
    return [
        dict(name="12b", arch=GRANITE, shape="train_4k", multi_pod=True,
             mode="fsdp", mesh=list(POD_MESH), axes=list(POD_AXES),
             batch=GRANITE_B["batch"] * CROSSPOD_CP["n_pods"]
             * CROSSPOD_CP["local_steps"], seq=GRANITE_B["seq"]),
        dict(zamba, name="13b prefill", shape="prefill_32k",
             seq=SERVE_PROMPT),
        dict(zamba, name="13b decode", shape="decode_32k", seq=cache_len(
            get_config(ZAMBA), SERVE_PROMPT, TP_ZAMBA["new"])),
        *[dict(name=f"14b {mode}", arch=GRANITE, shape="train_4k",
               multi_pod=False, mode=mode, mesh=list(shape), axes=dm,
               batch=TRAIN_FULL["batch"], seq=TRAIN_FULL["text"])
          for mode, shape in TRAIN_GRANITE]]


def start_held_counts():
    """Phase 15's counts, started: one niced process on the host's
    cores."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return _child(
        [sys.executable, "-c", _COUNT_SCRIPT, json.dumps(held_steps()),
         torch.cuda.get_device_name(0)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=lambda: os.nice(19))


def phase15(proc, smi, pod, zamba, granite):
    """Phase 15: each step's count held against the phase's run of it on
    the card — the bytes by collective kind equal to its listener's, byte
    for byte (the arguments' own "scatter" onto the mesh, where the phase
    cut them inside its listener, counted from their resident bytes),
    each argument's bytes a coordinate (``per_device_bytes`` of the
    step's ``in_specs``) equal to every coordinate's resident bytes, K4's
    and K5's counted calls equal to their launches; each step's counted
    bound a card × its coordinates printed beside its measured ms, no
    gate."""
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"15: the count exited {proc.returncode}: "
                             f"{err[-3000:]}")
    counted = json.loads([x for x in out.splitlines()
                          if x.startswith("RESULT:")][-1][len("RESULT:"):])
    zt = zamba[f"tp {TP_ZAMBA['mesh']}"]
    k4, k5 = "flash_attention_zamba2_tp4", "ssd_scan_zamba2_tp4"
    runs = {"12b": dict(
        moved=pod["bytes_per_round_by_kind"][0], placed=1,
        args=pod["resident_argument_bytes"], calls={},
        ms=pod["profiled_round"]["device_busy_ms"],
        what=f"busy ms of round {pod['profiled_round']['index']}")}
    runs["13b prefill"] = dict(
        moved=zt["collective_bytes_per_prefill"], placed=1,
        args=zt["resident_argument_bytes"]["prefill"],
        calls={"flash_attention": zt["launches_per_prefill"][k4],
               "ssd_scan": zt["launches_per_prefill"][k5]},
        ms=zt["prefill_ms"], what="wall ms of a prefill")
    runs["13b decode"] = dict(
        moved=zt["collective_bytes_per_decode_step"], placed=1,
        args=zt["resident_argument_bytes"]["decode"],
        calls={"flash_attention": 0, "ssd_scan": 0},
        ms=zt["decode_ms_per_step"], what="wall ms of a decode step")
    for mode, shape in TRAIN_GRANITE:
        g = granite[f"{mode} {shape}"]
        runs[f"14b {mode}"] = dict(
            moved=g["bytes_by_kind"], placed=None,
            args=g["resident_argument_bytes"], calls={},
            ms=g["profile"]["device_busy_ms"], what="busy ms of the step")
    report = {}
    for name, run in runs.items():
        c = counted[name]
        want = {k: v for k, v in c["collectives"].items() if v}
        if run["placed"] is not None:  # the argument cut in the listener
            want["scatter"] = want.get("scatter", 0) + sum(
                run["args"][run["placed"]][1:])
        if run["moved"] != want:
            raise AssertionError(f"15 {name}: bytes by kind {run['moved']} "
                                 f"on the card, counted {want}")
        for i, (n, per_coord) in enumerate(zip(
                c["argument_bytes"], run["args"], strict=True)):
            if any(r != n for r in per_coord):
                raise AssertionError(f"15 {name}: argument {i}'s resident "
                                     f"bytes {per_coord}, counted {n}")
        for k, n in run["calls"].items():
            if c["calls"][k] != n:
                raise AssertionError(f"15 {name}: {k} counted "
                                     f"{c['calls'][k]} calls, launched {n}")
        bound_ms = c["bound_time_s"] * 1e3 * c["coordinates"]
        report[name] = dict(c, measured_ms=run["ms"], measured=run["what"],
                            bound_ms_times_coordinates=bound_ms)
        log(f"15 {name}: bytes by kind {run['moved']} = counted; argument "
            f"bytes a coordinate {c['argument_bytes']} = resident; K4 / K5 "
            f"{c['calls']['flash_attention']} / {c['calls']['ssd_scan']} "
            f"counted{' = launched' if run['calls'] else ''}; counted "
            f"bound {c['bound_time_s'] * 1e3:.3f} ms a card "
            f"({c['dominant']}, coordinate {c['busiest_coordinate']}) × "
            f"{c['coordinates']} = {bound_ms:.1f} ms against "
            f"{run['ms']:.1f} {run['what']} (count {c['count_s']:.1f} s); "
            f"on {smi}")
    return report


def kernels_line(rows, launches, where):
    """Print each row's facts and the kernels line; ``launches[name]``
    its launches on the path (``where[name]`` says where)."""
    kernels = []
    for name, r in rows.items():
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched on the path")
        lib = r["library_ms"]
        warm = f" (cold; warm {r['warm_ms']:.4f})" if "warm_ms" in r else ""
        log(f"{name}: launches {launches[name]} ({where[name]}), "
            f"max_abs_err {r['max_abs_err']:.3e}, "
            f"ms {r['ms']:.4f}{warm}, plain_ms {r['plain_ms']:.4f}, "
            f"library_ms {'null' if lib is None else f'{lib:.4f}'}, bound_ms "
            f"{r['bound_ms']} ({r['bound_by']})")
        kernels.append({
            "name": name, "route": "cuda",
            "source": r.get("source", CUDA_SRC),
            "replaces": r["replaces"], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)


def phase_seconds(name, t0):
    """Log a phase's seconds since ``t0``; → now."""
    now = time.perf_counter()
    log(f"phase {name} took {now - t0:.1f} s")
    return now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config, paper_cifar, paper_mnist
    from repro_torch.core import make_eval_fn
    from repro_torch.kernels import _build, ops
    from repro_torch.models import make_loss_and_acc_fn
    from repro_torch.utils import make_flat_spec

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"({_build.library_path()})")
    log(_build.build_log().strip())
    kernel_facts(_build)
    _build.load_library()

    dev = torch.device("cuda")
    data, test, params0, mlp_logits = paper_mnist.workload(SEED, device=dev)
    spec = make_flat_spec(params0)
    n, d = data["x"].shape[0], spec.dim
    log(f"paper-MNIST: data {tuple(data['x'].shape)}, D = {d}")
    if (n, d) != (100, 159010):
        raise AssertionError(f"unexpected width {(n, d)}")

    t0 = time.perf_counter()
    cifar_data, cifar_test, cifar_params0, cnn_logits = \
        paper_cifar.workload(SEED, device=dev)
    cifar_spec = make_flat_spec(cifar_params0)
    log(f"paper-CIFAR: data {tuple(cifar_data['x'].shape)} (Dirichlet β = "
        f"{paper_cifar.DIRICHLET_BETA}, trimmed to the smallest client), "
        f"D = {cifar_spec.dim}, made in {time.perf_counter() - t0:.2f} s")
    if (cifar_data["x"].shape[0], cifar_spec.dim) != (100, 196426):
        raise AssertionError("unexpected CIFAR width "
                             f"{(cifar_data['x'].shape[0], cifar_spec.dim)}")

    t0 = time.perf_counter()
    rows = check_kernels(dev, ops, n, d, 16)
    rows["trigger_sq_norms_pytree"] = check_pytree_kernel(
        dev, ops, {"mlp": params0, "cnn": cifar_params0})
    rows.update(check_sharded_kernels(dev, ops, n, d))
    rows.update(check_model_kernels(dev, ops))
    log(f"phase 3 took {time.perf_counter() - t0:.1f} s")

    ctx = dict(dev=dev, data=data, test=test, params0=params0, spec=spec,
               smi=smi, cfgs=paper_mnist, logits=mlp_logits,
               eval_fn=make_eval_fn(make_loss_and_acc_fn(), spec=spec,
                                    device=dev))
    t0 = time.perf_counter()
    form_a, counts_a = drive(
        "A", 5, 1, ctx, ops,
        {"trigger_sq_norms": 1, "fused_gss": 1, "admm_update": 0})
    t0 = phase_seconds("4", t0)
    form_b, counts_b = drive(
        "B", 3, 1, ctx, ops,
        {"trigger_sq_norms": 1, "admm_update": 1, "fused_gss": 0})
    t0 = phase_seconds("5", t0)
    forms_c, counts_c = drive_forms(ctx, ops, BASELINE_FORMS)
    forms_c["C7"] = dict(drive_scaffold(ctx, ops, 3, 1),
                         what=paper_mnist.FORMS["C7"].what)
    t0 = phase_seconds("5b", t0)
    forms_t, counts_t = drive_forms(ctx, ops, TREE_FORMS)
    t0 = phase_seconds("5c", t0)
    cifar_ctx = dict(ctx, data=cifar_data, test=cifar_test,
                     params0=cifar_params0, spec=cifar_spec,
                     cfgs=paper_cifar, logits=cnn_logits)
    check_conv_precision(cifar_ctx)
    forms_cf, counts_cf = drive_forms(cifar_ctx, ops, CIFAR_FORMS)
    t0 = phase_seconds("5d", t0)
    forms_s, counts_s = drive_forms(ctx, ops, SHARDED_FORMS)
    t0 = phase_seconds("5e", t0)
    log(json.dumps({"forms": {"A": form_a, "B": form_b, **forms_c,
                              **forms_t, **forms_s, **forms_cf},
                      "card": smi}))
    check_serve_sync_anchor(ctx)
    check_staleness_commit_bits(ctx)
    forms_sv, counts_sv = {}, {}
    for form, expect in SERVE_FORMS:
        forms_sv[form], counts = drive_serve(form, expect, ctx, ops)
        for k, v in counts.items():
            counts_sv[k] = counts_sv.get(k, 0) + v
    log(json.dumps({"serve_forms": forms_sv, "card": smi}))
    t0 = phase_seconds("5f", t0)

    ef_report = check_ef_aggregation(ctx)
    forms_q, counts_q = drive_forms(ctx, ops, COMPRESSED_FORMS)
    beside = {"QA": ("A", form_a), "QB": ("B", form_b),
              "QC": ("C3", forms_c["C3"]), "QS": ("SA", forms_s["SA"])}
    log("compressed forms, ms/round: " + "; ".join(
        f"{q} {forms_q[q]['ms_per_round']:.3f} ({b} "
        f"{r['ms_per_round']:.3f})" for q, (b, r) in beside.items())
        + f" on {smi}")
    checkpoints = check_checkpoints(ctx, ops)
    log(json.dumps({"compressed_forms": forms_q, "ef_aggregation": ef_report,
                    "checkpoints": checkpoints, "card": smi}))
    t0 = phase_seconds("5g", t0)

    forms_r, counts_r = drive_ragged(ctx, cifar_ctx, ops)
    beside = {"RA": ("A", form_a), "RB": ("B", form_b),
              "RS": ("SA", forms_s["SA"]), "RC": ("CF-A", forms_cf["CF-A"])}
    log("ragged forms, ms/round: " + "; ".join(
        f"{r} {forms_r[r]['ms_per_round']:.3f} ({b} "
        f"{v['ms_per_round']:.3f})" for r, (b, v) in beside.items())
        + f" on {smi}")
    log(json.dumps({"ragged_forms": forms_r, "card": smi}))
    t0 = phase_seconds("5h", t0)

    forms_w, forms_h, counts_wh = drive_sweeps_and_hosts(ctx, ops)
    beside = {"WA": ("A", form_a), "WB": ("B", form_b)}
    log("sweep forms, ms per sweep round: " + "; ".join(
        f"{w} {forms_w[w]['ms_per_round']:.3f} over "
        f"{len(forms_w[w]['runs'])} runs ({b} {r['ms_per_round']:.3f} a "
        f"round)" for w, (b, r) in beside.items()) + f" on {smi}")
    log("host forms, ms/round: " + "; ".join(
        f"{h} {r['ms_per_round']:.3f} (its device form "
        f"{r['device_form_ms_per_round']:.3f})" for h, r in forms_h.items())
        + f"; A {form_a['ms_per_round']:.3f}, QA "
        f"{forms_q['QA']['ms_per_round']:.3f}, RA "
        f"{forms_r['RA']['ms_per_round']:.3f} earlier in the run on {smi}")
    log(json.dumps({"sweep_forms": forms_w, "host_forms": forms_h,
                    "card": smi}))
    t0 = phase_seconds("5i–5j", t0)

    checker, counts_k = check_static_invariants(ctx, ops)
    log(json.dumps({"checker": checker, "card": smi}))
    t0 = phase_seconds("5k", t0)
    # 10c's mesh sweeps and phase 15's counts, niced, on the host's cores
    # beside phases 6–14 (they touch no card; phases 3–5k's CPU rounds
    # run on every core)
    mesh_dir, t_mesh = ROOT / "build" / "dryrun_mesh", time.perf_counter()
    for old_rec in mesh_dir.glob("*/*.json"):
        old_rec.unlink()
    held_proc, mesh_procs = start_held_counts(), start_mesh_sweeps(mesh_dir)

    zamba = get_config("zamba2-2.7b")
    _, counts_slice = check_slice_against_cpu(
        dev, ops, dataclasses.replace(zamba, num_layers=6, dtype="float32"),
        {"flash_attention_fp32": 1, "ssd_scan": 6, "flash_attention": 0})
    t0 = phase_seconds("6", t0)
    torch.cuda.empty_cache()
    serve_report, counts_serve = serve_full(
        dev, ops, smi, zamba, {"flash_attention": zamba.num_layers
                               // zamba.attn_every,
                               "ssd_scan": zamba.num_layers})
    log(json.dumps({"serve": serve_report}))
    phase_seconds("7", t0)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    granite = get_config(GRANITE)
    hold_7a = check_crosspod_against_cpu(
        dev, ops, dataclasses.replace(granite, num_layers=GRANITE_A["layers"],
                                      dtype="float32"), GRANITE_A, "7a",
        defer=True)
    log(f"phase 7a took {time.perf_counter() - t0:.1f} s on the card (its "
        "CPU round on the worker)")
    t1 = time.perf_counter()
    granite_b = drive_crosspod_full(dev, smi, granite, GRANITE_B, "7b")
    log(f"phase 7b took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    _, counts_gslice = check_slice_against_cpu(
        dev, ops, dataclasses.replace(granite, num_layers=GRANITE_A["layers"],
                                      dtype="float32"),
        {"flash_attention_fp32": GRANITE_A["layers"], "ssd_scan": 0,
         "flash_attention": 0})
    torch.cuda.empty_cache()
    granite_serve, counts_gserve = serve_full(
        dev, ops, smi, granite, {"flash_attention": granite.num_layers,
                                 "ssd_scan": 0},
        bf16_row="flash_attention_gqa")
    log(f"phase 7c took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    granite_a = hold_7a()
    del hold_7a  # the kept states, the card's and the CPU's, let go
    log(f"phase 7a's CPU round held in {time.perf_counter() - t1:.1f} s; "
        f"phases 7a–7c {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"granite": {"crosspod_vs_cpu": granite_a,
                                "crosspod_full": granite_b,
                                "serve": granite_serve}}))

    t0 = t1 = time.perf_counter()
    hold_8a = check_crosspod_against_cpu(
        dev, ops, dataclasses.replace(zamba, num_layers=ZAMBA_A["layers"],
                                      dtype="float32"), ZAMBA_A, "8a",
        defer=True)
    log(f"phase 8a took {time.perf_counter() - t1:.1f} s on the card (its "
        "CPU round on the worker)")
    t1 = time.perf_counter()
    zamba_b = drive_crosspod_full(dev, smi, zamba, ZAMBA_B, "8b")
    log(f"phase 8b took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    mamba = get_config(MAMBA)
    mamba_slice = dataclasses.replace(mamba, num_layers=MAMBA_D["layers"],
                                      dtype="float32")
    _, counts_mslice = check_slice_against_cpu(
        dev, ops, mamba_slice, {"ssd_scan_mamba2": MAMBA_D["layers"],
                                "ssd_scan": 0, "flash_attention_fp32": 0},
        ssd_row="ssd_scan_mamba2")
    torch.cuda.empty_cache()
    mamba_serve, counts_mserve = serve_full(
        dev, ops, smi, mamba, {"ssd_scan": mamba.num_layers,
                               "flash_attention": 0},
        ssd_row="ssd_scan_mamba2")
    torch.cuda.empty_cache()
    log(f"phase 8c took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    mamba_d = dict(
        loss_grads=check_loss_grads_against_cpu(dev, ops, mamba_slice,
                                                MAMBA_D, "8d loss"),
        crosspod=check_crosspod_against_cpu(dev, ops, mamba_slice, MAMBA_D,
                                            "8d"))
    torch.cuda.empty_cache()
    log(f"phase 8d took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    phi3 = get_config(PHI3)
    phi3_serve, counts_pserve = serve_full(
        dev, ops, smi, phi3, {"flash_attention": phi3.num_layers,
                              "ssd_scan": 0},
        bf16_row="flash_attention_phi3", new_tokens=PHI3_NEW)
    torch.cuda.empty_cache()
    log(f"phase 8e took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    zamba_a = hold_8a()
    del hold_8a
    log(f"phase 8a's CPU round held in {time.perf_counter() - t1:.1f} s; "
        f"phases 8a–8e {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"zamba2": {"crosspod_vs_cpu": zamba_a,
                               "crosspod_full": zamba_b},
                    "mamba2": {"serve": mamba_serve, **mamba_d},
                    "phi3": {"serve": phi3_serve}}))

    t0 = t1 = time.perf_counter()
    moonshot = get_config(MOONSHOT)
    moon_a, counts_moon_a = check_moe_slice(dev, ops, moonshot)
    log(f"phase 9a took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    moon_serve, counts_moon = serve_full(
        dev, ops, smi, moonshot,
        {"flash_attention": moonshot.num_layers, "ssd_scan": 0},
        bf16_row="flash_attention_moonshot", new_tokens=MOON_NEW,
        check=(dataclasses.replace(moonshot, capacity_factor=DROP_FREE_CF),
               *MOON_CHECK), after=moe_drop_share(moonshot, dev))
    torch.cuda.empty_cache()
    log(f"phase 9b took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    mixtral = get_config(MIXTRAL).reduced()
    mix_slice, counts_mix = check_slice_against_cpu(
        dev, ops, mixtral, {"flash_attention_fp32": mixtral.num_layers,
                            "flash_attention": 0, "ssd_scan": 0})
    mix_units = check_moe_units(dev)
    log(f"phase 9c took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    pali = get_config(PALIGEMMA)
    pali_slice, counts_pslice = check_slice_against_cpu(
        dev, ops, dataclasses.replace(pali, num_layers=PALI_LAYERS,
                                      dtype="float32"),
        {"flash_attention_fp32": 0, "flash_attention": 0, "ssd_scan": 0},
        k4_total=0)
    torch.cuda.empty_cache()
    pali_serve, counts_pali = serve_full(
        dev, ops, smi, pali, {"flash_attention": 0, "ssd_scan": 0},
        new_tokens=PALI_NEW, prompt_len=PALI_PROMPT,
        after=d11_refusal(pali, dev))
    torch.cuda.empty_cache()
    log(f"phase 9d took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    hubert = get_config(HUBERT)
    hub_a = check_loss_grads_against_cpu(
        dev, ops, dataclasses.replace(hubert, num_layers=HUBERT_A["layers"],
                                      dtype="float32"), HUBERT_A, "9e loss")
    torch.cuda.empty_cache()
    hub_b = train_step_full(dev, ops, smi, hubert, HUBERT_B, "9e")
    log(f"phase 9e took {time.perf_counter() - t1:.1f} s; phases 9a–9e "
        f"{time.perf_counter() - t0:.1f} s")
    log(json.dumps({"moonshot": {"fp32_cut": moon_a, "serve": moon_serve},
                    "mixtral_reduced": {"slice": mix_slice,
                                        "moe_units": mix_units},
                    "paligemma": {"slice": pali_slice, "serve": pali_serve},
                    "hubert": {"loss_grads": hub_a, "train_step": hub_b},
                    "card": smi}))
    torch.cuda.empty_cache()

    t0 = t1 = time.perf_counter()
    dry_dir = ROOT / "build" / "dryrun"
    if dry_dir.is_dir():
        for old_rec in dry_dir.glob("*.json"):
            old_rec.unlink()
    sweep_proc = start_dryrun_sweep(dry_dir)
    try:
        bf16_rows, counts_bf16 = check_bf16_kernels(dev, ops)
        rows.update(bf16_rows)
        log(f"phase 10a took {time.perf_counter() - t1:.1f} s")
        peaks = check_roofline_tables(smi)
        t1 = time.perf_counter()
        examples = drive_examples()
        log(f"phase 10d took {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        claims = check_system_claims(dev)
        log(f"phase 10e took {time.perf_counter() - t1:.1f} s")
        # Phase 11 drives the card from this process while the sweep
        # counts on the host's other cores.
        counts_mesh_a, counts_mesh_b = phase11(dev, ops, smi, granite)
        dryrun_report = finish_dryrun_sweep(sweep_proc, dry_dir, t0)
    finally:
        if sweep_proc.poll() is None:
            sweep_proc.kill()
            sweep_proc.wait()
    log(f"phases 10a–10e and 11 {time.perf_counter() - t0:.1f} s (10c "
        "beside the others, on the host's cores)")
    log(json.dumps({"roofline": peaks, "dryrun": dryrun_report,
                    "examples": examples, "system_claims": claims,
                    "card": smi}))

    finish_12a, pod_full = phase12(dev, ops, smi, granite, granite_b)
    counts_tp, zamba_tp = phase13(dev, ops, smi)
    finish_12a()
    del finish_12a
    t0 = time.perf_counter()
    granite_tp = phase14(dev, ops, smi)
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    for worker in _BACKGROUND:
        worker.shutdown()
    t0 = time.perf_counter()
    try:
        held = phase15(held_proc, smi, pod_full, zamba_tp, granite_tp)
        mesh_report = finish_mesh_sweeps(mesh_procs, mesh_dir, t_mesh)
    finally:
        for proc in (held_proc, *mesh_procs):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s (waited for its "
        "counts and 10c's mesh sweeps)")
    log(json.dumps({"dryrun_held": held, "dryrun_mesh": mesh_report,
                    "card": smi}))

    launches, where = {}, {}
    for name, r in rows.items():
        if name in counts_bf16:  # the bf16 rows: 10a's path alone
            launches_n = counts_bf16[name]
            where_s = f"bf16 path (10a) {launches_n}"
        else:
            launches_n = (counts_a[name] + counts_b[name]
                          + counts_c.get(name, 0) + counts_t.get(name, 0)
                          + counts_s.get(name, 0) + counts_sv.get(name, 0)
                          + counts_q.get(name, 0) + counts_r.get(name, 0)
                          + counts_wh.get(name, 0) + counts_k.get(name, 0)
                          + counts_cf.get(name, 0) + counts_slice[name]
                          + counts_serve[name] + counts_gslice[name]
                          + counts_gserve[name] + counts_mslice[name]
                          + counts_mserve[name] + counts_pserve[name]
                          + counts_moon_a[name] + counts_moon[name]
                          + counts_mix[name] + counts_pslice[name]
                          + counts_pali[name] + counts_mesh_a[name]
                          + counts_mesh_b[name] + counts_tp.get(name, 0))
            where_s = (
                f"form A {counts_a[name]}, "
                f"form B {counts_b[name]}, forms C {counts_c.get(name, 0)}, "
                f"forms TA/TB {counts_t.get(name, 0)}, forms SA/SB/ST/SR "
                f"{counts_s.get(name, 0)}, serve forms SVA/SVB/SVS "
                f"{counts_sv.get(name, 0)}, forms QA/QB/QC/QS "
                f"{counts_q.get(name, 0)}, forms RA/RB/RS/RC "
                f"{counts_r.get(name, 0)}, forms WA/WB/HA/HS/HQ/HR "
                f"{counts_wh.get(name, 0)}, checker forms A/B/HA/SVA (5k) "
                f"{counts_k.get(name, 0)}, forms CF-A/CF-T "
                f"{counts_cf.get(name, 0)}, "
                f"fp32 group {counts_slice[name]}, "
                f"serve {counts_serve[name]}, granite fp32 group "
                f"{counts_gslice[name]}, granite serve "
                f"{counts_gserve[name]}, mamba2 fp32 slice "
                f"{counts_mslice[name]}, mamba2 serve "
                f"{counts_mserve[name]}, phi3 serve {counts_pserve[name]}, "
                f"moonshot fp32 cut {counts_moon_a[name]}, moonshot serve "
                f"{counts_moon[name]}, mixtral reduced {counts_mix[name]}, "
                f"paligemma fp32 cut {counts_pslice[name]}, paligemma serve "
                f"{counts_pali[name]}, model mesh fp32 group (11a) "
                f"{counts_mesh_a[name]}, model mesh serve (11b) "
                f"{counts_mesh_b[name]}, tp serving (13a–13c) "
                f"{counts_tp.get(name, 0)}")
        launches[name], where[name] = launches_n, where_s
    kernels_line(rows, launches, where)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for child in _CHILDREN:  # the processes a failed phase left
            if child.poll() is None:
                child.kill()
                child.wait()
