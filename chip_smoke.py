#!/usr/bin/env python3
"""Drive raft_tpu_torch (the PyTorch/CUDA port) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name, the device count and ``nvidia-smi``'s name and
   power limit.  No CUDA device is a failure.
2. Build: compile every kernel under ``raft_tpu_torch/csrc`` with nvcc;
   then the ``raise`` validator's first call and a second one.
3. Kernel A (``kmeans_assign_update``) against its plain PyTorch version on
   the flagship's first Lloyd pass: its 500,000 x 128 training set and its
   4,096 initial centroids, tie-aware (``ops.kmeans_update.
   check_assignment``: the tensor core sums the exact bf16 products in its
   own order), the update held to the plain update of the kernel's own
   labels; its time, the assignment / update device split, and a bf16
   ``torch.matmul`` of the same product as ``library_ms``.
4. Flagship path (BASELINE.md config 4, ``conf/sift-like-1m.json`` entry
   ``raft_ivf_pq.dim64``): a 1,000,000 x 128 SIFT-like database (the
   generator of ``bench.py``, numpy seed 0), ``ivf_pq.build`` at
   ``IndexParams(n_lists=4096, pq_dim=64)``, then batches of 5,000 queries
   searched at n_probes 96, k 20 and refined to k 10, recall@10 against
   ``brute_force.knn``.  Launch counts are zeroed just before and read
   just after; Kernel A, both passes of Kernel B (``list_scan`` and
   ``merge_pairs``, ``csrc/pq_list_scan.cu``) and Kernel H (the build's
   balanced k-means assignments) must each be > 0, and Kernel B's gate
   must refuse no search (``search.fused_fallbacks`` unchanged).  Then
   the ``raise`` validation policy's cost: the batch's median ms under
   ``off`` and under ``raise``, in
   turns, and the difference as a share of the batch (the search alone
   too; and CAGRA's itopk-64 batch in phase 11).  The build runs under
   observability collection (``observability.collecting()``).
4b. The host-side subsystems on the flagship index: the no-fence
   contract (the calls through ``observability/stage.py
   _block_until_ready`` during one search + refine batch: 0 with
   collection off, at least one a stage crossed with it on; the batch's
   ms both ways in turns, the fence cost); the build's report
   (``observability.build_report``: every stage the JAX package records
   for this build, none longer than the build, the ``ivf_pq.build.*``
   timers within 10% or 5 ms of ``build.stage_seconds``) and the
   Prometheus text parsed line by line; one request trace
   (``start_request``) whose spans nest the search's stages; the delta
   memtable (``neighbors.delta``) at a streaming size, 16,384 upserts of
   new rows of the flagship's distribution (latent seed 1) and 4,096
   deletes of main-index ids into a ``Memtable(128, capacity=1024)`` on
   the card (capacity 1,024 -> 16,384), merged (``merge_with_main``) into
   the batch's refined top 10: recall@10 >= 0.90 against brute force over
   the live rows and the memtable, no deleted id, and equal to a host
   merge in float64 (distances within 1e-5 of ||q||^2 + max ||x||^2, ids
   tie-aware), its ms and ``digest()``; ``integrity.verify`` at
   ``statistical`` on the flagship (and, in their phases, on IVF-Flat
   nlist 4096 and CAGRA deg32), every check passing, with its seconds.
   Each line carries the card's name and power limit.  The profiler
   phase (7) checks that its events hold the ``raft_tpu:ivf_pq::search``
   and ``raft_tpu:refine`` ranges.
4c. The flagship served (``core/aot`` and ``serving/``): an ``Executor``
   at ``scan_mode="fused"``, n_probes 96, k 10, ``max_batch`` 1,024 (11
   buckets) with one brownout rung at n_probes 48 and a ``ShadowMonitor``,
   and one at the default ``auto`` with an ``IngestServer``; every bucket
   a captured CUDA graph (Kernel B, or G + the final top k), none served
   live; each bucket's replay equal to its live program bit for bit; all
   5,000 queries through ``Server.submit``
   from 16 threads in requests of 1-64 rows (closed loop, then each client
   submitting all its requests at once), each row equal to the direct
   batch's (tie-aware), recall@10, rows/s, p50 / p99, batch fill, the raw
   bucket-1,024 replay loop; a brownout step and back; 4,096 upserts and
   1,024 deletes through ``Server.write`` (visible, never returned,
   replayed from the WAL to the same memtable), folded and swapped in;
   shadow recall and one gated ``Rebalancer`` pass; no capture and no
   cache miss after warm-up or after a swap's own.  B's and G's kernels
   rows gain the served replays under ``also_checked``, their launches
   the kernel events torch.profiler sees in one served run (the replays
   pass no wrapper's count), cross-checked against the run's replays
   times each program's launches.  Every grouped pass checked here and in
   the kernel phases (B, G, F) runs at the static group count and at the
   exact one, bit-equal, each timed (``grouping_cost``).
5. Kernel B (``ivf_pq_scan_fused``, list-major) against its plain version
   on the flagship's batch: 5000 queries of the built index at n_probes
   96, k 20, with the batch's group count and the call's device time split
   into grouping, pass 1 and pass 2, and the pair buffer's bytes; past kt
   64 (k = kt = 256, groups of 32) its pair-group route (Kernel G's pass
   ``recon_pair_list_scan``, then ``merge_pairs``) against plain on the
   batch's first 1,000 queries, with its split (grouping, pass, pass 2),
   pass 2 alone against ``torch.topk`` over the same pairs, and the
   query-major kernel it replaced (``scan_query_major``) held to the same
   plain result and timed in turns; the batch's recall@10 on the one
   build through each route (the query-major kernel swapped in for the
   search's scan; the batch's ms through each in turns);
   Kernel H (``fused_l2_nn``) against its plain version at the shapes the
   build gave it (the extend's assignment, 1,000,000 x 128 -> 4,096, and a
   codebook fit's, 65,536 x 2 -> 256, its small-dim kernel, a row of its
   own in the kernels line: the codebook loop's batched launch, 64
   subspaces x 65,536 x 2 -> 256 in one launch (``fused_l2_nn_batched``,
   labels equal to the plain loop over the members), with the
   one-member call beside it; each H
   check times a call, the kernel's device time and a TF32-off fp32
   ``torch.matmul`` of the same product as ``library_ms``, a TF32-on one
   beside it; above dim 16 also the SIMT tile the tensor-core pass
   replaced, in the same run, and the share of labels equal to its; at
   the extend's shape and at the hierarchical fits' pass shapes the pass
   at two and four warpgroups a block, in turns).
6. IVF-PQ recon mode on the flagship index: ``scan_mode="recon"`` at
   n_probes 96, k 20, refined to k 10 (Kernel G, launches zeroed before,
   read after; pass 1 must be > 0), and Kernel G (``ivf_pq_scan_recon``,
   list-major pass 1) against its plain version on that batch, with its
   split (grouping, pass 1); past kt 64 its pair-group pass
   (``csrc/pair_list_scan.cu``, kt 128) against plain on 1,000 queries,
   with its split and the query-major kernel it replaced
   (``recon_scan_query_major``) in turns; the recon batch's recall@10
   through each route, as for B.  Then
   Kernels C (kt 20 and 4, k 20) and D (kt 4) on the index's codes (rot
   128, 8 bits: the list-major codes pass's tightest shared memory)
   against their plain versions on the batch.
6b. The rest of IVF-PQ on the flagship index: the LUT scan
   (``scan_mode="lut"``, a composition: no kernel) with an fp32 and a
   bf16 LUT on the 5,000 queries (ms, recall@10), and held to the codes
   scan (Kernel D) at kt = k on 1,000 queries within the bf16 rounding's
   bound; ``ivf_pq_helpers`` (a list unpacked and packed back leaves the
   search bit-equal; ``reconstruct_list_data`` equals the recon cache plus
   the centre); then the flagship configuration with
   ``CodebookKind.PER_CLUSTER``: the build (seconds, stages, the batched
   small-dim launches), ``auto`` (B), ``recon`` (G), ``recon8`` (E) and
   ``lut`` at n_probes 96, k 20 -> 10, the batched kernel against plain at
   the per-cluster loop's 4,096 x 1,024 x 2 -> 256, and the per-subspace
   build's codebooks stage beside its figures before the batched loop.
7. Where the flagship's time goes: one more build and one search+refine
   batch under ``torch.profiler`` — device busy time, idle share, heaviest
   kernels.
8. IVF-Flat at full width on the same data (``conf/sift-like-1m.json``
   entries ``raft_ivf_flat.nlist4096`` and ``.nlist16384``):
   ``ivf_flat.build`` at n_lists 4096 (seconds, stages, capacity), search
   at n_probes 32 / 64 / 128, k 10 (ms, QPS, recall@10, the super-tile
   factor F, the launches of Kernel F's two routes: the list-major pass
   must run, the query-major kernel not), the same build's recall@10 at
   each n_probes through each route (within 0.0004), Kernel F
   (``ivf_flat_scan``, list-major, ``csrc/flat_list_scan.cu``) against
   its plain version at n_probes 64 with its device split (grouping, pass
   1), groups and the bytes it streams against the probed live bytes;
   at k 100 the search on the first 1,000 queries (one launch of the
   pair-group pass ``flat_pair_list_scan``, no other scan) and the pass
   against plain there and on a 200,000 x 25 index (GloVe-25's width:
   one-value row loads), each with its split and the query-major kernel
   it replaced (``flat_scan_query_major``) held to the same plain result
   and timed in turns; one batch under the profiler; then n_lists
   16384 (the hierarchical fit) at n_probes 128 with Kernel F against
   plain there, and Kernels A and H against plain at its fit's and
   extend's shapes.
9. k-means at full width (BASELINE.md config 3): ``kmeans.fit`` on the
   1,000,000 x 128 rows at ``KMeansParams(n_clusters=1024)`` (k-means++,
   max_iter 300, tol 1e-4) and ``predict`` — seconds, iterations, inertia,
   Kernel A and H launches — then Kernel H (``fused_l2_nn``) against its
   plain version at 1,000,000 x 128 -> 1,024 and at BASELINE.md config 2's
   100,000 x 128 -> 100,000, with ``torch.cdist(x, y).min(1)`` timed as a
   yardstick (no single PyTorch call computes min + first argmin), and
   Kernel A against plain at the Lloyd pass's shape.
10. The round-5 profile decompositions (PERF.md kernel table rows 10-13),
    through the port's profile modules at the JAX scripts' sizes, launch
    counts zeroed before and read after: Kernel F's four (gather, extract)
    variants (the pair-group pass, each beside the same variant on the
    query-major kernel, held to the same plain result and timed in turns)
    on phase 8's two indexes at (n_lists, n_probes) (16384, 256) and
    (4096, 128), kt 10, and the pre-gather's time; the raw variant of
    Kernel G's rows on the flagship index (n_probes 96); Kernel J against
    ``torch.index_select`` on 320,000 random rows of a 1,000,000 x 128
    table, f32 and bf16, 1,024 and 2,048 rows a block; Kernel A's cuts
    (mm, mmmin, mmargmin, full; base, uw, mxuonly) at 1,000,000 x 128 ->
    1,024 with a bf16 ``torch.matmul`` of the same product as the
    yardstick, and the JAX script's uw spot check.  Then every variant
    against its plain version: raw distances within 1e-5 of ‖q‖² + max
    ‖x‖² (1e-4 for G's rows), selections as Kernel F's, Kernel J
    bit-equal, the cuts tie-aware as Kernel A (dmin within τ, labels the
    plain ones or at ties), counts exact from their own labels (mxuonly's
    column sums within 1e-4 relative), sums as Kernel A's.
11. Persistence at full width, on the indexes the script built, files
    under a ``tempfile.mkdtemp()`` it deletes: the flagship IVF-PQ
    ``ivf_pq.save`` then ``ivf_pq.load`` on the card (file bytes, save
    and load seconds, the recon cache's re-decode timed apart), the
    phase-4 batch searched and refined on the loaded index against the
    in-memory one (ids equal, distances bit-equal; two searches of the
    in-memory index are compared first, and were they to differ, the
    loaded one would be held to the ids), Kernel B's two passes launched
    on the loaded index; the flagship file with one byte flipped, then
    cut to half, makes ``load`` raise ``CorruptIndexError``; IVF-Flat
    nlist 4096 the same at n_probes 64, k 10, with Kernel F's list-major
    pass launched; then the checkpointed flagship build: ``build(...,
    checkpoint=dir)`` interrupted at its first ``interruptible.
    synchronize`` by ``faults.inject(..., exc=InterruptedException)``
    (the manifest must read ``["kmeans"]``), ``resume=True`` (the
    checkpoint loaded once and saved once, the centers bit-equal to the
    stage file, recall@10 against the flagship's recorded 0.9769-0.9786,
    printed with the gap when outside), then a resume from the complete
    checkpoint, bit-equal in every leaf to the build that wrote it; the
    seconds of each build.  The phase's CAGRA part closes phase 13.
12. Filtered and mutable indexes at full width, on the indexes built
    above, with three filters over the 1M ids: 50% per query (random
    words, seed FILTER_SEED), a ``TenantFilter`` of 16 contiguous ranges
    of 62,500 ids (query q in tenant q mod 16) and the 50% filter's
    first row broadcast (an ``expand``, query stride 0).  The flagship
    (n_probes 96, k 20 -> 10) and IVF-Flat nlist 4096 (n_probes 64, k
    10): ms per batch of 5,000 with each filter beside the unfiltered ms,
    recall@10 against the filtered ``brute_force.knn`` (>= 0.90 at 50%
    on the flagship), every returned id admitted, the list-major passes
    launched and no query-major kernel; the full-probe contract on 64
    queries (n_probes 4096: the filtered top 10 equals the unfiltered top
    64 with the rejected rows dropped, bit for bit, each query keeping at
    least 10 admitted rows); Kernels B and G (flagship) and F (IVF-Flat)
    with the 50% filter against their plain versions, B's pass-1 device
    ms with each filter beside the unfiltered pass in turn.  Mutation on
    the flagship: 10,000 random ids deleted (none surfaces; recall over
    the live rows), 5,000 of them upserted with their rows, ``compact``
    (capacity, each rebuilt cache's seconds; the search after equals the
    search before up to ties), the mutated index saved and loaded
    (searches bit-equal); on IVF-Flat 4096 delete and compact.  After the
    CAGRA phase: ``deg32`` at itopk 64 width 2 with the 50% filter
    (recall printed, one walk launch a search, every id admitted), the
    filtered walk captured and held to the plain walk bit for bit, and
    the delete shim (no deleted id).  In the deep phase: filtered
    ``fused`` / ``codes`` / ``recon8`` searches at kt 4 on 1,000 queries
    with one 50% row broadcast, and Kernels C, D and E with it against
    their plain versions.  Each filtered kernel check is an
    ``also_checked`` row of its kernel (its bytes count the admission
    bits: one a query and probed live row, one a probed live row for a
    broadcast row).  Then filtered search at k 100, where every scan keeps
    more than 64 rows a pair: the flagship searched at k 200 and refined
    to 100 in ``auto`` (Kernel B at kt 200: G's pair-group pass and the
    merge) and in ``recon`` at kt 128 (Kernel G's pair-group pass), and
    IVF-Flat nlist
    4096 at n_probes 64, k 100 (Kernel F's pair-group pass), each
    unfiltered and with each filter: ms per batch of 5,000, recall@100
    against ``brute_force.knn`` at k 100 (filtered as the search; at 50%
    per query at least the unfiltered recall@100 less 0.05, the tenant
    filter's printed only), every id admitted, the route launched and no
    other (no list-major pass, no query-major kernel); the unfiltered
    ``auto`` recall@100 through B's route and through its query-major
    kernel swapped in (within 0.002, the batch's ms through each in
    turns); the full-probe contract at k 100 (against the unfiltered k
    256) on 64 queries for both indexes (IVF-Flat's two searches on the
    pair-group pass); B, G and F with the 50% filter against their plain
    versions on 1,000 queries at those shapes, and unfiltered on the
    whole batch of 5,000 (the main entries of the pair-group pass's rows,
    B's with pass 2 against ``torch.topk``).  In the deep phase the same
    at k = kt = 128 refined to 100, on 1,000 queries with the three
    filters over the 10M ids: ``fused`` (Kernel C: D's pair-group pass
    and the merge), ``codes`` and ``recon8`` (D and E's pair-group pass;
    no query-major kernel), each unfiltered batch's recall@100 through
    the pass and through the query-major kernel swapped in (within 0.002,
    ms in turns), and C, D and E with the 50% filter against plain, the
    query-major kernels held to the same plain result and timed in turns
    beside the route.
13. CAGRA at full width (``conf/sift-like-1m.json`` entry
    ``raft_cagra.deg32``) on the same rows: ``cagra.build`` at
    ``IndexParams(graph_degree=32, intermediate_graph_degree=64)`` (seconds,
    stage seconds, the build's projected dimension, launches zeroed before
    the build: the walk kernel ``cagra_walk`` (the self-walk, one launch a
    chunk), Kernel I's hop kernel ``cagra_hop`` (the exact merge) and H
    must be > 0), the conf's four search points (itopk 24, 32, 64 width 2,
    128 width 2) at batch 5,000 and k 10 (first batch, warm ms, QPS,
    recall@10 — at least 0.90 at itopk 64 and 128 — walk format; exactly
    one walk launch and no hop launch a search), serving buckets of 1 / 8 /
    64 queries at itopk 32 and 64; then the yardstick, the per-hop loop the
    walk kernel replaced (``hop_loop``: per hop ``select_parents``,
    ``expand`` and the hop kernel, swapped in for the walk), against the
    walk kernel in turns at each point and bucket (equal results, medians,
    QPS), the build's self-walk chunks through both, one batch under the
    profiler through each route (idle share); the walk kernel against the
    plain walk (``torch.equal`` on keys, ids, visited flags and hop counts)
    on walks captured from the run: the search's 5,000 / itopk 64 / width
    2, a bucket's 64 / 32 / 1 and a build self-walk chunk's 8,192 / 96 / 1
    (CUDA-event and device ms, plain ms, the byte bound over the hops run,
    the yardstick's ms); and the hop kernel against its plain version at
    the build's exact merge and on the plain walk's fourth search hop,
    with ``torch.topk`` over the [buffer | candidate] keys timed as a
    yardstick (it does no dedupe).  Then the persistence phase's CAGRA
    part: ``cagra.save`` / ``cagra.load`` (bytes, seconds), the loaded
    index and a fresh index object of the same dataset and graph each
    searched first on a handle of one seed (the entry set is drawn there)
    at itopk 64 width 2: equal results and exactly one walk launch; a
    checkpointed build and a resume from its complete checkpoint, the
    graph bit-equal; the phase's seconds and numbers on one line with the
    card's name and power limit.
14. Deep path at full width (``conf/deep-like-10m.json`` entry
    ``raft_ivf_pq.dim48``): a 10,000,000 x 96 database + 5,000 queries
    from the same generator, ``ivf_pq.build`` at ``IndexParams(
    n_lists=8192, pq_dim=48, kmeans_trainset_fraction=0.1)`` (the
    hierarchical k-means build, Kernel A; its stages' wall seconds),
    Kernels A and H against their plain versions at the fit's three pass
    shapes and H at the codebook fits' shape, then per scan mode — ``auto`` (Kernel B), ``fused`` kt 4 (Kernel C),
    ``codes`` kt 4 (Kernel D), ``recon8`` kt 4 (Kernel E), ``recon`` kt 4
    (Kernel G), and ``auto`` on the index with its recon cache dropped
    (Kernel C at kt 20) — search at n_probes 96, k 20, refine to k 10: ms
    per batch, QPS and recall@10, each mode's launch counts zeroed before
    it and read after (``auto`` must launch both passes of Kernel B with
    no fallback; ``fused``, ``codes`` and the lean ``auto`` the
    list-major codes pass ``code_list_scan``, C with pass 2, and no
    query-major codes kernel; ``recon8`` E's list-major pass
    ``recon8_list_scan`` and never its query-major kernel), ``auto``,
    ``recon`` kt 4 and ``recon8`` kt 4 also through each route of B, G
    and E on the one build (within 0.0004), ``fused`` and ``codes``
    through each route of C and D (printed only).  Kernels B, C, D, E and
    G against their plain versions on the full batch at each mode's shape
    (with their device splits; E's time beside G's); the codes pass
    against Kernel G's pass 1 over the recon cache on the codes' norms,
    and E's pass with every scale 1 against G's pass 1 over the int8
    rows as bf16, each bit for bit, and the same at kt 128 (D and E's
    pair-group pass against G's on the same groups); ``codes`` and
    ``recon8`` at k = kt = 128 refined to 100 on the whole batch (the
    pair-group pass launched, no other scan; ms a batch) and D and E's
    pass against plain on that batch's scan inputs (device split, groups,
    the modelled bytes a probed live byte, printed: the main entries of the
    ``code_pair_list_scan`` / ``recon8_pair_list_scan`` rows); C's route
    past kt 64 (D's pass, then the merge, pass 2 against ``torch.topk``:
    the main entry of C's row past kt 64) and D and E's pass at k = kt =
    128 on 1,000 queries, the query-major kernels of C, D and E held to
    the same plain result and timed in turns, unfiltered and (phase 12)
    filtered; and each mode's batch under the profiler.  Then the rest of IVF-PQ on the
    deep index: ``lut`` on 1,000 queries; ``recon8`` at k = kt = 256 (the
    composition past Kernel E's gates) on 1,000 queries, the composition
    held to E at kt 128, and E's query-major kernel at a row width past
    1,024 bytes against plain; then InnerProduct (raft-ann-bench's
    ``deep-image-96-inner`` analogue): the deep rows unit-normalised,
    ``IndexParams(metric=InnerProduct, n_lists=8192, pq_dim=48,
    kmeans_trainset_fraction=0.1)``, ``auto`` / ``recon`` (the
    composition; auto counts a fallback, reason "dtype") on 5,000 queries
    and ``lut`` on 1,000, refined by inner product, recall@10 against the
    inner-product ``brute_force.knn`` (>= 0.80), the 50% per-query filter,
    and the full-probe filter contract on 64 queries, bit for bit.
15. Distributed (BASELINE.md config 5, ``bench.py bench_mnmg``): (a)
    world size 1 over NCCL in this process: the nine comms self-tests,
    ``distributed.kmeans.fit`` on 10,000,000 x 256 rows (a 32-d latent
    drawn on the card) -> 1,024 clusters, 5 iterations at tol 0 from
    k-means++, held to the same Lloyd loop without comms from the same
    centroids, Kernel H's launches counted on the fit (5 + 1),
    ``distributed.knn`` of 1,000 queries at k 10 held to
    ``brute_force.knn`` tie-aware, H at the fit's shape against plain;
    (b) two gloo ranks on the card (spawned, 1,250,000 rows each, the
    kernels already built): the self-tests, the fit and the kNN equal to
    world size 1 on the same 2.5M rows; the ops gloo staged through the
    host and each collective's ms.  Before it, after the IVF-Flat phase,
    the card paths that call ``select_k`` (brute force, refine, IVF-Flat
    search, the memtable merge) timed with its JAX tie order and with
    ``torch.topk`` alone, in turns.
16. Distributed by row (``bench.py bench_distributed``: 1,048,576 x 96
    rows from a 32-d latent, IVF-PQ with 512 lists a shard, pq_dim 48, 5
    k-means iterations, 32 probes, 1,000 queries at k 10; IVF-Flat with
    512 lists a shard and CAGRA deg32 at itopk 64, width 2 on the same
    rows): (a) world size 1 over NCCL in this process: ``distributed.ann``
    ``build`` / ``build_flat`` / ``build_cagra``, then ``search`` at
    ``auto`` (Kernel B) and ``recon`` (Kernel G), ``search_flat`` (Kernel
    F) and ``search_cagra`` (Kernel I's walk), each kernel's launches
    counted on its searches; every answer equal to the single-index
    ``ivf_pq.search`` / ``ivf_flat.search`` / ``cagra.search`` (on the
    table and entry set the sharded build attached) of the same shard (ids
    equal, distances within 1e-4); B, G, F and I held to their plain
    versions at these shapes (``also_checked``); (b) two gloo ranks on the
    card, 524,288 rows each: every search equal to the host merge of the
    ranks' single-index searches, shard 1 failed giving rank 0's answer
    and status [1, 0], each index's recall@10 within 0.02 of part (a)'s
    (and above 0.5); build seconds, QPS, recall@10 and the allgather's ms
    a call for each part.
17. Distributed, routed (``bench.py bench_distributed``'s routed
    configuration: phase 16's rows, IVF-PQ with 512 GLOBAL lists, pq_dim
    48, 5 iterations, the recon cache, 32 probes, 1,000 queries at k 10):
    (a) world size 1 over NCCL: ``build(placement="by_list")`` end to end;
    the routed ``recon`` (Kernel G) and ``fused`` (Kernel C) searches of
    the base's routed index, ``fused`` without the code leaves (Kernel B)
    and at k 100 (C past kt 64), each equal to ``ivf_pq.search`` of the
    base at the same form (ids equal, distances within 1e-4); B, G and C
    held to their plain versions on rank 0's probes of a 4-shard
    placement, three in four of them sentinels (``also_checked``); (b)
    four gloo ranks on the card, each loading the base and placing its
    lists at r = 1 and r = 2: every answer equal to the single-index
    search (ids equal or at a tie), alike on every rank, every rank's
    probe set equal; shard 0 failed at r = 2 bit-identical with status 3,
    at r = 1 degraded (its recall printed); a hedged straggler (10x the
    median search, the median its deadline) bit-identical, its p99 below
    the delay; catch-up and readmission of shard 2 through a stub server;
    the routed stream equal on every rank and read back; the most-scanned
    shard within 1.5x the probed rows / 4; build and placement seconds,
    QPS, the failover QPS, the hedged p99, the allgather's ms.
18. A JSON line with each kernel's route, source, launches, error, time
    (CUDA events), plain-version time, bound and yardstick library call
    (null where none computes the product) on its main path (the
    pair-group pass's six rows, ``flat_pair_list_scan``,
    ``recon_pair_list_scan``, B past kt 64 (G's pass + ``merge_pairs``),
    C past kt 64 (D's pass + ``merge_pairs``), ``code_pair_list_scan`` and
    ``recon8_pair_list_scan``: launches from the unfiltered k-100 batches
    and the route held to plain on those batches' own scan inputs (C's on
    the 1,000-query deep ``fused`` batch), the query-major kernel's error
    against the same plain result and its ms in turns as
    ``yardstick_query_major_max_abs_err`` and
    ``yardstick_query_major_ms``; B and C's pass 2 alone and
    ``torch.topk`` over the same pairs in turns as ``pass2_ms`` and
    ``pass2_topk_ms``, their bound the function's bytes as on every
    route (the pair buffer's bytes printed apart as
    ``pair_buffer_bytes``); the 1,000-query checks under
    ``also_checked``), and
    under ``also_checked`` the same measurements at the other shapes its
    paths give it; the ``nvidia-smi`` line; the result line ``{"ok":
    true, "device": {...}}`` last.

Bounds use the H100 SXM peaks: 3.35 TB/s of device memory, 989 TFLOP/s
for bf16 products (Kernels A-E and G multiply bf16 values, the int8 scan
by way of bf16; C and D's bytes are each probed list's live rows once at
their packed width + 8), 495 TFLOP/s of TF32 for Kernel F's list-major
and pair-group passes and Kernel H above dim 16 (their fp32 products as 3xTF32: three TF32
products of the hi / lo split, so three times the operations; the fp32
FFMA time of one product is printed beside it, the yardstick of the
earlier SIMT and query-major times) and 67 TFLOP/s of fp32 FFMA for F's
query-major route, H's small-dim kernel and I (I: its bf16 products are
summed one by one in dimension order, as its plain version sums them; the
walk's bytes are each run hop's fat rows once, over the hops its queries
ran).  Beside the bytes bound each walk has a latency bound: its longest
query's hops, each one dependent device-memory load (the exact-row
source: two, the graph row then the rows) of the latency a pointer chase
measures in the build phase, once for each wave of the blocks an SM holds
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, printed with each walk
and hop check, as the build phase prints each walk and hop kernel's ptxas
registers and spills).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12

N_DB, N_QUERIES, DIM, LATENT, NOISE = 1_000_000, 5_000, 128, 16, 0.05
N_LISTS, PQ_DIM, N_PROBES, K_SEARCH, K = 4096, 64, 96, 20, 10
DEEP_DB, DEEP_DIM, DEEP_LISTS, DEEP_PQ_DIM = 10_000_000, 96, 8192, 48
DEEP_TRAIN_FRACTION, DEEP_KT = 0.1, 4
SEARCH_REPS = 3
KERNEL_REPS = 5
# one dependent device-memory load's latency in ns, measured on the card
# by a pointer chase in the build phase (load_latency_ns)
LOAD_NS = None
# queries of the flagship batch at which the large-kt (query-major) routes
# of Kernels B and G are held to their plain versions
LARGE_KT_QUERIES = 1_000
# IVF-Flat (conf/sift-like-1m.json raft_ivf_flat.nlist4096 / .nlist16384)
FLAT_LISTS, FLAT_PROBES, FLAT_CHECK_PROBES = 4096, (32, 64, 128), 64
FLAT_FINE_LISTS, FLAT_FINE_PROBES = 16384, 128
# k of the check of Kernel F's query-major route (kt past KT_LIST_MAX) on
# the first LARGE_KT_QUERIES queries
FLAT_LARGE_K = 100
# that route on a row width off a multiple of 4 (GloVe-25's): an IVF-Flat
# index of the generator's rows at this width
FLAT_ODD_ROWS, FLAT_ODD_DIM, FLAT_ODD_LISTS = 200_000, 25, 1024
# the most two routes' recall@10 may differ by on one build
ROUTE_RECALL_GAP = 0.0004
# k-means (BASELINE config 3) and fusedL2NN (BASELINE config 2)
KMEANS_CLUSTERS, NN_ROWS = 1024, 100_000


def sift_like(n, n_queries, dim, latent, noise, device, seed=0,
              chunk=1 << 20):
    """bench.py's generator (``_make_dataset``): a 16-d latent mapped to
    ``dim`` plus 5% noise, numpy seed 0, database rows first, then the
    queries.  Drawn in row chunks straight onto the device, which gives
    the same numbers as one draw without a host copy of the whole set."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n + n_queries, latent)).astype(np.float32)
    A = rng.normal(size=(latent, dim)).astype(np.float32) / np.sqrt(latent)
    X = torch.empty(n + n_queries, dim, dtype=torch.float32, device=device)
    for s in range(0, n + n_queries, chunk):
        x = (Z[s:s + chunk] @ A).astype(np.float32)
        x += noise * rng.normal(size=x.shape).astype(np.float32)
        X[s:s + chunk] = torch.from_numpy(x)
    return X[:n], X[n:]


def counters():
    """Every kernel wrapper, by kernel name."""
    from raft_tpu_torch.ops import cagra_hop as chop
    from raft_tpu_torch.ops import cagra_walk as cw
    from raft_tpu_torch.ops import fused_l2_nn as fnn
    from raft_tpu_torch.ops import kmeans_update as ku
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_code_scan as pcs
    from raft_tpu_torch.ops import pq_group_scan as pgs
    from raft_tpu_torch.ops import row_gather as rg

    return {"kmeans_assign_update": ku.kmeans_assign_update,
            "list_scan": pgs.list_scan,
            "merge_pairs": pgs.merge_pairs,
            "scan_query_major": pgs.scan_query_major,
            "recon_scan_query_major": ps.recon_scan_query_major,
            "recon_pair_list_scan": ps.recon_pair_list_scan,
            "code_list_scan": pcs.code_list_scan,
            "code_pair_list_scan": pcs.code_pair_list_scan,
            "codes_fused_query_major": pcs.codes_fused_query_major,
            "codes_scan_query_major": pcs.codes_scan_query_major,
            "recon8_list_scan": pcs.recon8_list_scan,
            "recon8_pair_list_scan": pcs.recon8_pair_list_scan,
            "recon8_scan_query_major": pcs.recon8_scan_query_major,
            "flat_list_scan": ps.flat_list_scan,
            "flat_scan_query_major": ps.flat_scan_query_major,
            "flat_pair_list_scan": ps.flat_pair_list_scan,
            "fused_l2_nn": fnn.fused_l2_nn,
            "fused_l2_nn_batched": fnn.fused_l2_nn_batched,
            "cagra_hop": chop.cagra_hop,
            "cagra_walk": cw.cagra_walk,
            "cagra_walk_exact": cw.cagra_walk_exact,
            "pair_scan_variant": ps.pair_scan_variant,
            "pair_scan_variant_query_major": ps.pair_scan_variant_query_major,
            "row_gather": rg.row_gather,
            "kmeans_pass_cut": ku.kmeans_pass_cut}


def zero_launches():
    from raft_tpu_torch.ops import fused_l2_nn as fnn

    for fn in counters().values():
        fn.launches = 0
    fnn.fused_l2_nn.small_dim_launches = 0


def read_launches():
    """Each wrapper's launches; ``fused_l2_nn`` counts both of Kernel H's
    kernels, ``fused_l2_nn_small_dim`` the small-dim kernel's share."""
    from raft_tpu_torch.ops import fused_l2_nn as fnn

    out = {name: fn.launches for name, fn in counters().items()}
    out["fused_l2_nn_small_dim"] = fnn.fused_l2_nn.small_dim_launches
    return out


def h_tf32_launches(launches):
    """Kernel H's tensor-core launches in a run: its launches less the
    small-dim kernel's."""
    return launches["fused_l2_nn"] - launches["fused_l2_nn_small_dim"]


def bound(nbytes, flops, peak=BF16_FLOP_PER_S):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over their peak (bf16 products by
    default; TF32 for Kernel F's list-major pass and H's tensor-core pass,
    fp32 FFMA for F's query-major route and H's small-dim kernel)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


def peak_gb():
    import torch

    return torch.cuda.max_memory_allocated() / 1e9


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up, from CUDA
    events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# idle seconds at each end of a profiler window taken again
PROFILE_PAD_S = 0.25


def device_ms(fn, reps, kernel=""):
    """Mean device ms per call of the CUDA kernels whose name contains
    ``kernel`` (all of a call's kernels when empty), over ``reps`` calls
    after one warm-up, from torch.profiler: CUDA events around a run of
    ~30 us launches time the host's gaps between them, not the kernel."""
    return device_split(fn, reps, (kernel,))[1][kernel]


def device_split(fn, reps, names, may_be_absent=()):
    """``(total, {name: ms})``: mean device ms per call of all of a call's
    CUDA kernels, and of those whose name contains each of ``names``, over
    ``reps`` calls after one warm-up, from one torch.profiler window.  A
    kernel that ran takes time: where a named kernel reads 0 the window is
    taken once more with PROFILE_PAD_S of idle time at each end (the
    profiler drops device events it places outside its window), and a
    second 0 fails the run, listing what the window held
    (``may_be_absent``: names that may read 0)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(2):
        pad = PROFILE_PAD_S * attempt
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in events) / 1e3 / reps
        split = {name: sum(e.self_device_time_total for e in events
                           if name in e.key) / 1e3 / reps for name in names}
        empty = [name for name in names
                 if split[name] <= 0 and name not in may_be_absent]
        if not empty:
            return total, split
        print(f"profiler window {attempt + 1}: no device time for {empty}; "
              f"its CUDA events: "
              f"{[(e.key[:60], e.count) for e in events][:8]}", flush=True)
    raise AssertionError(f"the profiler measured no device time for "
                         f"{empty} in two windows")


def list_major_split(label, run, probes, n_lists, pair_bytes, merged,
                     pass1="list_scan_kernel", group=None):
    """The list-major route's device time over one call of ``run``, split
    into the grouping (every kernel but the two passes), pass 1 (the
    kernels whose name holds ``pass1``) and pass 2 (``merged``: Kernel B;
    else Kernel F or G, no pass 2); the batch's groups (of ``group``
    pairs, the list-major passes' 128 by default) and touched lists, and
    the pair buffer's bytes (not in the bound)."""
    from raft_tpu_torch.neighbors import grouped

    group = group or grouped.GROUP
    total, split = device_split(run, KERNEL_REPS, (pass1, "merge_kernel"),
                                () if merged else ("merge_kernel",))
    p1, p2 = split[pass1], split["merge_kernel"]
    n_groups = int(grouped.num_groups(probes, n_lists, group))
    touched = int(grouped.touched_lists(probes, n_lists))
    print(f"{label}: {n_groups:,} groups over {touched:,} touched lists "
          f"({probes.numel() / max(n_groups, 1):.1f} pairs a group); device "
          f"{total:.3f} ms = grouping {total - p1 - p2:.3f} + pass 1 "
          f"{p1:.3f}" + (f" + pass 2 {p2:.3f}" if merged else "")
          + f"; pair buffer {pair_bytes / 1e6:.1f} MB", flush=True)
    assert p1 > 0 and (p2 > 0) == merged, f"{label}: pass split {split}"
    return {"device_ms": total, "grouping_device_ms": total - p1 - p2,
            "pass1_device_ms": p1, "pass2_device_ms": p2,
            "n_groups": n_groups, "touched_lists": touched,
            "pair_buffer_bytes": pair_bytes}


def timed_once(fn):
    """``(fn(), ms)``: one call, its time from CUDA events.  The plain
    versions are timed by the call whose result is compared."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


MEASURED = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
# measured too where a kernel's check has them
EXTRA = ("library_tf32_ms", "yardstick_simt_ms", "yardstick_simt_device_ms",
         "simt_label_agreement", "block_size_device_ms",
         "tau", "label_flips", "device_ms", "assign_device_ms",
         "update_device_ms", "grouping_device_ms", "pass1_device_ms",
         "pass2_device_ms", "n_groups", "touched_lists", "pair_buffer_bytes",
         "source", "check_launches", "yardstick_loop_ms", "walk_hops",
         "unfiltered_pass1_device_ms", "tenant_pass1_device_ms",
         "broadcast_pass1_device_ms", "filter_bytes",
         "yardstick_query_major_ms", "yardstick_query_major_max_abs_err",
         "ffma_bound_ms", "group", "pass2_ms", "pass2_topk_ms",
         "pass2_candidates", "pass2_launches", "latency_bound_ms",
         "threads", "resident_blocks")


def load_latency_ns(dev, n=1 << 26, steps=20_000):
    """One dependent device-memory load's latency (ns): ``steps`` loads of
    a pointer chase (``csrc/mem_latency.cu``) around a random cycle over
    ``n`` int32 (256 MB, five times the L2), one thread, after a warm-up
    chase; CUDA events over three chases."""
    import torch
    from raft_tpu_torch.ops import _cuda

    g = torch.Generator(device=dev)
    g.manual_seed(22)
    perm = torch.randperm(n, generator=g, device=dev).int()
    nxt = torch.empty_like(perm)
    nxt[perm.long()] = torch.roll(perm, -1)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def chase():
        _cuda.check(_cuda.library().raft_mem_latency_chase(
            nxt.data_ptr(), 0, steps, out.data_ptr(), stream), "chase")

    return cuda_ms(chase, 3) * 1e6 / steps


def walk_latency_bound(nq, max_hops, loads, resident):
    """(ms, waves) of a walk's latency bound: its longest query's hops, each
    ``loads`` dependent device-memory loads of LOAD_NS (a table walk's fat
    row; the exact-row source's graph row, then its candidates' rows),
    once for each wave of ``resident`` blocks per SM over the card's SMs
    (one query a block)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    waves = -(-nq // max(resident * sms, 1))
    return max_hops * loads * LOAD_NS * waves / 1e6, waves


def ptxas_template(kernel):
    """``walk_kernel<256,1,0,0,0>`` from a mangled Kernel I name (template
    arguments in order), else the name as it is."""
    found = re.search(r"\d+([a-z_]+_kernel)I((?:L[ib]\d+E)+)E", kernel)
    if found is None:
        return kernel
    args = re.findall(r"L[ib](\d+)E", found.group(2))
    return f"{found.group(1)}<{','.join(args)}>"


def at_shape(row, shape, launches):
    """A kernel's check at one more shape its paths give it: the shape,
    the kernel's launches in the run of that path, and the row's
    measurements; listed under ``also_checked`` in the kernels line."""
    return {"shape": shape, "launches": launches,
            **{key: row[key] for key in MEASURED + EXTRA if key in row}}


_T0 = time.perf_counter()


def phase(name):
    """Start a phase: its name and the wall seconds since the start."""
    print(f"== {name} (t = {time.perf_counter() - _T0:.1f} s)", flush=True)


def device_breakdown(label, fn, top=6, ranges=()):
    """Run ``fn`` once under torch.profiler: wall time, the summed device
    time of its kernels, the device's idle share of the wall time, and its
    heaviest kernels (profiler overhead inflates the wall time).  Each
    label in ``ranges`` (a ``core.tracing`` range) must be among the
    profiler's events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{label} under the profiler: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.2f} ms {100 * ms / max(busy_ms, 1e-9):5.1f}% "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)
    keys = {e.key for e in prof.key_averages()}
    for name in ranges:
        found = [e for e in prof.key_averages() if e.key == name]
        assert found, f"{label}: the profiler saw no {name!r} range"
        print(f"  range {name}: x{found[0].count}, "
              f"{found[0].cpu_time_total / 1e3:.2f} ms host", flush=True)
    return keys


LIBRARY_OUT_BYTES = 8e9     # largest product a yardstick matmul may write


def matmul_ms(a, b, tf32=False):
    """CUDA-event ms of ``torch.matmul(a, b.T)`` (for fp32: TF32 off, or on
    with ``tf32``), the yardstick of a kernel whose product it computes;
    None when its output would pass ``LIBRARY_OUT_BYTES``."""
    import torch
    from raft_tpu_torch.utils import precision

    if a.shape[0] * b.shape[0] * a.element_size() > LIBRARY_OUT_BYTES:
        return None
    with precision.highest():         # which restores the flag after
        torch.backends.cuda.matmul.allow_tf32 = tf32
        ms = cuda_ms(lambda: torch.matmul(a, b.T), KERNEL_REPS)
    torch.cuda.empty_cache()
    return ms


def check_kernel_a(train, centroids, shape):
    """Kernel A vs plain on one Lloyd pass with unit weights (``shape``
    names it in the print), tie-aware (``ops.kmeans_update.
    check_assignment``): the tensor core sums the exact bf16 products in
    its own order, so dmin is held within τ and each label to the plain
    label or a tie (within 2τ); the count of labels that differ is
    printed.  The update is held to the plain update from the kernel's own
    labels: counts of unit weights equal, sums within 1e-5 · count ·
    max|x| (fp32 atomic order).  Then its time, the device split between
    the assignment and the update kernels, and a bf16 ``torch.matmul`` of
    the same product as ``library_ms`` (a yardstick: no single call
    computes argmin + update)."""
    import torch
    from raft_tpu_torch.ops import kmeans_update as ku

    xb = train.to(torch.bfloat16)
    w = torch.ones(train.shape[0], dtype=torch.float32, device=train.device)
    sums, counts, dmin, labels = ku.kmeans_assign_update_labelled(
        xb, w, centroids)
    (_, _, p_dmin, p_labels), plain_ms = timed_once(
        lambda: ku.kmeans_assign_update_labelled_plain(xb, w, centroids))
    check = ku.check_assignment(xb, centroids, dmin, labels, p_dmin,
                                p_labels)
    assert check.ok, f"kernel A at {shape}: {check}"
    u_sums, u_counts = ku.update_plain(xb, w, labels, centroids.shape[0])
    assert torch.equal(counts, u_counts), (
        f"kernel A at {shape}: counts differ from the update of its labels "
        f"in {int((counts != u_counts).sum())} clusters")
    tol = 1e-5 * u_counts[:, None] * float(xb.float().abs().max()) + 1e-6
    sums_err = (sums - u_sums).abs()
    assert bool((sums_err <= tol).all()), (
        f"kernel A at {shape}: sums differ by up to {float(sums_err.max())}")
    err = max(check.dmin_err, float(sums_err.max()))
    print(f"kernel A vs plain at {shape}: max |dmin err| {check.dmin_err} "
          f"(tau {check.tau:.3e}), labels differing {check.flips} of "
          f"{labels.numel():,} (all at ties), counts equal to the update "
          f"of its labels, max |sums err| {float(sums_err.max())}",
          flush=True)
    del sums, counts, dmin, labels, p_dmin, p_labels, u_sums, u_counts

    def run():
        ku.kmeans_assign_update(xb, w, centroids)

    ms = cuda_ms(run, KERNEL_REPS)
    assign_ms = device_ms(run, KERNEL_REPS, "assign_kernel")
    update_ms = device_ms(run, KERNEL_REPS, "update_kernel")
    lib_ms = matmul_ms(xb, centroids.to(torch.bfloat16))
    n, dim = train.shape
    k = centroids.shape[0]
    flops = 2.0 * n * k * dim
    nbytes = (n * dim * 2 + n * 4 + k * dim * 2 + k * 4      # inputs
              + k * dim * 4 + k * 4 + n * 4)                 # outputs
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"kernel A at {shape}: {ms:.3f} ms/pass "
          f"({flops / ms / 1e9:.1f} TFLOP/s), device: assignment "
          f"{assign_ms:.3f} ms + update {update_ms:.3f} ms (update "
          f"{update_ms / max(assign_ms + update_ms, 1e-9):.1%}), plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), bf16 "
          f"matmul {'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}",
          flush=True)
    return {"name": "kmeans_assign_update", "route": "cuda",
            "source": "raft_tpu_torch/csrc/kmeans_update.cu",
            "replaces": "raft_tpu/ops/kmeans_update_pallas.py:78",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "tau": check.tau, "label_flips": check.flips,
            "assign_device_ms": assign_ms, "update_device_ms": update_ms}


def ties_only(v, i, ref_i, atol=1e-4):
    """True when every id that differs from the reference sits at a
    distance tie (within ``atol`` + 1e-4 relative): next to an equal
    distance in its sorted row, or on the row's last finite rank (whose tie
    partner may lie past the row; ``profiles.pair_cut_ties.tie_mask``)."""
    from raft_tpu_torch.profiles.pair_cut_ties import tie_mask

    return bool(((i == ref_i) | tie_mask(v, atol)).all())


def compare_with_plain(name, vk, ik, vp, ip, atol=1e-4, dist_of=None):
    """Distances within 1e-4 relative + ``atol`` at every rank, the same
    exhausted ranks, -1 exactly there, ids equal except at distance ties.

    A tie is one of ``ties_only``'s, or, where ``dist_of(q, ids)`` recomputes
    the distance of each (query, id) from the index in one arithmetic, a
    rank whose two ids recompute to distances within the same tolerance of
    each other.  A row merged from each pair's top kt needs the second
    kind: when two rows of one list tie at the pair's cut, the kernel and
    the plain version may keep different ones, and each then stands in its
    merged row with its partner nowhere beside it.  Ranks that are neither
    are printed, both ids with their recomputed distances, before the
    check fails."""
    import torch
    from raft_tpu_torch.profiles.pair_cut_ties import tie_mask

    fin = torch.isfinite(vp)
    assert torch.equal(fin, torch.isfinite(vk)), f"{name}: exhausted ranks"
    assert torch.equal(ik < 0, ~fin), f"{name}: -1 ids off exhausted ranks"
    err = float((vk[fin] - vp[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert torch.allclose(vk[fin], vp[fin], rtol=1e-4, atol=atol), (
        f"{name} distances differ by {err}")
    off = (ik != ip) & ~tie_mask(vk, atol)
    at = torch.nonzero(off, as_tuple=True)
    cut = 0
    if dist_of is not None and bool(off.any()):
        dk, dp = dist_of(at[0], ik[at]), dist_of(at[0], ip[at])
        partner = (dk - dp).abs() <= atol + 1e-4 * vk[at].abs()
        cut = int(partner.sum())
        off[tuple(a[partner] for a in at)] = False
        at = torch.nonzero(off, as_tuple=True)
    for j in range(min(int(off.sum()), 8)):
        pos = tuple(int(a[j]) for a in at)
        line = (f"{name}: rank {pos}: kernel id {int(ik[pos])} at "
                f"{float(vk[pos])!r}, plain id {int(ip[pos])} at "
                f"{float(vp[pos])!r}")
        if dist_of is not None:
            q = at[0][j:j + 1]
            dk = float(dist_of(q, ik[pos].reshape(1))[0])
            dp = float(dist_of(q, ip[pos].reshape(1))[0])
            line += f"; recomputed {dk!r} / {dp!r}"
        print(line, flush=True)
    assert not bool(off.any()), (
        f"{name}: ids differ off distance ties at {int(off.sum())} ranks")
    same = float((ik == ip).float().mean())
    print(f"{name} vs plain: max |dist err| {err}, ids equal at {same:.5f} "
          f"of ranks (others are distance ties"
          + (f"; {cut} at a tie cut by a pair's top kt" if cut else "")
          + ")", flush=True)
    return err


def id_distances(index, qrot, q_of, ids, rows_of, rsq, scales=None):
    """Each (query ``q_of``, id ``ids``) distance recomputed from the index
    as the kernels compute it (the bf16 residual times the stored row,
    summed in fp32), and the list that holds each id."""
    import torch

    flat = index.list_indices.reshape(-1)
    slot_of = torch.full((int(flat.max()) + 1,), -1, dtype=torch.int64,
                         device=flat.device)
    live = flat >= 0
    slot_of[flat[live].long()] = torch.nonzero(live)[:, 0]
    slot = slot_of[ids.long()]
    lst = slot // index.capacity
    rows = rows_of(slot)
    sub = qrot[q_of] - index.centers[lst]
    sub = torch.nn.functional.pad(sub, (0, rows.shape[1] - sub.shape[1]))
    ip = (sub.to(torch.bfloat16).float() * rows).sum(1)
    if scales is not None:
        ip = scales[lst] * ip
    d = torch.clamp_min((sub * sub).sum(1) + rsq.reshape(-1)[slot]
                        - 2.0 * ip, 0.0)
    return d, lst


# returned (query, id) entries recomputed at a time: 2 GB of fp32 rows of
# 128 dims, so a 5,000-query batch at kt 128 never holds them all at once
RECOMPUTE_CHUNK = 1 << 22


def recompute(index, qrot, q_of, lists_of, vals, ids, rows_of, rsq,
              scales=None):
    """Every returned (query, id) distance recomputed from the index
    (``id_distances``, RECOMPUTE_CHUNK entries at a time): the id's slot
    must lie in the list its query probed (``lists_of``: the lists allowed
    for each entry, (m, n)), and the distance must match."""
    import torch

    for s in range(0, ids.numel(), RECOMPUTE_CHUNK):
        e = slice(s, s + RECOMPUTE_CHUNK)
        d, lst = id_distances(index, qrot, q_of[e], ids[e], rows_of, rsq,
                              scales)
        assert bool((lists_of[e] == lst[:, None]).any(1).all()), (
            "an id outside the lists its query probed")
        assert torch.allclose(d, vals[e], rtol=1e-4, atol=1e-4), (
            "returned ids do not match their distances")


def scan_bound(index, probes, row_bytes, extra_bytes, out_bytes, rot):
    """Each distinct probed list's live rows once, its center, the queries,
    probes, ``extra_bytes`` and the outputs; 2*rot bf16 operations per
    (query, probed live row)."""
    import torch

    nq = probes.shape[0]
    sizes = index.list_sizes.long()
    # a probe outside [0, n_lists) (a routed rank's sentinel) reads nothing
    pl = probes.long()
    pl = pl[(pl >= 0) & (pl < index.n_lists)]
    probed = torch.unique(pl)
    nbytes = (nq * index.rot_dim * 4 + probes.numel() * 4
              + probed.numel() * index.rot_dim * 4
              + int(sizes[probed].sum()) * row_bytes + extra_bytes
              + out_bytes)
    flops = 2.0 * rot * int(sizes[pl].sum())
    ms, by = bound(nbytes, flops)
    return ms, by, nbytes, flops


def probe(index, queries):
    """The rotated queries and their exact n_probes-list ranking."""
    from raft_tpu_torch.neighbors.ivf_flat import _select_clusters

    qrot = queries.float() @ index.rotation
    return qrot, _select_clusters(index.centers, qrot, N_PROBES,
                                  index.metric)


def check_scans(index, qrot, probes, specs, yardsticks=None):
    """Each scan kernel against its plain version on the same batch
    (``compare_with_plain``), every returned id recomputed from the index
    (``recompute``), then its CUDA-event time, its plain version's time
    and its bound; one kernels-line row each.  A spec holds the kernel's
    name, source, the TPU kernel it replaces, wrapper, plain version,
    arguments, the rows and norms its distances read (with per-list
    scales for int8), bytes per live row, other input bytes, output
    bytes and the row width its products run over.  ``yardsticks`` maps a
    spec's name to the kernel it replaced (called with the same
    arguments), held to the same plain result: its error goes into the
    row as ``yardstick_query_major_max_abs_err``."""
    import torch

    nq, n_probes = probes.shape
    rows = []
    for (name, src, replaces, kernel, plain, args, rows_of, rsq, scales,
         row_bytes, extra, out_bytes, ops_rot) in specs:
        vk, ik = kernel(*args)
        (vp, ip), plain_ms = timed_once(lambda: plain(*args))

        def dist_of(q, ids):
            return id_distances(index, qrot, q, ids, rows_of, rsq,
                                scales)[0]
        err = compare_with_plain(name, vk, ik, vp, ip, dist_of=dist_of)
        yard = {}
        if name in (yardsticks or {}):
            vy, iy = yardsticks[name](*args)
            yard["yardstick_query_major_max_abs_err"] = compare_with_plain(
                name + " [query-major kernel]", vy, iy, vp, ip,
                dist_of=dist_of)
            del vy, iy
        fin = torch.isfinite(vk)
        if vk.ndim == 2:       # per query: any of its probed lists
            q_of = torch.nonzero(fin)[:, 0]
            lists_of = probes.long()[q_of]
        else:                  # per pair: exactly the pair's list
            kt = vk.shape[2]
            q_of = torch.arange(nq, device=qrot.device)[:, None, None]
            q_of = q_of.expand(nq, n_probes, kt)[fin]
            lists_of = probes.long()[:, :, None].expand(
                nq, n_probes, kt)[fin][:, None]
        recompute(index, qrot, q_of, lists_of, vk[fin], ik[fin], rows_of,
                  rsq, scales)
        ms = cuda_ms(lambda: kernel(*args), KERNEL_REPS)
        bound_ms, bound_by, nbytes, flops = scan_bound(
            index, probes, row_bytes, extra, out_bytes, ops_rot)
        print(f"{name}: {ms:.3f} ms/batch of {nq}, plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.1f} GFLOP)", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": f"raft_tpu_torch/csrc/{src}",
                     "replaces": replaces, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None, **yard})
    return rows


def recon_rows_of(index):
    """The bf16 recon row of each flat slot, as fp32 (``recompute``)."""
    rot = index.rot_dim

    def rows(slot):
        return index.list_recon.reshape(-1, rot)[slot].float()
    return rows


def check_kernel_b(index, queries):
    """Kernel B vs plain on a path's batch of its built index (5000
    queries, n_probes 96, k 20, kt 20, as ``auto`` runs it): the
    list-major route, with its device time split and group count."""
    from raft_tpu_torch.ops import pq_group_scan as pgs

    qrot, probes = probe(index, queries)
    nq, rot = qrot.shape
    kt = min(K_SEARCH, index.capacity)
    args = (qrot, index.centers, probes, index.list_recon,
            index.list_recon_sq, index.list_indices, K_SEARCH, kt)
    row = check_scans(index, qrot, probes, [
        ("ivf_pq_scan_fused", "pq_list_scan.cu",
         "raft_tpu/ops/pq_group_scan_pallas.py:410", pgs.ivf_pq_scan_fused,
         pgs.ivf_pq_scan_fused_plain, args, recon_rows_of(index),
         index.list_recon_sq, None, rot * 2 + 8, 0, nq * K_SEARCH * 8,
         rot)])[0]
    row.update(list_major_split(
        "kernel B", lambda: pgs.ivf_pq_scan_fused(*args), probes,
        index.n_lists, probes.numel() * min(kt, K_SEARCH) * 8, True))
    row["static_vs_exact"] = grouping_cost(
        "kernel B (list_scan + merge_pairs)", probes, index.n_lists,
        lambda gl, sp: pgs.merge_pairs(*pgs.list_scan(
            qrot, index.centers, probes, gl, sp, index.list_recon,
            index.list_recon_sq, index.list_indices, kt), K_SEARCH))
    return row


def in_turns(kernel, yardstick, reps=KERNEL_REPS):
    """CUDA-event ms of ``kernel`` and of ``yardstick`` in turns (kernel,
    yardstick, yardstick, kernel): ``([kernel ms], [yardstick ms])``."""
    k1 = cuda_ms(kernel, reps)
    y1 = cuda_ms(yardstick, reps)
    y2 = cuda_ms(yardstick, reps)
    k2 = cuda_ms(kernel, reps)
    return [k1, k2], [y1, y2]


def grouping_cost(label, probes, n_lists, run, group=None):
    """A grouped pass ``run(group_list, slot_pairs)`` after grouping at the
    exact count (what a live search runs: one wait on the device) and at
    ``grouped.group_capacity``'s static count (what a captured one runs):
    the outputs equal bit for bit, then the CUDA-event ms of grouping +
    pass each way, in turns (exact, static, static, exact), and both group
    counts.  Returns the dict kept on the kernels-line entry."""
    import torch
    from raft_tpu_torch.neighbors import grouped

    group = group or grouped.GROUP
    nq, n_probes = probes.shape
    cap = grouped.group_capacity(nq, n_probes, n_lists, group)[0]

    def exact():
        return run(*grouped.build_groups(probes, n_lists, group))

    def static():
        return run(*grouped.build_groups(probes, n_lists, group, cap))
    ve, ie = exact()
    vs, i_s = static()
    assert torch.equal(ve, vs) and torch.equal(ie, i_s), (
        f"{label}: the static group count changed the result")
    del ve, ie, vs, i_s
    n_exact = int(grouped.num_groups(probes, n_lists, group))
    st, ex = in_turns(static, exact)
    print(f"{label}: exact group count {n_exact:,} vs static {cap:,} "
          f"(+{cap - n_exact:,} groups without a pair): "
          f"grouping + pass {sum(ex) / 2:.3f} ms exact, "
          f"{sum(st) / 2:.3f} ms static ({ex[0]:.3f} / {st[0]:.3f} / "
          f"{st[1]:.3f} / {ex[1]:.3f} in turns); results bit-equal",
          flush=True)
    return {"exact_groups": n_exact, "static_groups": cap,
            "exact_ms": ex, "static_ms": st}


def merge_against_topk(label, pairs, k):
    """Pass 2 (``merge_pairs``) alone on a pair-group pass's output
    (``pairs()``: (nq, n_probes, kt) values and ids) against
    ``torch.topk`` over the same (nq, n_probes * kt) candidates, the
    merge's library yardstick: the same values, ids equal but at ties
    (the merge breaks them by probe, then the pair's rank); the two timed
    in turns.  Returns the row's pass-2 fields."""
    import torch
    from raft_tpu_torch.ops import pq_group_scan as pgs

    pv, pi = pairs()
    nq = pv.shape[0]
    flat_v, flat_i = pv.reshape(nq, -1), pi.reshape(nq, -1)

    def topk():
        v, pos = torch.topk(flat_v, k, dim=1, largest=False)
        i = torch.gather(flat_i, 1, pos)
        return v, torch.where(torch.isinf(v), torch.full_like(i, -1), i)

    mv, mi = pgs.merge_pairs(pv, pi, k)
    tv, ti = topk()
    assert torch.equal(mv, tv), f"{label}: the merge's values are not topk's"
    assert ties_only(mv, mi, ti, 0.0), f"{label}: ids differ off ties"
    ms, lib = in_turns(lambda: pgs.merge_pairs(pv, pi, k), topk)
    print(f"{label}: pass 2 alone over {flat_v.shape[1]:,} candidates a "
          f"query, in turns with torch.topk: merge_pairs {ms[0]:.4f} / "
          f"{ms[1]:.4f} ms, topk {lib[0]:.4f} / {lib[1]:.4f} ms", flush=True)
    return {"pass2_ms": ms, "pass2_topk_ms": lib,
            "pass2_candidates": flat_v.shape[1]}


def check_query_major(index, queries, nq, fused, k=None, filter_words=None,
                      launches=0):
    """Kernel B's or G's route past kt 64 against its plain version on the
    first ``nq`` queries of a path's batch, its launches counted; an
    ``also_checked`` entry of its kernel's row, with ``launches`` (that
    path's).  ``fused``: B at k = kt = ``k`` (256 by default) through
    ``ivf_pq_scan_fused``, which runs Kernel G's pair-group pass
    (``csrc/pair_list_scan.cu``, ``recon_pair_list_scan``) then pass 2
    (``merge_pairs``); else G at kt ``k`` (128 by default) through
    ``ivf_pq_scan_recon``, the pass alone.  Either way: its device split
    (grouping, pass, and for B pass 2), its bound (each probed list's live
    rows once against bf16 operations; for B the same bytes as on its
    other routes: the pair buffer, which only this route writes, is
    reported apart as ``pair_buffer_bytes``), and the query-major kernel
    it replaced
    (``scan_query_major`` / ``recon_scan_query_major``, which must not
    launch on the route) held to the same plain result and timed in turns
    with it; for B pass 2 alone against ``torch.topk`` over the same pairs
    (``merge_against_topk``).  With ``filter_words`` (``nq`` rows) all
    run filtered, every returned id must be admitted, and the bytes count
    the admission bits (one a query and probed live row)."""
    from raft_tpu_torch.neighbors import grouped
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_group_scan as pgs

    qrot, probes = probe(index, queries[:nq])
    rot, cap = qrot.shape[1], index.capacity
    fw, tag, adm = (), "", 0
    if filter_words is not None:
        fw, tag = (filter_words,), ", filtered"
        adm = admission_bytes(index.list_sizes, probes,
                              filter_words.stride(0) == 0)
    lists = (index.list_recon, index.list_recon_sq, index.list_indices)
    if fused:
        k = kt = min(k or pgs.K_MAX, cap)
        assert pgs.scan_route(cap, rot, k, kt)[0] == "pair"
        pair_bytes = probes.numel() * kt * 8
        spec = (f"ivf_pq_scan_fused (B past kt 64: G's pair-group pass + "
                f"merge{tag})", "pair_list_scan.cu",
                "raft_tpu/ops/pq_group_scan_pallas.py:410",
                pgs.ivf_pq_scan_fused, pgs.ivf_pq_scan_fused_plain,
                (qrot, index.centers, probes, *lists, k, kt) + fw,
                recon_rows_of(index), index.list_recon_sq, None,
                rot * 2 + 8, adm, nq * k * 8, rot)
        walked_kernel = pgs.scan_query_major
    else:
        k = kt = min(k or 2 * pgs.KT_LIST_MAX, cap)
        assert ps.recon_scan_route(rot, kt)[0] == "pair"
        pair_bytes = probes.numel() * kt * 8
        spec = (f"ivf_pq_scan_recon (G, pair-group pass{tag})",
                "pair_list_scan.cu",
                "raft_tpu/ops/pq_group_scan_pallas.py:566",
                ps.ivf_pq_scan_recon, ps.ivf_pq_scan_recon_plain,
                (qrot, index.centers, probes, *lists, kt) + fw,
                recon_rows_of(index), index.list_recon_sq, None,
                rot * 2 + 8, adm, pair_bytes, rot)
        walked_kernel = ps.recon_scan_query_major
    assert kt > pgs.KT_LIST_MAX, "the large-kt route needs kt past 64"
    wrapper, src = ps.recon_pair_list_scan, spec[1]
    before = (wrapper.launches, pgs.merge_pairs.launches)
    walked = walked_kernel.launches
    # the query-major kernel is held to the same plain result as the route
    row = check_scans(index, qrot, probes, [spec],
                      {spec[0]: walked_kernel})[0]
    launched = wrapper.launches - before[0]
    assert launched > 0, f"{spec[0]} never launched"
    assert (pgs.merge_pairs.launches > before[1]) == fused, (
        f"{spec[0]}: pass 2 launched {pgs.merge_pairs.launches - before[1]}")
    assert walked_kernel.launches == walked + 1, (
        f"{spec[0]}: the query-major kernel ran on the route")
    args = spec[5]
    group = ps.pair_list_layout(rot, kt, False).group
    row.update(list_major_split(
        f"{spec[0]} split", lambda: spec[3](*args), probes, index.n_lists,
        pair_bytes, fused, "recon_pair_kernel", group))
    ms, yard = in_turns(lambda: spec[3](*args), lambda: walked_kernel(*args))
    row.update(ms=ms[0], yardstick_query_major_ms=yard, group=group)
    print(f"{spec[0]}: in turns with the query-major kernel "
          f"({walked_kernel.__name__}): route {ms[0]:.3f} / {ms[1]:.3f} ms, "
          f"query-major {yard[0]:.3f} / {yard[1]:.3f} ms; {group} pairs a "
          f"group", flush=True)
    if fused:
        row.update(merge_against_topk(
            spec[0], lambda: ps.recon_pair_list_scan(
                qrot, index.centers, probes,
                *grouped.build_groups(probes, index.n_lists, group), *lists,
                kt, *fw), k))
    if filter_words is not None:
        assert_admitted(spec[0], spec[3](*args)[1], filter_words)
    return at_shape(dict(row, source=f"raft_tpu_torch/csrc/{src}",
                         check_launches=launched),
                    ("filtered, 50% per query: " if fw else "")
                    + f"{nq:,} queries x {probes.shape[1]} probes, k {k}, kt "
                    f"{kt}, capacity {cap:,}, rot {rot}, {group} pairs a "
                    f"group", launches)


def check_code_kernels(index, queries, kt, kernels=("C", "D", "E"),
                       k=K_SEARCH, filter_words=None, yardstick=False):
    """Kernels C, D and E (those named in ``kernels``) against their plain
    versions on a path's batch (n_probes 96) at per-pair ``kt`` and C's
    ``k``.  Each runs the route its gate picks: list-major where a pair
    keeps at most 64 candidates (``csrc/pq_code_list_scan.cu``, over the
    codes or, for E, the int8 rows, with the device split and the group
    count); up to kt 128 the pair-group pass (``csrc/pair_list_scan.cu``,
    for C then the merge: its device split, group count and size, the
    pair buffer's bytes (not in the bound, which is the function's bytes
    on every route) and the bytes its groups stream per probed live byte
    by ``flat_stream_bytes``' model; for C pass 2 alone against
    ``torch.topk``); else the query-major
    ``pq_code_scan.cu`` / ``pq_recon8_scan.cu``.  Each route's launch
    counter must move, and on the pass the query-major kernel's must not.
    With ``yardstick``, the query-major kernel, where the pass ran, is
    held to the same plain result and timed in turns with the pass (the
    row's ``ms`` then the route's first turn).  With ``filter_words`` every kernel and plain
    version runs filtered (names marked), every returned id must be
    admitted, and the bytes count the admission bits (one a probed live
    row for a broadcast row, one a query and probed live row else)."""
    from raft_tpu_torch.neighbors import grouped
    from raft_tpu_torch.ops import pq_code_scan as pcs

    qrot, probes = probe(index, queries)
    nq, n_probes = probes.shape
    rot, W = index.rot_dim, index.code_width
    cap = index.capacity
    books = index.codebooks
    codes_args = (qrot, index.centers, probes, index.list_codes, books,
                  index.list_code_rsq, index.list_indices, index.pq_bits)
    fw, tag, adm = (), "", 0
    if filter_words is not None:
        fw, tag = (filter_words,), " (filtered)"
        adm = admission_bytes(index.list_sizes, probes,
                              filter_words.stride(0) == 0)

    def decoded(slot):
        return pcs.decode_codes(index.list_codes.reshape(-1, W)[slot], books,
                                index.pq_bits).float()

    pair_out = nq * n_probes * kt * 8
    codes_src = "raft_tpu/ops/pq_code_scan_pallas.py:"
    # per spec: (route wrapper, query-major kernel, layout of the pass or
    # None, row bytes)
    specs, routes = [], []
    if "C" in kernels:
        route = pcs.codes_fused_route(cap, rot, index.pq_dim, index.pq_bits,
                                      k, kt)[0]
        c_kt = min(kt, cap, k)
        specs.append((
            "ivf_pq_scan_codes_fused" + tag,
            {"list": "pq_code_list_scan.cu", "pair": "pair_list_scan.cu",
             "query": "pq_code_scan.cu"}[route],
            codes_src + "282", pcs.ivf_pq_scan_codes_fused,
            pcs.ivf_pq_scan_codes_fused_plain, codes_args + (k, kt) + fw,
            decoded, index.list_code_rsq, None, W + 8,
            2 * books.numel() + adm, nq * k * 8, rot))
        routes.append((
            {"list": pcs.code_list_scan, "pair": pcs.code_pair_list_scan,
             "query": pcs.codes_fused_query_major}[route],
            pcs.codes_fused_query_major,
            pcs.code_pair_list_layout(rot, index.pq_dim, index.pq_bits, c_kt)
            if route == "pair" else None, W + 8))
    if "D" in kernels:
        route = pcs.codes_scan_route(cap, rot, index.pq_dim, index.pq_bits,
                                     min(kt, cap))[0]
        specs.append((
            "ivf_pq_scan_codes" + tag,
            {"list": "pq_code_list_scan.cu", "pair": "pair_list_scan.cu",
             "query": "pq_code_scan.cu"}[route],
            codes_src + "367", pcs.ivf_pq_scan_codes,
            pcs.ivf_pq_scan_codes_plain, codes_args + (kt,) + fw, decoded,
            index.list_code_rsq, None, W + 8, 2 * books.numel() + adm,
            pair_out, rot))
        routes.append((
            {"list": pcs.code_list_scan, "pair": pcs.code_pair_list_scan,
             "query": pcs.codes_scan_query_major}[route],
            pcs.codes_scan_query_major,
            pcs.code_pair_list_layout(rot, index.pq_dim, index.pq_bits,
                                      min(kt, cap))
            if route == "pair" else None, W + 8))
    if "E" in kernels:
        i8 = index.list_recon_i8
        rot_pad = i8.shape[2]
        route = pcs.recon8_scan_route(cap, rot_pad, min(kt, cap))[0]
        specs.append((
            "ivf_pq_scan_recon8" + tag,
            {"list": "pq_code_list_scan.cu", "pair": "pair_list_scan.cu",
             "query": "pq_recon8_scan.cu"}[route],
            codes_src + "441", pcs.ivf_pq_scan_recon8,
            pcs.ivf_pq_scan_recon8_plain,
            (qrot, index.centers, probes, i8, index.list_recon_scale,
             index.list_recon_i8_sq, index.list_indices, kt) + fw,
            lambda slot: i8.reshape(-1, rot_pad)[slot].float(),
            index.list_recon_i8_sq, index.list_recon_scale, rot_pad + 8,
            4 * index.n_lists + adm, pair_out, rot_pad))
        routes.append((
            {"list": pcs.recon8_list_scan, "pair": pcs.recon8_pair_list_scan,
             "query": pcs.recon8_scan_query_major}[route],
            pcs.recon8_scan_query_major,
            pcs.recon8_pair_list_layout(rot_pad, min(kt, cap))
            if route == "pair" else None, rot_pad + 8))
    # the pass's query-major yardstick: held to the same plain result
    yards = {spec[0]: walked for spec, (_, walked, layout, _) in
             zip(specs, routes) if yardstick and layout is not None}
    before = [(r.launches, w.launches if w else 0)
              for r, w, _, _ in routes]
    rows = check_scans(index, qrot, probes, specs, yards)
    for row, spec, (route, walked, layout, row_bytes), (b, bw) in zip(
            rows, specs, routes, before):
        assert route.launches > b, f"{row['name']}: its route never ran"
        if layout is not None:
            assert walked.launches == bw + (spec[0] in yards), (
                f"{row['name']}: the query-major kernel ran on the pass")
        if filter_words is not None:
            assert_admitted(row["name"], spec[3](*spec[5])[1], filter_words)
        merged = row["name"].startswith("ivf_pq_scan_codes_fused")
        pair_kt = min(kt, cap, k) if merged else min(kt, cap)
        if route in (pcs.code_list_scan, pcs.recon8_list_scan):
            row.update(list_major_split(
                f"{row['name']} (list-major, kt {kt})",
                lambda spec=spec: spec[3](*spec[5]), probes, index.n_lists,
                nq * n_probes * pair_kt * 8, merged,
                "code_list_scan_kernel"))
        if layout is None:
            continue
        # the pair-group pass (for C then the merge): its split and groups,
        # and the bytes the schedule model says it streams (printed only:
        # not measured)
        row.update(list_major_split(
            f"{row['name']} (pair-group pass{' + merge' if merged else ''}, "
            f"kt {pair_kt})", lambda spec=spec: spec[3](*spec[5]), probes,
            index.n_lists, nq * n_probes * pair_kt * 8, merged,
            "recon_pair_kernel", layout.group))
        streamed, _, live_bytes = flat_stream_bytes(
            probes, index.list_indices, 1, row_bytes, layout.group)
        row.update(group=layout.group)
        print(f"{row['name']}, schedule model (flat_stream_bytes, not "
              f"measured): {layout.group} pairs a group; "
              f"models {streamed / 1e6:.1f} MB for {live_bytes / 1e6:.1f} "
              f"MB of probed live rows ({streamed / max(live_bytes, 1):.3f} "
              f"per live byte)", flush=True)
        if spec[0] in yards:
            ms, yard = in_turns(lambda spec=spec: spec[3](*spec[5]),
                                lambda spec=spec, walked=walked: walked(
                                    *spec[5]))
            row.update(ms=ms[0], yardstick_query_major_ms=yard)
            print(f"{row['name']}: in turns with the query-major kernel "
                  f"({walked.__name__}): pass {ms[0]:.3f} / {ms[1]:.3f} ms, "
                  f"query-major {yard[0]:.3f} / {yard[1]:.3f} ms; "
                  f"{layout.group} pairs a group", flush=True)
        if merged:
            row.update(merge_against_topk(
                row["name"], lambda layout=layout, pair_kt=pair_kt,
                spec=spec: pcs.code_pair_list_scan(
                    qrot, index.centers, probes, *grouped.build_groups(
                        probes, index.n_lists, layout.group),
                    *codes_args[3:], pair_kt, *fw), k))
    return rows


def check_codes_query_major(index, queries, nq):
    """Past kt 64 (k = kt = 128) on the first ``nq`` queries of the
    batch: the pair-group pass (``csrc/pair_list_scan.cu``) of Kernel C
    (D's pass, then the merge, pass 2 also against ``torch.topk``), D and
    E, each against its plain version, its launches counted, the
    query-major kernels (``codes_fused_query_major``,
    ``codes_scan_query_major``, ``recon8_scan_query_major``) held to the
    same plain result and timed in turns beside the route; three
    ``also_checked`` entries."""
    from raft_tpu_torch.ops import pq_code_scan as pcs
    from raft_tpu_torch.ops import pq_group_scan as pgs

    kt = min(2 * 64, index.capacity)
    # C's route is the only one of the three that merges
    ran = (pgs.merge_pairs, pcs.code_pair_list_scan,
           pcs.recon8_pair_list_scan)
    before = [w.launches for w in ran]
    rows = check_code_kernels(index, queries[:nq], kt, ("C", "D", "E"), kt,
                              yardstick=True)
    ran = [w.launches - b for w, b in zip(ran, before)]
    assert min(ran) > 0, f"the routes past kt 64 launched {ran}"
    return [at_shape(dict(row, check_launches=n),
                     f"pair-group pass{' + merge' if i == 0 else ''} "
                     f"(csrc/{row['source'].split('/')[-1]}): "
                     f"{nq:,} queries x {N_PROBES} probes, k {kt}, kt {kt}, "
                     f"capacity {index.capacity:,}, rot {index.rot_dim}", 0)
            for i, (row, n) in enumerate(zip(rows, ran))]


def codes_bit_equal(index, queries, kt):
    """The codes pass against Kernel G's pass over the index's recon
    cache, both on the codes' norms (``list_code_rsq``), at per-pair
    ``kt`` on the batch: up to kt 64 the list-major codes pass against G's
    pass 1, past it D's pair-group pass against G's on the same groups.
    The decoded rows are the cache's bits and the tiling is the same, so
    values and ids must be equal."""
    import torch
    from raft_tpu_torch.neighbors import grouped
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_code_scan as pcs
    from raft_tpu_torch.ops import pq_group_scan as pgs

    qrot, probes = probe(index, queries)
    common = (qrot, index.centers, probes)
    if kt <= pgs.KT_LIST_MAX:
        groups = grouped.build_groups(probes, index.n_lists)
        cv, ci = pcs.code_list_scan(*common, *groups, index.list_codes,
                                    index.codebooks, index.list_code_rsq,
                                    index.list_indices, index.pq_bits, kt)
        rv, ri = pgs.list_scan(*common, *groups, index.list_recon,
                               index.list_code_rsq, index.list_indices, kt)
        names = "code_list_scan vs list_scan"
    else:
        group = pcs.code_pair_list_layout(index.rot_dim, index.pq_dim,
                                          index.pq_bits, kt).group
        groups = grouped.build_groups(probes, index.n_lists, group)
        cv, ci = pcs.code_pair_list_scan(
            *common, *groups, index.list_codes, index.codebooks,
            index.list_code_rsq, index.list_indices, index.pq_bits, kt)
        rv, ri = ps.recon_pair_list_scan(
            *common, *groups, index.list_recon, index.list_code_rsq,
            index.list_indices, kt, group=group)
        names = (f"code_pair_list_scan vs recon_pair_list_scan ({group} "
                 f"pairs a group)")
    torch.cuda.synchronize()
    same = torch.equal(cv, rv) and torch.equal(ci, ri)
    print(f"{names} over the recon cache (kt {kt}, {probes.numel():,} "
          f"pairs): bit-equal {same}", flush=True)
    assert same, "the codes pass differs from G's pass over the recon cache"


def recon8_bit_equal(index, queries, kt):
    """Kernel E's pass with every scale 1 against Kernel G's pass over the
    int8 rows as bf16 (``q8[..., :rot]``, exact), both on the int8 norms,
    at per-pair ``kt`` on the batch (up to kt 64 the list-major passes,
    past it the pair-group passes on the same groups): the same tiles,
    exact products, summation order and fold, so values and ids must be
    equal."""
    import torch
    from raft_tpu_torch.neighbors import grouped
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_code_scan as pcs
    from raft_tpu_torch.ops import pq_group_scan as pgs

    qrot, probes = probe(index, queries)
    common = (qrot, index.centers, probes)
    i8, rsq8 = index.list_recon_i8, index.list_recon_i8_sq
    assert i8.shape[2] == -(-index.rot_dim // 16) * 16
    ones = torch.ones_like(index.list_recon_scale)
    rows = i8[..., :index.rot_dim].to(torch.bfloat16)
    if kt <= pgs.KT_LIST_MAX:
        groups = grouped.build_groups(probes, index.n_lists)
        ev, ei = pcs.recon8_list_scan(*common, *groups, i8, ones, rsq8,
                                      index.list_indices, kt)
        gv, gi = pgs.list_scan(*common, *groups, rows, rsq8,
                               index.list_indices, kt)
        names = "recon8_list_scan at scale 1 vs list_scan"
    else:
        group = pcs.recon8_pair_list_layout(i8.shape[2], kt).group
        groups = grouped.build_groups(probes, index.n_lists, group)
        ev, ei = pcs.recon8_pair_list_scan(*common, *groups, i8, ones, rsq8,
                                           index.list_indices, kt)
        gv, gi = ps.recon_pair_list_scan(*common, *groups, rows, rsq8,
                                         index.list_indices, kt, group=group)
        names = (f"recon8_pair_list_scan at scale 1 vs recon_pair_list_scan "
                 f"({group} pairs a group)")
    torch.cuda.synchronize()
    same = torch.equal(ev, gv) and torch.equal(ei, gi)
    del rows
    torch.cuda.empty_cache()
    print(f"{names} over the int8 rows as bf16 (kt {kt}, {probes.numel():,} "
          f"pairs): bit-equal {same}", flush=True)
    assert same, "the int8 pass differs from G's pass over its rows as bf16"


def check_kernel_g(index, queries, kt):
    """Kernel G vs plain on a path's batch (5000 queries, n_probes 96) at
    per-pair ``kt``, as ``scan_mode="recon"`` runs it: list-major pass 1,
    with its device time split and group count."""
    from raft_tpu_torch.ops import pair_scan as ps

    from raft_tpu_torch.ops import pq_group_scan as pgs

    qrot, probes = probe(index, queries)
    nq, n_probes = probes.shape
    rot = index.rot_dim
    kt = min(kt, index.capacity)
    assert kt <= pgs.KT_LIST_MAX, "kernel G check: the list-major route"
    args = (qrot, index.centers, probes, index.list_recon,
            index.list_recon_sq, index.list_indices, kt)
    row = check_scans(index, qrot, probes, [
        ("ivf_pq_scan_recon", "pq_list_scan.cu",
         "raft_tpu/ops/pq_group_scan_pallas.py:566", ps.ivf_pq_scan_recon,
         ps.ivf_pq_scan_recon_plain, args, recon_rows_of(index),
         index.list_recon_sq, None, rot * 2 + 8, 0, nq * n_probes * kt * 8,
         rot)])[0]
    row.update(list_major_split(
        "kernel G", lambda: ps.ivf_pq_scan_recon(*args), probes,
        index.n_lists, nq * n_probes * kt * 8, False))
    row["static_vs_exact"] = grouping_cost(
        "kernel G (list_scan)", probes, index.n_lists,
        lambda gl, sp: pgs.list_scan(
            qrot, index.centers, probes, gl, sp, index.list_recon,
            index.list_recon_sq, index.list_indices, kt))
    return row


def flat_scan_args(index, queries, n_probes, k):
    """What ``ivf_flat.search`` hands Kernel F: the queries, the
    (super-tile) probes, the (L/F, F·cap) views of the lists, kt; and F
    (passed as ``sub_lists``)."""
    from raft_tpu_torch.neighbors import ivf_flat

    probes = ivf_flat._select_clusters(index.centers, queries, n_probes,
                                       index.metric)
    cap, dim = index.capacity, index.dim
    F, n_eff = ivf_flat.super_tile_factor(cap, index.n_lists, n_probes)
    if F > 1:
        probes = ivf_flat.dedup_super_probes(probes, F, n_eff)
    return (queries, probes, index.list_data.reshape(n_eff, F * cap, dim),
            index.list_data_sq.reshape(n_eff, F * cap),
            index.list_indices.reshape(n_eff, F * cap),
            min(k, F * cap)), F


def flat_stream_bytes(probes, ids, F, row_bytes, group=None):
    """``(read, multiplied, live)``, a model of Kernel F's list-major
    schedule worked out from the batch's groups, not a counter: the bytes
    of rows the schedule streams (each group its tile's sub-lists, each up
    to its last live row), the bytes of the rows it multiplies (those rows
    padded to 128-row windows with zeros it does not read), and the probed
    tiles' live rows read once.  ``group``: the schedule's pairs a group
    (the list-major pass's 128 by default)."""
    import torch
    from raft_tpu_torch.neighbors import grouped

    n_tiles, rows = ids.shape
    live = ids.reshape(n_tiles, F, rows // F) >= 0
    slot = torch.arange(1, rows // F + 1, device=live.device)
    end = (live * slot).amax(-1)                      # (n_tiles, F)
    gl = grouped.build_groups(probes, n_tiles,
                              group or grouped.GROUP)[0].long()
    read = int(end.sum(1)[gl].sum()) * row_bytes
    multiplied = int(((end + 127) // 128).sum(1)[gl].sum()) * 128 * row_bytes
    return read, multiplied, int(live[torch.unique(gl)].sum()) * row_bytes


def check_kernel_f(index, queries, n_probes, k, label, filter_words=None):
    """Kernel F vs plain on an IVF-Flat batch at ``n_probes`` and ``k``
    through ``ivf_flat_scan`` (k <= 64: the list-major pass; up to 256
    the pair-group pass, with the query-major kernel it replaced held to
    the same plain result and timed in turns beside it; the route's
    launch counter must move, and the query-major kernel's must not
    unless it is the route): values
    within 1e-5 of the scale ‖q‖² + max ‖x‖² that fp32 cancellation
    moves them by, ids equal but at ties, every returned id found in its
    pair's tile with its distance recomputed; then its CUDA-event time,
    the plain version's and the bound.  The list-major bound is the larger
    of the bytes (each probed tile's live rows read once) and 3xTF32's
    three TF32 products of 2·dim operations per (query, probed live row)
    at the TF32 peak, the fp32 FFMA time of one product beside it (the
    yardstick of the earlier query-major times, printed, and kept as
    ``ffma_bound_ms`` on the pair-group pass); the query-major route's is
    bytes against fp32 FFMA.  The grouped routes add their device split
    and groups to the row, and print the bytes their schedule streams by
    flat_stream_bytes' model.  With ``filter_words``
    both run filtered, every returned id must be admitted, and the bytes
    count the admission bits (one a query and probed live row)."""
    import torch
    from raft_tpu_torch.ops import pair_scan as ps

    args, F = flat_scan_args(index, queries, n_probes, k)
    q, probes, data, dsq, ids, kt = args
    fw = dict(filter_words=filter_words)
    route = ps.flat_scan_route(data.shape[1], index.dim, kt, F)[0]
    listed = route != "query"               # a grouped route
    wrapper = {"list": ps.flat_list_scan, "pair": ps.flat_pair_list_scan,
               "query": ps.flat_scan_query_major}[route]
    before = wrapper.launches
    walked = ps.flat_scan_query_major.launches
    vk, ik = ps.ivf_flat_scan(*args, sub_lists=F, **fw)
    assert wrapper.launches == before + 1, f"{label}: route not taken"
    assert route == "query" or ps.flat_scan_query_major.launches == walked, (
        f"{label}: the query-major kernel ran on the {route} route")
    if filter_words is not None:
        assert_admitted(label, ik, filter_words)
    (vp, ip), plain_ms = timed_once(
        lambda: ps.ivf_flat_scan_plain(*args, **fw))
    q_sq = (q * q).sum(1)
    scale = float(q_sq.max() + dsq.max())
    err = compare_with_plain(label, vk, ik, vp, ip, atol=1e-5 * scale)
    fin = torch.isfinite(vk)
    flat = ids.reshape(-1)
    slot_of = torch.full((int(flat.max()) + 1,), -1, dtype=torch.int64,
                         device=flat.device)
    slot_of[flat[flat >= 0].long()] = torch.nonzero(flat >= 0)[:, 0]
    slot = slot_of[ik[fin].long()]
    nq, n_pr = probes.shape
    pair_q = torch.arange(nq, device=q.device)[:, None, None].expand(
        nq, n_pr, kt)[fin]
    pair_tile = probes.long()[:, :, None].expand(nq, n_pr, kt)[fin]
    assert bool((slot // data.shape[1] == pair_tile).all()), (
        f"{label}: an id outside its pair's tile")
    got = vk[fin]
    for s in range(0, slot.numel(), RECOMPUTE_CHUNK):
        e = slice(s, s + RECOMPUTE_CHUNK)
        rows = data.reshape(-1, index.dim)[slot[e]]
        d = torch.clamp_min(q_sq[pair_q[e]] + dsq.reshape(-1)[slot[e]]
                            - 2.0 * (q[pair_q[e]] * rows).sum(1), 0.0)
        assert torch.allclose(d, got[e], rtol=0, atol=1e-5 * scale), (
            f"{label}: returned ids do not match their distances")
    del got
    ms = cuda_ms(lambda: ps.ivf_flat_scan(*args, sub_lists=F, **fw),
                 KERNEL_REPS)
    live = (ids >= 0).sum(1)
    pr = probes.long()
    pr = pr[pr < data.shape[0]]
    row_bytes = index.dim * 4 + 8
    nbytes = (int(live[torch.unique(pr)].sum()) * row_bytes
              + q.numel() * 4 + probes.numel() * 4 + vk.numel() * 8)
    if filter_words is not None:
        nbytes += admission_bytes(live, probes,
                                  filter_words.stride(0) == 0)
    flops = 2.0 * index.dim * int(live[pr].sum())
    ffma_ms = 1e3 * flops / FP32_FLOP_PER_S
    row = {"name": "ivf_flat_scan", "route": "cuda",
           "source": "raft_tpu_torch/csrc/" + {
               "list": "flat_list_scan.cu", "pair": "pair_list_scan.cu",
               "query": "pair_scan.cu"}[route],
           "replaces": "raft_tpu/ops/pq_group_scan_pallas.py:637",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": None, "F": F}
    ops_ms = 1e3 * (3 * flops / TF32_FLOP_PER_S if listed
                    else flops / FP32_FLOP_PER_S)
    if listed:
        group = (ps.pair_list_layout(index.dim, kt, True).group
                 if route == "pair" else None)
        bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
        streamed, multiplied, live_bytes = flat_stream_bytes(
            probes, ids, F, row_bytes, group)
        row.update(list_major_split(
            f"{label} split",
            lambda: ps.ivf_flat_scan(*args, sub_lists=F, **fw),
            probes, data.shape[0], vk.numel() * 8, False,
            "flat_list_scan_kernel" if route == "list"
            else "flat_pair_kernel", group))
        if route == "list" and filter_words is None:
            row["static_vs_exact"] = grouping_cost(
                f"{label} (flat_list_scan)", probes, data.shape[0],
                lambda gl, sp: ps.flat_list_scan(q, probes, gl, sp, data,
                                                 dsq, ids, kt, False, F))
        print(f"{label}, schedule model (flat_stream_bytes, not measured): "
              f"streams {streamed / 1e6:.1f} MB for {live_bytes / 1e6:.1f} "
              f"MB of probed live rows ({streamed / max(live_bytes, 1):.3f} "
              f"per live byte); rows multiplied, padded to 128-row "
              f"windows: {multiplied / max(live_bytes, 1):.3f} per live "
              f"byte", flush=True)
    else:
        bound_ms, bound_by = bound(nbytes, flops, FP32_FLOP_PER_S)
    row.update(bound_ms=bound_ms, bound_by=bound_by)
    if route == "pair":
        # the query-major kernel it replaced: held to the same plain
        # result, then timed in turns with the pass
        walked = ps.flat_scan_query_major.launches
        vy, iy = ps.flat_scan_query_major(*args, **fw)
        assert ps.flat_scan_query_major.launches == walked + 1
        if filter_words is not None:
            assert_admitted(label + " [query-major]", iy, filter_words)
        yard_err = compare_with_plain(label + " [query-major kernel]", vy,
                                      iy, vp, ip, atol=1e-5 * scale)
        del vy, iy
        ms_turns, yard = in_turns(
            lambda: ps.ivf_flat_scan(*args, sub_lists=F, **fw),
            lambda: ps.flat_scan_query_major(*args, **fw))
        row.update(ms=ms_turns[0], yardstick_query_major_ms=yard,
                   yardstick_query_major_max_abs_err=yard_err,
                   ffma_bound_ms=1e3 * max(nbytes / HBM_BYTES_PER_S,
                                           flops / FP32_FLOP_PER_S),
                   group=group)
        ms = ms_turns[0]
        print(f"{label}: in turns with the query-major kernel "
              f"(csrc/pair_scan.cu): pass {ms_turns[0]:.3f} / "
              f"{ms_turns[1]:.3f} ms, query-major {yard[0]:.3f} / "
              f"{yard[1]:.3f} ms; {group} pairs a group", flush=True)
    name = {"list": "list-major", "pair": "pair-group",
            "query": "query-major"}[route]
    print(f"{label} ({name}, n_probes "
          f"{n_probes}, k {k}, F {F}, tile {data.shape[1]} slots): {ms:.3f} "
          f"ms/batch of {nq}, plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB = "
          f"{1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms of bytes, "
          f"{flops / 1e9:.1f} GFLOP = "
          f"{'3xTF32' if listed else 'fp32 FFMA'} {ops_ms:.4f} ms"
          + (f"; fp32 FFMA yardstick {ffma_ms:.4f} ms" if listed else "")
          + ")", flush=True)
    return row


def flat_searches(res, index, queries, truth, probes_list, label):
    """ivf_flat.search at each n_probes, k 10: a first search, then
    SEARCH_REPS timed batches; ms, QPS, recall@10, F and the launches of
    Kernel F's two routes per setting."""
    import torch
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import pair_scan as ps

    out = {}
    for n_probes in probes_list:
        sp = ivf_flat.SearchParams(n_probes=n_probes)
        F, _ = ivf_flat.super_tile_factor(index.capacity, index.n_lists,
                                          n_probes)
        before = (ps.flat_list_scan.launches,
                  ps.flat_scan_query_major.launches)
        ivf_flat.search(res, sp, index, queries, K)
        ms = []
        for _ in range(SEARCH_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, found = ivf_flat.search(res, sp, index, queries, K)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
        recall = float(hits) / truth.numel()
        med = sorted(ms)[len(ms) // 2]
        out[n_probes] = {"ms": med, "recall": recall, "F": F}
        print(f"{label} n_probes {n_probes} (F {F}): search "
              f"{', '.join(f'{m:.2f}' for m in ms)} ms per batch of "
              f"{queries.shape[0]}; QPS {queries.shape[0] / (med / 1e3):.0f} "
              f"(median); recall@10 {recall:.4f}; Kernel F launches: "
              f"list-major {ps.flat_list_scan.launches - before[0]}, "
              f"query-major {ps.flat_scan_query_major.launches - before[1]}",
              flush=True)
    return out


def build_flat(res, db, n_lists, label):
    """ivf_flat.build with its seconds, stages and list sizes printed."""
    import torch
    from raft_tpu_torch.neighbors import ivf_flat

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_flat.build(res, ivf_flat.IndexParams(n_lists=n_lists), db)
    torch.cuda.synchronize()
    sizes = index.list_sizes.float()
    print(f"{label} build: {time.perf_counter() - t0:.2f} s; stages (s): "
          f"{json.dumps(ivf_flat.build.stage_seconds)}; {index.n_lists} "
          f"lists, capacity {index.capacity} (sizes mean "
          f"{float(sizes.mean()):.1f}, max {int(sizes.max())}, min "
          f"{int(sizes.min())})", flush=True)
    return index


def odd_width_check(res, dev):
    """Kernel F's pair-group pass at a row width off a multiple of 4 (its
    one-value row loads): an IVF-Flat index of FLAT_ODD_ROWS x 25 rows
    (GloVe-25's width; the generator, numpy seed 25) at FLAT_ODD_LISTS
    lists, its first LARGE_KT_QUERIES queries at n_probes
    FLAT_CHECK_PROBES and k FLAT_LARGE_K against the plain version, the
    query-major kernel in turns beside it; an ``also_checked`` entry of
    the pass's row (its search's launch)."""
    import torch
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import pair_scan as ps

    db, queries = sift_like(FLAT_ODD_ROWS, LARGE_KT_QUERIES, FLAT_ODD_DIM,
                            LATENT, NOISE, dev, seed=FLAT_ODD_DIM)
    index = ivf_flat.build(res, ivf_flat.IndexParams(
        n_lists=FLAT_ODD_LISTS), db)
    # the public search at k 100 (its first search also attaches the
    # rows' norms)
    zero_launches()
    dist, _ = ivf_flat.search(res, ivf_flat.SearchParams(
        n_probes=FLAT_CHECK_PROBES), index, queries, FLAT_LARGE_K)
    launches = read_launches()
    assert launches["flat_pair_list_scan"] == 1 and launches[
        "flat_scan_query_major"] == 0 and bool(
        torch.isfinite(dist[:, 0]).all()), "dim-25 search at k 100"
    row = check_kernel_f(index, queries, FLAT_CHECK_PROBES, FLAT_LARGE_K,
                         f"ivf_flat_scan (F pair-group pass, dim "
                         f"{FLAT_ODD_DIM})")
    entry = at_shape(
        row, f"one-value row loads: {FLAT_ODD_ROWS:,} x {FLAT_ODD_DIM}, "
        f"nlist {FLAT_ODD_LISTS}, {LARGE_KT_QUERIES:,} queries x "
        f"{FLAT_CHECK_PROBES} probes, k {FLAT_LARGE_K}, F {row['F']}, "
        f"capacity {index.capacity}", launches["flat_pair_list_scan"])
    del db, queries, index
    torch.cuda.empty_cache()
    return entry


def ivf_flat_path(db, queries, truth):
    """The IVF-Flat phases: ``raft_ivf_flat.nlist4096`` built and searched
    at n_probes 32 / 64 / 128 (launches zeroed before the build, read
    after the searches; Kernel F's list-major pass must run and its
    query-major kernel not), the same build through each route of Kernel
    F, Kernel F vs plain at n_probes 64 (list-major; and at k 100 on the
    first LARGE_KT_QUERIES queries the search, which must launch the
    pair-group pass once and no other scan, then the pass against plain
    with the query-major kernel in turns), one batch under the profiler;
    then ``raft_ivf_flat.nlist16384`` (the hierarchical fit) at n_probes
    128 with Kernel F vs plain there, and Kernels A and H vs plain at the
    shapes its hierarchical fit and its extend give them, on a trainset of
    the build's size (``also_checked``).  Returns F's kernels row, the
    pair-group pass's row, the A and H ``also_checked`` entries and the
    two indexes (nlist 16384, then 4096) for the profile phase."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import ivf_flat
    from raft_tpu_torch.ops import pair_scan as ps

    res = DeviceResources(seed=0)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    index = build_flat(res, db, FLAT_LISTS, "IVF-Flat nlist 4096")
    results = flat_searches(res, index, queries, truth, FLAT_PROBES,
                            "IVF-Flat nlist 4096")
    launches = read_launches()
    print(f"IVF-Flat nlist 4096 launches (build + searches): "
          f"{json.dumps(launches)}; peak device memory {peak_gb():.2f} GB",
          flush=True)
    for name in ("flat_list_scan", "fused_l2_nn", "kmeans_assign_update"):
        assert launches[name] > 0, f"IVF-Flat: {name} never launched"
    assert launches["flat_scan_query_major"] == 0, (
        "IVF-Flat: the k-10 searches left the list-major route")
    assert results[FLAT_PROBES[-1]]["recall"] >= 0.90, (
        f"IVF-Flat recall@10 {results[FLAT_PROBES[-1]]['recall']} below "
        f"0.90 at n_probes {FLAT_PROBES[-1]}")
    for n_probes in FLAT_PROBES:
        sp = ivf_flat.SearchParams(n_probes=n_probes)
        same_build_routes(
            f"IVF-Flat nlist 4096 n_probes {n_probes}", ivf_flat,
            "ivf_flat_scan",
            lambda *a, sub_lists=1: ps.flat_scan_query_major(*a),
            (ps.flat_list_scan, ps.flat_scan_query_major),
            lambda: ivf_flat.search(res, sp, index, queries, K)[1], truth)
    row = check_kernel_f(index, queries, FLAT_CHECK_PROBES, K,
                         "ivf_flat_scan")
    row["launches"] = launches["flat_list_scan"]
    # past kt 64: the public search at k 100 on LARGE_KT_QUERIES queries
    # (the pair-group pass, counted), then the pass against plain with the
    # query-major kernel it replaced in turns
    sp = ivf_flat.SearchParams(n_probes=FLAT_CHECK_PROBES)
    zero_launches()
    ivf_flat.search(res, sp, index, queries[:LARGE_KT_QUERIES], FLAT_LARGE_K)
    wide = read_launches()
    assert wide["flat_pair_list_scan"] == 1 and wide[
        "flat_scan_query_major"] == wide["flat_list_scan"] == 0, (
            f"IVF-Flat k {FLAT_LARGE_K}: {json.dumps(wide)}")
    pair = check_kernel_f(
        index, queries[:LARGE_KT_QUERIES], FLAT_CHECK_PROBES, FLAT_LARGE_K,
        "ivf_flat_scan (F, pair-group pass, k 100)")
    pair.update(name="flat_pair_list_scan",
                launches=wide["flat_pair_list_scan"],
                shape=f"nlist 4096, {LARGE_KT_QUERIES:,} queries x "
                f"{FLAT_CHECK_PROBES} probes, k {FLAT_LARGE_K}, F "
                f"{pair['F']}, capacity {index.capacity}")
    odd = odd_width_check(res, db.device)
    device_breakdown(f"IVF-Flat search batch (n_probes {FLAT_CHECK_PROBES})",
                     lambda: ivf_flat.search(res, sp, index, queries, K))

    zero_launches()
    fine = build_flat(res, db, FLAT_FINE_LISTS, "IVF-Flat nlist 16384")
    flat_searches(res, fine, queries, truth, (FLAT_FINE_PROBES,),
                  "IVF-Flat nlist 16384")
    fine_launches = read_launches()
    for name in ("flat_list_scan", "fused_l2_nn", "kmeans_assign_update"):
        assert fine_launches[name] > 0, f"IVF-Flat 16384: {name} never launched"
    row_fine = check_kernel_f(fine, queries, FLAT_FINE_PROBES, K,
                              "ivf_flat_scan nlist 16384")
    row["also_checked"] = [
        at_shape(row_fine, f"nlist 16384: {N_QUERIES:,} queries x "
                 f"{FLAT_FINE_PROBES} probes, k {K}, F {row_fine['F']}, "
                 f"capacity {fine.capacity}",
                 fine_launches["flat_list_scan"])]
    pair["also_checked"] = [odd]
    n_train = int(N_DB * ivf_flat.IndexParams().kmeans_trainset_fraction)
    sel = torch.randperm(N_DB, generator=DeviceResources(seed=0).generator,
                         device=db.device)[:n_train]
    a_rows, h_rows = hierarchical_checks(
        db[sel], FLAT_FINE_LISTS, "IVF-Flat nlist 16384",
        fine_launches["kmeans_assign_update"], h_tf32_launches(fine_launches))
    h_rows.append(h_check(db, fine.centers, f"IVF-Flat nlist 16384 extend: "
                          f"{N_DB:,} x {DIM} -> {FLAT_FINE_LISTS:,}",
                          h_tf32_launches(fine_launches)))
    del sel
    torch.cuda.empty_cache()
    return row, pair, a_rows, h_rows, (fine, index)


def check_kernel_h(x, y, shape, yardstick, block_sizes=False):
    """Kernel H vs plain at one shape: dmin within 1e-5 of the scale ‖x‖²
    + max ‖y‖², each index equal to the plain version's or at a distance
    tie with it (both recomputed directly); its CUDA-event time (wrapper
    included), the device time of the kernel it launched, the plain
    version's time, the bound (x and y read once; at k > SMALL_DIM the
    tensor-core pass's 3 · 2·m·n·k TF32 operations, the fp32 FFMA time of
    one product and the byte time printed beside it; at k <= SMALL_DIM
    2·m·n·k fp32 operations), a TF32-off fp32 ``torch.matmul`` of the same
    product as ``library_ms`` (a yardstick: no single call computes min +
    first argmin) with a TF32-on one (one TF32 product) beside it and,
    with ``yardstick``, the two-call ``torch.cdist(x, y).min(1)``.  At k >
    SMALL_DIM the SIMT tile (the k > 16 kernel before the tensor-core
    pass, ``fused_l2_nn_variant(..., "simt")``) is timed in the same run,
    and the share of the pass's labels equal to the SIMT tile's printed
    with the distance gap of the others; with ``block_sizes``, the pass at
    two and at four warpgroups a block, in turns.  At k <= SMALL_DIM the
    row is the small-dim kernel's."""
    import torch
    from raft_tpu_torch.ops import fused_l2_nn as fnn
    from raft_tpu_torch.utils import precision

    dk, ik = fnn.fused_l2_nn(x, y)
    (dp, ip), plain_ms = timed_once(lambda: fnn.fused_l2_nn_plain(x, y))
    scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
    err = float((dk - dp).abs().max())
    assert err <= 1e-5 * scale, f"fused_l2_nn at {shape}: dmin off by {err}"

    def dist(i):
        return ((x - y[i.long()]) ** 2).sum(1)

    gap = (dist(ik) - dist(ip)).abs()
    assert bool(((ik == ip) | (gap <= 1e-5 * scale)).all()), (
        f"fused_l2_nn at {shape}: an index off a distance tie")
    same = float((ik == ip).float().mean())
    (m, k), n = x.shape, y.shape[0]
    small = k <= fnn.SMALL_DIM
    kernel = "small_dim_kernel" if small else "nn_tf32_kernel"
    ms = cuda_ms(lambda: fnn.fused_l2_nn(x, y), KERNEL_REPS)
    dev_ms = device_ms(lambda: fnn.fused_l2_nn(x, y), KERNEL_REPS, kernel)
    flops = 2.0 * m * n * k
    nbytes = (m + n) * k * 4 + m * 8
    if small:
        bound_ms, bound_by = bound(nbytes, flops, FP32_FLOP_PER_S)
    else:
        bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
    lib_ms = matmul_ms(x, y)
    lib_tf32_ms = matmul_ms(x, y, tf32=True)
    yard_ms = None
    if yardstick:
        with precision.highest():
            yard_ms = cuda_ms(lambda: torch.cdist(x, y).min(1), KERNEL_REPS)
    row = {"name": "fused_l2_nn_small_dim" if small else "fused_l2_nn",
           "route": "cuda", "source": "raft_tpu_torch/csrc/fused_l2_nn.cu",
           "replaces": "raft_tpu/ops/fused_l2_nn_pallas.py:65",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
           "library_tf32_ms": lib_tf32_ms, "device_ms": dev_ms,
           "yardstick_cdist_min_ms": yard_ms, "shape": shape}
    print(f"fused_l2_nn{' small-dim' if small else ''} at {shape}: max "
          f"|dmin err| {err} (scale {scale:.1f}), indices equal at "
          f"{same:.6f} (others at ties); {ms:.3f} ms a call, kernel "
          f"{dev_ms:.4f} ms on the device ({flops / dev_ms / 1e9:.1f} "
          f"TFLOP/s of one product), plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}"
          + ("" if small else
             f"; 3xTF32 {3e3 * flops / TF32_FLOP_PER_S:.4f} ms, fp32 FFMA "
             f"{1e3 * flops / FP32_FLOP_PER_S:.4f} ms, bytes "
             f"{1e3 * nbytes / HBM_BYTES_PER_S:.4f} ms")
          + f"); fp32 matmul "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'} (TF32 on: "
          f"{'n/a' if lib_tf32_ms is None else f'{lib_tf32_ms:.3f} ms'}); "
          f"cdist+min yardstick "
          f"{yard_ms if yard_ms is None else round(yard_ms, 3)} ms",
          flush=True)
    if small:
        return row
    # the same-run yardstick: the SIMT tile the tensor-core pass replaced
    _, i_simt = fnn.fused_l2_nn_variant(x, y, "simt")
    simt_ms = cuda_ms(lambda: fnn.fused_l2_nn_variant(x, y, "simt"),
                      KERNEL_REPS)
    simt_dev = device_ms(lambda: fnn.fused_l2_nn_variant(x, y, "simt"),
                         KERNEL_REPS, "nn_kernel")
    differ = ik != i_simt
    gaps = ((dist(ik) - dist(i_simt)).abs() / scale)[differ]
    agree = 1.0 - float(differ.double().mean())
    row.update(yardstick_simt_ms=simt_ms, yardstick_simt_device_ms=simt_dev,
               simt_label_agreement=agree)
    listed = sorted(gaps.tolist(), reverse=True)[:20]
    print(f"  SIMT tile yardstick: {simt_ms:.3f} ms a call, "
          f"{simt_dev:.4f} ms on the device (the pass {simt_dev / dev_ms:.2f}x"
          f" faster); labels equal to the SIMT tile's at {agree:.7f} "
          f"({int(differ.sum())} differ; their distance gap / scale, "
          f"largest first: {', '.join(f'{g:.2e}' for g in listed) or '-'})",
          flush=True)
    if block_sizes:
        times = {}
        for variant in ("tf32 2 warpgroups", "tf32 4 warpgroups",
                        "tf32 4 warpgroups", "tf32 2 warpgroups"):
            times.setdefault(variant, []).append(device_ms(
                lambda: fnn.fused_l2_nn_variant(x, y, variant), KERNEL_REPS,
                kernel))
        row["block_size_device_ms"] = times
        print(f"  block sizes in turns (device ms): {json.dumps(times)}",
              flush=True)
    return row


def h_check(x, y, shape, launches, block_sizes=False):
    """Kernel H vs plain at one more shape a path gives it, as an
    ``also_checked`` entry."""
    return at_shape(check_kernel_h(x, y, shape, False, block_sizes), shape,
                    launches)


def hierarchical_checks(train, n_clusters, label, a_launches, h_launches):
    """Kernels A and H against their plain versions at the three pass
    shapes of the hierarchical balanced fit of ``n_clusters`` clusters on
    ``train``: the mesocluster pass (all rows), a per-mesocluster pass (a
    sample of the fit's size) and a full-K pass, each from strided
    initial centroids as the fit starts.  Returns the ``also_checked``
    entries of A and of H."""
    from raft_tpu_torch.cluster.kmeans_balanced import _strided_init

    n_meso = round(n_clusters ** 0.5)
    k_max = -(-n_clusters // n_meso)
    per = max(2048, 32 * k_max)
    a_rows, h_rows = [], []
    for what, rows, k in (("mesocluster", train, n_meso),
                          ("per-mesocluster", train[:per], k_max),
                          ("full-K", train, n_clusters)):
        shape = (f"{label} {what} pass: {rows.shape[0]:,} x {rows.shape[1]} "
                 f"-> {k:,}")
        c0 = _strided_init(rows, k)
        a_rows.append(at_shape(check_kernel_a(rows, c0, shape), shape,
                               a_launches))
        h_rows.append(h_check(rows, c0, shape, h_launches,
                              block_sizes=True))
    return a_rows, h_rows


def codebook_h_check(index, rows, label):
    """Kernel H vs plain at the shape an IVF-PQ build's codebook fits give
    it, its small-dim kernel's: the first subspace of ``_BOOK_TRAIN_ROWS``
    rotated residuals against its codebook (256 x pq_len).  Returns the
    check's row."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import fused_l2_nn as fnn

    rot = rows[:ivf_pq._BOOK_TRAIN_ROWS].float() @ index.rotation
    lab = fnn.fused_l2_nn_plain(rot, index.centers)[1].long()
    pq_len = index.rot_dim // index.pq_dim
    sub = (rot - index.centers[lab])[:, :pq_len].contiguous()
    book = index.codebooks[0].contiguous()
    return check_kernel_h(sub, book, f"{label} codebook fit: "
                          f"{sub.shape[0]:,} x {pq_len} -> {book.shape[0]}",
                          False)


def kmeans_path(db):
    """BASELINE config 3: ``kmeans.fit`` on the 1,000,000 x 128 rows at
    ``KMeansParams(n_clusters=1024)`` (k-means++, max_iter 300, tol 1e-4),
    then ``predict``; launches zeroed before the fit and read after the
    predict.  k-means++ alone is timed again from the same generator.
    Kernel H vs plain at 1,000,000 x 128 -> 1,024 and at BASELINE config
    2's 100,000 x 128 -> 100,000 (``also_checked``; no path of this script
    runs that shape, so its launches are 0), and Kernel A vs plain at the
    Lloyd loop's shape (1,000,000 x 128 -> 1,024).  Returns H's kernels
    row and A's ``also_checked`` entry."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.cluster import kmeans
    from raft_tpu_torch.cluster.kmeans_types import KMeansParams

    params = KMeansParams(n_clusters=KMEANS_CLUSTERS)
    res = DeviceResources(seed=0)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    centroids, inertia, n_iter = kmeans.fit(res, params, db)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    kmeans.predict(res, params, db, centroids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, inertia_p = kmeans.predict(res, params, db, centroids)
    torch.cuda.synchronize()
    predict_ms = 1e3 * (time.perf_counter() - t0)
    launches = read_launches()
    t0 = time.perf_counter()
    kmeans.init_plus_plus(res, db, KMEANS_CLUSTERS,
                          generator=kmeans._restart_generator(
                              params.seed, 0, db.device))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    inertia, inertia_p = float(inertia), float(inertia_p)
    print(f"k-means 1M x 128 -> {KMEANS_CLUSTERS}: fit {fit_s:.2f} s "
          f"(k-means++ alone {init_s:.2f} s), n_iter {n_iter}, inertia "
          f"{inertia:.6e}; predict {predict_ms:.2f} ms, inertia "
          f"{inertia_p:.6e}; launches {json.dumps(launches)}", flush=True)
    for name in ("kmeans_assign_update", "fused_l2_nn"):
        assert launches[name] > 0, f"k-means: {name} never launched"
    assert centroids.shape == (KMEANS_CLUSTERS, DIM) and bool(
        torch.isfinite(centroids).all()), "k-means: bad centroids"
    assert int(labels.min()) >= 0 and int(labels.max()) < KMEANS_CLUSTERS
    assert 0 < inertia < float("inf") and abs(inertia_p - inertia) <= (
        1e-5 * inertia), "k-means: predict's inertia is not the fit's"
    row = check_kernel_h(db, centroids,
                         f"1,000,000 x 128 -> {KMEANS_CLUSTERS:,}", True)
    row["launches"] = h_tf32_launches(launches)
    row["also_checked"] = [h_check(
        db[:NN_ROWS], db[NN_ROWS:2 * NN_ROWS],
        f"{NN_ROWS:,} x 128 -> {NN_ROWS:,} (BASELINE config 2)", 0)]
    shape = f"k-means Lloyd pass: 1,000,000 x 128 -> {KMEANS_CLUSTERS:,}"
    a_row = at_shape(check_kernel_a(db, centroids, shape), shape,
                     launches["kmeans_assign_update"])
    return row, a_row


# the profile decompositions (PERF.md kernel table rows 10-13): the JAX
# scripts' (n_lists, n_probes), the gather's rows a block, the A cuts
PROFILE_FLAT = ((FLAT_FINE_LISTS, 256), (FLAT_LISTS, 128))
PROFILE_KT = 10
GATHER_ROWS = (1024, 2048)
POLICY_REPS = 5


def policy_cost(label, fn):
    """The ``raise`` validation policy's cost on one batch of a path:
    ``fn`` under ``off`` and under ``raise``, in turns, POLICY_REPS times
    each; the medians and their difference as a share of the batch."""
    import torch
    from raft_tpu_torch import config

    ms = {"off": [], "raise": []}
    for _ in range(POLICY_REPS):
        for policy in ("off", "raise"):
            with config.validation_policy(policy):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms[policy].append(1e3 * (time.perf_counter() - t0))
    med = {p: sorted(v)[len(v) // 2] for p, v in ms.items()}
    share = (med["raise"] - med["off"]) / med["off"]
    print(f"validation policy cost, {label}: off "
          f"{', '.join(f'{m:.3f}' for m in ms['off'])} ms; raise "
          f"{', '.join(f'{m:.3f}' for m in ms['raise'])} ms; medians "
          f"{med['off']:.3f} / {med['raise']:.3f} ms; raise costs "
          f"{med['raise'] - med['off']:.3f} ms = {100 * share:.2f}% of the "
          f"batch", flush=True)
    return med, share


def validator_first_call(dev):
    """The ``raise`` validator's first call in the process (its CUDA
    kernels load on first use) and a second one, on 5,000 x 128 queries;
    the main path's first batch would pay the first."""
    import torch
    from raft_tpu_torch.integrity import boundary

    q = torch.zeros(N_QUERIES, DIM, device=dev)
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        boundary.check_matrix(q, "queries", site="chip_smoke", dim=DIM,
                              policy="raise")
        ms.append(1e3 * (time.perf_counter() - t0))
    print(f"validator (raise) on {N_QUERIES:,} x {DIM}: first call "
          f"{ms[0]:.3f} ms, second {ms[1]:.3f} ms", flush=True)


def variant_row(name, src, replaces, launches, checks):
    """A kernels-line row from its checks, the first the row's own shape
    and the rest under ``also_checked``."""
    first = checks[0]
    row = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches,
           **{key: first[key] for key in MEASURED + EXTRA if key in first}}
    row["shape"] = first["shape"]
    row["also_checked"] = [at_shape(c, c["shape"], launches)
                           for c in checks[1:]]
    return row


def check_scan_variant(label, args, kw, ms, scale, row_bytes, n_rows,
                       flops):
    """One F / G variant of the pair-group pass against its plain
    version: raw blocks within 1e-5 · ``scale`` (F) or 1e-4 (G) at every
    slot with the same +inf, selections as ``compare_with_plain`` holds
    Kernels F and G; the bound from ``n_rows`` rows of ``row_bytes`` read
    once, the queries, the probes and the output against the products as
    3xTF32 (F) or bf16 (G), F's fp32 FFMA bound beside it; and the same
    variant on the query-major kernel it replaced
    (``pair_scan_variant_query_major``), held to the same plain result and
    timed in turns with the pass."""
    import torch
    from raft_tpu_torch.ops import pair_scan as ps

    out = ps.pair_scan_variant(*args, **kw)
    ref, plain_ms = timed_once(lambda: ps.pair_scan_variant_plain(*args,
                                                                  **kw))
    atol = 1e-5 * scale if kw.get("centers") is None else 1e-4 * max(
        scale, 1.0)

    def held(name, got):
        if kw["extract"]:
            return compare_with_plain(name, *got, *ref, atol=atol)
        fin = torch.isfinite(ref)
        assert torch.equal(fin, torch.isfinite(got)), f"{name}: +inf slots"
        worst = float((got[fin] - ref[fin]).abs().max())
        assert worst <= atol, f"{name}: raw distances differ by {worst}"
        return worst
    err = held(label, out)
    out_bytes = out[0].numel() * 8 if kw["extract"] else out.numel() * 4
    # the query-major kernel it replaced, held to the same plain result
    yard_err = held(label + " [query-major kernel]",
                    ps.pair_scan_variant_query_major(*args, **kw))
    q, probes = args[0], args[1]
    nbytes = n_rows * row_bytes + q.numel() * 4 + probes.numel() * 4 \
        + out_bytes
    fp32 = kw.get("centers") is None
    bound_ms, bound_by = (bound(nbytes, 3 * flops, TF32_FLOP_PER_S) if fp32
                          else bound(nbytes, flops))
    ffma_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
    del out, ref
    ms_turns, yard = in_turns(lambda: ps.pair_scan_variant(*args, **kw),
                              lambda: ps.pair_scan_variant_query_major(
                                  *args, **kw))
    print(f"{label}: {ms:.3f} ms (in turns {ms_turns[0]:.3f} / "
          f"{ms_turns[1]:.3f}, the query-major kernel {yard[0]:.3f} / "
          f"{yard[1]:.3f}), plain {plain_ms:.1f} ms, max |err| {err} (the "
          f"query-major kernel {yard_err}; tol {atol:.3g}), bound "
          f"{bound_ms:.4f} ms ({bound_by}; "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP"
          + (f"; fp32 FFMA {ffma_ms:.4f} ms" if fp32 else "") + ")",
          flush=True)
    return {"shape": label, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "yardstick_query_major_ms": yard,
            "yardstick_query_major_max_abs_err": yard_err,
            **({"ffma_bound_ms": ffma_ms} if fp32 else {})}


def flat_variant_checks(index, queries, n_probes, lines):
    """Row 10 at one IVF-Flat shape: each (gather, extract) variant line
    of the profile's run (``lines``) held to its plain version."""
    import torch
    from raft_tpu_torch.profiles import group_kernel_decomp_r5 as gkd

    probes, data, dsq, ids = gkd.scan_inputs(index, queries, n_probes)
    qg = gkd.pregather(queries, n_probes)
    scale = float((queries * queries).sum(1).max() + dsq.max())
    cap, dim = index.capacity, index.dim
    pr = probes.long()
    probed = torch.unique(pr)
    live = (ids >= 0).sum(1)
    checks = []
    for line in lines:
        gather, extract = line["gather"], line["extract"]
        q_in = queries if gather else qg
        if extract:     # live rows, their ids and norms; live products
            n_rows = int(live[probed].sum())
            row_bytes = dim * 4 + 8
            flops = 2.0 * dim * int(live[pr].sum())
        else:           # every slot, its norm; every product
            n_rows = probed.numel() * cap
            row_bytes = dim * 4 + 4
            flops = 2.0 * dim * pr.numel() * cap
        checks.append(check_scan_variant(
            f"pair_scan_variant F nlist {index.n_lists}, n_probes "
            f"{n_probes}, capacity {cap}, gather {gather}, extract "
            f"{extract}", (q_in, probes, data, dsq, ids, PROFILE_KT),
            dict(gather=gather, extract=extract), line["ms"], scale,
            row_bytes, n_rows, flops))
    return checks


def recon_raw_inputs(index, queries):
    """Row 10's raw variant on Kernel G's rows (``Bf16Rows``) at the
    flagship ``recon`` shape: the scan's arguments and switches."""
    qrot, probes = probe(index, queries)
    return ((qrot, probes, index.list_recon, index.list_recon_sq,
             index.list_indices, K_SEARCH),
            dict(gather=True, extract=False, centers=index.centers))


def recon_raw_check(index, args, kw, ms):
    """G's raw scan (timed at ``ms`` on the profile path) against its
    plain version, with its bound: every slot of every probed list."""
    import torch

    qrot, probes = args[0], args[1]
    cap, rot = index.capacity, index.rot_dim
    pr = probes.long()
    n_rows = torch.unique(pr).numel() * cap
    scale = float((qrot * qrot).sum(1).max() + index.list_recon_sq.max())
    return check_scan_variant(
        f"pair_scan_variant G raw, flagship recon: {N_QUERIES:,} queries x "
        f"{N_PROBES} probes, capacity {cap}, rot {rot}", args, kw, ms, scale,
        rot * 2 + 4, n_rows, 2.0 * rot * pr.numel() * cap)


def gather_checks(table, ids, lines):
    """Row 11: Kernel J bit-equal to ``index_select`` at each dtype and
    block height the profile ran; bound = the gathered rows read once and
    written once, and the ids."""
    import torch
    from raft_tpu_torch.ops import row_gather as rg

    lib = {ln["dtype"]: ln["ms"] for ln in lines
           if ln["impl"] == "index_select"}
    checks = []
    for dtype in ("bf16", "f32"):
        t = table.to(torch.bfloat16) if dtype == "bf16" else table
        for line in lines:
            if line["impl"] != "row_gather" or line["dtype"] != dtype:
                continue
            out = rg.row_gather(t, ids, line["rows"])
            ref, plain_ms = timed_once(lambda: rg.row_gather_plain(t, ids))
            assert torch.equal(out, ref), f"row_gather {dtype} differs"
            nbytes = 2 * out.numel() * out.element_size() + ids.numel() * 4
            bound_ms, bound_by = bound(nbytes, 0.0)
            label = (f"row_gather {dtype}: {ids.numel():,} of "
                     f"{t.shape[0]:,} x {t.shape[1]} rows, {line['rows']} "
                     f"rows a block")
            print(f"{label}: {line['ms']:.4f} ms ({line['gb_per_s']:.1f} "
                  f"GB/s gathered), index_select {lib[dtype]:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bit-equal, bound {bound_ms:.4f} ms "
                  f"({bound_by})", flush=True)
            checks.append({"shape": label, "max_abs_err": 0.0,
                           "ms": line["ms"], "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "library_ms": lib[dtype]})
            del out, ref
    return checks


def cut_checks(x, c, timed):
    """Rows 12-13: each Kernel A cut against its plain version, tie-aware
    as Kernel A (``check_assignment``: dmin within τ, each label the plain
    one or at a tie; the count that differs is printed); mmargmin's label
    sum and uw's counts exact and uw's sums within 1e-5 · count · max|x|
    against the plain update from the cut's own labels, mxuonly's column
    sums within 1e-4 of the largest — with its time from the profiles'
    run (``timed``: cut -> (ms, source line, library ms)); bound: the
    product's bf16 operations, or x, the centroids and the outputs
    once."""
    import torch
    from raft_tpu_torch.ops import kmeans_update as ku
    from raft_tpu_torch.profiles.kmeans_decomp_r5 import TILE

    xb = x.to(torch.bfloat16)
    n, dim = x.shape
    k = c.shape[0]
    flops = 2.0 * n * k * dim
    checks = []
    for cut, (ms, src, lib_ms) in timed.items():
        sums, counts, dmin, labels = ku.kmeans_pass_cut(xb, c, cut)
        (p_sums, p_counts, p_dmin, p_labels), plain_ms = timed_once(
            lambda: ku.kmeans_pass_cut_plain(xb, c, cut))
        assert (labels is None) == (p_labels is None)
        check = ku.check_assignment(xb, c, dmin, labels, p_dmin, p_labels)
        assert check.ok, f"kmeans_pass_cut {cut}: {check}"
        if labels is not None:
            p_sums, p_counts = ku.pass_cut_update_plain(xb, cut, labels, k)
        cerr = float((counts - p_counts).abs().max())
        if cut == "mxuonly":
            assert cerr <= 1e-4 * float(p_counts.abs().max()), (
                f"kmeans_pass_cut mxuonly: column sums differ by {cerr}")
        else:
            assert cerr == 0.0, f"kmeans_pass_cut {cut}: counts"
        serr = (sums - p_sums).abs()
        tol = 1e-5 * p_counts.clamp_min(0)[:, None] * float(
            xb.float().abs().max()) + 1e-6
        if cut in ("uw", "full"):
            assert bool((serr <= tol).all()), (
                f"kmeans_pass_cut {cut}: sums differ by {float(serr.max())}")
        err = max(float(serr.max()), cerr, check.dmin_err)
        nbytes = n * dim * 2 + k * dim * 2 + k * 4 + n * 4 + k * 4 + (
            k * dim * 4 + n * 4 if cut in ("uw", "full") else 0)
        bound_ms, bound_by = bound(nbytes, flops)
        label = (f"kmeans_pass_cut {cut} ({src}): {n:,} x {dim} -> {k:,}, "
                 f"tile {TILE}")
        print(f"{label}: {ms:.3f} ms, plain {plain_ms:.1f} ms, max |dmin "
              f"err| {check.dmin_err} (tau {check.tau:.3e}), labels "
              f"differing {check.flips} (at ties), max |err| {err}, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of it "
              f"reached), library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}",
              flush=True)
        checks.append({"shape": label, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms,
                       "tau": check.tau, "label_flips": check.flips})
        del sums, counts, dmin, labels, p_sums, p_counts, p_dmin, p_labels
    return checks


def profiles_path(dev, flagship, queries, flat_indexes):
    """The four profile entry points of the port at the JAX scripts' sizes
    (rows 10-13), launches zeroed before and read after: the F variants on
    the IVF-Flat phase's two indexes and G's raw scan on the flagship
    index; the row gather; the k-means cuts, base, uw and mxuonly.  Then
    each kernel variant against its plain version; returns the three
    kernels-line rows."""
    import torch
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.profiles import gather_bench as gb
    from raft_tpu_torch.profiles import group_kernel_decomp_r5 as gkd
    from raft_tpu_torch.profiles import kmeans_decomp_r5 as kd
    from raft_tpu_torch.profiles import kmeans_kernel_r5 as kk

    def show(lines):
        for line in lines:
            print(json.dumps(line), flush=True)

    torch.cuda.synchronize()
    zero_launches()
    flat_lines = {}
    for (n_lists, n_probes), index in zip(PROFILE_FLAT, flat_indexes):
        flat_lines[n_lists] = gkd.run_on_index(index, queries, n_probes,
                                               PROFILE_KT, KERNEL_REPS)
        show(flat_lines[n_lists])
    g_args, g_kw = recon_raw_inputs(flagship, queries)
    g_ms = cuda_ms(lambda: ps.pair_scan_variant(*g_args, **g_kw),
                   KERNEL_REPS)
    table, ids = gb.inputs(device=dev)
    g_lines, match = gb.run(table, ids, GATHER_ROWS)
    show(g_lines)
    print("match:", match, flush=True)
    assert match, "row_gather: not bit-equal to index_select"
    x, c = kd.inputs(device=dev)
    kd_lines = kd.run(x, c)
    show(kd_lines)
    kk_lines, spot = kk.run(x, c)
    show(kk_lines + [spot])
    assert all(spot.values()), f"kmeans_kernel_r5 spot check: {spot}"
    launches = read_launches()
    print(f"profile launches: {json.dumps(launches)}", flush=True)
    for name in ("pair_scan_variant", "row_gather", "kmeans_pass_cut"):
        assert launches[name] > 0, f"profiles: {name} never launched"

    # F's own shape (nlist 4096) first, its raw gathering scan first of
    # all: the row's main entry is the split of Kernel F's time
    f_checks = []
    for (n_lists, n_probes), index in reversed(list(zip(PROFILE_FLAT,
                                                        flat_indexes))):
        lines = sorted((ln for ln in flat_lines[n_lists] if "gather" in ln),
                       key=lambda ln: (ln["extract"], not ln["gather"]))
        f_checks += flat_variant_checks(index, queries, n_probes, lines)
    g_check = recon_raw_check(flagship, g_args, g_kw, g_ms)
    j_checks = gather_checks(table, ids, g_lines)
    del table, ids
    yard = kd_lines[-1]["ms"]
    timed = {ln["variant"]: (ln["ms"], "profiles/kmeans_decomp_r5.py:67",
                             yard if ln["variant"] == "mm" else None)
             for ln in kd_lines if "variant" in ln}
    timed.update({ln["variant"]: (ln["ms"], "profiles/kmeans_kernel_r5.py:77",
                                  None)
                  for ln in kk_lines if ln["variant"] != "base"})
    a_checks = cut_checks(x, c, timed)
    del x, c
    torch.cuda.empty_cache()
    return [
        variant_row("pair_scan_variant",
                    "raft_tpu_torch/csrc/pair_list_scan.cu",
                    "profiles/group_kernel_decomp_r5.py:50",
                    launches["pair_scan_variant"], f_checks + [g_check]),
        variant_row("row_gather", "raft_tpu_torch/csrc/row_gather.cu",
                    "profiles/gather_bench.py:70", launches["row_gather"],
                    j_checks),
        variant_row("kmeans_pass_cut", "raft_tpu_torch/csrc/kmeans_update.cu",
                    "profiles/kmeans_decomp_r5.py:67",
                    launches["kmeans_pass_cut"], a_checks)]


def search_mode(res, index, db, queries, truth, label, sp, kernel,
                reps=SEARCH_REPS):
    """One IVF-PQ scan mode on a built index: launch counts zeroed before
    and read after; a first search (which attaches the mode's lazy cache),
    then ``reps`` batches of search + refine (refined by the index's
    metric).  ``kernel``: the wrapper that must have launched, or None for
    a composition, which must launch no scan kernel."""
    import torch
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors import refine as refine_

    def refine(res, db, queries, cand, k):
        if index.metric == DistanceType.InnerProduct:
            return refine_(res, db, queries, cand, k, metric=index.metric)
        return refine_(res, db, queries, cand, k)

    torch.cuda.synchronize()
    zero_launches()
    fallbacks = ivf_pq.search.fused_fallbacks
    t0 = time.perf_counter()
    ivf_pq.search(res, sp, index, queries, K_SEARCH)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    search_ms, batch_ms = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, cand = ivf_pq.search(res, sp, index, queries, K_SEARCH)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, found = refine(res, db, queries, cand, K)
        torch.cuda.synchronize()
        search_ms.append(1e3 * (t1 - t0))
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_launches()
    fallbacks = ivf_pq.search.fused_fallbacks - fallbacks
    hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
    recall = float(hits) / truth.numel()
    med = sorted(batch_ms)[len(batch_ms) // 2]
    print(f"{label}: first search {first_ms:.2f} ms (lazy caches "
          f"included); search {', '.join(f'{m:.2f}' for m in search_ms)} "
          f"ms; search+refine {', '.join(f'{m:.2f}' for m in batch_ms)} ms "
          f"per batch of {queries.shape[0]}; QPS "
          f"{queries.shape[0] / (med / 1e3):.0f} (median); recall@10 "
          f"{recall:.4f}; launches {json.dumps(launches)}; fused "
          f"fallbacks {fallbacks}", flush=True)
    if kernel is None:
        scans = {n: c for n, c in launches.items()
                 if n not in ("fused_l2_nn", "fused_l2_nn_small_dim") and c}
        assert not scans, f"{label}: the composition launched {scans}"
    else:
        assert launches[kernel] > 0, f"{label}: {kernel} never launched"
    return {"label": label, "recall": recall, "launches": launches,
            "batch_ms": med, "cand": cand, "fallbacks": fallbacks}


def same_build_routes(label, module, name, walked, kernels, search,
                      truth, gate=True, gap=ROUTE_RECALL_GAP,
                      first="list-major", turns=False):
    """Recall@k (k: ``truth``'s width) of one batch on one build
    (``search()`` gives its found ids) through the search's own route
    (``first``: the list-major pass, or the pair-group pass) and through
    the query-major scan ``walked`` swapped in for ``module.name``, the
    search's scan: what the routes' own rounding does to recall, with the
    build held fixed.  With ``turns`` the batch's wall ms through each, in
    turns (route, query-major, query-major, route); else one run each,
    untimed.  ``kernels`` (the first route's
    wrapper, the query-major wrapper): their launches say that each route
    ran alone.  Where ``gate``, the two must agree within ``gap``; else
    the comparison is printed only."""
    import torch

    listed = getattr(module, name)
    recall, ms = {}, {}

    def walked_scan(*args, filter_words=None, **kw):
        # the search's scan is called with its filter (None: unfiltered);
        # the query-major kernels take none
        assert filter_words is None, f"{label}: a filtered search"
        return walked(*args, **kw)

    order = (first, "query-major") + (("query-major", first) if turns
                                      else ())
    for route in order:
        before = [k.launches for k in kernels]
        if route == "query-major":
            setattr(module, name, walked_scan)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            found = search()
            torch.cuda.synchronize()
            ms.setdefault(route, []).append(1e3 * (time.perf_counter() - t0))
        finally:
            setattr(module, name, listed)
        ran = tuple(k.launches > b for k, b in zip(kernels, before))
        assert ran == (route == first, route == "query-major"), (
            f"{label}: the {route} route did not run alone")
        hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
        recall.setdefault(route, []).append(float(hits) / truth.numel())
    at = truth.shape[1]
    print(f"{label}, one build, recall@{at} by route: {json.dumps(recall)}"
          + (f"; ms a batch in turns: {json.dumps(ms)}" if turns else ""),
          flush=True)
    recall = {route: r[0] for route, r in recall.items()}
    apart = abs(recall[first] - recall["query-major"])
    assert apart <= gap or not gate, (
        f"{label}: the routes' recall@{at} differ by {apart}")
    return recall


def pq_same_build_routes(res, index, db, queries, truth, label, sp, fused):
    """:func:`same_build_routes` for one IVF-PQ search + refine batch:
    Kernel B's ``scan_query_major`` swapped in for the search's fused scan
    when ``fused``, else G's ``recon_scan_query_major`` for its recon
    scan; pass 1 (``list_scan``) is the list-major route of both."""
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_group_scan as pgs

    name, walked = (("ivf_pq_scan_fused", pgs.scan_query_major) if fused
                    else ("ivf_pq_scan_recon", ps.recon_scan_query_major))
    return same_build_routes(
        label, ivf_pq, name, walked, (pgs.list_scan, walked),
        lambda: refine(res, db, queries, ivf_pq.search(
            res, sp, index, queries, K_SEARCH)[1], K)[1], truth)


def codes_same_build_routes(res, index, db, queries, truth, label, sp,
                            fused):
    """:func:`same_build_routes` for one IVF-PQ search + refine batch over
    the codes: Kernel C's ``codes_fused_query_major`` swapped in for the
    search's fused codes scan when ``fused``, else D's
    ``codes_scan_query_major``; ``code_list_scan`` is the list-major route
    of both.  Printed only, gated on nothing."""
    from raft_tpu_torch.neighbors import refine
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import pq_code_scan as pcs

    name, walked = (("ivf_pq_scan_codes_fused", pcs.codes_fused_query_major)
                    if fused else ("ivf_pq_scan_codes",
                                   pcs.codes_scan_query_major))
    return same_build_routes(
        label, pcs, name, walked, (pcs.code_list_scan, walked),
        lambda: refine(res, db, queries, ivf_pq.search(
            res, sp, index, queries, K_SEARCH)[1], K)[1], truth, gate=False)


def recon8_same_build_routes(res, index, db, queries, truth, label, sp):
    """:func:`same_build_routes` for one IVF-PQ recon8 search + refine
    batch: Kernel E's ``recon8_scan_query_major`` swapped in for the
    search's int8 scan, ``recon8_list_scan`` its list-major route; the
    two must agree within ROUTE_RECALL_GAP."""
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.ops import pq_code_scan as pcs

    walked = pcs.recon8_scan_query_major
    return same_build_routes(
        label, pcs, "ivf_pq_scan_recon8", walked,
        (pcs.recon8_list_scan, walked),
        lambda: refine(res, db, queries, ivf_pq.search(
            res, sp, index, queries, K_SEARCH)[1], K)[1], truth)


def flagship_code_checks(index, queries):
    """Kernels C (kt 20 and kt 4, k 20) and D (kt 4) on the flagship
    index's codes (rot 128, pq_dim 64, 8 bits: the list-major codes
    pass's tightest shared-memory shape) against their plain versions on
    its batch (5000 queries x 96 probes).  Returns C's and D's
    ``also_checked`` entries (the main path runs neither: 0 launches)."""
    from raft_tpu_torch.neighbors import ivf_pq

    ivf_pq._with_code_rsq(index)
    c20 = check_code_kernels(index, queries, K_SEARCH, ("C",))[0]
    c4, d4 = check_code_kernels(index, queries, DEEP_KT, ("C", "D"))
    shape = (f"flagship codes (list-major): {N_QUERIES:,} queries x "
             f"{N_PROBES} probes, capacity {index.capacity:,}, rot "
             f"{index.rot_dim}, pq_dim {index.pq_dim}, {index.pq_bits} bits")
    return ([at_shape(c20, f"{shape}, k {K_SEARCH}, kt {K_SEARCH}", 0),
             at_shape(c4, f"{shape}, k {K_SEARCH}, kt {DEEP_KT}", 0)],
            [at_shape(d4, f"{shape}, kt {DEEP_KT}", 0)])


def codes_past_smem_checks(dev):
    """Kernel D's query-major route at shapes whose books and whole LUT
    do not fit in its shared memory together, both admitted by the Pallas
    codes gate: rot 256, pq_dim 128, 8 bits (the books read from global
    memory) and pq_dim 256 (the LUT summed in chunks), each against its
    plain version on random lists, called as itself (``codes_scan_route``,
    printed, gives both shapes to the pair-group pass, its books in
    global memory).  Returns D's ``also_checked`` entries
    (no path of this script gives D these shapes: 0 launches)."""
    import torch
    from raft_tpu_torch.ops import pq_code_scan as pcs

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    L, cap, rot, bits, nq, P, kt = 64, 416, 256, 8, 256, 8, 100
    entries = []
    for pq_dim in (128, 256):
        pq_len, W = rot // pq_dim, pq_dim * bits // 8
        _, lut_sub, staged = pcs.codes_layout(cap, rot, pq_dim, bits)
        assert not staged, f"Kernel D at pq_dim {pq_dim}: books staged"
        # D's route here is the pair-group pass (its books in global
        # memory); the query-major kernel is called as itself
        route, why = pcs.codes_scan_route(cap, rot, pq_dim, bits, kt)
        print(f"Kernel D at rot {rot}, pq_dim {pq_dim}, kt {kt}: route "
              f"{route} ({why})", flush=True)
        codes = torch.randint(0, 256, (L, cap, W), device=dev, generator=g,
                              dtype=torch.uint8)
        books = torch.randn(pq_dim, 1 << bits, pq_len, device=dev,
                            generator=g) * 0.1
        rsq = (pcs.decode_codes(codes, books, bits).float() ** 2).sum(-1)
        ids = torch.arange(L * cap, device=dev, dtype=torch.int32).reshape(
            L, cap)
        ids[:, 1::7] = -1
        qq = torch.randn(nq, rot, device=dev, generator=g) * 0.1
        cc = torch.randn(L, rot, device=dev, generator=g) * 0.1
        pr = torch.randint(0, L, (nq, P), device=dev, generator=g,
                           dtype=torch.int32)
        args = (qq, cc, pr, codes, books, rsq, ids, bits, kt)
        vk, ik = pcs.codes_scan_query_major(*args)
        (vp, ip), plain_ms = timed_once(
            lambda: pcs.ivf_pq_scan_codes_plain(*args))
        shape = (f"rot {rot}, pq_dim {pq_dim}, {bits} bits (books in "
                 f"global memory, LUT chunks of {lut_sub} subspaces), {nq} "
                 f"queries x {P} probes of {L} random lists of {cap}, kt "
                 f"{kt}")
        err = compare_with_plain(f"Kernel D query-major at {shape}", vk, ik,
                                 vp, ip)
        ms_k = cuda_ms(lambda: pcs.codes_scan_query_major(*args),
                       KERNEL_REPS)
        nbytes = nq * P * cap * (W + 8) + 2 * books.numel() + nq * P * kt * 8
        bound_ms, bound_by = bound(nbytes, 2.0 * nq * P * cap * rot)
        print(f"Kernel D at {shape}: {ms_k:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        entries.append(at_shape(
            {"max_abs_err": err, "ms": ms_k, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None},
            shape, 0))
    return entries


def deep_path(dev):
    """Phase 10: the deep-like-10m / raft_ivf_pq.dim48 index at full width,
    every compact-code scan mode through ``ivf_pq.search``, then every
    kernel of the path against its plain version at the shapes the path
    gives it.  Returns the kernel rows of C, D and E with the launches of
    their modes' runs, the rows of their pair-group pass past kt 64 (C, D,
    E), the deep-shape checks of Kernels A, B, G and H (``at_shape``
    entries); the rest of IVF-PQ's runs; and the rows, the
    queries and their exact top-10 for the deep CAGRA phase."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    db, queries = sift_like(DEEP_DB, N_QUERIES, DEEP_DIM, LATENT, NOISE, dev)
    torch.cuda.synchronize()
    print(f"deep data: {DEEP_DB} x {DEEP_DIM} + {N_QUERIES} queries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    res = DeviceResources(seed=0)
    t0 = time.perf_counter()
    _, truth = brute_force.knn(res, db, queries, K)
    torch.cuda.synchronize()
    print(f"deep ground truth (brute_force.knn): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    params = ivf_pq.IndexParams(n_lists=DEEP_LISTS, pq_dim=DEEP_PQ_DIM,
                                kmeans_trainset_fraction=DEEP_TRAIN_FRACTION)
    zero_launches()
    t0 = time.perf_counter()
    index = ivf_pq.build(res, params, db)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = read_launches()
    sizes = index.list_sizes.float()
    print(f"deep build: {build_s:.2f} s; {index.n_lists} lists, capacity "
          f"{index.capacity} (list sizes mean {float(sizes.mean()):.1f}, max "
          f"{int(sizes.max())}, min {int(sizes.min())}), {index.size} rows, "
          f"pq_dim {index.pq_dim}, rot {index.rot_dim}; launches "
          f"{json.dumps(build_launches)}", flush=True)
    # coarse_fit is the hierarchical k-means, ~sqrt(K) mesoclusters looped
    print(f"deep build stages (s): {json.dumps(ivf_pq.build.stage_seconds)}",
          flush=True)
    for name in ("kmeans_assign_update", "fused_l2_nn"):
        assert build_launches[name] > 0, f"deep build: {name} never launched"
    print(f"deep peak device memory through the build: {peak_gb():.2f} GB",
          flush=True)

    # Kernels A and H at the hierarchical fit's three pass shapes, on the
    # build's trainset (the first draw of a seed-0 handle, rotated), and H
    # at the codebook fits' shape
    n_train = int(DEEP_DB * DEEP_TRAIN_FRACTION)
    sel = torch.randperm(DEEP_DB, generator=DeviceResources(seed=0).generator,
                         device=dev)[:n_train]
    train = db[sel] @ index.rotation
    del sel
    a_deep, h_deep = hierarchical_checks(
        train, DEEP_LISTS, "deep", build_launches["kmeans_assign_update"],
        h_tf32_launches(build_launches))
    del train
    book = batched_h_check(index, db, "subspace", "deep")
    hs_deep = at_shape(book, book["shape"],
                       build_launches["fused_l2_nn_batched"])
    torch.cuda.empty_cache()

    def sp(**kw):
        return ivf_pq.SearchParams(n_probes=N_PROBES, **kw)

    kt4 = dict(per_probe_topk=DEEP_KT)
    runs = {}
    for label, params_, kernel in (
            ("auto", sp(), "merge_pairs"),
            ("fused", sp(scan_mode="fused", **kt4), "code_list_scan"),
            ("codes", sp(scan_mode="codes", **kt4), "code_list_scan"),
            ("recon8", sp(scan_mode="recon8", **kt4), "recon8_list_scan"),
            ("recon", sp(scan_mode="recon", **kt4), "list_scan")):
        runs[label] = search_mode(res, index, db, queries, truth,
                                  f"deep {label}", params_, kernel)
        runs[label]["params"] = params_
    # C and D at kt 4 run the list-major codes pass (C with pass 2), never
    # the query-major kernels
    assert runs["fused"]["launches"]["merge_pairs"] > 0, (
        "deep fused: pass 2 never launched")
    for label in ("fused", "codes"):
        got = runs[label]["launches"]
        assert got["codes_fused_query_major"] == got[
            "codes_scan_query_major"] == 0, (
            f"deep {label}: a query-major codes kernel ran")
        assert runs[label]["fallbacks"] == 0, f"deep {label}: C refused"
    # E at kt 4 runs its list-major pass, never the query-major kernel
    assert runs["recon8"]["launches"]["recon8_scan_query_major"] == 0, (
        "deep recon8: the query-major kernel ran")
    agree = float((runs["fused"]["cand"] == runs["codes"]["cand"]).float()
                  .mean())
    print(f"deep fused vs codes: candidate ids equal at {agree:.5f} of "
          f"ranks", flush=True)
    assert runs["auto"]["recall"] >= 0.90, (
        f"deep auto recall@10 {runs['auto']['recall']} below 0.90")
    assert runs["auto"]["fallbacks"] == 0, "deep auto: Kernel B refused"
    assert runs["auto"]["launches"]["list_scan"] > 0, (
        "deep auto: pass 1 never launched")
    pq_same_build_routes(res, index, db, queries, truth, "deep auto", sp(),
                         True)
    pq_same_build_routes(res, index, db, queries, truth, "deep recon kt 4",
                         runs["recon"]["params"], False)
    for label in ("fused", "codes"):
        codes_same_build_routes(res, index, db, queries, truth,
                                f"deep {label} kt 4", runs[label]["params"],
                                label == "fused")
    recon8_same_build_routes(res, index, db, queries, truth,
                             "deep recon8 kt 4", runs["recon8"]["params"])
    for label in ("fused", "codes", "recon8", "recon"):
        assert runs[label]["recall"] >= 0.80, (
            f"deep {label} recall@10 {runs[label]['recall']} below 0.80")
    assert agree >= 0.99, f"deep fused and codes ids agree at {agree}"
    print(f"deep peak device memory through the searches: {peak_gb():.2f} "
          f"GB", flush=True)

    rows = check_code_kernels(index, queries, DEEP_KT)
    rows[0]["launches"] = runs["fused"]["launches"]["merge_pairs"]
    rows[0]["pass1_launches"] = runs["fused"]["launches"]["code_list_scan"]
    rows[1]["launches"] = runs["codes"]["launches"]["code_list_scan"]
    rows[2]["launches"] = runs["recon8"]["launches"]["recon8_list_scan"]
    for row in rows:
        row["also_checked"] = []
    rows_f = deep_filtered(res, index, queries)
    for kt in (DEEP_KT, WIDE_DEEP_KT):
        codes_bit_equal(index, queries, kt)
        recon8_bit_equal(index, queries, kt)
    t0 = time.perf_counter()
    pair_rows = deep_pair_batches(res, index, db, queries)
    walked = check_codes_query_major(index, queries, LARGE_KT_QUERIES)
    walked_f, unfiltered = deep_wide_filtered(res, index, db, queries)
    print(f"deep k = kt = {WIDE_DEEP_KT} (the pair-group pass of C, D and "
          f"E): {time.perf_counter() - t0:.1f} s", flush=True)
    # the checks past kt 64 go under the pass's rows: C's main entry is its
    # 1,000-query check with the launches of the unfiltered 1,000-query
    # fused search (its k-100 batch); D and E's 1,000-query check has the
    # launches of theirs
    rows[0]["also_checked"].append(rows_f[0])
    for row, pair, i, mode in zip(rows[1:], pair_rows, (1, 2),
                                  ("codes", "recon8")):
        row["also_checked"].append(rows_f[i])
        pair["also_checked"] = [dict(walked[i], launches=unfiltered[mode]),
                                walked_f[i]]
    pair_rows.insert(0, dict(
        walked[0], name="ivf_pq_scan_codes_fused (C past kt 64)",
        route="cuda", replaces="raft_tpu/ops/pq_code_scan_pallas.py:282",
        launches=unfiltered["fused"],
        pass2_launches=unfiltered["fused merge"],
        also_checked=[walked_f[0]]))
    b_deep = at_shape(
        check_kernel_b(index, queries),
        f"deep: {N_QUERIES:,} queries x {N_PROBES} probes, k {K_SEARCH}, kt "
        f"{K_SEARCH}, capacity {index.capacity:,}, rot {index.rot_dim}",
        runs["auto"]["launches"]["merge_pairs"])
    g_deep = at_shape(
        check_kernel_g(index, queries, DEEP_KT),
        f"deep recon: {N_QUERIES:,} queries x {N_PROBES} probes, kt "
        f"{DEEP_KT}, capacity {index.capacity:,}, rot {index.rot_dim}",
        runs["recon"]["launches"]["list_scan"])
    ratio = rows[2]["ms"] / g_deep["ms"]
    print(f"deep kt {DEEP_KT}: E {rows[2]['ms']:.3f} ms against G "
          f"{g_deep['ms']:.3f} ms in this run ({ratio:.2f}x)", flush=True)

    for label, run in runs.items():
        device_breakdown(f"deep {label} search+refine batch",
                         lambda: refine(res, db, queries, ivf_pq.search(
                             res, run["params"], index, queries,
                             K_SEARCH)[1], K))

    # the memory-lean deployment: no recon cache, so auto -> codes, whose
    # Kernel C runs at kt = k
    index.list_recon = index.list_recon_sq = index.list_code_rsq = None
    torch.cuda.empty_cache()
    lean = search_mode(res, index, db, queries, truth, "deep auto without a "
                       "recon cache", sp(), "code_list_scan")
    assert lean["recall"] >= 0.90, (
        f"deep auto (no recon cache) recall@10 {lean['recall']} below 0.90")
    assert lean["launches"]["merge_pairs"] > 0 and lean["fallbacks"] == 0, (
        "deep auto without a recon cache: not the list-major C")
    row_c = check_code_kernels(index, queries, K_SEARCH, ("C",))[0]
    rows[0]["also_checked"].append(at_shape(
        row_c, f"deep, no recon cache: {N_QUERIES:,} queries x {N_PROBES} "
        f"probes, k {K_SEARCH}, kt {K_SEARCH}, capacity {index.capacity:,}",
        lean["launches"]["merge_pairs"]))
    print(f"deep peak device memory, plain versions included: "
          f"{peak_gb():.2f} GB", flush=True)

    # the LUT scan and recon8 past Kernel E's gates on the same index
    lut = search_mode(res, index, db, queries[:DEEP_LUT_QUERIES],
                      truth[:DEEP_LUT_QUERIES], "deep lut",
                      sp(scan_mode="lut"), None, 1)
    e_wide, wide8 = recon8_wide_checks(res, index, db, queries, truth)
    rows[2]["also_checked"].append(e_wide)
    del index
    torch.cuda.empty_cache()
    rest = {"deep lut": (lut["batch_ms"], lut["recall"]),
            "deep recon8 k = kt = 256": wide8,
            "InnerProduct": ip_path(dev, db, queries)}
    return (rows, pair_rows, a_deep, b_deep, g_deep, h_deep, hs_deep, rest,
            (db, queries, truth))


def deep_filtered(res, index, queries):
    """The deep index's first DEEP_FILTER_QUERIES queries with one row of
    the 50% filter broadcast (1.25 MB of words for its 10M ids): a filtered
    search in each compact-code mode at kt 4 (its list-major kernel
    launched, no query-major one; every id admitted), then Kernels C, D
    and E against their plain versions with the filter at that shape.
    Returns three ``also_checked`` entries (C, D, E)."""
    from raft_tpu_torch.filters import SampleFilter
    from raft_tpu_torch.neighbors import ivf_pq

    nq = DEEP_FILTER_QUERIES
    q = queries[:nq]
    words = half_words(1, DEEP_DB, FILTER_SEED, q.device).expand(nq, -1)
    f = SampleFilter(words=words, n_rows=DEEP_DB)
    launched = {}
    for mode, kernel in (("fused", "code_list_scan"),
                         ("codes", "code_list_scan"),
                         ("recon8", "recon8_list_scan")):
        sp = ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode=mode,
                                 per_probe_topk=DEEP_KT)
        zero_launches()
        (_, ids), ms = timed_once(
            lambda: ivf_pq.search(res, sp, index, q, K_SEARCH, filter=f))
        launches = read_launches()
        assert_admitted(f"deep filtered {mode}", ids, words)
        assert launches[kernel] > 0 and launches[
            "codes_fused_query_major"] == launches[
            "codes_scan_query_major"] == launches[
            "recon8_scan_query_major"] == 0, (
            f"deep filtered {mode}: launches {launches}")
        launched[mode] = launches[kernel]
        print(f"deep filtered {mode} kt {DEEP_KT} (50% row broadcast, "
              f"{nq:,} queries): {ms:.2f} ms; launches "
              f"{json.dumps(launches)}", flush=True)
    rows = check_code_kernels(index, q, DEEP_KT, filter_words=words)
    # each pass's device ms unfiltered and filtered, in turns, at this shape
    from raft_tpu_torch.ops import pq_code_scan as pcs

    qrot, probes = probe(index, q)
    common = (qrot, index.centers, probes)
    codes = common + (index.list_codes, index.codebooks, index.list_code_rsq,
                      index.list_indices, index.pq_bits)
    for row, (fn, args) in zip(rows, (
            (pcs.ivf_pq_scan_codes_fused, codes + (K_SEARCH, DEEP_KT)),
            (pcs.ivf_pq_scan_codes, codes + (DEEP_KT,)),
            (pcs.ivf_pq_scan_recon8, common + (
                index.list_recon_i8, index.list_recon_scale,
                index.list_recon_i8_sq, index.list_indices, DEEP_KT)))):
        split = {}
        for turn in ("unfiltered", "filtered", "filtered", "unfiltered"):
            fw = dict(filter_words=words) if turn == "filtered" else {}
            _, got = device_split(lambda: fn(*args, **fw), KERNEL_REPS,
                                  ("code_list_scan_kernel",))
            split.setdefault(turn, []).append(got["code_list_scan_kernel"])
        row["unfiltered_pass1_device_ms"] = min(split["unfiltered"])
        print(f"{row['name']}: pass 1 device ms in turns, unfiltered "
              f"{split['unfiltered']}, filtered {split['filtered']}",
              flush=True)
    return [at_shape(dict(row, filter_bytes=words.shape[1] * 4),
                     f"filtered, 50% row broadcast: deep, {nq:,} queries x "
                     f"{N_PROBES} probes, kt {DEEP_KT}" + (
                         f", k {K_SEARCH}" if i == 0 else "")
                     + f", capacity {index.capacity:,}", launched[mode])
            for i, (row, mode) in enumerate(zip(
                rows, ("fused", "codes", "recon8")))]


# CAGRA (conf/sift-like-1m.json raft_cagra.deg32)
CAGRA_DEGREE, CAGRA_INTERMEDIATE = 32, 64
CAGRA_POINTS = ((24, 1), (32, 1), (64, 2), (128, 2))
CAGRA_BUCKETS, CAGRA_BUCKET_POINTS, BUCKET_REPS = (1, 8, 64), ((32, 1),
                                                                (64, 2)), 20
# the exact-merge hop call whose inputs are kept for Kernel I's hop check
# (a middle chunk)
CAPTURE_CALL = 4
# the hop of the plain walk whose inputs hold Kernel I's hop kernel at the
# search shape (a middle hop: some of the buffer visited, some not)
CHECK_HOP = 4
# the walk's shapes held to the plain walk, (nq, itopk, search_width, deg)
# at most: the search batch, a serving bucket, a build self-walk chunk
WALK_CHECKS = (((N_QUERIES, 64, 2, CAGRA_DEGREE), "search"),
               ((64, 32, 1, CAGRA_DEGREE), "serving bucket"),
               ((8192, 96, 1, CAGRA_INTERMEDIATE), "build self-walk"))


class _Swap:
    """Stands in for one of ``neighbors.cagra``'s handles on an ops module
    (``attr``) inside a ``with`` block; other names pass through."""

    attr = ""

    def __init__(self, real):
        from raft_tpu_torch.neighbors import cagra

        self.cagra, self.real = cagra, real
        self.calls, self.kept = {}, {}

    def __getattr__(self, name):
        return getattr(self.real, name)

    def __enter__(self):
        setattr(self.cagra, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.cagra, self.attr, self.real)


class HopCapture(_Swap):
    """``neighbors.cagra``'s hop handle while a CAGRA run goes on (only the
    build's exact merge calls it): every hop goes to the real wrapper
    (which counts its launches as always), and the inputs of the
    ``CAPTURE_CALL``-th hop of each (nq, itopk, wd, pdim) shape are kept
    for the kernel check."""

    attr = "_hop"

    def __init__(self):
        from raft_tpu_torch.ops import cagra_hop as chop

        super().__init__(chop)

    def cagra_hop(self, *args, ip_metric):
        nq, wd, pdim = args[2].shape
        key = (nq, args[5].shape[1], wd, pdim)
        self.calls[key] = self.calls.get(key, 0) + 1
        if self.calls[key] == CAPTURE_CALL:
            self.kept[key] = (args, ip_metric)
        return self.real.cagra_hop(*args, ip_metric=ip_metric)


class WalkCapture(_Swap):
    """``neighbors.cagra``'s walk handle while a CAGRA run goes on: every
    walk goes to the real wrapper (one launch each, counted as always), and
    the first walk's inputs of each (nq, itopk, search_width, deg) shape
    are kept for the walk check."""

    attr = "_walk"

    def __init__(self):
        from raft_tpu_torch.ops import cagra_walk as cw

        super().__init__(cw)

    def cagra_walk(self, *args, **kw):
        key = (args[3].shape[0], args[3].shape[1], kw["search_width"],
               kw["deg"])
        self.calls[key] = self.calls.get(key, 0) + 1
        self.kept.setdefault(key, (args, dict(kw)))
        return self.real.cagra_walk(*args, **kw)

    def cagra_walk_exact(self, *args, **kw):
        """The direct walk's exact-row source, kept under ("exact", nq,
        itopk, search_width, deg)."""
        key = ("exact", args[5].shape[0], args[5].shape[1],
               kw["search_width"], args[2].shape[1])
        self.calls[key] = self.calls.get(key, 0) + 1
        self.kept.setdefault(key, (args, dict(kw)))
        return self.real.cagra_walk_exact(*args, **kw)


def hop_loop(qp_t, q_sq, table, buf_d, buf_i, visited, *, deg,
             search_width, max_iterations, ip_metric, quant=False,
             scales=None, exit_every=8, return_hops=False,
             filter_words=None):
    """The yardstick: the per-hop loop the walk kernel replaced, kept here
    only — per hop ``select_parents`` → ``expand`` → Kernel I's hop kernel
    (``cagra_hop``), the all(visited) exit checked every ``exit_every``
    hops (a host sync).  It returns what the walk returns."""
    from raft_tpu_torch.ops import cagra_hop as chop
    from raft_tpu_torch.ops import cagra_walk as cw

    assert not return_hops
    pdim = qp_t.shape[1]
    for it in range(max_iterations):
        if exit_every and it % exit_every == 0 and it and bool(visited.all()):
            break
        sel, ok, visited = cw.select_parents(buf_d, buf_i, visited,
                                             search_width)
        nb_p, nb_sq, nb_id = cw.expand(table, sel, ok, deg, pdim, quant,
                                       scales, filter_words)
        buf_d, buf_i, visited = chop.cagra_hop(
            qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i, visited,
            ip_metric=ip_metric)
    return buf_d, buf_i, visited


class LoopWalk(_Swap):
    """``neighbors.cagra``'s walk handle routed to :func:`hop_loop`, so
    ``cagra.search`` runs as it did before the walk kernel (the yardstick
    of the search points and the serving buckets)."""

    attr = "_walk"

    def __init__(self):
        from raft_tpu_torch.ops import cagra_walk as cw

        super().__init__(cw)

    def cagra_walk(self, *args, **kw):
        return hop_loop(*args, **kw)


def walk_bound(args, kw, hops):
    """(ms, by, bytes) of a walk: the query side and the buffer read once,
    the buffer written once, each run hop's fat rows read once (``hops``:
    the hops the queries ran); 2·pdim fp32 operations per candidate."""
    from raft_tpu_torch.ops import cagra_walk as cw

    qp_t, buf_d = args[0], args[3]
    nq, itopk = buf_d.shape
    pdim = qp_t.shape[1]
    rows = kw["search_width"] * kw["deg"]
    nbytes = (nq * (pdim * 2 + 4) + 2 * nq * itopk * 9
              + hops * rows * cw.walk_unit(pdim, kw["quant"]) * 2)
    ms, by = bound(nbytes, 2.0 * hops * rows * pdim, FP32_FLOP_PER_S)
    return ms, by, nbytes


def check_kernel_walk(args, kw, shape):
    """The walk kernel vs the plain walk on one captured walk: keys, ids,
    visited flags and each query's hop count equal (``torch.equal``); its
    CUDA-event ms and device ms (profiler), the plain walk's ms, the bound
    (walk_bound over the hops the queries ran) and the yardstick, the
    per-hop loop of Kernel I's hop kernel (:func:`hop_loop`) on the same
    inputs.  No single PyTorch call walks a graph."""
    import torch
    from raft_tpu_torch.ops import cagra_walk as cw

    kd, ki, kv, kh = cw.cagra_walk(*args, return_hops=True, **kw)
    (pd, pi, pv, ph), plain_ms = timed_once(
        lambda: cw.cagra_walk_plain(*args, return_hops=True, **kw))
    for what, a, b in (("keys", kd, pd), ("ids", ki, pi),
                       ("visited flags", kv, pv), ("hop counts", kh, ph)):
        assert torch.equal(a, b), f"cagra_walk at {shape}: {what} differ"
    fin = torch.isfinite(pd)
    err = float((kd[fin] - pd[fin]).abs().max()) if bool(fin.any()) else 0.0

    def walk():
        return cw.cagra_walk(*args, **kw)

    ms = cuda_ms(walk, KERNEL_REPS * 4)
    dev_ms = device_ms(walk, KERNEL_REPS * 4, "walk_kernel")
    loop_ms = cuda_ms(lambda: hop_loop(*args, **kw), KERNEL_REPS)
    hops = int(kh.sum())
    bound_ms, bound_by, nbytes = walk_bound(args, kw, hops)
    nq, itopk = args[3].shape
    threads, blocks = cw.walk_resident(itopk, kw["search_width"], kw["deg"],
                                       args[0].shape[1], kw["quant"], False,
                                       kw.get("filter_words") is not None)
    lat_ms, waves = walk_latency_bound(nq, int(kh.max()), 1, blocks)
    print(f"cagra_walk at {shape}: keys, ids, visited flags and hop counts "
          f"equal to the plain walk; {hops:,} hops run "
          f"({hops / kh.numel():.2f} a query, at most {int(kh.max())} of "
          f"{kw['max_iterations']}); "
          f"{ms:.4f} ms (CUDA events; device {dev_ms:.4f}), plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{nbytes / 1e6:.2f} MB), latency bound {lat_ms:.4f} ms (most "
          f"hops x {LOAD_NS:.1f} ns x {waves} waves; {threads} threads a "
          f"block, {blocks} resident a SM); yardstick (per-hop loop on "
          f"Kernel I's hop kernel) {loop_ms:.3f} ms = {loop_ms / ms:.1f}x "
          f"the walk", flush=True)
    return {"name": "cagra_walk", "route": "cuda",
            "source": "raft_tpu_torch/csrc/cagra_walk.cu",
            "replaces": "raft_tpu/ops/cagra_hop_pallas.py:257",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": dev_ms, "yardstick_loop_ms": loop_ms,
            "walk_hops": hops, "latency_bound_ms": lat_ms,
            "threads": threads, "resident_blocks": blocks}


def check_kernel_i(args, ip_metric, shape):
    """Kernel I's hop kernel vs plain on one hop: the same finite slots,
    keys within 1e-5 relative, ids equal except at key ties, visited flags
    equal where ids are; its device time (profiler; the CUDA-event time of
    back-to-back calls printed beside it), the plain version's, the bound
    (every input read once, the buffer written once; 2·pdim fp32 operations
    per candidate) and ``torch.topk`` over the [buffer | candidate] keys as
    a yardstick (it does no dedupe: no single PyTorch call computes the
    hop)."""
    import torch
    from raft_tpu_torch.ops import cagra_hop as chop

    kd, ki, kv = chop.cagra_hop(*args, ip_metric=ip_metric)
    (pd, pi, pv), plain_ms = timed_once(
        lambda: chop.cagra_hop_plain(*args, ip_metric=ip_metric))
    fin = torch.isfinite(pd)
    assert torch.equal(fin, torch.isfinite(kd)), f"cagra_hop at {shape}: " \
        "finite slots differ"
    err = float((kd[fin] - pd[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert torch.allclose(kd[fin], pd[fin], rtol=1e-5, atol=1e-5), (
        f"cagra_hop at {shape}: keys differ by {err}")
    assert bool((ki[~fin] == -1).all()), f"cagra_hop at {shape}: dead ids"
    assert ties_only(kd, ki, pi, 1e-5), (
        f"cagra_hop at {shape}: ids differ off key ties")
    same = ki == pi
    assert torch.equal(kv[same], pv[same]), (
        f"cagra_hop at {shape}: visited flags differ")
    def hop():
        return chop.cagra_hop(*args, ip_metric=ip_metric)

    ms = device_ms(hop, KERNEL_REPS * 4, "hop_kernel")
    event_ms = cuda_ms(hop, KERNEL_REPS * 4)
    qp_t, q_sq, nb_p, nb_sq, nb_id, buf_d, buf_i, vis = args
    nq, wd, pdim = nb_p.shape
    itopk = buf_d.shape[1]
    nbytes = (nq * (pdim * 2 + 4) + nq * wd * (pdim * 2 + 8)
              + 2 * nq * itopk * 9)
    flops = 2.0 * nq * wd * pdim
    bound_ms, bound_by = bound(nbytes, flops, FP32_FLOP_PER_S)
    key, _ = chop.hop_keys(qp_t, q_sq, nb_p, nb_sq, nb_id, ip_metric)
    cat = torch.cat([buf_d, key], 1)
    topk_ms = device_ms(lambda: torch.topk(cat, itopk, dim=1, largest=False),
                        KERNEL_REPS * 4)
    threads, blocks = chop.hop_resident(itopk, wd, pdim)
    print(f"cagra_hop at {shape}: max |key err| {err}, ids equal at "
          f"{float(same.float().mean()):.6f}; {ms:.4f} ms on the device "
          f"(CUDA events over back-to-back calls {event_ms:.4f}), plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{nbytes / 1e6:.1f} MB); torch.topk yardstick {topk_ms:.4f} ms; "
          f"{threads} threads a block, {blocks} resident a SM", flush=True)
    return {"name": "cagra_hop", "route": "cuda",
            "source": "raft_tpu_torch/csrc/cagra_hop.cu",
            "replaces": "raft_tpu/ops/cagra_hop_pallas.py:257",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "event_ms": event_ms, "yardstick_topk_ms": topk_ms,
            "threads": threads, "resident_blocks": blocks}


def plain_hop_inputs(args, kw, hop):
    """The inputs of the plain walk's ``hop``-th hop on a captured walk:
    ``hop`` - 1 hops of the plain walk, then that hop's parents and their
    decoded rows (so the hop check's buffer keeps the walk's history)."""
    from raft_tpu_torch.ops import cagra_walk as cw

    kw = dict(kw, max_iterations=hop - 1, exit_every=0)
    buf_d, buf_i, vis = cw.cagra_walk_plain(*args, **kw)
    sel, ok, vis = cw.select_parents(buf_d, buf_i, vis, kw["search_width"])
    nb_p, nb_sq, nb_id = cw.expand(args[2], sel, ok, kw["deg"],
                                   args[0].shape[1], kw["quant"],
                                   kw["scales"])
    return (args[0], args[1], nb_p, nb_sq, nb_id, buf_d, buf_i, vis)


def walk_format(index):
    (pdim, quant), = list(index._walk_tables)
    return f"pdim {pdim}, {'int8' if quant else 'bf16'} table"


def timed_searches(fn, reps):
    """``reps`` calls of ``fn``, each ending in a synchronise: their wall
    ms and the last result."""
    import torch

    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms, out


def median(ms):
    return sorted(ms)[len(ms) // 2]


def walk_against_loop(label, fn, reps):
    """``fn`` (a search) with the walk kernel and with the yardstick loop
    (:class:`LoopWalk`), in turns, ``reps`` times each: both routes give
    the same ids and distances bit for bit; returns the medians."""
    import torch

    ms = {"walk": [], "loop": []}
    outs = {}
    for _ in range(reps):
        for route in ("walk", "loop"):
            if route == "loop":
                with LoopWalk():
                    t, outs[route] = timed_searches(fn, 1)
            else:
                t, outs[route] = timed_searches(fn, 1)
            ms[route] += t
    for a, b in zip(outs["walk"], outs["loop"]):
        assert torch.equal(a, b), f"{label}: walk kernel and loop differ"
    med = {route: median(v) for route, v in ms.items()}
    print(f"{label}: walk kernel {', '.join(f'{m:.2f}' for m in ms['walk'])}"
          f" ms, yardstick loop {', '.join(f'{m:.2f}' for m in ms['loop'])}"
          f" ms; medians {med['walk']:.3f} / {med['loop']:.3f} ms = "
          f"{med['loop'] / med['walk']:.2f}x; results equal", flush=True)
    return med


def cagra_path(db, queries, truth):
    """``raft_cagra.deg32`` on the flagship's rows: ``cagra.build``
    (seconds, stages, build pdim, walk / hop / H / A launches), the conf's
    four search points at batch 5000, k 10 (first batch, warm ms, QPS,
    recall@10, walk format, walk launches: one per search), serving
    buckets of 1 / 8 / 64 queries; then each point and bucket against the
    yardstick loop in turns, the build's self-walk against the loop's
    prediction, one batch under the profiler through each route, the walk
    kernel vs the plain walk on walks captured from the run, and Kernel
    I's hop kernel vs plain at the exact merge and at the search's fourth
    hop.  Returns the walk's and the hop kernel's kernels rows, and the
    index (for the persistence checks)."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import cagra

    res = DeviceResources(seed=0)
    params = cagra.IndexParams(graph_degree=CAGRA_DEGREE,
                               intermediate_graph_degree=CAGRA_INTERMEDIATE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with HopCapture() as cap, WalkCapture() as wcap:
        t0 = time.perf_counter()
        index = cagra.build(res, params, db)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_launches = read_launches()
        stages = dict(cagra.build.stage_seconds)
        print(f"CAGRA build (graph_degree {CAGRA_DEGREE}, intermediate "
              f"{CAGRA_INTERMEDIATE}): {build_s:.2f} s; stages (s): "
              f"{json.dumps(stages)}; build pdim "
              f"{cagra.build.build_pdim}; launches: walk "
              f"{build_launches['cagra_walk']}, hop "
              f"{build_launches['cagra_hop']}, H "
              f"{build_launches['fused_l2_nn']}, A "
              f"{build_launches['kmeans_assign_update']}; walk shapes (nq, "
              f"itopk, width, deg) x calls: "
              f"{ {str(k): v for k, v in wcap.calls.items()} }; hop shapes "
              f"(nq, itopk, wd, pdim) x calls: "
              f"{ {str(k): v for k, v in cap.calls.items()} }; peak device "
              f"memory {peak_gb():.2f} GB", flush=True)
        for name in ("cagra_walk", "cagra_hop", "fused_l2_nn"):
            assert build_launches[name] > 0, f"CAGRA build: {name} never " \
                "launched"
        g = index.graph
        assert g.shape == (N_DB, CAGRA_DEGREE) and int(g.min()) >= 0 and \
            int(g.max()) < N_DB, "CAGRA build: bad graph"

        results = {}
        for itopk, width in CAGRA_POINTS:
            sp = cagra.SearchParams(itopk_size=itopk, search_width=width)
            before = read_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cagra.search(res, sp, index, queries, K)
            torch.cuda.synchronize()
            first_ms = 1e3 * (time.perf_counter() - t0)
            ms, (_, found) = timed_searches(
                lambda: cagra.search(res, sp, index, queries, K),
                SEARCH_REPS)
            after = read_launches()
            walks = after["cagra_walk"] - before["cagra_walk"]
            assert walks == 1 + SEARCH_REPS and \
                after["cagra_hop"] == before["cagra_hop"], (
                    f"CAGRA itopk {itopk}: {walks} walk launches, "
                    f"{after['cagra_hop'] - before['cagra_hop']} hop "
                    f"launches in {1 + SEARCH_REPS} searches")
            hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
            recall = float(hits) / truth.numel()
            results[(itopk, width)] = recall
            print(f"CAGRA itopk {itopk} width {width}: first batch "
                  f"{first_ms:.2f} ms (walk cache included on the first "
                  f"point); {', '.join(f'{m:.2f}' for m in ms)} ms per batch "
                  f"of {N_QUERIES}; QPS {N_QUERIES / (median(ms) / 1e3):.0f} "
                  f"(median); recall@10 {recall:.4f}; {walk_format(index)}; "
                  f"walk launches {walks / (1 + SEARCH_REPS):.0f} a search, "
                  f"hop launches 0", flush=True)
        for point in ((64, 2), (128, 2)):
            assert results[point] >= 0.90, (
                f"CAGRA recall@10 {results[point]} below 0.90 at itopk "
                f"{point[0]}, width {point[1]}")

        bucket_before = read_launches()["cagra_walk"]
        for itopk, width in CAGRA_BUCKET_POINTS:
            sp = cagra.SearchParams(itopk_size=itopk, search_width=width)
            for nq in CAGRA_BUCKETS:
                q = queries[:nq]
                cagra.search(res, sp, index, q, K)
                ms, _ = timed_searches(
                    lambda: cagra.search(res, sp, index, q, K), BUCKET_REPS)
                print(f"CAGRA bucket of {nq} at itopk {itopk} width {width}: "
                      f"median {median(ms):.3f} ms per batch (min "
                      f"{min(ms):.3f}, max {max(ms):.3f})", flush=True)
        bucket_launches = read_launches()["cagra_walk"] - bucket_before
    launches = read_launches()
    print(f"CAGRA launches (build + searches + buckets): "
          f"{json.dumps(launches)}; peak device memory {peak_gb():.2f} GB",
          flush=True)

    # the yardstick: the per-hop loop on Kernel I's hop kernel, in turns
    for itopk, width in CAGRA_POINTS:
        sp = cagra.SearchParams(itopk_size=itopk, search_width=width)
        med = walk_against_loop(
            f"CAGRA itopk {itopk} width {width}, batch of {N_QUERIES}",
            lambda: cagra.search(res, sp, index, queries, K), SEARCH_REPS)
        print(f"CAGRA itopk {itopk} width {width}: QPS walk kernel "
              f"{N_QUERIES / (med['walk'] / 1e3):.0f}, yardstick loop "
              f"{N_QUERIES / (med['loop'] / 1e3):.0f}", flush=True)
    for itopk, width in CAGRA_BUCKET_POINTS:
        sp = cagra.SearchParams(itopk_size=itopk, search_width=width)
        for nq in CAGRA_BUCKETS:
            q = queries[:nq]
            walk_against_loop(f"CAGRA bucket of {nq} at itopk {itopk} width "
                              f"{width}",
                              lambda: cagra.search(res, sp, index, q, K),
                              BUCKET_REPS)

    # the build's self-walk: its chunks' walks against the loop's time
    sw = [k for k in wcap.calls if k[1:] == WALK_CHECKS[2][0][1:]]
    n_walks = sum(wcap.calls[k] for k in sw)
    sw_args, sw_kw = wcap.kept[max(sw)]
    walk_ms = cuda_ms(lambda: cagra._walk.cagra_walk(*sw_args, **sw_kw),
                      KERNEL_REPS)
    loop_ms = cuda_ms(lambda: hop_loop(*sw_args, **sw_kw), KERNEL_REPS)
    walk_stage_s = sum(v for k, v in stages.items()
                       if k.startswith("walk_refine"))
    print(f"CAGRA build self-walk: {n_walks} chunk walks (chunk "
          f"{max(sw)[0]:,}); a chunk {walk_ms:.3f} ms through the walk "
          f"kernel, {loop_ms:.3f} ms through the yardstick loop; predicted "
          f"self-walk seconds {n_walks * walk_ms / 1e3:.3f} (kernel) / "
          f"{n_walks * loop_ms / 1e3:.3f} (loop); the walk_refine stages "
          f"took {walk_stage_s:.3f} s", flush=True)

    sp = cagra.SearchParams(itopk_size=64, search_width=2)
    device_breakdown("CAGRA search batch (itopk 64, width 2)",
                     lambda: cagra.search(res, sp, index, queries, K))
    with LoopWalk():
        device_breakdown("CAGRA search batch (itopk 64, width 2) through "
                         "the yardstick loop",
                         lambda: cagra.search(res, sp, index, queries, K))
    policy_cost(f"CAGRA search, itopk 64 width 2 (batch of {N_QUERIES})",
                lambda: cagra.search(res, sp, index, queries, K))

    rows = []
    for (nq, itopk, width, deg), what in WALK_CHECKS:
        keys = [k for k in wcap.kept if k[1:] == (itopk, width, deg)
                and k[0] <= nq]
        key = max(keys)
        args, kw = wcap.kept[key]
        rows.append(check_kernel_walk(
            args, kw, f"{what}: {key} (nq, itopk, width, deg)"))
    row_walk = dict(rows[0], launches=launches["cagra_walk"])
    row_walk["also_checked"] = [
        at_shape(rows[1], "serving bucket: 64 queries, itopk 32, width 1",
                 bucket_launches),
        at_shape(rows[2], "build self-walk chunk: 8,192 nodes, itopk 96, "
                 "width 1, deg 64", build_launches["cagra_walk"])]

    merge = [k for k in cap.kept if k[1] == CAGRA_INTERMEDIATE + 1]
    key = max(merge)
    args, ipm = cap.kept[key]
    row_i = check_kernel_i(args, ipm, f"build exact merge: {key} (nq, "
                           f"itopk, wd, pdim)")
    row_i["launches"] = launches["cagra_hop"]
    s_args, s_kw = wcap.kept[WALK_CHECKS[0][0]]
    shape = (f"search hop {CHECK_HOP} of the plain walk: {N_QUERIES:,} "
             f"queries, itopk 64, wd {2 * CAGRA_DEGREE}")
    row_i["also_checked"] = [at_shape(check_kernel_i(
        plain_hop_inputs(s_args, s_kw, CHECK_HOP), s_kw["ip_metric"], shape),
        shape, 0)]
    del cap, wcap
    torch.cuda.empty_cache()
    return row_walk, row_i, index, results


# ---------------------------------------------------------------------------
# the rest of CAGRA: the direct walk, hops past 256, the deep-scale build
# ---------------------------------------------------------------------------

# the direct walk on the deg32 index (walk_pdim=0) and its kernel check's
# queries (the plain direct walk on the first EXACT_CHECK_QUERIES)
DIRECT_POINT, EXACT_CHECK_QUERIES = (64, 2), 256
# hops past 256 on the deg32 index: itopk 512 width 1, and itopk 256 width
# 16 (wd 512); the walk and hop kernels held to plain on the first
# WIDE_CHECK_QUERIES queries of walks captured at those shapes
WIDE_POINTS, WIDE_CHECK_QUERIES = ((512, 1), (256, 16)), 1_000
# conf/deep-cagra-10m.json raft_cagra.deg32 on the deep phase's rows
DEEP_CAGRA = dict(graph_degree=32, intermediate_graph_degree=64,
                  build_n_probes=12)
DEEP_CAGRA_POINTS = ((32, 1), (48, 1), (64, 1), (96, 2))
GRAPH_RECALL_NODES = 1_000


def head(args, m, shared):
    """The first ``m`` queries of a captured walk's per-query operands
    (the positions in ``shared`` — table, graph, rows — whole)."""
    return tuple(a if i in shared else a[:m] for i, a in enumerate(args))


def exact_walk_bound(args, kw, hops):
    """(ms, by, bytes) of a direct walk: the queries and the buffer read
    once, the buffer written once, and for each run hop its parents' graph
    rows and each candidate's fp32 row and norm read once; 2·dim fp32
    operations per candidate."""
    graph, rows, buf_d = args[2], args[3], args[5]
    nq, itopk = buf_d.shape
    dim, deg = rows.shape[1], graph.shape[1]
    wd = kw["search_width"] * deg
    nbytes = (nq * (dim * 4 + 4) + 2 * nq * itopk * 9
              + hops * wd * (4 + dim * 4 + 4))
    ms, by = bound(nbytes, 2.0 * hops * wd * dim, FP32_FLOP_PER_S)
    return ms, by, nbytes


def check_kernel_walk_exact(args, kw, shape, m=EXACT_CHECK_QUERIES):
    """The walk kernel's exact-row source vs the plain direct walk on the
    first ``m`` queries of a captured walk: keys, ids, visited flags and
    hop counts equal (``torch.equal``); the kernel's ms (CUDA events and
    device) on the whole captured walk, the plain walk's ms on the ``m``
    queries, the bound over the hops the whole walk ran.  No single
    PyTorch call walks a graph."""
    import torch
    from raft_tpu_torch.ops import cagra_walk as cw

    few = head(args, m, (2, 3, 4))
    kd, ki, kv, kh = cw.cagra_walk_exact(*few, return_hops=True, **kw)
    (pd, pi, pv, ph), plain_ms = timed_once(
        lambda: cw.cagra_walk_exact_plain(*few, return_hops=True, **kw))
    for what, a, b in (("keys", kd, pd), ("ids", ki, pi),
                       ("visited flags", kv, pv), ("hop counts", kh, ph)):
        assert torch.equal(a, b), f"cagra_walk_exact at {shape}: {what} differ"
    fin = torch.isfinite(pd)
    err = float((kd[fin] - pd[fin]).abs().max()) if bool(fin.any()) else 0.0

    def walk():
        return cw.cagra_walk_exact(*args, **kw)

    ms = cuda_ms(walk, KERNEL_REPS)
    dev_ms = device_ms(walk, KERNEL_REPS, "walk_kernel")
    all_hops = cw.cagra_walk_exact(*args, return_hops=True, **kw)[3]
    hops = int(all_hops.sum())
    bound_ms, bound_by, nbytes = exact_walk_bound(args, kw, hops)
    nq, itopk = args[5].shape
    threads, blocks = cw.walk_resident(itopk, kw["search_width"],
                                       args[2].shape[1], args[3].shape[1],
                                       exact=True, filtered=kw.get(
                                           "filter_words") is not None)
    lat_ms, waves = walk_latency_bound(nq, int(all_hops.max()), 2, blocks)
    print(f"cagra_walk_exact at {shape}: keys, ids, visited flags and hop "
          f"counts equal to the plain direct walk on {few[5].shape[0]} "
          f"queries (plain "
          f"{plain_ms:.2f} ms); {nq:,} queries: {hops:,} hops run "
          f"({hops / nq:.2f} a query, at most {int(all_hops.max())}), "
          f"{ms:.4f} ms (CUDA events; device "
          f"{dev_ms:.4f}), bound {bound_ms:.4f} ms ({bound_by}; "
          f"{nbytes / 1e6:.2f} MB), latency bound {lat_ms:.4f} ms (most "
          f"hops x 2 loads x {LOAD_NS:.1f} ns x {waves} waves; {threads} "
          f"threads a block, {blocks} resident a SM)", flush=True)
    return {"name": "cagra_walk_exact", "route": "cuda",
            "source": "raft_tpu_torch/csrc/cagra_walk.cu",
            "replaces": "raft_tpu/neighbors/cagra.py:1857",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": dev_ms, "walk_hops": hops,
            "check_queries": few[5].shape[0], "latency_bound_ms": lat_ms,
            "threads": threads, "resident_blocks": blocks}


def search_point(res, index, sp, queries, truth, label):
    """One search point: the first batch, SEARCH_REPS warm batches (ms,
    QPS at the median), recall@10, the route (table format or direct
    walk) and the walk launches of each kind a search."""
    import torch
    from raft_tpu_torch.neighbors import cagra

    before = read_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cagra.search(res, sp, index, queries, K)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    ms, (_, found) = timed_searches(
        lambda: cagra.search(res, sp, index, queries, K), SEARCH_REPS)
    after = read_launches()
    per = {name: (after[name] - before[name]) / (1 + SEARCH_REPS)
           for name in ("cagra_walk", "cagra_walk_exact", "cagra_hop")}
    hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
    recall = float(hits) / truth.numel()
    route = ("direct walk (exact rows)" if per["cagra_walk_exact"]
             else walk_format(index))
    n = queries.shape[0]
    qps = n / (median(ms) / 1e3)
    print(f"{label}: first batch {first_ms:.2f} ms; "
          f"{', '.join(f'{m:.2f}' for m in ms)} ms per batch of {n}; QPS "
          f"{qps:.0f} (median); recall@10 {recall:.4f}; route {route}; "
          f"launches a search: walk {per['cagra_walk']:.0f}, exact walk "
          f"{per['cagra_walk_exact']:.0f}, hop {per['cagra_hop']:.0f}",
          flush=True)
    assert sum(per.values()) == 1, f"{label}: launches {per}"
    return {"first_ms": first_ms, "ms": ms, "qps": qps, "recall": recall,
            "route": route, "launches": per}


def cagra_rest_path(index, queries, truth, recall_128):
    """The direct walk and hops past 256 on the deg32 index: the direct
    walk (``walk_pdim=0``) at itopk 64 width 2, then itopk 512 width 1 and
    itopk 256 width 16 (wd 512) through the packed table, each with ms,
    QPS and recall@10; then the exact-row source against the plain direct
    walk, and the walk and hop kernels against plain on walks captured at
    the wide shapes.  Returns the walk rows and the hop rows (``at_shape``
    entries) for the kernels line."""
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import cagra

    res = DeviceResources(seed=0)
    runs = {}
    with WalkCapture() as wcap:
        itopk, width = DIRECT_POINT
        runs["direct"] = search_point(
            res, index, cagra.SearchParams(itopk_size=itopk,
                                           search_width=width, walk_pdim=0),
            queries, truth, f"CAGRA direct walk (walk_pdim=0) itopk {itopk} "
            f"width {width}")
        assert runs["direct"]["launches"]["cagra_walk_exact"] == 1
        assert runs["direct"]["recall"] >= 0.90, (
            f"direct walk recall@10 {runs['direct']['recall']} below 0.90")
        for itopk, width in WIDE_POINTS:
            runs[(itopk, width)] = search_point(
                res, index, cagra.SearchParams(itopk_size=itopk,
                                               search_width=width),
                queries, truth, f"CAGRA wide itopk {itopk} width {width} "
                f"(wd {width * CAGRA_DEGREE})")
            assert runs[(itopk, width)]["launches"]["cagra_walk"] == 1
    r512 = runs[(512, 1)]["recall"]
    print(f"CAGRA itopk 512 width 1 recall@10 {r512:.4f} against itopk 128 "
          f"width 2 {recall_128:.4f}", flush=True)
    assert r512 >= recall_128 - 0.01, (r512, recall_128)

    itopk, width = DIRECT_POINT
    key = ("exact", N_QUERIES, itopk, width, CAGRA_DEGREE)
    args, kw = wcap.kept[key]
    exact = check_kernel_walk_exact(
        args, kw, f"direct walk: {N_QUERIES:,} queries, itopk {itopk}, width "
        f"{width}, deg {CAGRA_DEGREE}, dim {DIM}")
    walks = [at_shape(exact, f"exact rows (the direct walk), {N_QUERIES:,} "
                      f"queries, itopk {itopk}, width {width}, deg "
                      f"{CAGRA_DEGREE}, dim {DIM}; plain on the first "
                      f"{EXACT_CHECK_QUERIES}",
                      wcap.calls[key])]
    hops = []
    for itopk, width in WIDE_POINTS:
        key = (N_QUERIES, itopk, width, CAGRA_DEGREE)
        args, kw = wcap.kept[key]
        few = head(args, WIDE_CHECK_QUERIES, (2,))
        shape = (f"itopk {itopk}, width {width} (wd {width * CAGRA_DEGREE}), "
                 f"deg {CAGRA_DEGREE}: the first {WIDE_CHECK_QUERIES:,} "
                 f"queries of the search's walk")
        walks.append(at_shape(check_kernel_walk(few, kw, shape), shape,
                              wcap.calls[key]))
        hop_shape = (f"hop {CHECK_HOP} of the plain walk at {shape}")
        hops.append(at_shape(check_kernel_i(
            plain_hop_inputs(few, kw, CHECK_HOP), kw["ip_metric"], hop_shape),
            hop_shape, 0))
    return walks, hops, runs


def graph_recall(res, db, knn, n_nodes):
    """recall@deg of the kNN graph ``knn`` (self-edges removed) on
    ``n_nodes`` strided nodes against ``brute_force.knn`` (self dropped)."""
    import torch
    from raft_tpu_torch.neighbors import brute_force

    n, deg = knn.shape
    nodes = torch.arange(0, n, n // n_nodes, device=db.device)[:n_nodes]
    _, gt = brute_force.knn(res, db, db[nodes], deg + 1)
    not_self = gt != nodes[:, None]
    gt = torch.stack([row[keep][:deg] for row, keep in zip(gt, not_self)])
    got = knn[nodes.long()]
    hits = (got[:, :, None] == gt[:, None, :]).any(2).sum()
    return float(hits) / gt.numel()


def deep_cagra_path(db, queries, truth):
    """conf/deep-cagra-10m.json ``raft_cagra.deg32`` on the deep phase's
    10M x 96 rows: the deep-regime build (seconds and stage seconds, walk /
    hop / A / H launches, the rounds' table plans, peak memory, the
    intermediate graph's recall@64 on GRAPH_RECALL_NODES nodes), the
    conf's four search points at batch 5000, k 10 (route, ms, QPS,
    recall@10), and the walk kernel against plain at the build's
    self-walk chunk and at the search's walk.  Returns ``at_shape``
    entries for the walk's row, and the runs."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import cagra

    res = DeviceResources(seed=0)
    params = cagra.IndexParams(**DEEP_CAGRA)
    kept = {}
    real_prune = cagra.prune

    def keep_prune(r, knn, degree):
        kept["knn"] = knn
        return real_prune(r, knn, degree)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    cagra.prune = keep_prune
    try:
        with WalkCapture() as wcap:
            t0 = time.perf_counter()
            index = cagra.build(res, params, db)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            build_launches = read_launches()
            stages = dict(cagra.build.stage_seconds)
            plans = list(cagra.build.deep_plans)
            build_peak = peak_gb()
            n_rows = db.shape[0]
            rec64 = graph_recall(res, db, kept["knn"], GRAPH_RECALL_NODES)
            print(f"deep-cagra-10m build ({json.dumps(DEEP_CAGRA)}): "
                  f"{build_s:.2f} s; stages (s): {json.dumps(stages)}; build "
                  f"pdim {cagra.build.build_pdim}; deep plans (deg_t, pdim, "
                  f"quant) a round: {plans}; launches: walk "
                  f"{build_launches['cagra_walk']}, hop "
                  f"{build_launches['cagra_hop']}, H "
                  f"{build_launches['fused_l2_nn']} (small-dim "
                  f"{build_launches['fused_l2_nn_small_dim']}), A "
                  f"{build_launches['kmeans_assign_update']}; walk shapes "
                  f"x calls: { {str(k): v for k, v in wcap.calls.items()} }; "
                  f"peak device "
                  f"memory {build_peak:.2f} GB; intermediate graph "
                  f"recall@{kept['knn'].shape[1]} on {GRAPH_RECALL_NODES:,} "
                  f"nodes {rec64:.4f}", flush=True)
            assert index.graph.shape == (n_rows, DEEP_CAGRA["graph_degree"])
            assert int(index.graph.min()) >= 0 and \
                int(index.graph.max()) < n_rows, "deep CAGRA: bad graph"
            assert "reverse_merge" in stages, "deep CAGRA: not the deep regime"
            assert build_launches["cagra_walk"] > 0 and plans and \
                all(p is not None for p in plans), (
                    f"deep CAGRA: walk rounds {plans}")
            del kept["knn"]
            runs = {}
            for itopk, width in DEEP_CAGRA_POINTS:
                runs[(itopk, width)] = search_point(
                    res, index, cagra.SearchParams(itopk_size=itopk,
                                                   search_width=width),
                    queries, truth, f"deep-cagra-10m itopk {itopk} width "
                    f"{width}")
    finally:
        cagra.prune = real_prune
    print(f"deep-cagra-10m peak device memory (build + searches): "
          f"{peak_gb():.2f} GB", flush=True)
    last = DEEP_CAGRA_POINTS[-1]
    assert runs[last]["recall"] >= 0.80, (
        f"deep-cagra-10m recall@10 {runs[last]['recall']} below 0.80 at "
        f"itopk {last[0]} width {last[1]}")

    rows = []
    sw = [k for k in wcap.kept if k[0] == min(8192, n_rows)]
    args, kw = wcap.kept[max(sw)]
    shape = (f"deep-cagra-10m build self-walk chunk: {max(sw)} (nq, itopk, "
             f"width, deg), {'int8' if kw['quant'] else 'bf16'} table, pdim "
             f"{args[0].shape[1]}")
    rows.append(at_shape(check_kernel_walk(args, kw, shape), shape,
                         build_launches["cagra_walk"]))
    itopk, width = DEEP_CAGRA_POINTS[-1]
    key = ("exact", N_QUERIES, itopk, width, DEEP_CAGRA["graph_degree"])
    search_launches = sum(r["launches"]["cagra_walk_exact"]
                          + r["launches"]["cagra_walk"]
                          for r in runs.values()) * (1 + SEARCH_REPS)
    if key in wcap.kept:
        args, kw = wcap.kept[key]
        shape = (f"deep-cagra-10m search, direct walk: {N_QUERIES:,} "
                 f"queries, itopk {itopk}, width {width}, deg "
                 f"{DEEP_CAGRA['graph_degree']}, dim {DEEP_DIM}")
        rows.append(at_shape(check_kernel_walk_exact(args, kw, shape), shape,
                             search_launches))
    else:
        key = (N_QUERIES, itopk, width, DEEP_CAGRA["graph_degree"])
        args, kw = wcap.kept[key]
        few = head(args, WIDE_CHECK_QUERIES, (2,))
        shape = (f"deep-cagra-10m search, {walk_format(index)}: the first "
                 f"{WIDE_CHECK_QUERIES:,} queries, itopk {itopk}, width "
                 f"{width}")
        rows.append(at_shape(check_kernel_walk(few, kw, shape), shape,
                             search_launches))
    del index, wcap
    torch.cuda.empty_cache()
    return rows, {"build_s": build_s, "stages": stages, "plans": plans,
                  "graph_recall@64": rec64, "peak_gb": build_peak,
                  "points": {f"{i} w{w}": (r["ms"], r["qps"], r["recall"],
                                           r["route"])
                             for (i, w), r in runs.items()}}


# ---------------------------------------------------------------------------
# persistence at full width
# ---------------------------------------------------------------------------

# the flagship's recall@10 over the recorded builds (PERF.md §7)
FLAGSHIP_RECALL = (0.9769, 0.9786)
CAGRA_PERSIST_POINT = (64, 2)
# the seed of the fresh handles whose first search draws a CAGRA entry set
CAGRA_ENTRY_SEED = 11


class CheckpointCalls:
    """Counts ``CheckpointManager.load`` / ``.save`` calls while active
    (the port has no observability registry to count them)."""

    def __enter__(self):
        from raft_tpu_torch.resilience import CheckpointManager

        self.calls = {"load": 0, "save": 0}
        self._orig = {n: getattr(CheckpointManager, n) for n in self.calls}
        for name, orig in self._orig.items():
            def spy(mgr, *a, _orig=orig, _name=name, **kw):
                self.calls[_name] += 1
                return _orig(mgr, *a, **kw)
            setattr(CheckpointManager, name, spy)
        return self

    def __exit__(self, *exc):
        from raft_tpu_torch.resilience import CheckpointManager

        for name, orig in self._orig.items():
            setattr(CheckpointManager, name, orig)


def timed_s(fn):
    """``(fn(), s)``: one call's wall seconds, its CUDA work included."""
    (ms,), out = timed_searches(fn, 1)
    return out, ms / 1e3


def save_and_load(module, res, index, path, label, **load_kw):
    """``module.save`` then ``module.load`` of ``index`` through ``path``:
    prints the file's bytes and both times; returns the loaded index and
    the numbers."""
    import os

    _, save_s = timed_s(lambda: module.save(res, path, index))
    loaded, load_s = timed_s(lambda: module.load(res, path, **load_kw))
    nbytes = os.path.getsize(path)
    print(f"{label}: file {nbytes:,} bytes; save {save_s:.3f} s "
          f"({nbytes / save_s / 1e9:.2f} GB/s); load {load_s:.3f} s "
          f"({nbytes / load_s / 1e9:.2f} GB/s)", flush=True)
    return loaded, {"bytes": nbytes, "save_s": save_s, "load_s": load_s}


def same_results(label, ref, ours, ref_again=None):
    """Ids equal and distances bit-equal; where two searches of the
    in-memory index already differ (``ref_again``), print that and hold
    the loaded index's result to the ids only."""
    import torch

    stable = ref_again is None or (torch.equal(ref[0], ref_again[0])
                                   and torch.equal(ref[1], ref_again[1]))
    ids = torch.equal(ours[1], ref[1])
    dist = torch.equal(ours[0], ref[0])
    repeat = ("" if ref_again is None else "two searches of the in-memory "
              f"index {'agree bit for bit' if stable else 'DIFFER'}; ")
    print(f"{label}: {repeat}loaded index against the in-memory one: ids "
          f"{'equal' if ids else 'DIFFER'}, distances "
          f"{'bit-equal' if dist else 'differ'}", flush=True)
    assert ids and (dist or not stable), f"{label}: loaded index differs"


def recall_at(found, truth):
    hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
    return float(hits) / truth.numel()


def persistence_path(res, index, flat, db, queries, truth, params, sp):
    """Phase 11 on the indexes the script built: the flagship IVF-PQ and
    IVF-Flat 4096 saved, loaded on the card and searched against the
    in-memory index (Kernel B's passes / Kernel F's list-major pass
    launched on the loaded index), a flipped byte and a truncated copy of
    the flagship file refused, and the checkpointed flagship build
    (interrupted at its first sync point, resumed from ``kmeans``, then
    from the complete checkpoint).  Returns the numbers."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.core.interruptible import InterruptedException
    from raft_tpu_torch.core.serialize import CorruptIndexError
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, refine
    from raft_tpu_torch.resilience import CheckpointManager, faults

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    try:
        # flagship: save -> load -> the phase-4 batch
        path = os.path.join(tmp, "flagship.ivf_pq")
        loaded, out["flagship"] = save_and_load(
            ivf_pq, res, index, path, "flagship IVF-PQ")
        _, recon_s = timed_s(lambda: ivf_pq._with_recon(dataclasses.replace(
            loaded, list_recon=None, list_recon_sq=None)))
        out["flagship"]["recon_s"] = recon_s
        print(f"flagship IVF-PQ: of the load, the recon cache's re-decode "
              f"takes {recon_s:.3f} s (timed apart)", flush=True)
        batch = lambda ix: refine(res, db, queries, ivf_pq.search(  # noqa
            res, sp, ix, queries, K_SEARCH)[1], K)
        ref, ref_again = batch(index), batch(index)
        zero_launches()
        ours = batch(loaded)
        launches = read_launches()
        same_results("flagship IVF-PQ search+refine", ref, ours, ref_again)
        print(f"flagship IVF-PQ loaded-index launches: list_scan "
              f"{launches['list_scan']}, merge_pairs "
              f"{launches['merge_pairs']}", flush=True)
        assert launches["list_scan"] > 0 and launches["merge_pairs"] > 0, \
            "Kernel B never launched on the loaded flagship index"
        del loaded

        # corruption: one flipped byte, then a truncated copy
        with open(path, "rb") as f:
            raw = f.read()
        flipped = bytearray(raw)
        flipped[len(raw) // 2] ^= 0x5A
        for label, data in (("one byte flipped", bytes(flipped)),
                            ("truncated to half", raw[:len(raw) // 2])):
            bad = os.path.join(tmp, "bad.ivf_pq")
            with open(bad, "wb") as f:
                f.write(data)
            try:
                ivf_pq.load(res, bad)
            except CorruptIndexError as e:
                print(f"corruption ({label}): load raised "
                      f"CorruptIndexError: {str(e)[:100]}", flush=True)
            else:
                raise AssertionError(f"corruption ({label}) loaded")
        del raw, flipped, data
        os.remove(path)

        # IVF-Flat nlist 4096: save -> load -> n_probes 64, k 10
        path = os.path.join(tmp, "flat4096.ivf_flat")
        loaded, out["ivf_flat"] = save_and_load(
            ivf_flat, res, flat, path, "IVF-Flat nlist 4096")
        fsp = ivf_flat.SearchParams(n_probes=FLAT_CHECK_PROBES)
        fsearch = lambda ix: ivf_flat.search(res, fsp, ix, queries, K)  # noqa
        ref, ref_again = fsearch(flat), fsearch(flat)
        zero_launches()
        ours = fsearch(loaded)
        launches = read_launches()
        same_results(f"IVF-Flat nlist 4096 n_probes {FLAT_CHECK_PROBES}",
                     ref, ours, ref_again)
        print(f"IVF-Flat loaded-index launches: flat_list_scan "
              f"{launches['flat_list_scan']}", flush=True)
        assert launches["flat_list_scan"] > 0, \
            "Kernel F never launched on the loaded IVF-Flat index"
        del loaded
        os.remove(path)

        # the checkpointed flagship build
        ck = os.path.join(tmp, "ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with faults.inject("interruptible.synchronize", times=1,
                           exc=InterruptedException):
            try:
                ivf_pq.build(DeviceResources(seed=0), params, db,
                             checkpoint=ck)
            except InterruptedException:
                torch.cuda.synchronize()
                cut_s = time.perf_counter() - t0
            else:
                raise AssertionError("the injected interruption never came")
        stages = CheckpointManager(ck).completed
        assert stages == ["kmeans"], f"manifest after the cut: {stages}"
        with CheckpointCalls() as calls:
            resumed, resume_s = timed_s(lambda: ivf_pq.build(
                DeviceResources(seed=0), params, db, checkpoint=ck,
                resume=True))
        assert calls.calls == {"load": 1, "save": 1}, calls.calls
        saved = CheckpointManager(ck).load("kmeans")["centers"]
        assert np.array_equal(resumed.centers.cpu().numpy(), saved), \
            "resumed centers differ from the kmeans stage file"
        recall = recall_at(batch(resumed)[1], truth)
        lo, hi = FLAGSHIP_RECALL
        gap = 0.0 if lo <= recall <= hi else min(abs(recall - lo),
                                                 abs(recall - hi))
        print(f"checkpointed flagship build: interrupted at its first "
              f"synchronize after {cut_s:.2f} s (manifest {stages}); "
              f"resumed from kmeans in "
              f"{resume_s:.2f} s (checkpoint loads {calls.calls['load']}, "
              f"saves {calls.calls['save']}; stages (s) "
              f"{json.dumps(ivf_pq.build.stage_seconds)}); centers "
              f"bit-equal to the stage file; recall@10 {recall:.4f} "
              + ("within" if gap == 0.0 else f"off by {gap:.4f} from")
              + f" the recorded {lo}-{hi}", flush=True)
        with CheckpointCalls() as calls:
            again, full_s = timed_s(lambda: ivf_pq.build(
                DeviceResources(seed=0), params, db, checkpoint=ck,
                resume=True))
        assert calls.calls == {"load": 2, "save": 0}, calls.calls
        equal = {leaf: torch.equal(getattr(again, leaf),
                                   getattr(resumed, leaf))
                 for leaf in ("centers", "codebooks", "list_codes",
                              "list_indices", "list_sizes", "list_recon",
                              "list_recon_sq")}
        print(f"resume from the complete checkpoint: {full_s:.2f} s (loads "
              f"{calls.calls['load']}); against the build that wrote it, "
              f"bit-equal: {json.dumps(equal)}", flush=True)
        assert all(equal.values()), f"complete resume differs: {equal}"
        out["checkpointed_build"] = {
            "interrupted_s": cut_s, "resume_s": resume_s,
            "full_resume_s": full_s,
            "recall": recall, "recall_gap": gap}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def cagra_persistence(db, queries, index):
    """The CAGRA part of the persistence phase on the ``deg32`` index:
    save -> load -> itopk 64 width 2 on fresh seeded handles (the loaded
    index and a fresh index object of the same dataset and graph: equal
    results, exactly one walk launch a search), then a checkpointed build
    and a resume from its complete checkpoint (the graph bit-equal)."""
    import os
    import shutil
    import tempfile

    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops import cagra_walk as cw

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    try:
        res = DeviceResources(seed=0)
        path = os.path.join(tmp, "deg32.cagra")
        loaded, out["cagra"] = save_and_load(cagra, res, index, path,
                                             "CAGRA deg32")
        os.remove(path)
        itopk, width = CAGRA_PERSIST_POINT
        sp = cagra.SearchParams(itopk_size=itopk, search_width=width)
        fresh = cagra.Index(dataset=index.dataset, graph=index.graph,
                            metric=index.metric)
        ref = cagra.search(DeviceResources(seed=CAGRA_ENTRY_SEED), sp,
                           fresh, queries, K)
        before = cw.cagra_walk.launches
        ours = cagra.search(DeviceResources(seed=CAGRA_ENTRY_SEED), sp,
                            loaded, queries, K)
        walks = cw.cagra_walk.launches - before
        same_results(f"CAGRA itopk {itopk} width {width}, fresh handles of "
                     f"seed {CAGRA_ENTRY_SEED}", ref, ours)
        print(f"CAGRA loaded-index search: {walks} cagra_walk launch(es)",
              flush=True)
        assert walks == 1, f"CAGRA: {walks} walk launches in one search"
        del loaded, fresh

        params = cagra.IndexParams(graph_degree=CAGRA_DEGREE,
                                   intermediate_graph_degree=CAGRA_INTERMEDIATE)
        ck = os.path.join(tmp, "ckpt")
        built, build_s = timed_s(lambda: cagra.build(
            DeviceResources(seed=0), params, db, checkpoint=ck))
        resumed, resume_s = timed_s(lambda: cagra.build(
            DeviceResources(seed=0), params, db, checkpoint=ck,
            resume=True))
        equal = torch.equal(built.graph, resumed.graph)
        print(f"CAGRA checkpointed build {build_s:.2f} s; resume from the "
              f"complete checkpoint {resume_s:.2f} s; graph "
              f"{'bit-equal' if equal else 'DIFFERS'}", flush=True)
        assert equal, "CAGRA resume: graph differs"
        out["cagra_resume"] = {"build_s": build_s, "resume_s": resume_s}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# filtered and mutable indexes at full width
# ---------------------------------------------------------------------------

# the 50% filter's seed, the tenants (contiguous id ranges; query q in
# tenant q mod N_TENANTS), the queries and the unfiltered k of the
# full-probe contract, the ids deleted and re-inserted, the deep filter's
# queries
FILTER_SEED, N_TENANTS = 15, 16
FULL_PROBE_QUERIES, FULL_PROBE_K = 64, 64
N_DELETE, N_UPSERT = 10_000, 5_000
DEEP_FILTER_QUERIES = 1_000
# filtered search at k 100, where every scan keeps more than 64 rows a
# pair and so runs a query-major kernel: the flagship searches k 200 and
# refines to 100 (``auto``: Kernel B at kt 200; ``recon`` at kt 128:
# Kernel G), IVF-Flat searches k 100 (Kernel F), the deep index k = kt =
# 128 refined to 100 on DEEP_FILTER_QUERIES queries (Kernels C, D, E)
WIDE_K, WIDE_K_SEARCH, WIDE_RECON_KT, WIDE_DEEP_KT = 100, 200, 128, 128
# the full-probe contract at k 100: the unfiltered search's k
WIDE_FULL_PROBE_K = 256
# the most a 50% per-query filter may take off recall@100
WIDE_RECALL_GAP = 0.05
# the most the deep codes / recon8 k-100 recall@100 through D and E's
# pair-group pass may differ from the query-major route's on one build
PAIR_RECALL_GAP = 0.002


def half_words(nq, n_rows, seed, device):
    """(nq, ceil(n_rows / 32)) int32 words of uniform random bits: a
    per-query filter admitting each id with probability 1/2."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (nq, -(-n_rows // 32)),
                         generator=g, dtype=torch.int64,
                         device=device).to(torch.int32)


def test_filters(nq, n_rows, device):
    """The phase's three filters by name: 50% per query, a tenant filter
    (N_TENANTS contiguous ranges, query q in tenant q mod N_TENANTS, its
    rows gathered per query) and the 50% filter's first row broadcast (an
    ``expand``, query stride 0)."""
    import torch
    from raft_tpu_torch.filters import SampleFilter, TenantFilter

    half = SampleFilter(words=half_words(nq, n_rows, FILTER_SEED, device),
                        n_rows=n_rows)
    per = n_rows // N_TENANTS
    tenants = TenantFilter({f"t{i}": (i * per, (i + 1) * per)
                            for i in range(N_TENANTS)}, n_rows)
    rows = torch.stack([torch.from_numpy(tenants.words_for(t))
                        for t in tenants.tenants]).to(device)
    pick = torch.arange(nq, device=device) % N_TENANTS
    return {"50% per query": half,
            f"tenant (1/{N_TENANTS}, ranges of {per:,})":
                SampleFilter(words=rows[pick], n_rows=n_rows),
            "50% one row broadcast":
                SampleFilter(words=half.words[:1].expand(nq, -1),
                             n_rows=n_rows)}


def filter_bytes(f):
    """The filter's words as the kernels read them: one row where it is
    broadcast."""
    w = f.words
    return (1 if w.stride(0) == 0 else w.shape[0]) * w.shape[1] * 4


def assert_admitted(label, ids, words):
    """Every id >= 0 of each query's row admitted by its filter row."""
    import torch
    from raft_tpu_torch.filters import query_bits

    flat = ids.reshape(ids.shape[0], -1)
    bits = query_bits(words, torch.arange(flat.shape[0],
                                          device=flat.device), flat)
    bad = int(((flat >= 0) & (bits == 0)).sum())
    assert bad == 0, f"{label}: {bad} returned ids the filter rejects"


def live_recall(found, truth):
    """recall@10 over the truth's ids >= 0."""
    hit = ((found[:, :, None] == truth[:, None, :])
           & (truth[:, None, :] >= 0)).any(2).sum()
    return float(hit) / max(int((truth >= 0).sum()), 1)


def admission_bytes(sizes, probes, broadcast):
    """The admission bits a scan must read, in bytes: one a (query,
    probed live row) — one a probed live row for a broadcast row."""
    import torch

    pr = probes.long()
    pr = pr[(pr >= 0) & (pr < sizes.shape[0])]
    rows = sizes.long()[torch.unique(pr) if broadcast else pr].sum()
    return int(rows) / 8


def posthoc_top(d_u, i_u, words, k):
    """The unfiltered result (sorted, a large k) with the rows each
    query's filter rejects dropped, its first ``k``; and the fewest
    admitted rows a query kept (must be >= k)."""
    import torch
    from raft_tpu_torch.filters import query_bits

    adm = (query_bits(words, torch.arange(i_u.shape[0],
                                          device=i_u.device), i_u) > 0) \
        & (i_u >= 0)
    order = torch.argsort((~adm).int(), dim=1, stable=True)[:, :k]
    return (torch.gather(d_u, 1, order), torch.gather(i_u, 1, order),
            int(adm.sum(1).min()))


def full_probe_contract(label, search, queries, words, n_rows, k=K,
                        wide=FULL_PROBE_K, route=None, others=()):
    """At full probe a filtered search at ``k`` equals the unfiltered
    result at ``wide`` filtered afterwards, bit for bit, on
    FULL_PROBE_QUERIES queries; with ``route``, both searches launch that
    wrapper and none of ``others``."""
    import torch
    from raft_tpu_torch.filters import SampleFilter

    before = read_launches()
    q = queries[:FULL_PROBE_QUERIES]
    w = words[:FULL_PROBE_QUERIES]
    d_u, i_u = search(q, wide, None)
    ref_d, ref_i, kept = posthoc_top(d_u, i_u, w, k)
    assert kept >= k, (f"{label}: a query kept {kept} admitted rows in its "
                       f"unfiltered top {wide}")
    d_f, i_f = search(q, k, SampleFilter(words=w, n_rows=n_rows))
    launches = {n: c - before[n] for n, c in read_launches().items()}
    assert route is None or (launches[route] >= 2 and not any(
        launches[o] for o in others)), (
            f"{label} full-probe contract: launches {json.dumps(launches)}")
    same = torch.equal(i_f, ref_i) and torch.equal(d_f, ref_d)
    print(f"{label} full-probe contract ({FULL_PROBE_QUERIES} queries, k "
          f"{k}, unfiltered k {wide}, at least {kept} admitted kept): "
          f"filtered == unfiltered filtered afterwards: {same}", flush=True)
    assert same, f"{label}: the full-probe contract fails"


def filtered_searches(label, search, queries, filters, truths, k=K):
    """``search(q, k, filter)`` (a batch ending in its ids) unfiltered,
    then with each filter, SEARCH_REPS batches each: ms, recall@k against
    the filtered ground truth (and the unfiltered recall@k where
    ``truths`` holds the unfiltered truth under None), the launches of each
    run; every returned id admitted.  Returns {filter: (median ms, recall,
    launches)}, the unfiltered run under None."""
    zero_launches()
    ms, ids = timed_searches(lambda: search(queries, k, None), SEARCH_REPS)
    launches = read_launches()
    r = live_recall(ids, truths[None]) if None in truths else None
    print(f"{label} unfiltered: {', '.join(f'{m:.2f}' for m in ms)} ms per "
          f"batch of {queries.shape[0]}" + (
              "" if r is None else f"; recall@{k} {r:.4f}"), flush=True)
    out = {None: (median(ms), r, launches)}
    for name, f in filters.items():
        zero_launches()
        ms, ids = timed_searches(lambda: search(queries, k, f), SEARCH_REPS)
        launches = read_launches()
        assert_admitted(f"{label} {name}", ids, f.words)
        r = live_recall(ids, truths[name])
        print(f"{label} filter {name} ({filter_bytes(f):,} bytes of words): "
              f"{', '.join(f'{m:.2f}' for m in ms)} ms per batch (median "
              f"{median(ms):.2f}, unfiltered {out[None][0]:.2f}); "
              f"recall@{k} {r:.4f} against the filtered brute_force.knn; "
              f"every id admitted; launches {json.dumps(launches)}",
              flush=True)
        out[name] = (median(ms), r, launches)
    return out


def filtered_ivf_pq(res, index, db, queries, filters, truths):
    """The flagship IVF-PQ with each filter (search + refine, n_probes 96,
    k 20 -> 10), the full-probe contract at n_probes 4096 (``auto``), and
    Kernels B and G with the 50% filter against their plain versions at
    the batch's shape.  Returns the two filtered kernel rows and the
    launches of the filtered searches."""
    import torch
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_group_scan as pgs

    sp = ivf_pq.SearchParams(n_probes=N_PROBES)

    def batch(q, k, f):
        _, cand = ivf_pq.search(res, sp, index, q, K_SEARCH, filter=f)
        if f is not None:
            assert_admitted("flagship candidates", cand, f.words)
        return refine(res, db, q, cand, k)[1]

    runs = filtered_searches("flagship IVF-PQ search+refine", batch, queries,
                             filters, truths)
    for name, (_, r, launches) in runs.items():
        if name is None:
            continue
        assert launches["list_scan"] > 0 and launches["merge_pairs"] > 0, (
            f"flagship {name}: Kernel B's passes not launched")
        assert launches["scan_query_major"] == 0
        if name.startswith("50%"):
            assert r >= 0.90, f"flagship {name}: recall@10 {r} below 0.90"
    full = ivf_pq.SearchParams(n_probes=index.n_lists)
    full_probe_contract(
        "flagship IVF-PQ auto",
        lambda q, k, f: ivf_pq.search(res, full, index, q, k, filter=f),
        queries, filters["50% per query"].words, N_DB)

    half = filters["50% per query"]
    qrot, probes = probe(index, queries)
    nq, rot = qrot.shape
    kt = min(K_SEARCH, index.capacity)
    adm = admission_bytes(index.list_sizes, probes, False)
    common = (qrot, index.centers, probes, index.list_recon,
              index.list_recon_sq, index.list_indices)
    rows = check_scans(index, qrot, probes, [
        ("ivf_pq_scan_fused (50% filter)", "pq_list_scan.cu",
         "raft_tpu/ops/pq_group_scan_pallas.py:410", pgs.ivf_pq_scan_fused,
         pgs.ivf_pq_scan_fused_plain, common + (K_SEARCH, kt, half.words),
         recon_rows_of(index), index.list_recon_sq, None, rot * 2 + 8, adm,
         nq * K_SEARCH * 8, rot),
        ("ivf_pq_scan_recon (50% filter)", "pq_list_scan.cu",
         "raft_tpu/ops/pq_group_scan_pallas.py:566", ps.ivf_pq_scan_recon,
         ps.ivf_pq_scan_recon_plain, common + (kt, half.words),
         recon_rows_of(index), index.list_recon_sq, None, rot * 2 + 8, adm,
         probes.numel() * kt * 8, rot)])
    for row, fn in zip(rows, (pgs.ivf_pq_scan_fused, ps.ivf_pq_scan_recon)):
        args = common + ((K_SEARCH, kt) if fn is pgs.ivf_pq_scan_fused
                         else (kt,))
        assert_admitted(row["name"], fn(*args, half.words)[1], half.words)
        _, split = device_split(lambda: fn(*args, half.words), KERNEL_REPS,
                                ("list_scan_kernel",))
        _, plain_split = device_split(lambda: fn(*args), KERNEL_REPS,
                                      ("list_scan_kernel",))
        row["pass1_device_ms"] = split["list_scan_kernel"]
        row["unfiltered_pass1_device_ms"] = plain_split["list_scan_kernel"]
        print(f"{row['name']}: pass 1 device {split['list_scan_kernel']:.3f} "
              f"ms, unfiltered {plain_split['list_scan_kernel']:.3f} ms in "
              f"turn; admission bits {adm / 1e6:.2f} MB in the bound",
              flush=True)
    # the tenant filter's pass 1 (1/16 admitted, 16 distinct rows)
    tenant = [f for n, f in filters.items() if n.startswith("tenant")][0]
    bcast = filters["50% one row broadcast"]
    for name, f in (("tenant", tenant), ("50% broadcast", bcast)):
        _, split = device_split(
            lambda: pgs.ivf_pq_scan_fused(*common, K_SEARCH, kt, f.words),
            KERNEL_REPS, ("list_scan_kernel",))
        print(f"ivf_pq_scan_fused ({name} filter): pass 1 device "
              f"{split['list_scan_kernel']:.3f} ms", flush=True)
        rows[0][f"{name.split()[-1]}_pass1_device_ms"] = \
            split["list_scan_kernel"]
    return rows, runs


def mutate_ivf_pq(res, index, db, queries, tmp):
    """Delete N_DELETE random ids of the flagship (none may surface;
    recall over the live rows), upsert N_UPSERT of them with their rows,
    compact (capacity, each rebuilt cache's seconds; the search after
    equals the search before up to ties), then save and load the mutated
    index (the loaded index searches bit-equal).  Returns the numbers."""
    import os

    import torch
    from raft_tpu_torch.filters import SampleFilter
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine

    sp = ivf_pq.SearchParams(n_probes=N_PROBES)
    g = torch.Generator()
    g.manual_seed(FILTER_SEED)
    dead = torch.randperm(N_DB, generator=g)[:N_DELETE].to(db.device)

    def batch(idx):
        d, cand = ivf_pq.search(res, sp, idx, queries, K_SEARCH)
        return d, cand, refine(res, db, queries, cand, K)[1]

    def truth_without(gone):
        keep = torch.ones(N_DB, dtype=torch.bool, device=db.device)
        keep[gone.long()] = False
        f = SampleFilter.from_mask(keep[None])
        return brute_force.knn(res, db, queries, K, filter=f)[1]

    deleted, del_s = timed_s(lambda: ivf_pq.delete(res, index, dead))
    _, cand, found = batch(deleted)
    assert not bool(torch.isin(cand, dead).any()), "a deleted id surfaced"
    r_del = live_recall(found, truth_without(dead))
    back = dead[:N_UPSERT]
    upserted, up_s = timed_s(lambda: ivf_pq.upsert(res, deleted, back,
                                                   db[back.long()]))
    d_u, cand_u, found_u = batch(upserted)
    assert not bool(torch.isin(cand_u, dead[N_UPSERT:]).any()), (
        "a deleted id surfaced after the upsert")
    r_up = live_recall(found_u, truth_without(dead[N_UPSERT:]))
    compacted, comp_s = timed_s(lambda: ivf_pq.compact(res, upserted))
    d_c, cand_c = ivf_pq.search(res, sp, compacted, queries, K_SEARCH)
    compare_with_plain("flagship search after compact (before: the reference)", d_c,
                       cand_c, d_u, cand_u)
    path = os.path.join(tmp, "flagship_mutated.ivfpq")
    loaded, numbers = save_and_load(ivf_pq, res, compacted, path,
                                    "flagship mutated")
    same_results("flagship mutated", (d_c, cand_c),
                 ivf_pq.search(res, sp, loaded, queries, K_SEARCH))
    print(f"flagship mutation: delete {N_DELETE:,} ids {del_s * 1e3:.2f} ms "
          f"(recall@10 over the live rows {r_del:.4f}, no deleted id "
          f"returned); upsert {N_UPSERT:,} {up_s:.3f} s (recall {r_up:.4f}, "
          f"capacity {upserted.capacity}); compact {comp_s:.3f} s, capacity "
          f"{index.capacity} -> {compacted.capacity}, caches rebuilt (s) "
          f"{json.dumps(ivf_pq.compact.cache_seconds)}; generation "
          f"{index.generation} -> {compacted.generation}", flush=True)
    return dict(numbers, delete_ms=del_s * 1e3, upsert_s=up_s,
                compact_s=comp_s, recall_live=r_del, recall_upserted=r_up,
                capacity=compacted.capacity,
                cache_s=dict(ivf_pq.compact.cache_seconds))


def filtered_ivf_flat(res, index, db, queries, filters, truths):
    """IVF-Flat nlist 4096 (n_probes 64, k 10) with each filter, the
    full-probe contract, Kernel F with the 50% filter against its plain
    version, then delete N_DELETE ids and compact (no deleted id; the
    search after equals the search before up to ties).  Returns F's
    filtered row and the filtered searches' launches."""
    import torch
    from raft_tpu_torch.neighbors import ivf_flat

    sp = ivf_flat.SearchParams(n_probes=FLAT_CHECK_PROBES)
    runs = filtered_searches(
        "IVF-Flat nlist 4096", lambda q, k, f: ivf_flat.search(
            res, sp, index, q, k, filter=f)[1], queries, filters, truths)
    for name, (_, _, launches) in runs.items():
        if name is not None:
            assert launches["flat_list_scan"] > 0 and \
                launches["flat_scan_query_major"] == 0, (
                    f"IVF-Flat {name}: not Kernel F's list-major pass")
    full = ivf_flat.SearchParams(n_probes=index.n_lists)
    full_probe_contract(
        "IVF-Flat nlist 4096",
        lambda q, k, f: ivf_flat.search(res, full, index, q, k, filter=f),
        queries, filters["50% per query"].words, N_DB)
    row = check_kernel_f(index, queries, FLAT_CHECK_PROBES, K,
                         "ivf_flat_scan (50% filter)",
                         filter_words=filters["50% per query"].words)
    g = torch.Generator()
    g.manual_seed(FILTER_SEED + 1)
    dead = torch.randperm(N_DB, generator=g)[:N_DELETE].to(db.device)
    deleted, del_s = timed_s(lambda: ivf_flat.delete(res, index, dead))
    d_b, i_b = ivf_flat.search(res, sp, deleted, queries, K)
    assert not bool(torch.isin(i_b, dead).any()), "a deleted id surfaced"
    compacted, comp_s = timed_s(lambda: ivf_flat.compact(res, deleted))
    d_a, i_a = ivf_flat.search(res, sp, compacted, queries, K)
    scale = float((queries * queries).sum(1).max()
                  + index.list_data_sq.max())
    compare_with_plain("IVF-Flat search after compact (before: the reference)",
                       d_a, i_a,
                       d_b, i_b, atol=1e-5 * scale)
    print(f"IVF-Flat nlist 4096 mutation: delete {N_DELETE:,} ids "
          f"{del_s * 1e3:.2f} ms, no deleted id returned; compact "
          f"{comp_s:.3f} s, capacity {index.capacity} -> "
          f"{compacted.capacity}", flush=True)
    return row, runs


def filtered_cagra(res, index, queries, filters, truths):
    """CAGRA deg32 at itopk 64 width 2 with the 50% filter (recall@10
    printed, no floor; one walk launch a search; every id admitted), the
    filtered walk captured and held to the plain walk, and the delete
    shim (N_DELETE ids: none surfaces).  Returns the walk's filtered
    row."""
    import torch
    from raft_tpu_torch.neighbors import cagra

    sp = cagra.SearchParams(itopk_size=64, search_width=2)
    half = {n: f for n, f in filters.items() if n == "50% per query"}
    runs = filtered_searches(
        "CAGRA itopk 64 width 2", lambda q, k, f: cagra.search(
            res, sp, index, q, k, filter=f)[1], queries, half, truths)
    _, r, launches = runs["50% per query"]
    assert launches["cagra_walk"] == SEARCH_REPS and \
        launches["cagra_hop"] == 0, "CAGRA filtered: not one walk a search"
    with WalkCapture() as wcap:
        cagra.search(res, sp, index, queries, K,
                     filter=half["50% per query"])
    key = (N_QUERIES, 64, 2, CAGRA_DEGREE)
    args, kw = wcap.kept[key]
    assert kw.get("filter_words") is not None, "the captured walk is "\
        "unfiltered"
    row = check_kernel_walk(args, kw, f"filtered (50%): {key} (nq, itopk, "
                            f"width, deg)")
    g = torch.Generator()
    g.manual_seed(FILTER_SEED + 2)
    dead = torch.randperm(N_DB, generator=g)[:N_DELETE].to(queries.device)
    deleted = cagra.delete(res, index, dead)
    _, ids = cagra.search(res, sp, deleted, queries, K)
    assert not bool(torch.isin(ids, dead).any()), "a deleted id surfaced"
    print(f"CAGRA delete shim: {N_DELETE:,} ids, none returned; "
          f"generation {index.generation} -> {deleted.generation}",
          flush=True)
    return row, launches


def ground_truths(res, db, queries, filters, k):
    """brute_force.knn at ``k``: unfiltered (under None) and with each
    filter."""
    from raft_tpu_torch.neighbors import brute_force

    truths = {}
    for name, f in [(None, None)] + list(filters.items()):
        (_, truths[name]), s = timed_s(
            lambda: brute_force.knn(res, db, queries, k, filter=f))
        print(f"ground truth at k {k} ({name or 'unfiltered'}): {s:.2f} s",
              flush=True)
    return truths


def wide_searches(label, search, queries, filters, truths, route, others):
    """``filtered_searches`` at WIDE_K: every run launches the query-major
    wrapper ``route`` and none of ``others`` (the list-major passes), and
    the 50% per-query filter's recall@100 is at least the unfiltered
    recall@100 less WIDE_RECALL_GAP (the tenant filter's is printed
    only).  Returns the runs."""
    runs = filtered_searches(label, search, queries, filters, truths, WIDE_K)
    for name, (_, r, launches) in runs.items():
        assert launches[route] > 0 and not any(
            launches[o] for o in others), (
            f"{label} {name}: launches {json.dumps(launches)}")
        if name == "50% per query":
            assert r >= runs[None][1] - WIDE_RECALL_GAP, (
                f"{label} {name}: recall@{WIDE_K} {r} against "
                f"{runs[None][1]} unfiltered")
    return runs


def wide_filtered_ivf_pq(res, index, db, queries, filters, truths):
    """The flagship at k 100 with each filter: ``auto`` (Kernel B past kt
    64: G's pair-group pass and the merge, kt 200) and ``recon`` at kt
    WIDE_RECON_KT (Kernel G's pair-group pass), search k 200 refined to
    100, the query-major kernels never launched; the unfiltered ``auto``
    batch's recall@100 through B's route and through its query-major
    kernel swapped in on the one build (within PAIR_RECALL_GAP), and
    their ms in turns; the full-probe contract at k 100 (``auto``); B and
    G filtered against their plain versions on the first
    LARGE_KT_QUERIES queries at the searches' shapes, and unfiltered on
    the whole batch.  Returns the two filtered ``also_checked`` entries
    (launches from the 50% runs), G's runs, and B's and G's whole-batch
    entries (launches from the unfiltered runs: B's the merge's, its
    pass's as ``pass1_launches``)."""
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.ops import pq_group_scan as pgs

    half = filters["50% per query"]
    out, whole = [], {}
    for mode, kt, route, others in (
            ("auto", 0, "recon_pair_list_scan",
             ("list_scan", "scan_query_major", "recon_scan_query_major")),
            ("recon", WIDE_RECON_KT, "recon_pair_list_scan",
             ("list_scan", "scan_query_major", "recon_scan_query_major"))):
        sp = ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode=mode,
                                 per_probe_topk=kt)

        def batch(q, k, f, sp=sp):
            _, cand = ivf_pq.search(res, sp, index, q, WIDE_K_SEARCH,
                                    filter=f)
            if f is not None:
                assert_admitted("flagship candidates", cand, f.words)
            return refine(res, db, q, cand, k)[1]

        runs = wide_searches(
            f"flagship IVF-PQ {mode} k {WIDE_K_SEARCH} -> {WIDE_K}"
            + (f", kt {kt}" if kt else ""), batch, queries, filters, truths,
            route, others)
        merges = [r[2]["merge_pairs"] for r in runs.values()]
        assert all(merges) == (mode == "auto") and (
            any(merges) == (mode == "auto")), (
            f"flagship {mode} k {WIDE_K_SEARCH}: pass 2 launched {merges}")
        fused = mode == "auto"
        if fused:
            same_build_routes(
                f"flagship IVF-PQ auto k {WIDE_K_SEARCH} -> {WIDE_K}",
                ivf_pq, "ivf_pq_scan_fused", pgs.scan_query_major,
                (pgs.merge_pairs, pgs.scan_query_major),
                lambda batch=batch: batch(queries, WIDE_K, None),
                truths[None], gap=PAIR_RECALL_GAP, first="pair-group",
                turns=True)
        else:
            recon_runs = runs
        # the route at the unfiltered batch's own shape (all its queries),
        # held to plain: the main entry of its row
        count = "merge_pairs" if fused else route
        whole[mode] = check_query_major(
            index, queries, queries.shape[0], fused, kt or WIDE_K_SEARCH,
            None, runs[None][2][count])
        if fused:
            whole[mode]["pass1_launches"] = runs[None][2][route]
        out.append(check_query_major(
            index, queries, LARGE_KT_QUERIES, fused, kt or WIDE_K_SEARCH,
            half.words[:LARGE_KT_QUERIES],
            runs["50% per query"][2][count]))
    full = ivf_pq.SearchParams(n_probes=index.n_lists)
    full_probe_contract(
        "flagship IVF-PQ auto",
        lambda q, k, f: ivf_pq.search(res, full, index, q, k, filter=f),
        queries, half.words, N_DB, WIDE_K, WIDE_FULL_PROBE_K)
    return out, recon_runs, whole["recon"], whole["auto"]


def wide_filtered_ivf_flat(res, index, queries, filters, truths):
    """IVF-Flat nlist 4096 at k 100 (n_probes 64: Kernel F's pair-group
    pass, its query-major kernel and list-major pass not launched) with
    each filter; the full-probe contract at k 100 (both of its searches on
    the pair-group pass); F against its plain version on the whole
    unfiltered batch and filtered on the first LARGE_KT_QUERIES queries,
    the query-major kernel held to the same plain result and timed in
    turns each time.  Returns the filtered ``also_checked`` entry
    (launches from the 50% run), the runs, and the whole-batch row (its
    launches the unfiltered run's)."""
    from raft_tpu_torch.neighbors import ivf_flat

    half = filters["50% per query"]
    sp = ivf_flat.SearchParams(n_probes=FLAT_CHECK_PROBES)
    runs = wide_searches(
        f"IVF-Flat nlist 4096 k {WIDE_K}", lambda q, k, f: ivf_flat.search(
            res, sp, index, q, k, filter=f)[1], queries, filters, truths,
        "flat_pair_list_scan", ("flat_list_scan", "flat_scan_query_major"))
    full = ivf_flat.SearchParams(n_probes=index.n_lists)
    full_probe_contract(
        "IVF-Flat nlist 4096",
        lambda q, k, f: ivf_flat.search(res, full, index, q, k, filter=f),
        queries, half.words, N_DB, WIDE_K, WIDE_FULL_PROBE_K,
        "flat_pair_list_scan", ("flat_list_scan", "flat_scan_query_major"))
    nall = queries.shape[0]
    full = check_kernel_f(index, queries, FLAT_CHECK_PROBES, WIDE_K,
                          f"ivf_flat_scan (pair-group pass, k {WIDE_K}, "
                          f"{nall:,} queries)")
    full.update(launches=runs[None][2]["flat_pair_list_scan"],
                shape=f"nlist 4096, {nall:,} queries x {FLAT_CHECK_PROBES} "
                f"probes, k {WIDE_K}, F {full['F']}, capacity "
                f"{index.capacity} (the unfiltered k-{WIDE_K} batch)")
    nq = LARGE_KT_QUERIES
    row = check_kernel_f(index, queries[:nq], FLAT_CHECK_PROBES, WIDE_K,
                         "ivf_flat_scan (pair-group pass, 50% filter)",
                         filter_words=half.words[:nq])
    return at_shape(
        row, f"filtered, 50% per query: nlist 4096, {nq:,} queries x "
        f"{FLAT_CHECK_PROBES} probes, k {WIDE_K}, F {row['F']}",
        runs["50% per query"][2]["flat_pair_list_scan"]), runs, full


def deep_wide_filtered(res, index, db, queries):
    """The deep index's first DEEP_FILTER_QUERIES queries at k = kt =
    WIDE_DEEP_KT, refined to WIDE_K, with the phase's three filters over
    its 10M ids: ``fused`` (Kernel C: D's pair-group pass and the merge),
    ``codes`` (D's pass) and ``recon8`` (E's), ms beside unfiltered,
    recall@100 against the filtered brute_force.knn, each run launching
    its route and no other (no list-major pass, no query-major kernel);
    the unfiltered batches' recall@100 through the pass and through the
    query-major kernel swapped in on the one build, within
    PAIR_RECALL_GAP, and their ms in turns; then C, D and E filtered (50%
    per query) against their plain versions at that shape, the
    query-major kernels held to the same plain result and timed in turns
    beside the route.  Returns three ``also_checked`` entries (launches
    from the 50% runs) and each mode's launches of its pass in the
    unfiltered run (``"fused merge"``: C's pass 2)."""
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.ops import pq_code_scan as pcs

    nq = DEEP_FILTER_QUERIES
    q = queries[:nq]
    filters = test_filters(nq, DEEP_DB, q.device)
    truths = ground_truths(res, db, q, filters, WIDE_K)
    launched, unfiltered = {}, {}
    for mode, route, others, scan, walked in (
            ("fused", "code_pair_list_scan",
             ("code_list_scan", "codes_fused_query_major",
              "codes_scan_query_major"),
             "ivf_pq_scan_codes_fused", pcs.codes_fused_query_major),
            ("codes", "code_pair_list_scan",
             ("code_list_scan", "codes_scan_query_major"),
             "ivf_pq_scan_codes", pcs.codes_scan_query_major),
            ("recon8", "recon8_pair_list_scan",
             ("recon8_list_scan", "recon8_scan_query_major"),
             "ivf_pq_scan_recon8", pcs.recon8_scan_query_major)):
        sp = ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode=mode,
                                 per_probe_topk=WIDE_DEEP_KT)

        def batch(qq, k, f, sp=sp):
            _, cand = ivf_pq.search(res, sp, index, qq, WIDE_DEEP_KT,
                                    filter=f)
            return refine(res, db, qq, cand, k)[1]

        label = f"deep {mode} k = kt = {WIDE_DEEP_KT} -> {WIDE_K}"
        runs = wide_searches(label, batch, q, filters, truths, route,
                             others)
        launched[mode] = runs["50% per query"][2][route]
        unfiltered[mode] = runs[None][2][route]
        merges = [r[2]["merge_pairs"] for r in runs.values()]
        assert all(merges) == (mode == "fused") and (
            any(merges) == (mode == "fused")), (
            f"{label}: pass 2 launched {merges}")
        if mode == "fused":
            unfiltered["fused merge"] = runs[None][2]["merge_pairs"]
        same_build_routes(
            label, pcs, scan, walked, (getattr(pcs, route), walked),
            lambda batch=batch: batch(q, WIDE_K, None), truths[None],
            gap=PAIR_RECALL_GAP, first="pair-group", turns=mode == "fused")
    rows = check_code_kernels(index, q, WIDE_DEEP_KT, k=WIDE_DEEP_KT,
                              filter_words=filters["50% per query"].words,
                              yardstick=True)
    return [at_shape(row, f"filtered, 50% per query: {name} "
                     f"(csrc/{row['source'].split('/')[-1]}): deep, {nq:,} "
                     f"queries x {N_PROBES} probes, k {WIDE_DEEP_KT}, kt "
                     f"{WIDE_DEEP_KT}, capacity {index.capacity:,}",
                     launched[mode])
            for row, mode, name in zip(
                rows, ("fused", "codes", "recon8"),
                ("pair-group pass + merge", "pair-group pass",
                 "pair-group pass"))], unfiltered


def deep_pair_batches(res, index, db, queries):
    """The deep index's whole batch (N_QUERIES queries x 96 probes) at k =
    kt = WIDE_DEEP_KT refined to WIDE_K in ``codes`` (Kernel D) and
    ``recon8`` (E): ms per batch, launches zeroed before and read after
    (the pair-group pass launched; no list-major pass, no query-major D or
    E kernel), then the pass against its plain version on the batch's own
    scan inputs (``check_code_kernels``, with its split, groups and
    streamed bytes): the main entries of the ``code_pair_list_scan`` and
    ``recon8_pair_list_scan`` rows, their launches those searches'."""
    from raft_tpu_torch.neighbors import ivf_pq, refine

    launched = {}
    for mode, route, others in (
            ("codes", "code_pair_list_scan",
             ("code_list_scan", "codes_scan_query_major")),
            ("recon8", "recon8_pair_list_scan",
             ("recon8_list_scan", "recon8_scan_query_major"))):
        sp = ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode=mode,
                                 per_probe_topk=WIDE_DEEP_KT)
        zero_launches()
        ms, _ = timed_searches(lambda sp=sp: refine(
            res, db, queries, ivf_pq.search(res, sp, index, queries,
                                            WIDE_DEEP_KT)[1], WIDE_K)[1],
            SEARCH_REPS)
        launches = read_launches()
        print(f"deep {mode} k = kt = {WIDE_DEEP_KT} -> {WIDE_K}: "
              f"{', '.join(f'{m:.2f}' for m in ms)} ms per batch of "
              f"{queries.shape[0]:,} (search + refine); launches "
              f"{json.dumps(launches)}", flush=True)
        assert launches[route] > 0 and not any(launches[o] for o in others), (
            f"deep {mode} k = kt = {WIDE_DEEP_KT}: launches "
            f"{json.dumps(launches)}")
        launched[mode] = launches[route]
    rows = check_code_kernels(index, queries, WIDE_DEEP_KT, ("D", "E"),
                              k=WIDE_DEEP_KT)
    return [dict(row, name=name, launches=launched[mode],
                 shape=f"deep {mode}: {queries.shape[0]:,} queries x "
                 f"{N_PROBES} probes, k = kt = {WIDE_DEEP_KT}, capacity "
                 f"{index.capacity:,}, rot {index.rot_dim} (the unfiltered "
                 f"k-{WIDE_K} batch)")
            for row, mode, name in zip(
                rows, ("codes", "recon8"),
                ("code_pair_list_scan", "recon8_pair_list_scan"))]


def filtered_phase(res, index, flat, db, queries):
    """The flagship IVF-PQ and IVF-Flat 4096 with the phase's filters,
    their full-probe contracts, their filtered kernels against plain, and
    their mutations.  Returns the filters, their ground truths, the
    filtered kernel rows and the numbers."""
    import shutil
    import tempfile

    filters = test_filters(N_QUERIES, N_DB, db.device)
    truths = ground_truths(res, db, queries, filters, K)
    pq_rows, pq_runs = filtered_ivf_pq(res, index, db, queries, filters,
                                       truths)
    tmp = tempfile.mkdtemp(prefix="raft_tpu_torch_mutation_")
    try:
        numbers = mutate_ivf_pq(res, index, db, queries, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    f_row, flat_runs = filtered_ivf_flat(res, flat, db, queries, filters,
                                         truths)
    t0 = time.perf_counter()
    wide = ground_truths(res, db, queries, filters, WIDE_K)
    (b_wide, g_wide), g_runs, g_full, b_full = wide_filtered_ivf_pq(
        res, index, db, queries, filters, wide)
    f_wide, f_runs, f_full = wide_filtered_ivf_flat(res, flat, queries,
                                                    filters, wide)
    print(f"filtered k {WIDE_K} (the pair-group passes of B, G and F): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return (filters, truths, pq_rows, f_row, pq_runs, flat_runs, numbers,
            {"B": b_wide, "G": g_wide, "F": f_wide,
             "G_runs": g_runs, "F_runs": f_runs, "G_full": g_full,
             "F_full": f_full, "B_full": b_full})

# ---------------------------------------------------------------------------
# the rest of IVF-PQ: the small-dim kernel's batch axis, per-cluster books,
# the LUT scan, InnerProduct, wide recon8 scans and the list-data helpers
# ---------------------------------------------------------------------------

# the per-subspace flagship codebooks stage before the batched loop (PERF.md
# §5: chip_smoke PR 8 runs 3 / 5; the small-dim launches of the flagship
# build, PERF.md kernel table row 8)
FLAGSHIP_BOOKS_S, FLAGSHIP_BOOK_LAUNCHES = (0.72, 1.03), 1344
# the LUT scan's queries on the deep index, and InnerProduct's
DEEP_LUT_QUERIES = 1_000
# the LUT scan against the codes scan: the largest relative gap allowed
LUT_CODES_REL_GAP = 0.01
# the deep recon8 search past Kernel E's gates: k = kt
WIDE_RECON8_K = 256
# recall@10 sanity floor of the per-cluster and InnerProduct searches
NEW_RECALL_FLOOR = 0.80


def check_kernel_h_batched(x, y, shape):
    """Kernel H's small-dim kernel with a batch axis
    (``fused_l2_nn_batched``, one launch for all B members) against its
    plain version (a loop of ``fused_l2_nn_plain`` over the members):
    labels equal and dmin within H's tolerance (1e-5 of the scale ‖x‖² +
    max ‖y‖²); its CUDA-event time, device time, plain time, the bound
    (x and y read once, dmin and labels written once; 2·B·m·n·k fp32
    operations at the FFMA rate) and a TF32-off batched ``torch.bmm`` of
    the same products as ``library_ms`` (a yardstick: no call computes
    the argmin)."""
    import torch
    from raft_tpu_torch.ops import fused_l2_nn as fnn
    from raft_tpu_torch.utils import precision

    dk, ik = fnn.fused_l2_nn_batched(x, y)
    (dp, ip), plain_ms = timed_once(lambda: fnn.fused_l2_nn_batched_plain(
        x, y))
    scale = float((x * x).sum(2).max() + (y * y).sum(2).max())
    err = float((dk - dp).abs().max())
    same = float((ik == ip).float().mean())
    assert err <= 1e-5 * scale, f"batched H at {shape}: dmin off by {err}"
    assert same == 1.0, f"batched H at {shape}: labels equal at {same}"
    ms = cuda_ms(lambda: fnn.fused_l2_nn_batched(x, y), KERNEL_REPS)
    dev_ms = device_ms(lambda: fnn.fused_l2_nn_batched(x, y), KERNEL_REPS,
                       "small_dim_kernel")
    B, m, k = x.shape
    n = y.shape[1]
    flops = 2.0 * B * m * n * k
    nbytes = B * ((m + n) * k * 4 + m * 8)
    bound_ms, bound_by = bound(nbytes, flops, FP32_FLOP_PER_S)
    with precision.highest():
        lib_ms = cuda_ms(lambda: torch.bmm(x, y.transpose(1, 2)),
                         KERNEL_REPS)
    print(f"small-dim H batched at {shape}: labels equal, max |dmin err| "
          f"{err} (scale {scale:.3f}); {ms:.4f} ms a launch, kernel "
          f"{dev_ms:.4f} ms on the device, plain {plain_ms:.1f} ms ({B} "
          f"calls), bound {bound_ms:.4f} ms ({bound_by}), fp32 bmm "
          f"{lib_ms:.4f} ms", flush=True)
    return {"name": "fused_l2_nn_small_dim", "route": "cuda",
            "source": "raft_tpu_torch/csrc/fused_l2_nn.cu",
            "replaces": "raft_tpu/ops/fused_l2_nn_pallas.py:65",
            "wrapper": "fused_l2_nn_batched", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "device_ms": dev_ms, "shape": shape}


def book_inputs(index, rows, kind):
    """The batched codebook loop's first turn at the shape ``index``'s
    build gives it: ``_BOOK_TRAIN_ROWS`` rotated rows' residuals split
    into subspaces (B = pq_dim) or sampled per coarse list (B = n_lists,
    ``per`` sub-rows each), with their strided initial books."""
    import torch
    from raft_tpu_torch.cluster.kmeans_balanced import _strided_init
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import fused_l2_nn as fnn

    rot = rows[:ivf_pq._BOOK_TRAIN_ROWS].float() @ index.rotation
    lab = fnn.fused_l2_nn_plain(rot, index.centers)[1].long()
    resid = ivf_pq._subspace_split(rot - index.centers[lab], index.pq_dim)
    book = index.pq_book_size
    if kind == "subspace":
        sub = resid.transpose(0, 1).contiguous()
    else:
        per = max(book * 4, 256)
        gen = torch.Generator(device=rows.device)
        gen.manual_seed(0)
        idx = ivf_pq._sample_per_cluster(
            lab.repeat_interleave(index.pq_dim), gen, index.n_lists, per)
        sub = resid.reshape(-1, resid.shape[2])[idx].contiguous()
    return sub, _strided_init(sub, book).contiguous()


def batched_h_check(index, rows, kind, label):
    sub, c0 = book_inputs(index, rows, kind)
    shape = (f"{label} {kind} codebook loop: {sub.shape[0]:,} x "
             f"{sub.shape[1]:,} x {sub.shape[2]} -> {c0.shape[1]}")
    return check_kernel_h_batched(sub, c0, shape)


def per_cluster_path(db, queries, truth, main_stages, main_launches):
    """The flagship configuration with ``CodebookKind.PER_CLUSTER``: the
    build (seconds, stages, the batched loop's launches), searches in
    ``auto`` (Kernel B), ``recon`` (G), ``recon8`` (E) and ``lut`` (the
    composition) at n_probes 96, k 20 -> 10, and the per-subspace build's
    codebooks stage beside its figures before the batched loop.  Returns
    the batched kernel's check at the per-cluster loop's shape."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import ivf_pq

    books = main_stages["codebooks"]
    print(f"per-subspace flagship codebooks stage: {books:.3f} s in "
          f"{main_launches['fused_l2_nn_batched']} batched small-dim "
          f"launches and {main_launches['fused_l2_nn_small_dim']} unbatched "
          f"(before the batched loop: {FLAGSHIP_BOOKS_S[0]}-"
          f"{FLAGSHIP_BOOKS_S[1]} s in {FLAGSHIP_BOOK_LAUNCHES:,} launches, "
          f"PERF.md)", flush=True)
    assert main_launches["fused_l2_nn_batched"] > 0, (
        "the batched small-dim kernel was never launched on the main path")
    res = DeviceResources(seed=0)
    params = ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM,
                                codebook_kind=ivf_pq.CodebookKind.PER_CLUSTER)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    index = ivf_pq.build(res, params, db)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"per-cluster build: {build_s:.2f} s; stages (s): "
          f"{json.dumps(ivf_pq.build.stage_seconds)}; codebooks "
          f"{tuple(index.codebooks.shape)}, capacity {index.capacity}; "
          f"launches {json.dumps(launches)}", flush=True)
    assert launches["fused_l2_nn_batched"] > 0, (
        "per-cluster build: the batched small-dim kernel never launched")
    runs = {}
    for label, sp, kernel, reps in (
            ("auto", ivf_pq.SearchParams(n_probes=N_PROBES), "merge_pairs",
             SEARCH_REPS),
            ("recon", ivf_pq.SearchParams(n_probes=N_PROBES,
                                          scan_mode="recon"), "list_scan",
             SEARCH_REPS),
            ("recon8", ivf_pq.SearchParams(n_probes=N_PROBES,
                                           scan_mode="recon8"),
             "recon8_list_scan", SEARCH_REPS),
            ("lut", ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode="lut"),
             None, 1)):
        runs[label] = search_mode(res, index, db, queries, truth,
                                  f"per-cluster flagship {label}", sp,
                                  kernel, reps)
        assert runs[label]["recall"] >= NEW_RECALL_FLOOR, (
            f"per-cluster {label} recall@10 {runs[label]['recall']}")
    row = batched_h_check(index, db, "per-cluster", "flagship")
    entry = at_shape(row, row["shape"], launches["fused_l2_nn_batched"])
    del index
    torch.cuda.empty_cache()
    return entry, {k: (v["batch_ms"], v["recall"]) for k, v in runs.items()}


def lut_path(res, index, db, queries, truth):
    """The LUT scan on the flagship index: fp32 and bf16 LUT, 5,000
    queries, search + refine (ms, recall@10); then the LUT held to the
    codes scan (Kernel D) at kt = k on the same index."""
    import torch
    from raft_tpu_torch.neighbors import ivf_pq

    out = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        run = search_mode(res, index, db, queries, truth,
                          f"flagship lut {name}", ivf_pq.SearchParams(
                              n_probes=N_PROBES, scan_mode="lut",
                              lut_dtype=dtype), None)
        assert run["recall"] >= 0.90, f"flagship lut {name}: {run['recall']}"
        out[name] = (run["batch_ms"], run["recall"])
    q = queries[:LARGE_KT_QUERIES]
    d_l, i_l = ivf_pq.search(res, ivf_pq.SearchParams(
        n_probes=N_PROBES, scan_mode="lut"), index, q, K_SEARCH)
    d_c, i_c = ivf_pq.search(res, ivf_pq.SearchParams(
        n_probes=N_PROBES, scan_mode="codes", per_probe_topk=K_SEARCH),
        index, q, K_SEARCH)
    lut_against_codes(index, q, d_l, i_l, d_c, i_c)
    return out


def lut_against_codes(index, q, d_l, i_l, d_c, i_c):
    """The fp32 LUT scan against the codes scan (Kernel D) at kt = k: D
    rounds the residual and the codebook to bf16 (unit roundoff u =
    2^-8), so for a row of squared norm ‖c‖², a residual of ‖r‖² and a
    distance d the two differ by at most u·(d + 2‖c‖² + ‖r‖²) (the cross
    terms bounded by 2ab <= a² + b²; plus 1e-5 of it for the fp32 sums).
    Each rank's distance is held to its row's largest bound (a sorted
    row's j-th value moves by no more), and every id more than two of the
    row's largest bounds inside its last distance in one scan is in the
    other's top k.  The bound reaches a few percent of a distance, so the
    largest relative gap is held to ``LUT_CODES_REL_GAP`` as well (ROADMAP
    §3 recorded 0.2% on a small CPU index)."""
    import torch

    u = 2.0 ** -8
    fin = torch.isfinite(d_c)
    assert torch.equal(fin, torch.isfinite(d_l)), "lut vs codes: exhausted"
    rows = index.list_indices.reshape(-1)
    slot = torch.full((int(rows.max()) + 1,), -1, dtype=torch.long,
                      device=rows.device)
    live = torch.nonzero(rows >= 0)[:, 0]
    slot[rows[live].long()] = live
    pos = slot[i_c.clamp_min(0).long()]
    lists = pos // index.capacity
    rsq = index.list_code_rsq.reshape(-1)[pos]
    qrot = q.float() @ index.rotation
    r = qrot[:, None, :] - index.centers[lists]
    tol = (u * (d_c + 2.0 * rsq + (r * r).sum(-1))) * (1.0 + 1e-5) + 1e-6
    gap = (d_l - d_c).abs()
    edge = torch.where(fin, d_c, torch.zeros_like(d_c)).amax(1,
                                                              keepdim=True)
    band = torch.where(fin, tol, torch.zeros_like(tol)).amax(1, keepdim=True)
    # a sorted row's j-th value moves by at most the row's largest bound
    assert bool((gap <= band)[fin].all()), (
        f"lut vs codes: a rank off its row's bound by "
        f"{float((gap - band)[fin].max())}")
    # a row more than two bands inside a row's last distance in one scan
    # is in the other scan's top k
    cut = edge - 2.0 * band
    for qi in range(d_c.shape[0]):
        assert set(i_l[qi][d_l[qi] < cut[qi]].tolist()) <= set(
            i_c[qi].tolist()), f"lut vs codes: query {qi}, a LUT id missing"
        assert set(i_c[qi][d_c[qi] < cut[qi]].tolist()) <= set(
            i_l[qi].tolist()), f"lut vs codes: query {qi}, a codes id missing"
    rel = float((gap[fin] / d_c[fin].abs().clamp_min(1e-12)).max())
    # the largest relative gap, besides the derived bound, which reaches
    # a few percent of a distance: two runs on the H100 read 0.376% and
    # 0.564%, past the 0.2% a small CPU index gave
    assert rel <= LUT_CODES_REL_GAP, (
        f"lut vs codes: relative gap {rel} past {LUT_CODES_REL_GAP}")
    same = float((i_l == i_c).float().mean())
    print(f"flagship lut vs codes (kt {d_c.shape[1]}, {q.shape[0]:,} "
          f"queries): every rank within its row's bf16 bound (largest "
          f"relative gap {rel:.5f} (limit {LUT_CODES_REL_GAP}; 0.2% not "
          f"met where it is above 0.002), largest bound/distance "
          f"{float((tol[fin] / d_c[fin].clamp_min(1e-12)).max()):.4f}); ids "
          f"equal at {same:.5f} of ranks, the rest inside a row's band",
          flush=True)


def recon8_wide_checks(res, index, db, queries, truth):
    """recon8 past Kernel E's gates on the deep index: k = kt =
    WIDE_RECON8_K on DEEP_LUT_QUERIES queries (the composition of the XLA
    twin), refined to 10; the composition held to Kernel E (query-major)
    at kt 128 on the same pairs; and E's query-major kernel at a row
    width past 1,024 bytes (its shared-memory residual) against its plain
    version.  Returns E's ``also_checked`` entry of the wide kernel."""
    import torch
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.neighbors.ivf_flat import (_finalize_topk,
                                                   _select_clusters)
    from raft_tpu_torch.ops import pq_code_scan as pcs

    q = queries[:DEEP_LUT_QUERIES]
    sp = ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode="recon8",
                             per_probe_topk=WIDE_RECON8_K)
    zero_launches()
    ms, (_, cand) = timed_searches(
        lambda: ivf_pq.search(res, sp, index, q, WIDE_RECON8_K), SEARCH_REPS)
    launches = read_launches()
    assert launches["recon8_list_scan"] == launches[
        "recon8_pair_list_scan"] == launches[
        "recon8_scan_query_major"] == 0, "wide recon8: a kernel ran"
    _, found = refine(res, db, q, cand, K)
    r = live_recall(found, truth[:q.shape[0]])
    print(f"deep recon8 k = kt = {WIDE_RECON8_K} (the composition), "
          f"{q.shape[0]:,} queries: {', '.join(f'{m:.2f}' for m in ms)} ms; "
          f"recall@10 after refine {r:.4f}", flush=True)
    qrot = q.float() @ index.rotation
    probes = _select_clusters(index.centers, qrot, N_PROBES, index.metric)
    kt = pcs.KT_MAX
    d_w, i_w = ivf_pq._search_recon8_wide(index, qrot, probes, kt, kt)
    vals, ids = pcs.ivf_pq_scan_recon8(
        qrot, index.centers.float(), probes, index.list_recon_i8,
        index.list_recon_scale, index.list_recon_i8_sq, index.list_indices,
        kt)
    d_e, i_e = _finalize_topk(vals, ids, kt, index.metric)
    compare_with_plain(f"deep recon8 composition vs Kernel E at kt {kt}",
                       d_w, i_w, d_e, i_e)
    # E's query-major kernel at rot_pad 1,104 (the residual in shared
    # memory; past the pair-group pass's 1,024, its route) against its
    # plain version
    dev = q.device
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    L, cap, rot, rot_pad, nq, P = 64, 512, 1100, 1104, 256, 8
    i8 = torch.randint(-127, 128, (L, cap, rot_pad), device=dev,
                       generator=g).to(torch.int8)
    i8[..., rot:] = 0
    sc = torch.rand(L, device=dev, generator=g) * 0.01 + 1e-3
    rsq = sc[:, None] ** 2 * (i8.float() ** 2).sum(-1)
    ids = torch.arange(L * cap, device=dev, dtype=torch.int32).reshape(L, cap)
    qq = torch.randn(nq, rot, device=dev, generator=g) * 0.1
    cc = torch.randn(L, rot, device=dev, generator=g) * 0.1
    pr = torch.randint(0, L, (nq, P), device=dev, generator=g,
                       dtype=torch.int32)
    kt = 100
    route, why = pcs.recon8_scan_route(cap, rot_pad, kt)
    assert route == "query", f"E at rot_pad {rot_pad}: route {route}"
    print(f"Kernel E at rot_pad {rot_pad}, kt {kt}: the query-major route "
          f"({why})", flush=True)
    vk, ik = pcs.recon8_scan_query_major(qq, cc, pr, i8, sc, rsq, ids, kt)
    (vp, ip), plain_ms = timed_once(lambda: pcs.ivf_pq_scan_recon8_plain(
        qq, cc, pr, i8, sc, rsq, ids, kt))
    err = compare_with_plain("Kernel E query-major, rot_pad 1,104", vk, ik,
                             vp, ip)
    ms_k = cuda_ms(lambda: pcs.recon8_scan_query_major(
        qq, cc, pr, i8, sc, rsq, ids, kt), KERNEL_REPS)
    nbytes = nq * P * cap * (rot_pad + 8) + nq * P * kt * 8
    bound_ms, bound_by = bound(nbytes, 2.0 * nq * P * cap * rot_pad)
    shape = (f"rot_pad {rot_pad} (past 1,024 bytes: the residual in shared "
             f"memory), {nq} queries x {P} probes of {L} random lists of "
             f"{cap}, kt {kt}")
    print(f"Kernel E at {shape}: {ms_k:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return at_shape({"max_abs_err": err, "ms": ms_k, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}, shape, 0), (median(ms), r)


def helpers_check(res, index, queries):
    """``ivf_pq_helpers`` on the flagship index: list 0 unpacked and
    packed back leaves the search bit-equal; ``reconstruct_list_data``
    equals the recon cache plus the list's centre, rotated back."""
    import torch
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors import ivf_pq_helpers as helpers

    sp = ivf_pq.SearchParams(n_probes=N_PROBES)
    q = queries[:LARGE_KT_QUERIES]
    before = ivf_pq.search(res, sp, index, q, K_SEARCH)
    label = int(torch.argmax(index.list_sizes))
    codes = helpers.unpack_list_data(res, index, label)
    packed = helpers.pack_list_data(res, index, label, codes)
    after = ivf_pq.search(res, sp, packed, q, K_SEARCH)
    same = torch.equal(before[0], after[0]) and torch.equal(before[1],
                                                             after[1])
    n = int(index.list_sizes[label])
    rec = helpers.reconstruct_list_data(res, index, label)
    want = (index.list_recon[label, :n].float()
            + index.centers[label].float()) @ index.rotation.T
    err = float((rec - want).abs().max())
    print(f"helpers on list {label} ({n} rows, {tuple(codes.shape)} codes): "
          f"unpack + pack leaves the search bit-equal: {same}; "
          f"reconstruct_list_data against recon + centre: max err {err}",
          flush=True)
    assert same, "pack_list_data(unpack_list_data) changed the search"
    assert err <= 1e-5, f"reconstruct_list_data off by {err}"


def ip_path(dev, db, queries):
    """InnerProduct at the deep configuration's width (raft-ann-bench's
    ``deep-image-96-inner`` analogue): the deep rows and queries
    unit-normalised, ``IndexParams(metric=InnerProduct, n_lists=8192,
    pq_dim=48, kmeans_trainset_fraction=0.1)``; ``auto`` and ``recon``
    (the composition of the XLA twin) on 5,000 queries and ``lut`` on
    DEEP_LUT_QUERIES, n_probes 96, k 20 -> refine 10 by inner product,
    recall@10 against the inner-product ``brute_force.knn``; the 50%
    per-query filter; the full-probe filter contract on 64 queries."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.filters import SampleFilter
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine

    ip = DistanceType.InnerProduct
    db = db / db.norm(dim=1, keepdim=True)
    queries = queries / queries.norm(dim=1, keepdim=True)
    res = DeviceResources(seed=0)
    _, truth = brute_force.knn(res, db, queries, K, metric=ip)
    params = ivf_pq.IndexParams(metric=ip, n_lists=DEEP_LISTS,
                                pq_dim=DEEP_PQ_DIM,
                                kmeans_trainset_fraction=DEEP_TRAIN_FRACTION)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_pq.build(res, params, db)
    torch.cuda.synchronize()
    print(f"InnerProduct build: {time.perf_counter() - t0:.2f} s; stages "
          f"(s): {json.dumps(ivf_pq.build.stage_seconds)}; capacity "
          f"{index.capacity}", flush=True)
    out = {}
    for label, mode, q, t in (
            ("auto", "auto", queries, truth),
            ("recon", "recon", queries, truth),
            ("lut", "lut", queries[:DEEP_LUT_QUERIES],
             truth[:DEEP_LUT_QUERIES])):
        before = ivf_pq.search.fused_fallbacks
        run = search_mode(res, index, db, q, t, f"InnerProduct {label}",
                          ivf_pq.SearchParams(n_probes=N_PROBES,
                                              scan_mode=mode), None,
                          1 if mode == "lut" else SEARCH_REPS)
        fell = ivf_pq.search.fused_fallbacks - before
        if mode == "auto":
            assert fell > 0 and ivf_pq.search.last_fallback_reason == \
                "dtype", "InnerProduct auto: no fallback counted"
        assert run["recall"] >= NEW_RECALL_FLOOR, (
            f"InnerProduct {label} recall@10 {run['recall']}")
        out[label] = (run["batch_ms"], run["recall"])
    words = half_words(queries.shape[0], db.shape[0], FILTER_SEED, dev)
    half = SampleFilter(words=words, n_rows=db.shape[0])
    _, t_f = brute_force.knn(res, db, queries, K, metric=ip, filter=half)
    sp = ivf_pq.SearchParams(n_probes=N_PROBES)
    ms, (_, cand) = timed_searches(lambda: refine(
        res, db, queries, ivf_pq.search(res, sp, index, queries, K_SEARCH,
                                        filter=half)[1], K, metric=ip),
        SEARCH_REPS)
    assert_admitted("InnerProduct 50% per query", cand, words)
    r = live_recall(cand, t_f)
    print(f"InnerProduct auto with the 50% per-query filter, k "
          f"{K_SEARCH} -> refine {K}: {', '.join(f'{m:.2f}' for m in ms)} "
          f"ms per batch of {queries.shape[0]:,}; recall@10 {r:.4f} against "
          f"the filtered inner-product brute_force.knn; every id admitted",
          flush=True)
    out["auto 50% filter"] = (median(ms), r)
    full = ivf_pq.SearchParams(n_probes=DEEP_LISTS)
    full_probe_contract("InnerProduct deep", lambda q, k, f: ivf_pq.search(
        res, full, index, q, k, filter=f), queries, words, db.shape[0])
    print(f"InnerProduct phase: {json.dumps(out)}", flush=True)
    del index
    torch.cuda.empty_cache()
    return out


# the host-side subsystems phase: the memtable's stream (PERF.md §5)
DELTA_UPSERTS, DELTA_DELETES, DELTA_CAPACITY = 16_384, 4_096, 1_024
DELTA_SEED = 1
FENCE_TURNS = 5
# a build stage's timer against build.stage_seconds: within 10% or 5 ms
STAGE_REL, STAGE_ABS_S = 0.10, 0.005
# the memtable merge against the host's plain merge: distances within
# 1e-5 of ||q||^2 + max ||x||^2, ids tie-aware
DELTA_ATOL = 1e-5
PROM_LINE = re.compile(
    r"^(# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|summary|histogram)"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{le=\"[^\"]+\"\})? "
    r"[-+]?([0-9.]+([eE][-+]?[0-9]+)?|inf|nan))$")


def flagship_rows(n, seed):
    """``n`` more rows of the flagship's distribution: sift_like's latent
    map (its numpy seed-0 draw) applied to latents and noise drawn from
    ``seed``, so they fall among the flagship's rows and queries."""
    import numpy as np

    rng = np.random.default_rng(0)
    rng.normal(size=(N_DB + N_QUERIES, LATENT))
    A = rng.normal(size=(LATENT, DIM)).astype(np.float32) / np.sqrt(LATENT)
    new = np.random.default_rng(seed)
    x = (new.normal(size=(n, LATENT)).astype(np.float32) @ A).astype(
        np.float32)
    return x + NOISE * new.normal(size=x.shape).astype(np.float32)


def host_merge(main_d, main_i, queries, rows, ids, deleted, k):
    """The memtable merge built on the host, in float64: the main
    results with deleted ids masked, the memtable's exact top-k, one
    stable sort, worst -> id -1."""
    import numpy as np

    md = main_d.astype(np.float64)
    mi = main_i.astype(np.int64)
    hit = np.isin(mi, deleted) & (mi >= 0)
    md = np.where(hit, np.inf, md)
    mi = np.where(hit, -1, mi)
    q = queries.astype(np.float64)
    r = rows.astype(np.float64)
    d = ((q * q).sum(1)[:, None] + (r * r).sum(1)[None, :]
         - 2.0 * q @ r.T)
    top = np.argsort(d, axis=1, kind="stable")[:, :k]
    dd = np.take_along_axis(d, top, 1)
    di = ids[top].astype(np.int64)
    alld = np.concatenate([md, dd], 1)
    alli = np.concatenate([mi, di], 1)
    order = np.argsort(alld, axis=1, kind="stable")[:, :k]
    out_d = np.take_along_axis(alld, order, 1)
    out_i = np.take_along_axis(alli, order, 1)
    return out_d, np.where(np.isinf(out_d), -1, out_i)


def merge_matches(label, dist, ids, ref_d, ref_i, scale, atol):
    """Distances within ``atol * scale`` (per query) of the host merge's;
    ids equal where the distances differ from their neighbours by more
    than that (a tie may order its ids either way)."""
    import numpy as np

    fin = np.isfinite(ref_d)
    assert np.array_equal(np.isfinite(dist), fin), f"{label}: sentinels"
    rel = np.where(fin, np.abs(np.where(fin, dist - ref_d, 0.0)), 0.0) / \
        scale[:, None]
    tol = atol * scale[:, None]
    assert (rel <= atol).all(), (
        f"{label}: {int((rel > atol).sum())} distances off the host merge "
        f"by more than {atol} x (||q||^2 + max ||x||^2); worst "
        f"{float(rel.max()):.3g}")
    for q in np.nonzero((ids != ref_i).any(1))[0]:
        for j in np.nonzero(ids[q] != ref_i[q])[0]:
            near = np.abs(ref_d[q] - ref_d[q, j]) <= 2 * tol[q, 0]
            assert ids[q, j] in ref_i[q][near], (
                f"{label}: query {q} rank {j}: id {ids[q, j]} vs "
                f"{ref_i[q, j]} off distance ties")
    return float(rel.max())


def host_side_path(res, index, db, queries, sp, build_stages, smi_line):
    """The host-side subsystems on the flagship (phase 4b): the no-fence
    contract and its cost, the build's stage report against
    ``build.stage_seconds``, the Prometheus text, one request trace, the
    delta memtable at a streaming size merged into the flagship batch,
    and ``integrity.verify`` on the flagship index."""
    import numpy as np
    import torch
    from raft_tpu_torch import integrity
    from raft_tpu_torch import observability as obs
    from raft_tpu_torch.neighbors import brute_force, delta, ivf_pq, refine

    # the module (the package's ``stage`` attribute is the function)
    obs_stage = sys.modules["raft_tpu_torch.observability.stage"]

    def batch():
        d, i = refine(res, db, queries, ivf_pq.search(
            res, sp, index, queries, K_SEARCH)[1], K)
        return d, i

    # 1. the no-fence contract: calls through the fence indirection
    calls = [0]
    real_wait = obs_stage._block_until_ready

    def counting_wait(device):
        calls[0] += 1
        real_wait(device)

    obs_stage._block_until_ready = counting_wait
    try:
        ms = {"off": [], "on": []}
        fences = {"off": [], "on": []}
        stages_crossed = set()
        for _ in range(FENCE_TURNS):
            for mode in ("off", "on"):
                obs.reset()
                calls[0] = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "on":
                    with obs.collecting():
                        batch()
                else:
                    batch()
                torch.cuda.synchronize()
                ms[mode].append(1e3 * (time.perf_counter() - t0))
                fences[mode].append(calls[0])
                if mode == "on":
                    stages_crossed = set(obs.snapshot()["timers"])
    finally:
        obs_stage._block_until_ready = real_wait
    med = {m: sorted(v)[len(v) // 2] for m, v in ms.items()}
    print(f"fence cost, search+refine batch of {N_QUERIES}: collection off "
          f"{', '.join(f'{m:.3f}' for m in ms['off'])} ms ({fences['off']} "
          f"fence waits), on {', '.join(f'{m:.3f}' for m in ms['on'])} ms "
          f"({fences['on']} fence waits; stages {sorted(stages_crossed)}); "
          f"medians {med['off']:.3f} / {med['on']:.3f} ms, on - off "
          f"{med['on'] - med['off']:.3f} ms; nvidia-smi: {smi_line}",
          flush=True)
    assert all(n == 0 for n in fences["off"]), (
        f"a search with collection off waited on the device: {fences}")
    assert stages_crossed and all(
        n >= len(stages_crossed) for n in fences["on"]), (
        f"fewer fence waits than stages: {fences['on']}, {stages_crossed}")

    # 2. the build's report (the main path built under collection)
    rep = obs.build_report(index)
    assert rep is not None, "the flagship build recorded no report"
    stage_s = {n: round(t["total_s"], 4) for n, t in rep["stages"].items()}
    print(f"build report: total {rep['total_s']:.3f} s; stages (s): "
          f"{json.dumps(stage_s)}; counters {json.dumps(rep['counters'])}; "
          f"nvidia-smi: {smi_line}", flush=True)
    for name in ("ivf_pq.build.kmeans", "ivf_pq.build.codebooks",
                 "ivf_pq.build.recon_cache", "kmeans_balanced.fit"):
        assert name in rep["stages"], f"build report lacks {name}"
    for name, t in rep["stages"].items():
        assert t["total_s"] <= rep["total_s"], (
            f"{name} {t['total_s']} s exceeds the build's {rep['total_s']}")
    agree = {}
    for stage, parts in (("kmeans", ("trainset", "coarse_fit")),
                         ("codebooks", ("codebooks",)),
                         ("recon_cache", ("recon_cache",))):
        got = rep["stages"][f"ivf_pq.build.{stage}"]["total_s"]
        want = sum(build_stages[p] for p in parts)
        agree[stage] = (round(got, 4), round(want, 4))
        assert abs(got - want) <= max(STAGE_REL * want, STAGE_ABS_S), (
            f"ivf_pq.build.{stage}: {got} s vs build.stage_seconds {want}")
    print(f"build stages, registry vs build.stage_seconds (s): "
          f"{json.dumps(agree)}", flush=True)
    text = obs.to_prometheus()
    lines = text.strip().splitlines()
    bad = [ln for ln in lines if not PROM_LINE.match(ln)]
    assert not bad, f"Prometheus lines that do not parse: {bad[:5]}"
    print(f"Prometheus text: {len(lines)} lines, all parse", flush=True)

    # 3. one request trace
    obs.reset()
    with obs.collecting(), obs.tracing_scope():
        rec = obs.start_request()
        with obs.trace.activating(rec):
            batch()
            torch.cuda.synchronize()
        rec.close()
    tree = [(s.name, round(1e3 * (s.t0 - rec.t0), 3),
             round(1e3 * s.duration, 3)) for s in rec.spans]
    print(f"request trace {rec.trace_id} ({rec.name}, "
          f"{1e3 * rec.duration:.3f} ms): spans (name, start ms, ms) "
          f"{json.dumps(tree)}; nvidia-smi: {smi_line}", flush=True)
    names = [s.name for s in rec.spans]
    for name in ("ivf_pq.search.coarse", "ivf_pq.search.fused_scan",
                 "refine"):
        assert name in names, f"the request trace lacks {name}: {names}"
    assert all(rec.t0 <= s.t0 <= s.t1 <= rec.t1 for s in rec.spans), (
        "a span lies outside its request")

    # 4. the delta memtable at a streaming size
    rng = np.random.default_rng(DELTA_SEED)
    new_rows = flagship_rows(DELTA_UPSERTS, DELTA_SEED)
    new_ids = np.arange(N_DB, N_DB + DELTA_UPSERTS, dtype=np.int64)
    deleted = np.sort(rng.choice(N_DB, DELTA_DELETES, replace=False))
    mem = delta.Memtable(DIM, capacity=DELTA_CAPACITY, device=db.device)
    t0 = time.perf_counter()
    mem.apply(delta.Record(1, delta.OP_UPSERT, new_ids, new_rows))
    mem.apply(delta.Record(2, delta.OP_DELETE, deleted))
    apply_s = time.perf_counter() - t0
    assert mem.capacity == DELTA_UPSERTS, mem.capacity
    data, ids, tombs = mem.device_view()
    main_d, main_i = batch()

    def merge():
        return delta.merge_with_main(main_d, main_i, queries, data, ids,
                                     tombs, k=K, metric=index.metric)

    # the first call pays for the product's and the selection's first use
    (dist, found), first_ms = timed_once(merge)
    merge_ms = []
    for _ in range(KERNEL_REPS):
        (dist, found), ms_ = timed_once(merge)
        merge_ms.append(ms_)
    live = torch.ones(N_DB, dtype=torch.bool, device=db.device)
    live[torch.as_tensor(deleted, device=db.device)] = False
    live_ids = torch.nonzero(live)[:, 0]
    in_mem = ids >= 0
    union = torch.cat([db[live_ids], data[in_mem]])
    union_ids = torch.cat([live_ids, ids[in_mem].long()])
    _, pos = brute_force.knn(res, union, queries, K)
    truth = union_ids[pos.long()]
    hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
    recall = float(hits) / truth.numel()
    del union, union_ids, live, live_ids
    found_h = found.cpu().numpy()
    assert not np.isin(found_h, deleted).any(), "a deleted id came back"
    q_h = queries.cpu().numpy()
    ref_d, ref_i = host_merge(main_d.cpu().numpy(), main_i.cpu().numpy(),
                              q_h, new_rows, new_ids, deleted, K)
    scale = (q_h.astype(np.float64) ** 2).sum(1) + max(
        float((db * db).sum(1).max()), float((new_rows ** 2).sum(1).max()))
    worst = merge_matches("memtable merge", dist.cpu().numpy(), found_h,
                          ref_d, ref_i, scale, DELTA_ATOL)
    from_mem = float((found >= N_DB).sum()) / found.numel()
    print(f"memtable: {DELTA_UPSERTS:,} upserts + {DELTA_DELETES:,} deletes "
          f"applied in {apply_s:.3f} s (capacity {DELTA_CAPACITY:,} -> "
          f"{mem.capacity:,}, tombstone capacity {mem.tomb_capacity:,}, "
          f"generation {mem.generation}); merge_with_main ms "
          f"{', '.join(f'{m:.3f}' for m in merge_ms)} (first call "
          f"{first_ms:.3f}; batch of {N_QUERIES:,}, k {K}); recall@10 "
          f"{recall:.4f} against brute "
          f"force over the live rows and the memtable; {100 * from_mem:.2f}% "
          f"of the results from the memtable; worst distance gap to the "
          f"host merge {worst:.3g} of ||q||^2 + max ||x||^2; digest "
          f"{mem.digest()}; nvidia-smi: {smi_line}", flush=True)
    assert recall >= 0.90, f"merged recall@10 {recall} below 0.90"

    # 5. integrity.verify on the flagship index
    verify_timed("flagship IVF-PQ", index, smi_line)
    return {"fence_ms": med, "merge_ms": sorted(merge_ms)[KERNEL_REPS // 2],
            "delta_recall": recall}


def verify_timed(label, index, smi_line):
    """``integrity.verify`` at ``statistical`` on a built index, timed;
    every check passes."""
    import torch
    from raft_tpu_torch import integrity

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    integrity.verify(index, level="statistical")
    torch.cuda.synchronize()
    print(f"integrity.verify statistical, {label}: passed in "
          f"{time.perf_counter() - t0:.3f} s; nvidia-smi: {smi_line}",
          flush=True)


# ---------------------------------------------------------------------------
# serving the flagship (phase 4c): core/aot and serving/
# ---------------------------------------------------------------------------

SERVE_K, SERVE_MAX_BATCH, SERVE_RUNG_PROBES = 10, 1024, 48
SERVE_CLIENTS, SERVE_MAX_REQUEST = 16, 64
SERVE_SHADOW_ROWS = 1_000
SERVE_UPSERTS, SERVE_DELETES, SERVE_CROWD = 4_096, 1_024, 2_048
SERVE_SEED = 2
# served rows against the direct batch: distances within this share of
# the row's largest distance (the coarse matmul sums in another order at
# another batch size), ids equal off distance ties
SERVE_RTOL = 1e-4


class ReplayCount:
    """A bucket callable that counts its calls (the served path's graph
    replays); the executor's table entries are wrapped after warm-up."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0
        self.graph = getattr(fn, "graph", None)

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def count_replays(ex):
    for key, fn in list(ex._fns.items()):
        ex._fns[key] = ReplayCount(fn)


def replays(ex):
    """{(bucket, k, rung): calls} of an executor's wrapped table."""
    return {key: fn.calls for key, fn in ex._fns.items()
            if isinstance(fn, ReplayCount)}


# the served kernels by the symbols the profiler names them with (\b keeps
# code_list_scan_kernel out of list_scan_kernel)
SERVED_KERNELS = {"list_scan": r"\blist_scan_kernel<",
                  "merge_pairs": r"\bmerge_kernel\b"}


def served_launches(fn):
    """``(fn(), {name: launches})``: ``fn`` (served traffic) run under
    torch.profiler's CUDA activity, and the launches of each of
    SERVED_KERNELS among the window's kernel events — the graph replays'
    own kernels, which no wrapper's count sees (PROFILE_PAD_S of idle time
    at each end: the profiler drops device events it places outside its
    window)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    counts = dict.fromkeys(SERVED_KERNELS, 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name, pattern in SERVED_KERNELS.items():
                if re.search(pattern, e.key):
                    counts[name] += e.count
    return out, counts


def derived_launches(before, after, per_bucket):
    """The launches a window's replays should make: each bucket's replays
    in the window (``after`` - ``before``, from ``replays``) times the
    launches one run of its program makes (``program_launches``) — the
    cross-check of ``served_launches``."""
    return {name: sum((after.get((b, SERVE_K, 0), 0)
                       - before.get((b, SERVE_K, 0), 0)) * per.get(name, 0)
                      for b, per in per_bucket.items())
            for name in SERVED_KERNELS}


def program_launches(res, index, n_probes, batch, mode, queries):
    """The kernel launches one run of a bucket's program makes (what each
    replay of its graph launches), from the wrappers' counts."""
    from raft_tpu_torch.core import aot

    zero_launches()
    aot.search_program(*aot._bake_ivf_pq(res, index, n_probes, SERVE_K,
                                         batch, scan_mode=mode))(
        queries[:batch])
    return {name: n for name, n in read_launches().items() if n}


def served_equal(label, d, i, rd, ri):
    """Served rows against the direct batch's: the same exhausted ranks,
    distances within SERVE_RTOL of the row's scale, ids equal off ties
    (``ties_only``).  Returns (rows equal bit for bit, max |diff|)."""
    import torch

    fin = torch.isfinite(rd)
    assert torch.equal(fin, torch.isfinite(d)), f"{label}: exhausted ranks"
    scale = rd.masked_fill(~fin, 0).abs().amax(1, keepdim=True).clamp_min(1)
    gap = (d - rd).masked_fill(~fin, 0).abs()
    assert bool((gap <= SERVE_RTOL * scale).all()), (
        f"{label}: distances differ by {float(gap.max())}")
    assert ties_only(rd, i, ri, atol=float(SERVE_RTOL * scale.max())), (
        f"{label}: ids differ off distance ties")
    same = ((d == rd) & (i == ri)).all(1)
    return int(same.sum()), float(gap.max())


def serve_traffic(srv, queries, seed, burst=False):
    """Every row of ``queries`` through ``Server.submit`` from
    SERVE_CLIENTS threads in requests of 1..SERVE_MAX_REQUEST rows:
    ``(distances, ids)`` in row order, the wall seconds and (requests,
    p50, p99 ms at the clients).  Each client waits for a request's
    result before its next submit (closed loop), or with ``burst``
    submits all its requests, then waits for them."""
    import threading

    import numpy as np
    import torch

    q = queries.cpu().numpy()
    n = q.shape[0]
    rng = np.random.default_rng(seed)
    cuts = [0]
    while cuts[-1] < n:
        cuts.append(min(n, cuts[-1] + int(rng.integers(
            1, SERVE_MAX_REQUEST + 1))))
    spans = list(zip(cuts[:-1], cuts[1:]))
    d = np.zeros((n, SERVE_K), np.float32)
    i = np.zeros((n, SERVE_K), np.int32)
    errors, waits = [], []

    def client(c):
        try:
            mine = spans[c::SERVE_CLIENTS]
            if burst:
                t = time.perf_counter()
                futs = [srv.submit(q[s:e], SERVE_K) for s, e in mine]
                for (s, e), f in zip(mine, futs):
                    d[s:e], i[s:e] = f.result(timeout=120)
                    waits.append(time.perf_counter() - t)
                return
            for s, e in mine:
                t = time.perf_counter()
                d[s:e], i[s:e] = srv.submit(q[s:e], SERVE_K).result(
                    timeout=120)
                waits.append(time.perf_counter() - t)
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    wall = time.perf_counter() - t0
    assert not errors, f"serving traffic failed: {errors[0]!r}"
    assert not any(th.is_alive() for th in threads), "a client hung"
    dev = queries.device
    ms = np.asarray(waits) * 1e3
    return (torch.from_numpy(d).to(dev), torch.from_numpy(i).to(dev),
            wall, (len(spans), float(np.percentile(ms, 50)),
                   float(np.percentile(ms, 99))))


def latency_line(reg):
    """p50 / p99 of end-to-end serving latency (ms) and the mean batch
    fill, from the serving histograms."""
    snap = reg.snapshot()["histograms"]
    tot = snap["serving.latency.total"]
    fill = snap["serving.batch_fill"]
    return (1e3 * tot["p50"], 1e3 * tot["p99"],
            fill["sum"] / max(fill["count"], 1), int(tot["count"]))


def raw_loop_rows_per_s(ex, queries):
    """The bucket-1024 replay loop over every query, no batcher: rows/s
    (the JAX smoke's same-call yardstick)."""
    import torch

    n = queries.shape[0]
    b = ex.max_batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, n, b):
        chunk = queries[s:s + b]
        m = chunk.shape[0]
        if m < b:
            chunk = ex.pad(chunk, b)
        d, i = ex.search_bucket(chunk, m, SERVE_K)
        d.cpu(), i.cpu()
    return n / (time.perf_counter() - t0)


def served_kernel_entry(index, queries, fn, live, plain, name, launches,
                        merged, smi_line):
    """A served bucket's check for the kernels line: the replay at bucket
    SERVE_MAX_BATCH against the kernel's plain version on the bucket's own
    scan inputs (tie-aware, every id recomputed from the index), the replay
    equal to the live program bit for bit, their CUDA-event ms, the
    function's bound, and the bucket's list_scan pass (+ merge_pairs where
    ``merged``: Kernel B) at the static and the exact group count."""
    import torch

    from raft_tpu_torch.ops import pq_group_scan as pgs

    q = queries[:SERVE_MAX_BATCH]
    qrot, probes = probe(index, q)
    d, i = fn(q)
    ld, li = live(q)
    assert torch.equal(d, ld) and torch.equal(i, li), (
        f"{name}: the replay differs from the live program")
    (vp, ip), plain_ms = timed_once(lambda: plain(qrot, probes))

    def dist_of(qs, ids):
        return id_distances(index, qrot, qs, ids, recon_rows_of(index),
                            index.list_recon_sq)[0]
    err = compare_with_plain(f"served {name}", d, i, vp, ip,
                             dist_of=dist_of)
    ms = cuda_ms(lambda: fn(q), KERNEL_REPS)
    live_ms = cuda_ms(lambda: live(q), KERNEL_REPS)
    rot = index.rot_dim
    bound_ms, bound_by, _, _ = scan_bound(index, probes, rot * 2 + 8, 0,
                                          SERVE_MAX_BATCH * SERVE_K * 8,
                                          rot)

    def grouped_pass(gl, sp):
        out = pgs.list_scan(qrot, index.centers, probes, gl, sp,
                            index.list_recon, index.list_recon_sq,
                            index.list_indices, SERVE_K)
        return pgs.merge_pairs(*out, SERVE_K) if merged else out
    static_vs_exact = grouping_cost(f"served {name} at bucket "
                                    f"{SERVE_MAX_BATCH}", probes,
                                    index.n_lists, grouped_pass)
    print(f"served {name} at bucket {SERVE_MAX_BATCH}: replay {ms:.3f} ms, "
          f"the live program {live_ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); served launches "
          f"{launches}; nvidia-smi: {smi_line}", flush=True)
    return {"shape": f"served: {name}, graph replays at buckets 1-"
                     f"{SERVE_MAX_BATCH} (checked at {SERVE_MAX_BATCH} x "
                     f"{N_PROBES} probes, k {SERVE_K}, kt {SERVE_K}); the "
                     f"replay equals the live program bit for bit",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "live_ms": live_ms,
            "served_by": "CUDA graph replay",
            "static_vs_exact": static_vs_exact}


def serving_path(res, index, db, queries, truth, smi_line):
    """Phase 4c: the flagship served through ``core/aot`` and
    ``serving/`` on captured CUDA graphs.  Returns Kernel B's and G's
    served kernels-line entries (``also_checked``)."""
    import tempfile

    import numpy as np
    import torch

    from raft_tpu_torch import observability as obs
    from raft_tpu_torch import serving
    from raft_tpu_torch.core import aot
    from raft_tpu_torch.integrity import canary
    from raft_tpu_torch.neighbors import ivf_pq, mutate
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_group_scan as pgs

    t_phase = time.perf_counter()
    cache = aot.executables()
    full = ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode="fused")
    rung = ivf_pq.SearchParams(n_probes=SERVE_RUNG_PROBES,
                               scan_mode="fused")
    cfg = serving.ServerConfig(max_batch=SERVE_MAX_BATCH, max_wait_us=500,
                               max_queue_rows=4 * N_QUERIES)

    # 1. warm-up: the fused executor (one brownout rung) with the shadow
    # monitor, and the default (auto -> recon) executor with the ingest
    # tier, each bucket one capture
    ex_f = serving.Executor(res, "ivf_pq", index, ks=(SERVE_K,),
                            max_batch=SERVE_MAX_BATCH, search_params=full)
    srv_f = serving.Server(ex_f, cfg)
    ctl = serving.BrownoutController(
        srv_f, [serving.Rung("full"), serving.Rung("probes/2", params=rung)],
        serving.BrownoutConfig(dwell_s=0.0))
    shadow = serving.ShadowMonitor(serving.ShadowConfig(
        sample_rows_per_s=1e6, burst_rows=256, max_batch=64,
        window_s=3600.0))
    srv_f.attach_shadow(shadow)
    ex_a = serving.Executor(res, "ivf_pq", index, ks=(SERVE_K,),
                            max_batch=SERVE_MAX_BATCH,
                            search_params=ivf_pq.SearchParams(
                                n_probes=N_PROBES))
    srv_a = serving.Server(ex_a, cfg)
    tmp = tempfile.mkdtemp(prefix="raft-serving-")
    ing = serving.IngestServer(res, serving.IngestConfig(
        wal_dir=tmp + "/wal", memtable_capacity=1024, tomb_capacity=1024,
        max_memtable_rows=2 * SERVE_UPSERTS), dim=DIM)
    srv_a.attach_ingest(ing)
    ing.recover(base_index=index)
    reg = obs.registry()
    obs.reset()
    with obs.collecting():
        torch.cuda.synchronize()
        c0 = cache.captures
        t0 = time.perf_counter()
        srv_f.start()
        torch.cuda.synchronize()
        warm_f = time.perf_counter() - t0
        caps_f = cache.captures - c0
        t0 = time.perf_counter()
        srv_a.start()
        torch.cuda.synchronize()
        warm_a = time.perf_counter() - t0
        caps_a = cache.captures - c0 - caps_f
    try:
        n_b = len(ex_f.buckets)
        assert caps_f == n_b * 2 + len(shadow.executor.buckets), caps_f
        assert caps_a == n_b, caps_a
        for ex in (ex_f, ex_a, shadow.executor):
            assert not ex.fallbacks, f"buckets served live: {ex.fallbacks}"
            assert all(hasattr(fn, "graph") for fn in ex._fns.values())
        print(f"serving warm-up: fused executor {n_b} buckets x 2 rungs "
              f"(n_probes {N_PROBES} / {SERVE_RUNG_PROBES}) + the shadow's "
              f"{len(shadow.executor.buckets)} at full probe: {caps_f} "
              f"captures in {warm_f:.2f} s; auto executor {n_b} buckets: "
              f"{caps_a} captures in {warm_a:.2f} s; every bucket a captured "
              f"graph, none served live; graph pools {ex_f.pool.bytes()} / "
              f"{ex_a.pool.bytes()} / {shadow.executor.pool.bytes()} bytes "
              f"(fused / auto / shadow); nvidia-smi: {smi_line}",
              flush=True)

        # 2. each bucket's replay against the live program (exact group
        # count), on padded flagship queries
        for ex, mode, rungs in ((ex_f, "fused", ((0, N_PROBES),
                                                 (1, SERVE_RUNG_PROBES))),
                                (ex_a, "recon", ((0, N_PROBES),))):
            for b in ex.buckets:
                padded = ex.pad(queries[:max(1, b - 1)], b)
                for r, n_probes in rungs:
                    live = aot.search_program(*aot._bake_ivf_pq(
                        res, index, n_probes, SERVE_K, b, scan_mode=mode))
                    d, i = ex._fns[(b, SERVE_K, r)](padded)
                    ld, li = live(padded)
                    assert torch.equal(i, li) and torch.equal(d, ld), (
                        f"{mode} bucket {b} rung {r}: replay != live")
        d, i = ex_a._fns[(SERVE_MAX_BATCH, SERVE_K, 0)](
            queries[:SERVE_MAX_BATCH])
        rd, ri = ivf_pq.search(res, ivf_pq.SearchParams(
            n_probes=N_PROBES, scan_mode="recon"), index,
            queries[:SERVE_MAX_BATCH], SERVE_K)
        assert torch.equal(d, rd) and torch.equal(i, ri), (
            "auto bucket: replay != ivf_pq.search (recon)")
        print(f"serving replay vs live: every bucket of both executors (and "
              f"the fused rung) equals its live program at the exact group "
              f"count bit for bit; the auto executor's bucket "
              f"{SERVE_MAX_BATCH} equals ivf_pq.search(scan_mode='recon') "
              f"bit for bit; nvidia-smi: {smi_line}", flush=True)

        # launches each graph replays: B (list_scan + merge_pairs) for the
        # fused buckets, G (list_scan) for the auto ones
        per_f = {b: program_launches(res, index, N_PROBES, b, "fused",
                                     queries) for b in ex_f.buckets}
        per_a = {b: program_launches(res, index, N_PROBES, b, "recon",
                                     queries) for b in ex_a.buckets}
        assert all(set(v) == {"list_scan", "merge_pairs"}
                   for v in per_f.values()), per_f
        assert all(set(v) == {"list_scan"} for v in per_a.values()), per_a

        # 3. traffic: every flagship query through Server.submit
        count_replays(ex_f)
        count_replays(ex_a)
        fn_a = ex_a._fns[(SERVE_MAX_BATCH, SERVE_K, 0)].fn
        direct = aot.search_program(*aot._bake_ivf_pq(
            res, index, N_PROBES, SERVE_K, N_QUERIES, scan_mode="fused"))
        rd, ri = direct(queries)
        obs.reset()
        c1, m1 = cache.captures, cache.misses
        # the shadow's full-probe replays would share the card with the
        # measured traffic: sampled apart below
        shadow.disable()
        with obs.collecting():
            d, i, wall, (n_req, c50, c99) = serve_traffic(srv_f, queries,
                                                          SERVE_SEED)
            p50, p99, fill, n_lat = latency_line(reg)
        same, gap = served_equal("served fused", d, i, rd, ri)
        obs.reset()
        with obs.collecting():
            bd, bi, bwall, (_, b50, b99) = serve_traffic(
                srv_f, queries, SERVE_SEED, burst=True)
            _, _, bfill, _ = latency_line(reg)
        served_equal("served fused, burst", bd, bi, rd, ri)
        hits = (i[:, :, None] == truth[:, None, :]).any(2).sum()
        recall = float(hits) / truth.numel()
        loop = raw_loop_rows_per_s(ex_f, queries)
        # Kernel B's launches on the served path: one more burst of every
        # query through Server.submit under the profiler, its kernels
        # counted there (the graphs' replays pass no wrapper's count)
        rep0 = replays(ex_f)
        (pd, pi, _, _), served_b = served_launches(
            lambda: serve_traffic(srv_f, queries, SERVE_SEED, burst=True))
        served_equal("served fused, profiled", pd, pi, rd, ri)
        rep_f = replays(ex_f)
        derived_b = derived_launches(rep0, rep_f, per_f)
        assert served_b == derived_b, (
            f"served B launches {served_b}, the window's replays times "
            f"their programs' launches {derived_b}")
        assert cache.captures == c1 and cache.misses == m1, (
            "the traffic captured or missed")
        print(f"serving traffic: {N_QUERIES:,} flagship queries from "
              f"{SERVE_CLIENTS} threads in {n_req} requests of 1-"
              f"{SERVE_MAX_REQUEST} rows: {N_QUERIES / wall:.0f} rows/s "
              f"served ({wall:.3f} s), latency p50 {p50:.3f} ms, p99 "
              f"{p99:.3f} ms ({n_lat} requests; the histogram's bucket "
              f"bounds; at the clients {c50:.3f} / {c99:.3f} ms), mean "
              f"batch fill {fill:.3f}; each client submitting all its "
              f"requests at once {N_QUERIES / bwall:.0f} rows/s "
              f"({bwall:.3f} s, at the clients p50 {b50:.3f} / p99 "
              f"{b99:.3f} ms, batch fill {bfill:.3f}); the raw "
              f"bucket-{SERVE_MAX_BATCH} replay loop "
              f"{loop:.0f} rows/s in the same call; recall@10 {recall:.4f};"
              f" rows equal to the direct batch bit for bit {same} of "
              f"{N_QUERIES} (max |dist diff| {gap}, the rest distance ties "
              f"or the coarse matmul's summation order); replays "
              f"{sum(rep_f.values())}; a profiled served burst launched B "
              f"{json.dumps(served_b)} (kernel events; its "
              f"{sum(rep_f.values()) - sum(rep0.values())} replays times "
              f"their programs' launches agree); new captures 0, new cache "
              f"misses 0; nvidia-smi: {smi_line}", flush=True)
        assert recall >= NEW_RECALL_FLOOR, f"served recall@10 {recall}"

        # 4. brownout: one step to the rung and back
        c2 = cache.captures
        ctl.config.step_down_p99_s, ctl.config.step_up_p99_s = 0.0, -1.0
        with obs.collecting():
            srv_f.search(queries[:8].cpu().numpy(), SERVE_K, timeout=60)
            assert ctl.evaluate() == "step_down"
            assert srv_f.brownout.rung == 1
            d, i = srv_f.search(queries[:8].cpu().numpy(), SERVE_K,
                                timeout=60)
            ld, li = aot.search_program(*aot._bake_ivf_pq(
                res, index, SERVE_RUNG_PROBES, SERVE_K, 8,
                scan_mode="fused"))(queries[:8])
            assert np.array_equal(i, li.cpu().numpy()), "rung results"
            ctl.config.step_down_p99_s, ctl.config.step_up_p99_s = 1e9, 1e8
            assert ctl.evaluate() == "step_up"
            assert srv_f.brownout.rung == 0
        assert cache.captures == c2, "the brownout step captured"
        print(f"serving brownout: one step to n_probes {SERVE_RUNG_PROBES} "
              f"and back, served at the rung equal to its live program; new "
              f"captures 0; nvidia-smi: {smi_line}", flush=True)

        # 5. ingest: upserts (half crowded around one list) and deletes of
        # the first queries' nearest ids, through the auto server
        rows = flagship_rows(SERVE_UPSERTS, SERVE_SEED)
        cen = index.centers[0].cpu().numpy()
        rot = index.rotation.cpu().numpy()
        crowd = np.random.default_rng(SERVE_SEED).normal(
            size=(SERVE_CROWD, DIM)).astype(np.float32) * 0.05
        rows[:SERVE_CROWD] = (cen @ rot.T)[None, :] + crowd
        new_ids = np.arange(N_DB, N_DB + SERVE_UPSERTS, dtype=np.int64)
        dead = np.unique(truth[:, 0].cpu().numpy())[:SERVE_DELETES]
        assert dead.size == SERVE_DELETES
        t0 = time.perf_counter()
        for s in range(0, SERVE_UPSERTS, 256):
            srv_a.write(new_ids[s:s + 256], rows[s:s + 256])
        for s in range(0, dead.size, 256):
            srv_a.write(dead[s:s + 256], op="delete")
        write_s = time.perf_counter() - t0
        probe_rows = rows[SERVE_CROWD::32]
        probe_ids = new_ids[SERVE_CROWD::32]
        c3 = cache.captures
        for r, want in zip(probe_rows[:64], probe_ids[:64]):
            _, got = srv_a.search(r[None, :], SERVE_K, timeout=60)
            assert int(got[0, 0]) == want, "an upsert is not its own top 1"
        rep0 = replays(ex_a)
        (d, i, _, _), served_g = served_launches(
            lambda: serve_traffic(srv_a, queries, SERVE_SEED + 1))
        assert not np.isin(i.cpu().numpy(), dead).any(), "a deleted id"
        assert cache.captures == c3, "traffic with the memtable captured"
        derived_g = derived_launches(rep0, replays(ex_a), per_a)
        assert served_g == derived_g, (
            f"served G launches {served_g}, the window's replays times "
            f"their programs' launches {derived_g}")
        pool_a = [ex_a.pool.bytes()]
        digest = ing.memtable.digest()
        rec = serving.IngestServer(res, serving.IngestConfig(
            wal_dir=tmp + "/wal", memtable_capacity=1024,
            tomb_capacity=1024, max_memtable_rows=2 * SERVE_UPSERTS),
            dim=DIM)
        rec.recover(base_index=index)
        assert rec.memtable.digest() == digest, "WAL replay state"
        rec.close()
        t0 = time.perf_counter()
        folded = ing.fold()
        torch.cuda.synchronize()
        fold_s = time.perf_counter() - t0
        assert ex_a.index is folded and ing.stats()["wal_bytes"] == 0
        count_replays(ex_a)
        c4 = cache.captures
        assert c4 - c3 == n_b, "the fold's swap captured one table"
        d, i, _, _ = serve_traffic(srv_a, queries, SERVE_SEED + 2)
        assert not np.isin(i.cpu().numpy(), dead).any(), "deleted after fold"
        _, got = srv_a.search(probe_rows[:64], SERVE_K, timeout=60)
        assert (got[:, 0] == probe_ids[:64]).all(), "upserts after the fold"
        assert cache.captures == c4, "steady traffic after the swap captured"
        pool_a.append(ex_a.pool.bytes())
        print(f"serving ingest: {SERVE_UPSERTS:,} upserts and {dead.size:,} "
              f"deletes through Server.write in {write_s:.2f} s (fsync'd "
              f"WAL); each probed upsert its own top 1, no deleted id in "
              f"{N_QUERIES:,} served rows; a fresh recover replays the WAL "
              f"to the same memtable digest; the fold (delete + extend + "
              f"verify, swapped in) {fold_s:.2f} s, generation "
              f"{mutate.generation(folded)}, {c4 - c3} captures, none after; "
              f"the served traffic before it launched G {served_g['list_scan']}"
              f" times (profiled kernel events, agreeing with its replays); "
              f"nvidia-smi: {smi_line}", flush=True)

        # 6. shadow recall (a sampled closed-loop pass over the first
        # queries) and one rebalance pass, gated by verify and the canary,
        # swapped in through the auto server
        shadow.enable()
        serve_traffic(srv_f, queries[:SERVE_SHADOW_ROWS], SERVE_SEED)
        shadow.stop()
        shadow.disable()
        est = shadow.estimator.estimate()
        assert est is not None and est.rows > 0, "no shadow sample"
        folded.canaries = canary.make(res, db, metric=folded.metric)
        rb = serving.Rebalancer(res, folded, server=srv_a, ingest=ing,
                                config=serving.RebalanceConfig(
                                    max_lists_per_pass=2))
        overfull, _ = rb._plan(folded)
        t0 = time.perf_counter()
        out = rb.run_once()
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        st = rb.stats()
        assert overfull.size >= 1 and st["reclustered_rows"] > 0
        assert st["swaps"] == 1 and ex_a.index is out
        d, i, _, _ = serve_traffic(srv_a, queries, SERVE_SEED + 3)
        assert not np.isin(i.cpu().numpy(), dead).any(), "deleted after pass"
        live_truth = ~torch.from_numpy(np.isin(
            truth.cpu().numpy(), dead)).to(truth.device)
        hits = ((i[:, :, None] == truth[:, None, :]) & live_truth[:, None, :]
                ).any(2).sum()
        recall_after = float(hits) / float(live_truth.sum())
        pool_a.append(ex_a.pool.bytes())
        print(f"serving shadow + rebalance: shadow recall {est.recall:.4f} "
              f"[{est.lo:.4f}, {est.hi:.4f}] over {est.rows} sampled rows "
              f"at full probe; the rebalancer re-clustered lists "
              f"{overfull.tolist()} ({st['reclustered_rows']} rows), "
              f"compacted, passed verify + the canary and swapped in "
              f"({pass_s:.2f} s); served recall@10 after {recall_after:.4f} "
              f"(of the truth's ids not deleted); the auto executor's graph "
              f"pool {pool_a[0]} / {pool_a[1]} / {pool_a[2]} bytes before the "
              f"fold / after it / after the pass (the flagship's table "
              f"stays, held by this script; the fold's generation is the "
              f"server's last good one); nvidia-smi: {smi_line}",
              flush=True)
    finally:
        srv_f.stop()
        srv_a.stop()
        ing.close()
    entry_g = served_kernel_entry(
        index, queries, fn_a,
        aot.search_program(*aot._bake_ivf_pq(
            res, index, N_PROBES, SERVE_K, SERVE_MAX_BATCH,
            scan_mode="recon")),
        lambda qrot, probes: ivf_pq._finalize_topk(
            *ps.ivf_pq_scan_recon_plain(
                qrot, index.centers, probes, index.list_recon,
                index.list_recon_sq, index.list_indices, SERVE_K),
            SERVE_K, index.metric),
        "auto executor (Kernel G + the final top k)", served_g["list_scan"],
        False, smi_line)
    entry_b = served_kernel_entry(
        index, queries, ReplayCount(ex_f._fns[(SERVE_MAX_BATCH, SERVE_K,
                                               0)].fn),
        aot.search_program(*aot._bake_ivf_pq(
            res, index, N_PROBES, SERVE_K, SERVE_MAX_BATCH,
            scan_mode="fused")),
        lambda qrot, probes: pgs.ivf_pq_scan_fused_plain(
            qrot, index.centers, probes, index.list_recon,
            index.list_recon_sq, index.list_indices, SERVE_K, SERVE_K),
        "fused executor (Kernel B)", served_b["merge_pairs"], True, smi_line)
    entry_b["pass1_launches"] = served_b["list_scan"]
    for entry in (entry_b, entry_g):
        entry["launches_from"] = ("torch.profiler kernel events of one "
                                  "served run, equal to its replays times "
                                  "their programs' launches")
    assert entry_b["launches"] > 0 and entry_g["launches"] > 0, (
        "a served kernel was never replayed")
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s; "
          f"nvidia-smi: {smi_line}", flush=True)
    return entry_b, entry_g


# ---------------------------------------------------------------------------
# select_k's tie order (the JAX package's) against torch.topk's, in turns
# ---------------------------------------------------------------------------

# the order of the two selections' timings
SELECT_K_TURNS = ("topk", "stable", "stable", "topk")


class TopkSelect:
    """``select_k``'s selection swapped for ``torch.topk`` alone (its order
    among equal values arbitrary: the port before its tie fix) inside a
    ``with`` block, as the yardstick of the paths that call it."""

    def __enter__(self):
        import torch
        import raft_tpu_torch.matrix.select_k  # noqa: F401

        self.mod = sys.modules["raft_tpu_torch.matrix.select_k"]
        self.real = self.mod._stable_topk
        self.mod._stable_topk = lambda v, k, smin: torch.topk(
            v, k, dim=1, largest=not smin, sorted=True).indices
        return self

    def __exit__(self, *exc):
        self.mod._stable_topk = self.real


# the ties of select_k's card-route check: each row's values from this
# set, so every k-th value is tied thousands of times
SELECT_K_TIE_VALUES = (-float("inf"), -0.0, 0.0, 1.0, 2.0, float("inf"))


def select_k_card_route(dev, smi_line, rows=LARGE_KT_QUERIES,
                        cols=None, seed=0):
    """``select_k``'s card route past the whole-row sort relies on a detail
    of ATen's CUDA ``torch.topk`` (of the k-th value's ties it keeps the
    first it meets in the row), not on a documented promise: re-checked
    here on every run.  Tie-heavy rows at the brute-force tile's shape
    (LARGE_KT_QUERIES queries x the tile's 65,536 rows), values drawn on
    the card from SELECT_K_TIE_VALUES, at k 1, K and 100 and both
    directions: the card route (``_topk_card``) equal to the exact keys
    route (``_topk_keys``) and to a stable sort of the whole row."""
    import importlib
    import torch
    from raft_tpu_torch.neighbors import brute_force

    sk = importlib.import_module("raft_tpu_torch.matrix.select_k")
    cols = cols or brute_force._TILE_N
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    table = torch.tensor(SELECT_K_TIE_VALUES, device=dev)
    vals = table[torch.randint(0, len(SELECT_K_TIE_VALUES), (rows, cols),
                               generator=g, device=dev)]
    checked = []
    for select_min in (True, False):
        whole = torch.sort(sk._order_keys(vals, select_min), dim=1,
                           stable=True).indices
        for k in (1, K, 100):
            card = sk._topk_card(vals, k, select_min)
            keys = sk._topk_keys(vals, k, select_min)
            assert torch.equal(card, keys) and torch.equal(
                card, whole[:, :k]), (
                f"select_k's card route breaks ties in another order at "
                f"({rows}, {cols}), k {k}, select_min {select_min}: "
                f"torch.topk no longer keeps the first of the k-th "
                f"value's ties")
            checked.append((select_min, k))
    print(f"select_k card route on tie-heavy rows ({rows:,} x {cols:,}, "
          f"values {SELECT_K_TIE_VALUES}): equal to the keys route and "
          f"to a stable sort of the whole row at (select_min, k) "
          f"{checked}; torch {torch.__version__}; nvidia-smi: {smi_line}",
          flush=True)


def select_k_turns(res, index, flat, db, queries, sp, smi_line):
    """The card paths that call ``select_k`` — ``brute_force.knn`` (1,000
    queries over the 1M rows), ``refine`` (the flagship batch's k-20
    candidates to 10), ``ivf_flat.search`` (nlist 4096 at 32 probes, k
    10) and ``delta.merge_with_main`` (a memtable of DELTA_UPSERTS rows
    and DELTA_DELETES deletes merged into the flagship batch) — each timed
    (CUDA events, KERNEL_REPS calls) with ``select_k``'s JAX tie order
    and with ``torch.topk`` alone, in turns (topk, stable, stable, topk).
    Each path's answers through the two agree in distance bit for bit
    (ids may differ only where distances tie).  Returns {path: {"stable":
    [ms, ms], "topk": [ms, ms]}}."""
    import numpy as np
    import torch
    from raft_tpu_torch.neighbors import brute_force, delta, ivf_flat, \
        ivf_pq, refine

    q1k = queries[:LARGE_KT_QUERIES]
    _, cand = ivf_pq.search(res, sp, index, queries, K_SEARCH)
    main_d, main_i = refine(res, db, queries, cand, K)
    rng = np.random.default_rng(DELTA_SEED)
    mem = delta.Memtable(DIM, capacity=DELTA_CAPACITY, device=db.device)
    mem.apply(delta.Record(1, delta.OP_UPSERT, np.arange(
        N_DB, N_DB + DELTA_UPSERTS, dtype=np.int64),
        flagship_rows(DELTA_UPSERTS, DELTA_SEED)))
    mem.apply(delta.Record(2, delta.OP_DELETE, np.sort(
        rng.choice(N_DB, DELTA_DELETES, replace=False))))
    data, ids, tombs = mem.device_view()
    flat_sp = ivf_flat.SearchParams(n_probes=FLAT_PROBES[0])
    paths = {
        "brute_force.knn": lambda: brute_force.knn(res, db, q1k, K),
        "refine": lambda: refine(res, db, queries, cand, K),
        "ivf_flat.search": lambda: ivf_flat.search(res, flat_sp, flat,
                                                   queries, K),
        "delta.merge_with_main": lambda: delta.merge_with_main(
            main_d, main_i, queries, data, ids, tombs, k=K,
            metric=index.metric),
    }
    out = {}
    for name, fn in paths.items():
        times, answers = {"stable": [], "topk": []}, {}
        for turn in SELECT_K_TURNS:
            if turn == "topk":
                with TopkSelect():
                    answers[turn] = fn()
                    times[turn].append(cuda_ms(fn, KERNEL_REPS))
            else:
                answers[turn] = fn()
                times[turn].append(cuda_ms(fn, KERNEL_REPS))
        assert torch.equal(answers["stable"][0], answers["topk"][0]), (
            f"{name}: select_k's two orders give other distances")
        same = float((answers["stable"][1] == answers["topk"][1]).float()
                     .mean())
        out[name] = times
        print(f"select_k turns, {name}: ms with the JAX tie order "
              f"{', '.join(f'{m:.3f}' for m in times['stable'])}, with "
              f"torch.topk alone {', '.join(f'{m:.3f}' for m in times['topk'])}"
              f"; ids equal at {same:.6f} (the rest at distance ties); "
              f"nvidia-smi: {smi_line}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Distributed: comms self-tests and MNMG k-means + kNN (BASELINE config 5)
# ---------------------------------------------------------------------------

# bench.py bench_mnmg (BASELINE.md config 5): rows of dim 256 from a 32-d
# latent (5% noise), 1,024 clusters, 5 Lloyd iterations at tol 0 from
# k-means++ (InitMethod.Random, which the distributed fit seeds with ++),
# 1,000 queries at k 10.  Part (a): BASELINE's whole 10M rows on the one
# card, NCCL at world size 1; part (b): bench_mnmg's 1.25M rows a rank on
# two gloo ranks sharing the card
MNMG_ROWS, MNMG_QUERIES, MNMG_DIM, MNMG_LATENT = 10_000_000, 1_000, 256, 32
MNMG_CLUSTERS, MNMG_ITERS = 1024, 5
MNMG_RANKS, MNMG_RANK_ROWS = 2, 1_250_000
# Kernel H is held to plain on the first rows of the 10M
MNMG_CHECK_ROWS = 1_000_000
# a fit against the same Lloyd loop without comms, or against world size
# 1, from the same centroids.  One iteration: only the sums' order differs
# (index_add_'s atomic adds, the ranks' partial sums), ~1e-6 of a
# centroid.  Five: a row at a near tie between two centroids may take the
# other label after such a difference, moving each centroid by |x - c| /
# count (~1e-4 a row here, on data of unit scale), and a few of those
# compound over the iterations.  Each
# five-iteration check prints how many rows' final labels differ between
# the two fits and how near a tie those rows are (label_flips)
MNMG_ONE_ITER_ATOL = 1e-4
MNMG_CENTROID_ATOL, MNMG_INERTIA_RTOL = 1e-2, 1e-4
MNMG_KNN_REPS = 3
MNMG_RANK_TIMEOUT_S = 420


def device_sift_like(n, n_queries, dim, latent, noise, device, seed=0,
                     chunk=1 << 20):
    """``sift_like``'s model (a ``latent``-d Gaussian mapped to ``dim``
    plus ``noise``) drawn on the device by torch's generator from
    ``seed``: the same rows in every process on the same card, and no
    host draw of 10M x 256 values."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    A = torch.randn(latent, dim, generator=g, device=device) / latent ** 0.5
    X = torch.empty(n + n_queries, dim, device=device)
    for s in range(0, n + n_queries, chunk):
        m = min(chunk, n + n_queries - s)
        z = torch.randn(m, latent, generator=g, device=device)
        X[s:s + m] = z @ A + noise * torch.randn(m, dim, generator=g,
                                                 device=device)
    return X[:n], X[n:]


def mnmg_params():
    from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams

    return KMeansParams(n_clusters=MNMG_CLUSTERS, max_iter=MNMG_ITERS,
                        tol=0.0, init=InitMethod.Random)


def self_tests(session):
    """The nine comms self-tests on ``session``: {name: passed}."""
    from raft_tpu_torch.comms import self_test

    names = [n for n in dir(self_test) if n.startswith("perform_test_")]
    out = {n[len("perform_test_"):]: getattr(self_test, n)(session)
           for n in sorted(names)}
    assert len(out) == 9, sorted(out)
    return out


def lloyd_plain(x, c, max_iter, tol):
    """The distributed fit's Lloyd loop on the whole array, without comms:
    Kernel H, ``index_add_`` of the rows and counts, the same update.
    Returns (centroids, inertia, n_iter)."""
    import torch
    from raft_tpu_torch.ops import fused_l2_nn as fnn

    ones = torch.ones(x.shape[0], device=x.device)
    n_iter, shift = 0, float("inf")
    while n_iter < max_iter and shift >= tol:
        lab = fnn.fused_l2_nn(x, c)[1].long()
        sums = torch.zeros_like(c).index_add_(0, lab, x)
        counts = torch.zeros(c.shape[0], device=x.device).index_add_(
            0, lab, ones)
        new_c = torch.where((counts > 0)[:, None],
                            sums / torch.clamp_min(counts, 1.0)[:, None], c)
        shift = float(((new_c - c) ** 2).sum())
        c, n_iter = new_c, n_iter + 1
    return c, float(fnn.fused_l2_nn(x, c)[0].sum()), n_iter


def knn_agree(label, x, q, d, i, ref_d, ref_i):
    """kNN distances within 1e-5 of ‖q‖² + max ‖x‖² of the reference's,
    each id equal to the reference's or at a distance tie with it (both
    recomputed directly); returns the share of equal ids."""
    import torch

    x_sq_max = float((x * x).sum(1).max())
    scale = (q * q).sum(1, keepdim=True) + x_sq_max
    err = float(((d - ref_d).abs() / scale).max())
    assert err <= 1e-5, f"{label}: distances off by {err} of the scale"

    def dist(ids):
        return ((q[:, None, :] - x[ids.long()]) ** 2).sum(-1)

    same = i == ref_i
    gap = ((dist(i) - dist(ref_i)).abs() / scale)
    assert bool((same | (gap <= 1e-5)).all()), (
        f"{label}: an id off a distance tie")
    return float(same.float().mean())


def fit_agree(label, got, ref, atol=MNMG_CENTROID_ATOL):
    """(centroids, inertia, n_iter) against a reference fit's: n_iter
    equal, centroids within ``atol``, inertia within MNMG_INERTIA_RTOL."""
    c, inertia, n_iter = got
    rc, r_inertia, r_n = ref
    gap = float((c - rc).abs().max())
    rel = abs(inertia - r_inertia) / r_inertia
    assert n_iter == r_n, f"{label}: n_iter {n_iter} against {r_n}"
    assert gap <= atol and rel <= MNMG_INERTIA_RTOL, (
        f"{label}: centroids off by {gap}, inertia by {rel} (relative)")
    return gap, rel


def label_flips(x, c, rc):
    """The rows whose nearest centroid under a fit's ``c`` differs from the
    one under its reference's ``rc`` (Kernel H on both), and how near a
    tie they sit: (count, the largest relative gap |d_a - d_b| / min(d_a,
    d_b) between a row's distances to its two labels' centroids, under
    either fit's centroids)."""
    import torch
    from raft_tpu_torch.ops import fused_l2_nn as fnn

    la = fnn.fused_l2_nn(x, c)[1].long()
    lb = fnn.fused_l2_nn(x, rc)[1].long()
    rows = (la != lb).nonzero().squeeze(1)
    if rows.numel() == 0:
        return 0, 0.0
    xs, la, lb = x[rows], la[rows], lb[rows]
    gap = 0.0
    for cc in (c, rc):
        da = ((xs - cc[la]) ** 2).sum(1)
        db = ((xs - cc[lb]) ** 2).sum(1)
        gap = max(gap, float(((da - db).abs() / torch.minimum(da, db)
                              .clamp_min(1e-30)).max()))
    return int(rows.numel()), gap


def check_kernel_h_mnmg(x, c, launches, shape):
    """Kernel H at the MNMG fit's shape: held to plain (dmin within 1e-5 of
    ‖x‖² + max ‖c‖², labels tie-aware) on the first MNMG_CHECK_ROWS rows,
    timed on all of them (the plain version once), the bound that of the
    whole pass; an ``also_checked`` entry of H's row."""
    import torch
    from raft_tpu_torch.ops import fused_l2_nn as fnn

    xs = x[:MNMG_CHECK_ROWS]
    dk, ik = fnn.fused_l2_nn(xs, c)
    dp, ip = fnn.fused_l2_nn_plain(xs, c)
    scale = float((xs * xs).sum(1).max() + (c * c).sum(1).max())
    err = float((dk - dp).abs().max())
    assert err <= 1e-5 * scale, f"fused_l2_nn at {shape}: dmin off by {err}"

    def dist(i):
        return ((xs - c[i.long()]) ** 2).sum(1)

    assert bool(((ik == ip) | ((dist(ik) - dist(ip)).abs()
                               <= 1e-5 * scale)).all()), (
        f"fused_l2_nn at {shape}: an index off a distance tie")
    same = float((ik == ip).float().mean())
    del dk, ik, dp, ip
    ms = cuda_ms(lambda: fnn.fused_l2_nn(x, c), 3)
    dev_ms = device_ms(lambda: fnn.fused_l2_nn(x, c), 3, "nn_tf32_kernel")
    _, plain_ms = timed_once(lambda: fnn.fused_l2_nn_plain(x, c))
    (m, k), n = x.shape, c.shape[0]
    flops = 2.0 * m * n * k
    bound_ms, bound_by = bound((m + n) * k * 4 + m * 8, 3 * flops,
                               TF32_FLOP_PER_S)
    lib_ms = matmul_ms(x, c)
    torch.cuda.empty_cache()
    print(f"fused_l2_nn at {shape}: max |dmin err| {err} (scale "
          f"{scale:.1f}) on {xs.shape[0]:,} rows, indices equal at "
          f"{same:.6f} (others at ties); {ms:.3f} ms a call, kernel "
          f"{dev_ms:.4f} ms on the device ({flops / dev_ms / 1e9:.1f} "
          f"TFLOP/s of one product), plain {plain_ms:.1f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); fp32 matmul "
          f"{'n/a (output past LIBRARY_OUT_BYTES)' if lib_ms is None else f'{lib_ms:.3f} ms'}",
          flush=True)
    return {"shape": shape, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "device_ms": dev_ms}


def timed_comms(base):
    """``base`` (a Comms) with each allreduce / bcast / allgather call
    timed between two device synchronises: ``.ms[op]`` lists them."""
    import torch
    from raft_tpu_torch.comms import Comms

    class TimedComms(Comms):
        def __init__(self):
            super().__init__(base.axis_name, base.group, base.device,
                             base.axes)
            self.ms = {}

        def _timed(self, op, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.ms.setdefault(op, []).append(
                1e3 * (time.perf_counter() - t0))
            return out

        def allreduce(self, x, op="sum"):
            return self._timed("allreduce", super().allreduce, x, op)

        def bcast(self, x, root=0):
            return self._timed("bcast", super().bcast, x, root)

        def allgather(self, x):
            return self._timed("allgather", super().allgather, x)

    return TimedComms()


def mnmg_run(handle, X, Q, timed=False):
    """One MNMG fit and kNN through the handle's comms, as a rank runs
    them: Kernel H's launches counted on the fit alone (zeroed just
    before, read just after), the fit's seconds, kNN's seconds over
    MNMG_KNN_REPS batches after one warm-up, the collectives' times when
    ``timed``."""
    import torch
    from raft_tpu_torch.distributed import kmeans as dist_kmeans
    from raft_tpu_torch.distributed import knn as dist_knn

    if timed:
        handle.set_comms(timed_comms(handle.get_comms()))
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    c, inertia, n_iter = dist_kmeans.fit(handle, mnmg_params(), X)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = h_tf32_launches(read_launches())
    fit_ms = dict(handle.get_comms().ms) if timed else {}
    d, i = dist_knn.knn(handle, X, Q, K)
    knn_ms, (d, i) = timed_searches(lambda: dist_knn.knn(handle, X, Q, K),
                                    MNMG_KNN_REPS)
    return {"fit": (c, float(inertia), n_iter), "fit_s": fit_s,
            "h_launches": launches, "knn": (d, i), "knn_ms": knn_ms,
            "collective_ms": fit_ms}


def mnmg_rank(rank, world, rows, device, c0):
    """Part (b)'s rank: on ``device`` beside the other ranks, over the gloo
    default group the launcher made; the self-tests, then the fit and the
    kNN on the whole ``rows``-row array held on the host (each rank moves
    its own rows to the card), then one iteration from the centroids
    ``c0``.  Returns plain values for the parent."""
    import torch
    from raft_tpu_torch import observability as obs
    from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
    from raft_tpu_torch.comms import CommsSession, comms as comms_mod
    from raft_tpu_torch.distributed import kmeans as dist_kmeans
    from raft_tpu_torch.ops import _cuda

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    _cuda.library()                      # the parent built it: a load
    session = CommsSession(device=dev).init()
    with obs.collecting():
        checks = self_tests(session)
        X, Q = device_sift_like(rows, MNMG_QUERIES, MNMG_DIM, MNMG_LATENT,
                                NOISE, dev)
        X = X.cpu()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = mnmg_run(session.worker_handle(seed=0), X, Q, timed=True)
        one_it = KMeansParams(n_clusters=MNMG_CLUSTERS, max_iter=1, tol=0.0,
                              init=InitMethod.Array)
        c1, inertia1, n1 = dist_kmeans.fit(
            session.worker_handle(seed=0), one_it, X,
            centroids=torch.from_numpy(c0).to(dev))
        used = sorted({name.split(".")[1] for name in obs.snapshot()[
            "counters"] if name.startswith("comms.")})
    c, inertia, n_iter = out["fit"]
    d, i = out["knn"]
    return {"backend": session.backend, "checks": checks, "used": used,
            "staged": sorted(comms_mod.staged),
            "fit": (c.cpu().numpy(), inertia, n_iter),
            "fit one": (c1.cpu().numpy(), float(inertia1), int(n1)),
            "knn": (d.cpu().numpy(), i.cpu().numpy()),
            "fit_s": out["fit_s"], "knn_ms": out["knn_ms"],
            "h_launches": out["h_launches"],
            "collective_ms": out["collective_ms"],
            "peak_gb": peak_gb()}


def mnmg_path(dev, smi_line):
    """BASELINE.md config 5 on the card.  (a) World size 1 over NCCL in
    this process (the group made for the phase and destroyed after): the
    nine self-tests; ``distributed.kmeans.fit`` on 10M x 256 rows ->
    1,024 clusters (5 iterations, tol 0, k-means++) held to the same
    Lloyd loop without comms from the same ++ centroids; ``distributed.
    knn`` of the 1,000 queries at k 10 held to ``brute_force.knn`` on the
    whole array; Kernel H at the fit's shape against plain; then the fit
    and kNN at world size 1 on part (b)'s 2.5M rows.  (b) Two gloo ranks
    on the card (1.25M rows each): the self-tests, the fit and the kNN,
    equal to world size 1 on the same rows (ids tie-aware, centroids
    within MNMG_CENTROID_ATOL, one iteration from the same centroids
    within MNMG_ONE_ITER_ATOL), each rank's ids global; the backend, the
    ops gloo ran on CUDA tensors and those it staged through the host,
    each collective's ms.  Returns H's ``also_checked`` entry."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="raft_mnmg_")
    try:
        return mnmg_parts(dev, smi_line, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mnmg_parts(dev, smi_line, tmp):
    """:func:`mnmg_path`'s two parts, their rendezvous files in ``tmp``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.cluster.kmeans import init_plus_plus
    from raft_tpu_torch.cluster.kmeans_types import InitMethod, KMeansParams
    from raft_tpu_torch.comms import CommsSession, launch
    from raft_tpu_torch.distributed import kmeans as dist_kmeans
    from raft_tpu_torch.neighbors import brute_force

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/a",
                            world_size=1, rank=0)
    try:
        session = CommsSession(device=dev).init()
        checks = self_tests(session)
        print(f"MNMG (a): backend {session.backend}, world size 1; "
              f"self-tests {json.dumps(checks)}", flush=True)
        assert all(checks.values()), f"a comms self-test failed: {checks}"
        X, Q = device_sift_like(MNMG_ROWS, MNMG_QUERIES, MNMG_DIM,
                                MNMG_LATENT, NOISE, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a = mnmg_run(session.worker_handle(seed=0), X, Q)
        peak = peak_gb()
        c, inertia, n_iter = a["fit"]
        shape = (f"MNMG k-means (BASELINE config 5): {MNMG_ROWS:,} x "
                 f"{MNMG_DIM} -> {MNMG_CLUSTERS:,}")
        assert a["h_launches"] == MNMG_ITERS + 1, (
            f"Kernel H launched {a['h_launches']} times in the fit, not "
            f"{MNMG_ITERS + 1}")
        assert c.shape == (MNMG_CLUSTERS, MNMG_DIM) and bool(
            torch.isfinite(c).all()) and 0 < inertia < float("inf")
        # the same ++ draw (a seed-0 handle's first), then the loop
        # without comms
        take = min(MNMG_ROWS, max(64 * MNMG_CLUSTERS, 16384))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c0 = init_plus_plus(DeviceResources(seed=0, device=dev), X[:take],
                            MNMG_CLUSTERS).float()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = lloyd_plain(X, c0, MNMG_ITERS, 0.0)
        torch.cuda.synchronize()
        plain_loop_s = time.perf_counter() - t0
        gap, rel = fit_agree("MNMG (a) fit", a["fit"], ref)
        flips, flip_gap = label_flips(X, c, ref[0])
        # one iteration from the same centroids: the sums' order only
        one_it = KMeansParams(n_clusters=MNMG_CLUSTERS, max_iter=1, tol=0.0,
                              init=InitMethod.Array)
        c1, inertia1, n1 = dist_kmeans.fit(session.worker_handle(seed=0),
                                           one_it, X, centroids=c0)
        gap1, rel1 = fit_agree("MNMG (a) one iteration",
                               (c1, float(inertia1), n1),
                               lloyd_plain(X, c0, 1, 0.0),
                               atol=MNMG_ONE_ITER_ATOL)
        del c1
        res = DeviceResources(seed=0, device=dev)
        ref_d, ref_i = brute_force.knn(res, X, Q, K, metric=0)
        same = knn_agree("MNMG (a) kNN", X, Q, *a["knn"], ref_d, ref_i)
        knn_s = median(a["knn_ms"]) / 1e3
        print(f"MNMG (a) {MNMG_ROWS:,} x {MNMG_DIM} -> {MNMG_CLUSTERS:,}: "
              f"fit {a['fit_s']:.3f} s (k-means++ on {take:,} rows alone "
              f"{init_s:.3f} s), n_iter {n_iter}, "
              f"{n_iter / a['fit_s']:.3f} iterations/s "
              f"({n_iter / max(a['fit_s'] - init_s, 1e-9):.3f} without the "
              f"++ init), inertia {inertia:.6e}; Kernel H launches in the "
              f"fit {a['h_launches']}; the loop without comms "
              f"{plain_loop_s:.3f} s, centroids within {gap:.3g}, inertia "
              f"within {rel:.3g} (relative; after one iteration "
              f"{gap1:.3g} and {rel1:.3g}); final labels differ on "
              f"{flips:,} of {MNMG_ROWS:,} rows, each within "
              f"{flip_gap:.3g} (relative) of a distance tie between its "
              f"two labels; kNN of {MNMG_QUERIES:,} at k "
              f"{K}: ms {', '.join(f'{m:.2f}' for m in a['knn_ms'])}, QPS "
              f"{MNMG_QUERIES / knn_s:.1f} (median), ids equal to "
              f"brute_force.knn at {same:.6f}; peak device memory "
              f"{peak:.2f} GB; nvidia-smi: {smi_line}", flush=True)
        h_entry = check_kernel_h_mnmg(X, c, a["h_launches"], shape)
        del X, Q, ref, ref_d, ref_i, c0, a
        torch.cuda.empty_cache()

        # world size 1 on part (b)'s rows, for (b) to equal
        rows = MNMG_RANKS * MNMG_RANK_ROWS
        Xb, Qb = device_sift_like(rows, MNMG_QUERIES, MNMG_DIM, MNMG_LATENT,
                                  NOISE, dev)
        one = mnmg_run(session.worker_handle(seed=0), Xb, Qb)
        c0b = init_plus_plus(DeviceResources(seed=0, device=dev),
                             Xb[:take], MNMG_CLUSTERS).float()
        c1b, inertia1b, n1b = dist_kmeans.fit(session.worker_handle(seed=0),
                                              one_it, Xb, centroids=c0b)
        one_iter_b = (c1b, float(inertia1b), n1b)
        session.destroy()
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    ranks = launch.spawn(mnmg_rank, MNMG_RANKS, f"{tmp}/b",
                         backend="gloo",
                         args=(rows, str(dev), c0b.cpu().numpy()),
                         timeout_s=MNMG_RANK_TIMEOUT_S, collective_s=120)
    spawn_s = time.perf_counter() - t0
    for r, out in enumerate(ranks):
        assert all(out["checks"].values()), (
            f"MNMG (b) rank {r}: a self-test failed: {out['checks']}")
        assert out["h_launches"] == MNMG_ITERS + 1, (
            f"MNMG (b) rank {r}: Kernel H launched {out['h_launches']}")
        np.testing.assert_array_equal(out["fit"][0], ranks[0]["fit"][0])
        np.testing.assert_array_equal(out["fit one"][0],
                                      ranks[0]["fit one"][0])
        np.testing.assert_array_equal(out["knn"][1], ranks[0]["knn"][1])
    ours = ranks[0]
    gap_b, rel_b = fit_agree(
        "MNMG (b) fit", (torch.from_numpy(ours["fit"][0]).to(dev),
                         *ours["fit"][1:]), one["fit"])
    gap1_b, rel1_b = fit_agree(
        "MNMG (b) one iteration", (torch.from_numpy(ours["fit one"][0])
                                   .to(dev), *ours["fit one"][1:]),
        one_iter_b, atol=MNMG_ONE_ITER_ATOL)
    flips_b, flip_gap_b = label_flips(
        Xb, torch.from_numpy(ours["fit"][0]).to(dev), one["fit"][0])
    d_b = torch.from_numpy(ours["knn"][0]).to(dev)
    i_b = torch.from_numpy(ours["knn"][1]).to(dev)
    same_b = knn_agree("MNMG (b) kNN", Xb, Qb, d_b, i_b, *one["knn"])
    half = (i_b >= MNMG_RANK_ROWS).float().mean()
    assert 0 < float(half) < 1, "MNMG (b): the ids come from one shard"
    iters = ours["fit"][2]
    per_iter = {op: f"{sum(ms) / len(ms):.3f} ms x {len(ms)}"
                for op, ms in ours["collective_ms"].items()}
    print(f"MNMG (b) {MNMG_RANKS} ranks on cuda:0, {MNMG_RANK_ROWS:,} rows "
          f"each ({rows:,} x {MNMG_DIM}): backend {ours['backend']}; ops "
          f"used {ours['used']}, staged through the host {ours['staged']}, "
          f"run by gloo on CUDA tensors "
          f"{sorted(set(ours['used']) - set(ours['staged']))}; "
          f"self-tests {json.dumps(ours['checks'])}; fit "
          f"{ours['fit_s']:.3f} s ({iters / ours['fit_s']:.3f} "
          f"iterations/s; world size 1 on the same rows {one['fit_s']:.3f} "
          f"s), centroids within {gap_b:.3g} of world size 1, inertia "
          f"within {rel_b:.3g} (after one iteration from the same "
          f"centroids {gap1_b:.3g} and {rel1_b:.3g}); final labels differ "
          f"on {flips_b:,} of {rows:,} rows, each within {flip_gap_b:.3g} "
          f"(relative) of a distance tie between its two labels; "
          f"collectives in the fit (mean ms a call x "
          f"calls, {iters} iterations) {json.dumps(per_iter)}; kNN QPS "
          f"{MNMG_QUERIES / (median(ours['knn_ms']) / 1e3):.1f} (world size "
          f"1: {MNMG_QUERIES / (median(one['knn_ms']) / 1e3):.1f}), ids "
          f"equal to world size 1 at {same_b:.6f}, "
          f"{100 * float(half):.1f}% from rank 1's rows; peak device memory "
          f"a rank {ours['peak_gb']:.2f} GB; ranks spawned and joined in "
          f"{spawn_s:.1f} s; nvidia-smi: {smi_line}", flush=True)
    return h_entry


# Phase 16, bench.py bench_distributed (bench.py:2531-2534, 2552-2558):
# DIST_ROWS_PER_DEV rows a device on its 8 devices, dim 96 from a 32-d
# latent (sift_like's generator), IVF-PQ with 512 lists a shard, pq_dim
# 48 (DIST_DIM // 2) and 5 k-means iterations, n_probes 32, 1,000 queries
# at k 10; none cut.  IVF-Flat (512 lists a shard, 32 probes) and CAGRA
# (raft_cagra.deg32, itopk 64, width 2) on the same rows.  Part (a): the
# whole 1,048,576 rows at world size 1 (NCCL); part (b): two gloo ranks on
# the card, 524,288 rows each
DIST_ROWS, DIST_DIM, DIST_LATENT = 131_072 * 8, 96, 32
DIST_LISTS, DIST_PQ_DIM, DIST_ITERS = 512, 48, 5
DIST_PROBES, DIST_QUERIES, DIST_RANKS = 32, 1_000, 2
DIST_CAGRA_POINT = (64, 2)
DIST_REPS = 3
# part (b)'s recall may fall below part (a)'s by this much (each shard
# probes 32 of its own 512 lists); below the floor a merge is broken
DIST_RECALL_SLACK, DIST_RECALL_FLOOR = 0.02, 0.5
DIST_ATOL = 1e-4
DIST_RANK_TIMEOUT_S = 300
# the kernel each search of the path runs, and the wrapper counting it
DIST_KERNELS = {"IVF-PQ auto": "merge_pairs", "IVF-PQ recon": "list_scan",
                "IVF-Flat": "flat_list_scan", "CAGRA": "cagra_walk"}


def dist_build(h, X):
    """The three by-row indexes over ``X`` through the handle's comms, and
    each build's seconds."""
    import torch
    from raft_tpu_torch.distributed import ann
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq

    builds = {
        "IVF-PQ": lambda: ann.build(h, ivf_pq.IndexParams(
            n_lists=DIST_LISTS, pq_dim=DIST_PQ_DIM,
            kmeans_n_iters=DIST_ITERS), X),
        "IVF-Flat": lambda: ann.build_flat(h, ivf_flat.IndexParams(
            n_lists=DIST_LISTS), X),
        "CAGRA": lambda: ann.build_cagra(h, cagra.IndexParams(
            graph_degree=CAGRA_DEGREE,
            intermediate_graph_degree=CAGRA_INTERMEDIATE), X)}
    out, secs = {}, {}
    for name, fn in builds.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    assert out["CAGRA"].use_walk, "distributed CAGRA: no walk table"
    return out, secs


def dist_searches(h, idx, Q):
    """Each search of the path (IVF-PQ at ``auto`` and ``recon``, IVF-Flat,
    CAGRA): a warm-up and DIST_REPS timed batches; the last result, the
    ms, and the launches each search kind made."""
    from raft_tpu_torch.distributed import ann
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq

    itopk, width = DIST_CAGRA_POINT
    calls = {
        "IVF-PQ auto": lambda: ann.search(h, ivf_pq.SearchParams(
            n_probes=DIST_PROBES), idx["IVF-PQ"], Q, K),
        "IVF-PQ recon": lambda: ann.search(h, ivf_pq.SearchParams(
            n_probes=DIST_PROBES, scan_mode="recon"), idx["IVF-PQ"], Q, K),
        "IVF-Flat": lambda: ann.search_flat(h, ivf_flat.SearchParams(
            n_probes=DIST_PROBES), idx["IVF-Flat"], Q, K),
        "CAGRA": lambda: ann.search_cagra(h, cagra.SearchParams(
            itopk_size=itopk, search_width=width), idx["CAGRA"], Q, K)}
    out = {}
    for name, fn in calls.items():
        before = read_launches()
        fn()
        ms, res = timed_searches(fn, DIST_REPS)
        after = read_launches()
        out[name] = {"result": res, "ms": ms,
                     "launches": {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}}
        assert out[name]["launches"].get(DIST_KERNELS[name], 0) > 0, (
            f"distributed {name}: {DIST_KERNELS[name]} never launched")
    return out


def dist_singles(idx, Q):
    """The single-index searches of this rank's shards at the path's
    operating points, without refine: IVF-PQ at ``auto`` and ``recon``,
    IVF-Flat (whose lists hold 512 slots or more here, so its search tiles
    one list at a time, as the shard-local scan does), and CAGRA on the
    walk table and entry set the sharded build attached to the shard (its
    local ids shifted by the shard's offset)."""
    import torch
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq

    res = DeviceResources(seed=0, device=Q.device)
    pq, flat = idx["IVF-PQ"].local, idx["IVF-Flat"].local
    assert ivf_flat.super_tile_factor(flat.capacity, flat.n_lists,
                                      DIST_PROBES)[0] == 1
    graph = idx["CAGRA"]
    itopk, width = DIST_CAGRA_POINT
    d_c, i_c = cagra.search(res, cagra.SearchParams(
        itopk_size=itopk, search_width=width), graph.local, Q, K)
    offset = graph.rank * graph.local.size
    return {"CAGRA": (d_c, torch.where(i_c >= 0, i_c + offset, i_c)),
        "IVF-PQ auto": ivf_pq.search(res, ivf_pq.SearchParams(
            n_probes=DIST_PROBES), pq, Q, K),
        "IVF-PQ recon": ivf_pq.search(res, ivf_pq.SearchParams(
            n_probes=DIST_PROBES, scan_mode="recon"), pq, Q, K),
        "IVF-Flat": ivf_flat.search(res, ivf_flat.SearchParams(
            n_probes=DIST_PROBES), flat, Q, K)}


def allgather_ms(comms, nq, reps=20):
    """Mean ms of one allgather of a (nq, k) candidate buffer (distances
    and ids alternately), each call between device synchronises."""
    import torch

    d = torch.zeros(nq, K, device=comms.device)
    i = torch.zeros(nq, K, dtype=torch.int32, device=comms.device)
    ms = []
    for r in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comms.allgather(d if r % 2 else i)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return sum(ms[1:]) / reps


def same_answer(label, got, ref, atol=DIST_ATOL):
    """(distances, ids) against a reference: ids equal, distances within
    ``atol``; returns the largest distance gap."""
    import numpy as np

    d, i = (np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in got)
    rd, ri = (np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in ref)
    assert np.array_equal(i, ri), (
        f"{label}: ids differ at {int((i != ri).sum())} ranks")
    fin = np.isfinite(rd)
    assert np.array_equal(fin, np.isfinite(d)), f"{label}: exhausted ranks"
    gap = float(np.abs(d[fin] - rd[fin]).max()) if fin.any() else 0.0
    assert gap <= atol, f"{label}: distances off by {gap}"
    return gap


def dist_host_merge(parts):
    """The ranks' (distances, ids) merged on the host, each query's best
    k by distance, ties in rank order (as the device merge breaks them)."""
    import numpy as np

    d = np.concatenate([p[0] for p in parts], 1)
    i = np.concatenate([p[1] for p in parts], 1)
    order = np.argsort(d, axis=1, kind="stable")[:, :K]
    return np.take_along_axis(d, order, 1), np.take_along_axis(i, order, 1)


def dist_kernel_checks(idx, Q, walks, launches):
    """Kernels B, G, F and I held to their plain versions at the shapes the
    distributed path gave them at world size 1 (the shard's index, its
    1,000 queries x 32 probes at k 10; the walk captured from the CAGRA
    search): one ``also_checked`` entry each, with the path's launches."""
    from raft_tpu_torch.neighbors.ivf_flat import _select_clusters
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_group_scan as pgs

    pq = idx["IVF-PQ"].local
    qrot = Q.float() @ pq.rotation
    probes = _select_clusters(pq.centers, qrot, DIST_PROBES, pq.metric)
    nq, rot = Q.shape[0], pq.rot_dim
    kt = min(K, pq.capacity)
    base = (qrot, pq.centers, probes, pq.list_recon, pq.list_recon_sq,
            pq.list_indices)
    b, g = check_scans(pq, qrot, probes, [
        ("ivf_pq_scan_fused", "pq_list_scan.cu",
         "raft_tpu/ops/pq_group_scan_pallas.py:410", pgs.ivf_pq_scan_fused,
         pgs.ivf_pq_scan_fused_plain, base + (K, kt), recon_rows_of(pq),
         pq.list_recon_sq, None, rot * 2 + 8, 0, nq * K * 8, rot),
        ("ivf_pq_scan_recon", "pq_list_scan.cu",
         "raft_tpu/ops/pq_group_scan_pallas.py:566", ps.ivf_pq_scan_recon,
         ps.ivf_pq_scan_recon_plain, base + (kt,), recon_rows_of(pq),
         pq.list_recon_sq, None, rot * 2 + 8, 0,
         nq * DIST_PROBES * kt * 8, rot)])
    f = check_kernel_f(idx["IVF-Flat"].local, Q, DIST_PROBES, K,
                       "distributed IVF-Flat at world size 1")
    itopk, width = DIST_CAGRA_POINT
    key = (nq, itopk, width, CAGRA_DEGREE)
    shape = (f"distributed by row at world size 1: {nq:,} queries, itopk "
             f"{itopk}, width {width}, deg {CAGRA_DEGREE}, "
             f"{DIST_ROWS:,} x {DIST_DIM}")
    walk = check_kernel_walk(*walks.kept[key], shape)
    where = (f"distributed by row at world size 1: {DIST_ROWS:,} x "
             f"{DIST_DIM}, {DIST_LISTS} lists, capacity {pq.capacity}, "
             f"{nq:,} queries x {DIST_PROBES} probes, k {K}")
    return {
        "B": at_shape(b, where + f", kt {kt}",
                      launches["IVF-PQ auto"]["merge_pairs"]),
        "G": at_shape(g, where + f" (recon), kt {kt}",
                      launches["IVF-PQ recon"]["list_scan"]),
        "F": at_shape(f, f"distributed IVF-Flat by row at world size 1: "
                      f"{DIST_ROWS:,} x {DIST_DIM}, {DIST_LISTS} lists, "
                      f"{nq:,} queries x {DIST_PROBES} probes, k {K}, "
                      f"F {f['F']}", launches["IVF-Flat"]["flat_list_scan"]),
        "I": at_shape(walk, shape, launches["CAGRA"]["cagra_walk"])}


def dist_summary(label, secs, runs, truth, ag_ms, smi_line):
    """Print each index's build seconds, QPS of a batch, recall@10 and the
    path's launches; returns the recalls."""
    import torch

    recalls = {}
    for name, run in runs.items():
        ids = run["result"][1]
        ids = torch.as_tensor(ids).to(truth.device)
        recalls[name] = recall_at(ids, truth)
        assert recalls[name] >= DIST_RECALL_FLOOR, (
            f"{label} {name}: recall@10 {recalls[name]} below "
            f"{DIST_RECALL_FLOOR}")
    print(f"{label}: build s {json.dumps({k: round(v, 3) for k, v in secs.items()})}; "
          + "; ".join(
              f"{name} QPS {DIST_QUERIES / (median(run['ms']) / 1e3):.1f} "
              f"(ms {', '.join(f'{m:.2f}' for m in run['ms'])}), recall@10 "
              f"{recalls[name]:.4f}, launches {json.dumps(run['launches'])}"
              for name, run in runs.items())
          + f"; allgather of a ({DIST_QUERIES:,}, {K}) buffer "
          f"{ag_ms:.3f} ms a call; nvidia-smi: {smi_line}", flush=True)
    return recalls


def dist_rank(rank, world, path, q, device):
    """Part (b)'s rank: on ``device`` beside the other rank, over the gloo
    default group the launcher made; the whole ``path`` array memory-mapped
    (each rank moves its own rows to the card).  The path's builds and
    searches (launches zeroed before, read after), this rank's
    single-index searches, a search with shard 1 failed, the allgather's
    ms.  Returns plain values for the parent."""
    import numpy as np
    import torch
    from raft_tpu_torch.comms import CommsSession
    from raft_tpu_torch.distributed import ann
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import _cuda

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    _cuda.library()                      # the parent built it: a load
    session = CommsSession(device=dev).init()
    h = session.worker_handle(seed=0)
    X = np.load(path, mmap_mode="r")
    Q = torch.from_numpy(q).to(dev)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    idx, secs = dist_build(h, X)
    runs = dist_searches(h, idx, Q)
    launches = read_launches()

    def host(out):
        return tuple(t.cpu().numpy() for t in out)

    singles = {name: host(out) for name, out in dist_singles(idx, Q).items()}
    failed = ann.search(h, ivf_pq.SearchParams(n_probes=DIST_PROBES),
                        idx["IVF-PQ"], Q, K, failed_shards=[1],
                        return_status=True)
    return {"backend": session.backend, "build_s": secs,
            "runs": {name: dict(run, result=host(run["result"]))
                     for name, run in runs.items()},
            "launches": launches, "singles": singles,
            "failed": host(failed), "allgather_ms": allgather_ms(
                session.comms(), DIST_QUERIES),
            "rows": (idx["IVF-PQ"].rank * (DIST_ROWS // world),
                     idx["IVF-PQ"].local.capacity),
            "peak_gb": peak_gb()}


def dist_path(dev, smi_line):
    """Phase 16: ``distributed.ann`` by row at bench_distributed's
    configuration.  (a) World size 1 over NCCL in this process: the three
    builds; IVF-PQ at ``auto`` (Kernel B) and ``recon`` (Kernel G) equal
    to ``ivf_pq``'s single-index search of the same shard at the same
    operating point (ids equal, distances within DIST_ATOL), IVF-Flat
    (Kernel F) to ``ivf_flat.search``'s, CAGRA's walk (Kernel I) to
    ``cagra.search``'s on the same table; each kernel held to its plain
    version at the path's shape.  (b) Two gloo
    ranks on the card: every search equal to the host merge of the ranks'
    single-index searches, shard 1 failed giving rank 0's answer with
    status [1, 0], each recall@10 within DIST_RECALL_SLACK of part (a)'s.
    Returns B, G, F and I's ``also_checked`` entries."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="raft_dist_")
    try:
        return dist_parts(dev, smi_line, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dist_parts(dev, smi_line, tmp):
    """:func:`dist_path`'s two parts, their files in ``tmp``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.comms import CommsSession, launch
    from raft_tpu_torch.neighbors import brute_force

    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    X, Q = sift_like(DIST_ROWS, DIST_QUERIES, DIST_DIM, DIST_LATENT, NOISE,
                     dev)
    truth = brute_force.knn(DeviceResources(seed=0, device=dev), X, Q,
                            K)[1]
    np.save(f"{tmp}/x.npy", X.cpu().numpy())
    data_s = time.perf_counter() - t0
    dist.init_process_group("nccl", init_method=f"file://{tmp}/a",
                            world_size=1, rank=0)
    try:
        session = CommsSession(device=dev).init()
        h = session.worker_handle(seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        idx, secs = dist_build(h, X)
        with WalkCapture() as walks:
            runs = dist_searches(h, idx, Q)
        launches = read_launches()
        peak = peak_gb()
        singles = dist_singles(idx, Q)
        gaps = {name: same_answer(f"distributed (a) {name}",
                                  runs[name]["result"], singles[name])
                for name in runs}
        ag_ms = allgather_ms(session.comms(), DIST_QUERIES)
        print(f"distributed (a): backend {session.backend}, world size 1, "
              f"{DIST_ROWS:,} x {DIST_DIM} (data and exact truth "
              f"{data_s:.1f} s); IVF-PQ capacity "
              f"{idx['IVF-PQ'].local.capacity}; the path's launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}; "
              f"equal to the single-index searches (ids equal, largest "
              f"distance gap {json.dumps(gaps)}); peak device memory "
              f"{peak:.2f} GB", flush=True)
        recall_a = dist_summary("distributed (a)", secs, runs, truth, ag_ms,
                                smi_line)
        entries = dist_kernel_checks(idx, Q, walks, {
            name: run["launches"] for name, run in runs.items()})
        session.destroy()
        del idx, runs, singles, walks
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    ranks = launch.spawn(dist_rank, DIST_RANKS, f"{tmp}/b", backend="gloo",
                         args=(f"{tmp}/x.npy", Q.cpu().numpy(), str(dev)),
                         timeout_s=DIST_RANK_TIMEOUT_S, collective_s=120)
    spawn_s = time.perf_counter() - t0
    per = DIST_ROWS // DIST_RANKS
    for r, out in enumerate(ranks):
        assert out["rows"][0] == r * per, f"distributed (b) rank {r}: rows"
        for name, run in out["runs"].items():
            for a, b in zip(run["result"], ranks[0]["runs"][name]["result"]):
                np.testing.assert_array_equal(a, b)
    ours = ranks[0]
    for name in ours["runs"]:
        same_answer(f"distributed (b) {name} against the host merge",
                    ours["runs"][name]["result"],
                    dist_host_merge([out["singles"][name] for out in ranks]))
    d_f, i_f, status = ours["failed"]
    assert status.tolist() == [1, 0], f"failed shard status {status}"
    assert (i_f < per).all(), "distributed (b): an id of the failed shard"
    same_answer("distributed (b) shard 1 failed", (d_f, i_f),
                ranks[0]["singles"]["IVF-PQ auto"])
    runs_b = {name: dict(run, result=tuple(torch.from_numpy(a)
                                           for a in run["result"]))
              for name, run in ours["runs"].items()}
    recall_b = dist_summary(
        f"distributed (b) {DIST_RANKS} gloo ranks on cuda:0, {per:,} rows "
        f"each", ours["build_s"], runs_b, truth, ours["allgather_ms"],
        smi_line)
    for name in recall_a:
        assert recall_b[name] >= recall_a[name] - DIST_RECALL_SLACK, (
            f"distributed (b) {name}: recall@10 {recall_b[name]} against "
            f"{recall_a[name]} at world size 1")
    share = float((ours["runs"]["IVF-PQ auto"]["result"][1] >= per).mean())
    assert 0 < share < 1, "distributed (b): the ids come from one shard"
    print(f"distributed (b): backend {ours['backend']}; every rank's answer "
          f"equal; IVF-PQ auto / recon, IVF-Flat and CAGRA equal to the host "
          f"merge of the ranks' single-index searches; shard 1 failed: status "
          f"{status.tolist()}, rank 0's answer; {100 * share:.1f}% of the "
          f"ids from rank 1's rows; recall@10 (b) against (a) "
          f"{json.dumps({k: [round(recall_b[k], 4), round(recall_a[k], 4)] for k in recall_a})}; "
          f"peak device memory a rank {ours['peak_gb']:.2f} GB; ranks "
          f"spawned and joined in {spawn_s:.1f} s; nvidia-smi: {smi_line}",
          flush=True)
    return entries


# Phase 17, bench.py bench_distributed's routed configuration (bench.py:
# 2531-2534, 2586-2636): phase 16's rows, IVF-PQ with 512 GLOBAL lists,
# pq_dim 48, 5 k-means iterations and the recon cache, 32 probes, 1,000
# queries at k 10, no refine; none cut.  Part (a): world size 1 over NCCL;
# part (b): four gloo ranks sharing the card, each loading the base the
# parent built and placing its lists at r = 1 and r = 2
ROUTED_RANKS = 4
ROUTED_WIDE_K = 100           # C past kt 64: the pair-group pass + merge
ROUTED_HEDGE_SEARCHES = 20
ROUTED_TRIPWIRE = 1.5         # the JAX package's most-scanned-shard bound
ROUTED_RANK_TIMEOUT_S = 300


class StubServer:
    """What readmission publishes through: anything with ``swap_index``."""

    def __init__(self):
        self.swapped = []

    def swap_index(self, index):
        self.swapped.append(index)


def routed_same(label, got, ref, atol=DIST_ATOL):
    """(distances, ids) against a reference: distances within ``atol`` at
    every rank, ids equal or at a distance tie (``ties_only``); returns
    the share of equal ids."""
    import torch

    d, i = (torch.as_tensor(x).cpu() for x in got[:2])
    rd, ri = (torch.as_tensor(x).cpu() for x in ref[:2])
    fin = torch.isfinite(rd)
    assert torch.equal(fin, torch.isfinite(d)), f"{label}: exhausted ranks"
    gap = float((d[fin] - rd[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert gap <= atol, f"{label}: distances off by {gap}"
    assert ties_only(d, i, ri, atol), f"{label}: ids differ off ties"
    return float((i == ri).float().mean())


def routed_bit_equal(label, got, ref):
    import numpy as np

    for a, b in zip(got[:2], ref[:2]):
        assert np.array_equal(np.asarray(a), np.asarray(b)), (
            f"{label}: not bit-identical")


def routed_part(base, rank):
    """Rank ``rank``'s part of ``base`` under a ROUTED_RANKS-shard LPT
    placement at r = 1 (what ``shard_by_list`` gives that rank), and the
    path's probes of ``Q`` as that rank scans them: its own lists at their
    local slots, every other probe the out-of-range sentinel."""
    from raft_tpu_torch.distributed import ann
    from raft_tpu_torch.neighbors import ivf_pq, mutate

    ivf_pq._with_code_rsq(base)
    p = ann.compute_placement(
        mutate.live_sizes(base.list_indices).cpu().numpy(), ROUTED_RANKS)
    return ann._place_lists(
        rank, (base.list_recon, base.list_recon_sq, base.list_indices,
               base.list_sizes), base.centers.float(), base.rotation.float(),
        p, base.metric, int(base.list_sizes.sum()),
        code_leaves=(base.codebooks.float(), base.list_codes,
                     base.list_code_rsq), pq_bits=base.pq_bits)


def routed_kernel_checks(base, Q):
    """Kernels B, G and C (k 10 and, past kt 64, k ROUTED_WIDE_K) held to
    their plain versions on rank 0's part of the 4-shard placement and its
    probes, about three in four of them sentinels; one row each."""
    from raft_tpu_torch.distributed import ann
    from raft_tpu_torch.ops import pair_scan as ps
    from raft_tpu_torch.ops import pq_code_scan as pcs
    from raft_tpu_torch.ops import pq_group_scan as pgs

    part = routed_part(base, 0)
    local = part.local
    qrot, probes = ann._routed_probes(part, Q, DIST_PROBES)
    lp, owned = ann._local_probes(part, ann._Route(()), probes)
    assert int((lp >= local.n_lists).sum()) > 0, "no sentinel probe"
    nq, rot, W = Q.shape[0], local.rot_dim, local.code_width
    cap, books = local.capacity, local.codebooks
    kt = min(K, cap)
    recon = (qrot, local.centers, lp, local.list_recon,
             local.list_recon_sq, local.list_indices)
    codes = (qrot, local.centers, lp, local.list_codes, books,
             local.list_code_rsq, local.list_indices, local.pq_bits)

    def decoded(slot):
        return pcs.decode_codes(local.list_codes.reshape(-1, W)[slot], books,
                                local.pq_bits).float()

    def c_spec(k):
        route = pcs.codes_fused_route(cap, rot, local.pq_dim, local.pq_bits,
                                      k, min(k, cap))[0]
        return ("ivf_pq_scan_codes_fused",
                {"list": "pq_code_list_scan.cu", "pair": "pair_list_scan.cu",
                 "query": "pq_code_scan.cu"}[route],
                "raft_tpu/ops/pq_code_scan_pallas.py:282",
                pcs.ivf_pq_scan_codes_fused, pcs.ivf_pq_scan_codes_fused_plain,
                codes + (k, min(k, cap)), decoded, local.list_code_rsq, None,
                W + 8, 2 * books.numel(), nq * k * 8, rot)

    rows = check_scans(local, qrot, lp, [
        ("ivf_pq_scan_fused", "pq_list_scan.cu",
         "raft_tpu/ops/pq_group_scan_pallas.py:410", pgs.ivf_pq_scan_fused,
         pgs.ivf_pq_scan_fused_plain, recon + (K, kt), recon_rows_of(local),
         local.list_recon_sq, None, rot * 2 + 8, 0, nq * K * 8, rot),
        ("ivf_pq_scan_recon", "pq_list_scan.cu",
         "raft_tpu/ops/pq_group_scan_pallas.py:566", ps.ivf_pq_scan_recon,
         ps.ivf_pq_scan_recon_plain, recon + (kt,), recon_rows_of(local),
         local.list_recon_sq, None, rot * 2 + 8, 0,
         nq * DIST_PROBES * kt * 8, rot),
        c_spec(K), c_spec(ROUTED_WIDE_K)])
    where = (f"routed, rank 0 of {ROUTED_RANKS} (r = 1): {DIST_ROWS:,} x "
             f"{DIST_DIM}, {local.n_lists - 1} of {DIST_LISTS} lists, "
             f"capacity {cap:,}, {nq:,} queries x {DIST_PROBES} probes, "
             f"{int(owned.sum()):,} of {lp.numel():,} pairs owned (the rest "
             f"sentinels)")
    return dict(zip(("B", "G", "C", "C wide"), rows)), where


def routed_rank(rank, world, base_path, q, device):
    """Part (b)'s rank: on ``device`` beside the other ranks, over the gloo
    default group the launcher made.  Loads the parent's base, places its
    lists at r = 1 and r = 2 (launches zeroed before, read after the
    healthy searches), then failover, a hedged straggler, catch-up and
    readmission of shard 2, and a serialize / deserialize round trip.
    Returns plain values for the parent."""
    import hashlib
    import io

    import numpy as np
    import torch
    from raft_tpu_torch.comms import CommsSession
    from raft_tpu_torch.distributed import ann, health
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import _cuda
    from raft_tpu_torch.resilience import faults

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    _cuda.library()                      # the parent built it: a load
    session = CommsSession(device=dev).init()
    h = session.worker_handle(seed=0)
    with open(base_path, "rb") as f:
        base = ivf_pq.deserialize(h, f)
    Q = torch.from_numpy(q).to(dev)

    def host(out):
        return tuple(t.cpu().numpy() if torch.is_tensor(t) else t
                     for t in out)

    def sp(mode="fused"):
        return ivf_pq.SearchParams(n_probes=DIST_PROBES, scan_mode=mode)

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = {r: ann.shard_by_list(h, base, replication_factor=r)
           for r in (1, 2)}
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    del base
    torch.cuda.empty_cache()
    runs = {}
    for r in (1, 2):
        for mode in ("recon", "fused"):
            def fn(r=r, mode=mode):
                return ann.search(h, sp(mode), idx[r], Q, K,
                                  return_status=True, return_stats=True)
            fn()
            ms, out = timed_searches(fn, DIST_REPS)
            runs[f"r{r} {mode}"] = {"result": host(out[:3]), "ms": ms,
                                    "stats": out[3]}
    launches = read_launches()
    probes = ann._routed_probes(idx[1], Q, DIST_PROBES)[1]
    out = {"runs": runs, "launches": launches, "place_s": place_s,
           "probes": hashlib.sha256(probes.cpu().numpy().tobytes())
           .hexdigest(),
           "allgather_ms": allgather_ms(session.comms(), DIST_QUERIES)}
    # shard 0 failed: covered at r = 2, degraded at r = 1
    for r in (1, 2):
        def failed(r=r):
            return ann.search(h, sp(), idx[r], Q, K, failed_shards=[0],
                              return_status=True)
        failed()
        ms, res = timed_searches(failed, DIST_REPS)
        out[f"failover r{r}"] = {"result": host(res), "ms": ms}
    # a hedged straggler: shard 1 scripted 10x the median search, the
    # shard deadline the median (rank 0's, on every rank)
    ms, _ = timed_searches(lambda: ann.search(h, sp(), idx[2], Q, K), 5)
    t_med = float(session.comms().bcast(torch.tensor(
        [median(ms) / 1e3], dtype=torch.float64), root=0)[0])
    deadline = max(t_med, 1e-3)
    plan = faults.FaultPlan(seed=17).straggle_shard(1, delay=10.0 * t_med)
    with plan.active():
        lat, res = timed_searches(lambda: ann.search(
            h, sp(), idx[2], Q, K, shard_deadline_s=deadline,
            return_status=True), ROUTED_HEDGE_SEARCHES)
    out["hedged"] = {"result": host(res), "ms": lat, "median_s": t_med,
                     "delay_s": 10.0 * t_med, "deadline_s": deadline}
    # catch-up and canary-gated readmission of shard 2
    tr = health.HealthTracker(ROUTED_RANKS, health.HealthConfig(
        suspect_after=1, fail_after=1, ok_to_clear=1))
    tr.note_timeout(2)
    tr.note_timeout(2)
    srv = StubServer()
    caught = health.catch_up(h, idx[2], 2, tracker=tr)
    ok = health.readmit(h, srv, caught, 2, tracker=tr)
    out["readmit"] = (ok, tr.state(2), len(srv.swapped),
                      caught.placement.generation
                      - idx[2].placement.generation,
                      host(ann.search(h, sp(), srv.swapped[-1], Q, K))
                      if srv.swapped else None)
    # the routed stream: the same bytes on every rank, read back
    buf = io.BytesIO()
    ann.serialize_routed(h, buf, idx[2])
    back = ann.deserialize_routed(h, io.BytesIO(buf.getvalue()))
    out["stream"] = (hashlib.sha256(buf.getvalue()).hexdigest(),
                     len(buf.getvalue()),
                     host(ann.search(h, sp(), back, Q, K)),
                     host(ann.search(h, sp("recon"), back, Q, K)))
    out["peak_gb"] = peak_gb()
    session.destroy()
    return out


def routed_path(dev, smi_line):
    """Phase 17: ``distributed.ann``'s routed placement at
    bench_distributed's routed configuration.  (a) World size 1 over NCCL
    in this process: ``build(placement="by_list")`` end to end; the
    routed ``recon`` (Kernel G) and ``fused`` (Kernel C) searches of the
    base's routed index equal to ``ivf_pq.search`` of the base at the
    same form (ids equal, distances within DIST_ATOL); ``fused`` without
    the code leaves (Kernel B) and at k ROUTED_WIDE_K (C past kt 64) held
    the same way; B, G and C held to their plain versions on a rank's
    probes with sentinels.  (b) ROUTED_RANKS gloo ranks on the card at r =
    1 and r = 2: the healthy answers equal to the single-index searches
    (ids equal or at a tie) and alike on every rank, every rank's probe
    set equal; r = 2 with shard 0 failed bit-identical with status 3, r =
    1 degraded; a hedged straggler's answer bit-identical, its p99 below
    the scripted delay; catch-up + readmit of shard 2; the stream round
    trip; the scanned-rows tripwire.  Returns the kernels' ``also_checked``
    entries (B, G, C, C past kt 64)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="raft_routed_")
    try:
        return routed_parts(dev, smi_line, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def routed_parts(dev, smi_line, tmp):
    """:func:`routed_path`'s two parts, their files in ``tmp``."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.comms import CommsSession, launch
    from raft_tpu_torch.distributed import ann
    from raft_tpu_torch.neighbors import brute_force, ivf_pq

    torch.cuda.set_device(dev)
    X, Q = sift_like(DIST_ROWS, DIST_QUERIES, DIST_DIM, DIST_LATENT, NOISE,
                     dev)
    res = DeviceResources(seed=0, device=dev)
    truth = brute_force.knn(res, X, Q, K)[1]
    params = ivf_pq.IndexParams(n_lists=DIST_LISTS, pq_dim=DIST_PQ_DIM,
                                kmeans_n_iters=DIST_ITERS,
                                cache_reconstructions=True)

    def sp(mode, **kw):
        return ivf_pq.SearchParams(n_probes=DIST_PROBES, scan_mode=mode,
                                   **kw)

    dist.init_process_group("nccl", init_method=f"file://{tmp}/a",
                            world_size=1, rank=0)
    try:
        session = CommsSession(device=dev).init()
        h = session.worker_handle(seed=0)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built = ann.build(h, params, X, placement="by_list")
        runs = {}
        for mode in ("recon", "fused"):
            def fn(mode=mode):
                return ann.search(h, sp(mode), built, Q, K,
                                  return_status=True, return_stats=True)
            if mode == "recon":
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
            fn()
            ms, out = timed_searches(fn, DIST_REPS)
            runs[mode] = {"result": out, "ms": ms}
        launches = read_launches()
        for name in ("kmeans_assign_update", "list_scan", "code_list_scan",
                     "merge_pairs"):
            assert launches[name] > 0, (
                f"routed (a): {name} never launched on the path")
        assert runs["fused"]["result"][3]["scan_mode"] == "fused_codes"
        assert runs["recon"]["result"][3]["scan_mode"] == "recon"
        recalls = {m: recall_at(torch.as_tensor(r["result"][1]).to(dev),
                                truth) for m, r in runs.items()}
        for m, rec in recalls.items():
            assert rec >= DIST_RECALL_FLOOR, f"routed (a) {m}: {rec}"
        del built
        torch.cuda.empty_cache()
        # the base the ranks load, and its routed index here
        base = ivf_pq.build(DeviceResources(seed=0, device=dev), params, X)
        with open(f"{tmp}/base.bin", "wb") as f:
            ivf_pq.serialize(res, f, base)
        routed = ann.shard_by_list(h, base)
        singles = {m: ivf_pq.search(res, sp(m), base, Q, K)
                   for m in ("recon", "fused", "auto")}
        singles["wide"] = ivf_pq.search(res, sp("fused"), base, Q,
                                        ROUTED_WIDE_K)
        gaps = {}
        for m in ("recon", "fused"):
            got = ann.search(h, sp(m), routed, Q, K)
            gaps[m] = same_answer(f"routed (a) {m}", got, singles[m])
        # no code leaves (a v1 stream's index): fused runs Kernel B
        recon_only = dataclasses.replace(
            routed, local=dataclasses.replace(
                routed.local, codebooks=None, list_codes=None,
                list_code_rsq=None))
        zero_launches()
        got = ann.search(h, sp("fused"), recon_only, Q, K,
                         return_stats=True)
        b_launches = read_launches()
        assert got[2]["scan_mode"] == "fused_recon", got[2]["scan_mode"]
        assert b_launches["code_list_scan"] == 0 < b_launches["list_scan"]
        gaps["fused, no code leaves (B)"] = same_answer(
            "routed (a) fused without code leaves", got[:2],
            singles["auto"])
        zero_launches()
        got = ann.search(h, sp("fused"), routed, Q, ROUTED_WIDE_K)
        wide_launches = read_launches()
        assert wide_launches["code_pair_list_scan"] > 0, (
            "routed (a) k 100: C's pair-group pass never launched")
        gaps[f"fused k {ROUTED_WIDE_K}"] = same_answer(
            f"routed (a) fused k {ROUTED_WIDE_K}", got, singles["wide"])
        ag_ms = allgather_ms(session.comms(), DIST_QUERIES)
        print(f"routed (a): backend {session.backend}, world size 1, "
              f"{DIST_ROWS:,} x {DIST_DIM}, {DIST_LISTS} global lists, "
              f"capacity {routed.capacity:,}; build(placement='by_list') "
              f"{build_s:.3f} s; QPS of {DIST_QUERIES:,} q: "
              + ", ".join(f"{m} {DIST_QUERIES / (median(r['ms']) / 1e3):.1f}"
                          f" (ms {', '.join(f'{x:.2f}' for x in r['ms'])}, "
                          f"recall@10 {recalls[m]:.4f})"
                          for m, r in runs.items())
              + f"; the path's launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}; "
              f"equal to ivf_pq.search of the base at the same form (ids "
              f"equal, largest distance gap {json.dumps(gaps)}); NCCL "
              f"allgather of a ({DIST_QUERIES:,}, {K}) buffer {ag_ms:.3f} "
              f"ms; nvidia-smi: {smi_line}", flush=True)
        checked, where = routed_kernel_checks(base, Q)
        singles = {m: tuple(t.cpu() for t in out)
                   for m, out in singles.items()}
        session.destroy()
        del routed, recon_only, base, X
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    ranks = launch.spawn(routed_rank, ROUTED_RANKS, f"{tmp}/b",
                         backend="gloo",
                         args=(f"{tmp}/base.bin", Q.cpu().numpy(), str(dev)),
                         timeout_s=ROUTED_RANK_TIMEOUT_S, collective_s=120)
    spawn_s = time.perf_counter() - t0
    ours = ranks[0]
    for r, out in enumerate(ranks):
        assert out["probes"] == ours["probes"], f"rank {r}: probe set"
        assert out["stream"][0] == ours["stream"][0], f"rank {r}: stream"
        for name, run in out["runs"].items():
            routed_bit_equal(f"routed (b) rank {r} {name}", run["result"],
                             ours["runs"][name]["result"])
    same = {}
    for name, run in ours["runs"].items():
        mode = name.split()[1]
        same[name] = routed_same(f"routed (b) {name}", run["result"],
                                 singles[mode])
        assert run["result"][2].tolist() == [1] * ROUTED_RANKS, name
        scanned = run["stats"]["scanned_rows"]
        probed = int(scanned.sum())
        assert scanned.max() <= ROUTED_TRIPWIRE * probed / ROUTED_RANKS, (
            f"routed (b) {name}: scanned rows {scanned.tolist()}")
    healthy = ours["runs"]["r2 fused"]["result"]
    covered = ours["failover r2"]["result"]
    routed_bit_equal("routed (b) r2, shard 0 failed", covered, healthy)
    assert covered[2].tolist() == [3, 1, 1, 1], covered[2]
    degraded = ours["failover r1"]["result"]
    assert degraded[2].tolist() == [0, 1, 1, 1], degraded[2]
    ids_h = torch.as_tensor(ours["runs"]["r1 fused"]["result"][1])
    degraded_recall = recall_at(torch.as_tensor(degraded[1]), ids_h)
    hedged = ours["hedged"]
    routed_bit_equal("routed (b) hedged straggler", hedged["result"],
                     healthy)
    assert hedged["result"][2].tolist() == [1, 3, 1, 1], hedged["result"][2]
    p99 = float(np.percentile(hedged["ms"], 99))
    assert p99 < 1e3 * hedged["delay_s"], (
        f"hedged p99 {p99} ms against the scripted {hedged['delay_s']} s")
    ok, state, swapped, placement_bump, published = ours["readmit"]
    assert (ok, state, swapped, placement_bump) == (True, "HEALTHY", 1, 1)
    routed_bit_equal("routed (b) readmitted", published, healthy)
    routed_bit_equal("routed (b) stream", ours["stream"][2], healthy)
    routed_bit_equal("routed (b) stream recon", ours["stream"][3],
                     ours["runs"]["r2 recon"]["result"])

    def qps(ms):
        return DIST_QUERIES / (median(ms) / 1e3)

    print(f"routed (b): {ROUTED_RANKS} gloo ranks on {dev}; every rank's "
          f"answers and probe set equal; placed in "
          f"{ours['place_s']:.3f} s (r = 1 and 2); QPS "
          + ", ".join(f"{name} {qps(run['ms']):.1f}"
                      for name, run in ours["runs"].items())
          + f"; shard 0 failed: r2 {qps(ours['failover r2']['ms']):.1f} QPS "
          f"bit-identical with status {covered[2].tolist()}, r1 "
          f"{qps(ours['failover r1']['ms']):.1f} QPS at recall@10 "
          f"{degraded_recall:.4f} against the healthy answer; hedged "
          f"straggler (delay {1e3 * hedged['delay_s']:.2f} ms, deadline "
          f"{1e3 * hedged['deadline_s']:.2f} ms): p99 {p99:.2f} ms, median "
          f"{median(hedged['ms']):.2f} ms, bit-identical; readmitted shard "
          f"2; stream {ours['stream'][1]:,} bytes, equal on every rank; "
          f"ids equal to the single-index searches at "
          f"{json.dumps({k: round(v, 5) for k, v in same.items()})} (the "
          f"rest at ties); scanned rows per shard "
          f"{json.dumps({k: v['stats']['scanned_rows'].tolist() for k, v in ours['runs'].items()})}; "
          f"gloo allgather {ours['allgather_ms']:.3f} ms; peak device memory "
          f"a rank {ours['peak_gb']:.2f} GB; ranks spawned and joined in "
          f"{spawn_s:.1f} s; nvidia-smi: {smi_line}", flush=True)
    launches_b = ours["launches"]
    return {
        "B": at_shape(checked["B"], where + f", k {K}, kt {K} (no code "
                      f"leaves; launches at world size 1)",
                      b_launches["merge_pairs"]),
        "G": at_shape(checked["G"], where + f" (recon), kt {K}",
                      launches_b["list_scan"]),
        "C": at_shape(checked["C"], where + f", k {K}, kt {K}",
                      launches_b["code_list_scan"]),
        "C wide": at_shape(checked["C wide"], where + f", k = kt = "
                           f"{ROUTED_WIDE_K} (launches at world size 1)",
                           wide_launches["code_pair_list_scan"])}


def main() -> int:
    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch import observability as obs
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine
    from raft_tpu_torch.ops import _cuda

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi_line = smi()
    print(f"device: {kind} x{count}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi_line}", flush=True)

    phase("build kernels")
    _cuda.library()
    print(f"build: {_cuda.build_seconds:.1f} s", flush=True)
    for kernel, regs, stores, loads in _cuda.ptxas_usage(
            "fused_l2_nn.cu", "nn_tf32_kernel"):
        print(f"ptxas: {kernel}: {regs} registers, spill stores {stores} "
              f"B, spill loads {loads} B", flush=True)
    # C7519: ptxas fenced a wgmma's accumulators to let other code use
    # their registers (it serializes the products)
    print("ptxas C7519 remarks: " + ", ".join(
        f"{src} {_cuda.build_logs.get(src, '').count('C7519')}"
        for src in ("fused_l2_nn.cu", "kmeans_update.cu",
                    "flat_list_scan.cu", "pair_list_scan.cu")), flush=True)
    # the pair-group pass's instantiations: <resident, extract, filter>,
    # the recon kernel's led by its row source (0: G's bf16 rows, 1: D and
    # E's built rows)
    for kernel, regs, stores, loads in _cuda.ptxas_usage(
            "pair_list_scan.cu", "pair_kernel"):
        found = re.search(
            r"((?:flat|recon)_pair_kernel)I((?:Li\d+E)?(?:Lb[01]E)+)E",
            kernel)
        flags = "" if found is None else ",".join(
            re.findall(r"L[ib](\d+)E", found.group(2)))
        name = kernel if found is None else f"{found.group(1)}<{flags}>"
        print(f"ptxas: {name}: {regs} registers, spill stores {stores} B, "
              f"spill loads {loads} B", flush=True)
    # Kernel I's instantiations: walk_kernel<threads, staged, int8, filter,
    # exact>, hop_kernel<threads, 16-byte rows>
    for src, name in (("cagra_walk.cu", "walk_kernel"),
                      ("cagra_hop.cu", "hop_kernel")):
        for kernel, regs, stores, loads in _cuda.ptxas_usage(src, name):
            print(f"ptxas: {ptxas_template(kernel)}: {regs} registers, spill "
                  f"stores {stores} B, spill loads {loads} B", flush=True)
    global LOAD_NS
    LOAD_NS = load_latency_ns(torch.device("cuda", 0))
    print(f"dependent device-memory load (pointer chase over 256 MB): "
          f"{LOAD_NS:.1f} ns", flush=True)
    validator_first_call(torch.device("cuda", 0))

    dev = torch.device("cuda", 0)
    db, queries = sift_like(N_DB, N_QUERIES, DIM, LATENT, NOISE, dev)

    phase("kernel A vs plain (first Lloyd pass of the flagship fit)")
    # the build's first draw from a seed-0 handle is this trainset, and
    # the fit starts from these strided centroids
    probe_res = DeviceResources(seed=0)
    n_train = int(N_DB * ivf_pq.IndexParams().kmeans_trainset_fraction)
    sel = torch.randperm(N_DB, generator=probe_res.generator,
                         device=dev)[:n_train]
    train = db[sel]
    c0 = train[::max(n_train // N_LISTS, 1)][:N_LISTS].contiguous()
    row_a = check_kernel_a(train, c0, f"{n_train:,} x {DIM} -> {N_LISTS:,}")
    del train, sel

    phase("main path: IVF-PQ build + search + refine at full width")
    res = DeviceResources(seed=0)
    params = ivf_pq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM)
    sp = ivf_pq.SearchParams(n_probes=N_PROBES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    fallbacks = ivf_pq.search.fused_fallbacks
    t0 = time.perf_counter()
    # built under observability collection: phase 4b reads its report
    with obs.collecting():
        index = ivf_pq.build(res, params, db)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_stages = dict(ivf_pq.build.stage_seconds)
    batch_ms, search_ms = [], []
    for _ in range(SEARCH_REPS):
        t0 = time.perf_counter()
        _, cand = ivf_pq.search(res, sp, index, queries, K_SEARCH)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, found = refine(res, db, queries, cand, K)
        torch.cuda.synchronize()
        search_ms.append(1e3 * (t1 - t0))
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_launches()
    fallbacks = ivf_pq.search.fused_fallbacks - fallbacks
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, truth = brute_force.knn(res, db, queries, K)
    hits = (found[:, :, None] == truth[:, None, :]).any(2).sum()
    recall = float(hits) / truth.numel()
    med_ms = sorted(batch_ms)[len(batch_ms) // 2]
    print(f"index: {index.n_lists} lists, capacity {index.capacity}, "
          f"{index.size} rows, pq_dim {index.pq_dim}", flush=True)
    print(f"build: {build_s:.2f} s; stages (s): {json.dumps(build_stages)}",
          flush=True)
    print(f"search ms per batch of {N_QUERIES}: "
          f"{', '.join(f'{m:.2f}' for m in search_ms)}", flush=True)
    print(f"search+refine ms per batch of {N_QUERIES}: "
          f"{', '.join(f'{m:.2f}' for m in batch_ms)}; "
          f"QPS {N_QUERIES / (med_ms / 1e3):.0f} (median)", flush=True)
    print(f"recall@10: {recall:.4f}", flush=True)
    print(f"peak device memory: {peak_gb:.2f} GB", flush=True)
    print(f"launches on the main path: {json.dumps(launches)}", flush=True)
    for name in ("kmeans_assign_update", "list_scan", "merge_pairs",
                 "fused_l2_nn", "fused_l2_nn_batched"):
        assert launches[name] > 0, (
            f"{name} was never launched on the main path")
    assert fallbacks == 0, "Kernel B's gate refused the main path's search"
    assert recall >= 0.90, f"recall@10 {recall} below the 0.90 floor"
    # the search alone tells its validation from refine's, whose host
    # sync waits for the search's kernels before refine's work is queued
    policy_cost(f"search + refine (batch of {N_QUERIES})", lambda:
                refine(res, db, queries, ivf_pq.search(
                    res, sp, index, queries, K_SEARCH)[1], K))
    policy_cost(f"search alone (batch of {N_QUERIES})", lambda:
                ivf_pq.search(res, sp, index, queries, K_SEARCH))

    phase("host-side subsystems on the flagship: the no-fence contract, "
          "the build report, a request trace, the delta memtable, verify")
    t0 = time.perf_counter()
    host_side_path(res, index, db, queries, sp, build_stages, smi_line)
    host_side_s = time.perf_counter() - t0
    print(f"host-side subsystems phase: {host_side_s:.1f} s", flush=True)

    phase("serving the flagship: core/aot bucket graphs, the batcher and "
          "Server, brownout, ingest, shadow recall and the rebalancer")
    served_b, served_g = serving_path(res, index, db, queries, truth,
                                      smi_line)
    torch.cuda.empty_cache()

    phase("kernel B vs plain (the main path's batch on the built index; "
          "past kt 64 G's pair-group pass + the merge)")
    row_b = check_kernel_b(index, queries)
    pq_same_build_routes(res, index, db, queries, truth, "flagship auto",
                         sp, True)
    b_query_major = check_query_major(index, queries, LARGE_KT_QUERIES, True)

    phase("kernel H vs plain at the flagship build's shapes")
    h_more = [h_check(db @ index.rotation, index.centers,
                      f"flagship extend: {N_DB:,} x {DIM} -> {N_LISTS:,}",
                      h_tf32_launches(launches), block_sizes=True)]
    # the small-dim kernel on the main path: the codebook loop's batched
    # launch (B = pq_dim); the one-member call beside it
    row_hs = dict(batched_h_check(index, db, "subspace", "flagship"),
                  launches=launches["fused_l2_nn_batched"])
    assert row_hs["launches"] > 0, (
        "the small-dim kernel was never launched on the main path")
    one = codebook_h_check(index, db, "flagship")
    hs_one = at_shape(one, one["shape"] + " (one member, fused_l2_nn)",
                      launches["fused_l2_nn_small_dim"])

    phase("IVF-PQ recon mode: scan_mode='recon', n_probes 96, k 20 -> 10")
    sp_recon = ivf_pq.SearchParams(n_probes=N_PROBES, scan_mode="recon")
    recon = search_mode(res, index, db, queries, truth, "flagship recon",
                        sp_recon, "list_scan")
    pq_same_build_routes(res, index, db, queries, truth, "flagship recon",
                         sp_recon, False)
    assert recon["recall"] >= 0.90, (
        f"flagship recon recall@10 {recon['recall']} below 0.90")
    row_g = dict(check_kernel_g(index, queries, K_SEARCH),
                 launches=recon["launches"]["list_scan"])
    g_query_major = check_query_major(index, queries, LARGE_KT_QUERIES,
                                      False)

    phase("kernels C and D on the flagship's codes (rot 128, 8 bits)")
    c_flag, d_flag = flagship_code_checks(index, queries)
    d_flag += codes_past_smem_checks(dev)

    phase("the rest of IVF-PQ on the flagship index: the LUT scan and the "
          "list-data helpers")
    lut_runs = lut_path(res, index, db, queries, truth)
    helpers_check(res, index, queries)

    phase("per-cluster codebooks at the flagship's width")
    hs_cluster, pc_runs = per_cluster_path(db, queries, truth, build_stages,
                                           launches)

    phase("where the time goes (one build, one batch, under the profiler)")
    del index
    device_breakdown("build", lambda: ivf_pq.build(
        DeviceResources(seed=0), params, db))
    index = ivf_pq.build(DeviceResources(seed=0), params, db)
    device_breakdown("search+refine batch", lambda: refine(
        res, db, queries, ivf_pq.search(res, sp, index, queries,
                                        K_SEARCH)[1], K),
        ranges=("raft_tpu:ivf_pq::search", "raft_tpu:refine"))
    del cand, found
    torch.cuda.empty_cache()

    phase("IVF-Flat at full width: sift-like-1m, nlist 4096 and 16384")
    row_f, row_fp, a_flat, h_flat, flat_indexes = ivf_flat_path(db, queries,
                                                                truth)

    t0 = time.perf_counter()
    verify_timed("IVF-Flat nlist 4096", flat_indexes[1], smi_line)
    host_side_s += time.perf_counter() - t0

    phase("select_k: the JAX package's tie order against torch.topk alone "
          "on the card paths that call it")
    select_k_card_route(dev, smi_line)
    select_k_turns(res, index, flat_indexes[1], db, queries, sp, smi_line)

    phase("k-means at full width: 1M x 128 -> 1024 (BASELINE config 3)")
    row_h, a_kmeans = kmeans_path(db)

    phase("profiles: the round-5 decompositions (kernel table rows 10-13)")
    rows_profiles = profiles_path(dev, index, queries, flat_indexes)

    phase("persistence at full width: save / load / search, corruption, "
          "checkpointed flagship build")
    t0 = time.perf_counter()
    persisted = persistence_path(res, index, flat_indexes[1], db, queries,
                                 truth, params, sp)
    persist_s = time.perf_counter() - t0

    phase("filtered and mutable indexes at full width: the flagship and "
          "IVF-Flat nlist 4096")
    t0 = time.perf_counter()
    filters, truths, pq_rows, f_row, pq_runs, flat_runs, mutated, wide = \
        filtered_phase(res, index, flat_indexes[1], db, queries)
    filtered_s = time.perf_counter() - t0
    del index, flat_indexes
    torch.cuda.empty_cache()

    phase("CAGRA at full width: sift-like-1m, raft_cagra.deg32")
    row_walk, row_i, cagra_index, cagra_recall = cagra_path(db, queries,
                                                            truth)

    t0 = time.perf_counter()
    verify_timed("CAGRA deg32", cagra_index, smi_line)
    host_side_s += time.perf_counter() - t0
    print(f"host-side subsystems, all their checks: {host_side_s:.1f} s",
          flush=True)

    phase("CAGRA deg32: the direct walk (walk_pdim=0) and hops past 256")
    t0 = time.perf_counter()
    rest_walks, rest_hops, rest_runs = cagra_rest_path(
        cagra_index, queries, truth, cagra_recall[(128, 2)])
    print(f"CAGRA direct walk and wide hops: {time.perf_counter() - t0:.1f} "
          f"s; nvidia-smi: {smi_line}", flush=True)

    phase("filtered and mutable indexes at full width: CAGRA deg32")
    t0 = time.perf_counter()
    walk_f, walk_launches = filtered_cagra(
        DeviceResources(seed=0), cagra_index, queries, filters, truths)
    filtered_s += time.perf_counter() - t0
    print(f"filtered and mutable phase: {filtered_s:.1f} s; flagship "
          f"mutation {json.dumps(mutated)}; nvidia-smi: {smi_line}",
          flush=True)
    del filters, truths
    torch.cuda.empty_cache()

    phase("persistence at full width: CAGRA deg32")
    t0 = time.perf_counter()
    persisted.update(cagra_persistence(db, queries, cagra_index))
    persist_s += time.perf_counter() - t0
    print(f"persistence phase: {persist_s:.1f} s; {json.dumps(persisted)}; "
          f"nvidia-smi: {smi_line}", flush=True)
    del cagra_index, db, queries, truth
    torch.cuda.empty_cache()

    phase("deep path at full width: 10M x 96, n_lists 8192, pq_dim 48")
    (rows_cde, rows_cde_pair, a_deep, b_deep, g_deep, h_deep, hs_deep, rest,
     deep_data) = deep_path(dev)
    rest.update({"flagship lut": lut_runs, "per-cluster flagship": pc_runs})
    print(f"the rest of IVF-PQ (ms a batch, recall@10): {json.dumps(rest)}; "
          f"nvidia-smi: {smi_line}", flush=True)
    torch.cuda.empty_cache()

    phase("deep-cagra-10m at full width: 10M x 96, raft_cagra.deg32 "
          "(the deep-regime build, the conf's four search points)")
    t0 = time.perf_counter()
    deep_walks, deep_cagra = deep_cagra_path(*deep_data)
    del deep_data
    torch.cuda.empty_cache()
    print(f"deep-cagra-10m: {time.perf_counter() - t0:.1f} s; "
          f"{json.dumps(deep_cagra)}; nvidia-smi: {smi_line}", flush=True)

    phase("distributed: comms self-tests and MNMG k-means + kNN (BASELINE "
          "config 5)")
    t0 = time.perf_counter()
    h_mnmg = mnmg_path(dev, smi_line)
    print(f"distributed phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    phase("distributed by row: sharded IVF-PQ, IVF-Flat and CAGRA "
          "(bench.py bench_distributed)")
    t0 = time.perf_counter()
    by_row = dist_path(dev, smi_line)
    print(f"distributed by-row phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()

    phase("distributed, routed: index-parallel IVF-PQ with replicas, "
          "failover, hedged reads and readmission (bench.py "
          "bench_distributed)")
    t0 = time.perf_counter()
    routed = routed_path(dev, smi_line)
    print(f"distributed routed phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()

    phase("result")
    rows_cde[0]["also_checked"] += c_flag + [routed["C"]]
    rows_cde_pair[0]["also_checked"].append(routed["C wide"])
    rows_cde[1]["also_checked"] += d_flag
    half_launches = pq_runs["50% per query"][2]
    b_f, g_f = pq_rows
    b_filtered = at_shape(
        b_f, f"filtered, 50% per query ({N_QUERIES * -(-N_DB // 32) * 4:,} "
        f"bytes of words): flagship, {N_QUERIES:,} queries x {N_PROBES} "
        f"probes, k {K_SEARCH}, kt {K_SEARCH}", half_launches["merge_pairs"])
    g_filtered = at_shape(
        g_f, f"filtered, 50% per query: flagship recon, {N_QUERIES:,} "
        f"queries x {N_PROBES} probes, kt {K_SEARCH} (no filtered recon "
        f"search on the path)", 0)
    row_f["also_checked"].append(at_shape(
        f_row, f"filtered, 50% per query: nlist 4096, {N_QUERIES:,} queries "
        f"x {FLAT_CHECK_PROBES} probes, k {K}, F {f_row['F']}",
        flat_runs["50% per query"][2]["flat_list_scan"]))
    row_f["also_checked"].append(by_row["F"])
    # the pair-group pass's rows: their main entry the unfiltered k-100
    # batch (a path of its own: launches zeroed before it and read after),
    # its launches and the check on that batch's own scan inputs; the
    # 1,000-query checks under also_checked, each with its own launches
    row_fp = dict(wide["F_full"], name="flat_pair_list_scan",
                  also_checked=[at_shape(row_fp, row_fp["shape"],
                                         row_fp["launches"])]
                  + row_fp["also_checked"] + [wide["F"]])
    row_gp = dict(wide["G_full"], name="recon_pair_list_scan", route="cuda",
                  replaces="raft_tpu/ops/pq_group_scan_pallas.py:566",
                  also_checked=[g_query_major, wide["G"]])
    # Kernel B past kt 64 (G's pass + the merge): its main entry the
    # unfiltered auto k-200 batch, its launches the merge's there
    row_bp = dict(wide["B_full"], name="ivf_pq_scan_fused (B past kt 64)",
                  route="cuda",
                  replaces="raft_tpu/ops/pq_group_scan_pallas.py:410",
                  also_checked=[b_query_major, wide["B"]])
    for row in (row_fp, row_gp, row_bp, *rows_cde_pair):
        assert row["launches"] > 0, f"{row['name']}: never launched"
    row_walk["also_checked"].append(at_shape(
        walk_f, f"filtered, 50% per query: {N_QUERIES:,} queries, itopk 64, "
        f"width 2, deg {CAGRA_DEGREE}", walk_launches["cagra_walk"]))
    row_walk["also_checked"] += rest_walks + deep_walks + [by_row["I"]]
    row_i["also_checked"] += rest_hops
    print(f"CAGRA runs past the walk table and past 256: "
          f"{json.dumps({str(k): v for k, v in rest_runs.items()})}",
          flush=True)
    row_g["also_checked"] = [g_deep, g_filtered, served_g, by_row["G"],
                             routed["G"]]
    row_h["also_checked"] += h_more + h_flat + h_deep + [h_mnmg]
    row_hs["also_checked"] = [hs_cluster, hs_one, hs_deep]
    rows = [dict(row_a, launches=launches["kmeans_assign_update"],
                 also_checked=a_deep + a_flat + [a_kmeans]),
            dict(row_b, launches=launches["merge_pairs"],
                 pass1_launches=launches["list_scan"],
                 also_checked=[b_deep, b_filtered, served_b, by_row["B"],
                               routed["B"]])] + \
        rows_cde + [
                     row_f, row_g, row_fp, row_gp, row_bp, *rows_cde_pair,
                     row_h, row_hs, row_i, row_walk] + \
        rows_profiles
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"nvidia-smi: {smi_line}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
