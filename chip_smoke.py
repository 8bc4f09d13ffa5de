#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, ``nvcc``
under ``/usr/local/cuda`` and PyTorch built for CUDA.  It imports nothing
of JAX or of the JAX package.  Before its first CUDA call it takes the
port's card mutex (``utils/chiplock.py``: ``chip_lock(max_wait=60)``) and
holds it for the whole run, printing ``chip_lock: {...}`` (its
``as_fields()``); a lock still held by another process after 60 s is
recorded there and the run goes on.  Phases (any failure raises; exit
code 1):

1. build: compile every kernel of ``dat_replication_protocol_tpu_torch``
   from ``csrc/`` with ``nvcc`` (one process per source, all started
   together) and print the card's name and power limit; the bring-up
   and the build run inside ``obs.BackendInitWatchdog`` (telemetry off),
   whose stage timeline is printed.  Beside it, in a thread, ``g++``
   builds the two host libraries of the native codec route from
   ``native/`` (``dat_native``, ``dat_fastpath`` against this
   interpreter's ``Python.h``); their build seconds, the host's ``g++``
   version, whether ``triton`` imports and which batched syscalls the
   wire pump finds (``dat_pump_probe``: ``recvmmsg``, ``sendmmsg``) are
   printed;
2. kernels against their plain PyTorch versions on the card, byte-exact:
   both variants of B1 (batched BLAKE2b: one thread or four lanes per
   item) at edge lengths across four buckets and on buckets of 1, 31, 32
   and 33 items, also against ``hashlib``, and against ``hashlib`` on an
   item of 8,192 blocks; B2 (Merkle level) on 2^16 random leaves;
3. the digest session at BASELINE.json configs[2]'s item width (1 MiB
   blobs): the port's Encoder writes 2,048 blobs of 1 MiB and 65,536
   changes with 40-200-byte values, one ``change`` call each (the blob
   count is cut from 10k to fit the run's time limit),
   ``decode(backend="cuda")`` consumes it through ``pipe`` on the native
   route and every digest is held against ``hashlib``; then the same
   records with each blob's 32 changes as one ``change_many`` run (the
   same wire, which reaches the decoder's bulk index and C change loop:
   the C runs and the frames they covered are printed), whose digests
   must be the first session's; that wire, in the writes the pipe made,
   into a decoder on each route (``native=True``, ``native=False``),
   whose digests must be the same again, in order; both sessions at 256
   blobs in five alternating turns (medians and their ratio); a 256-blob
   repeat of each session under ``torch.profiler`` gives the device time by
   kernel and the busy share (the spans' device ranges printed apart,
   not counted); then a short session through ``sidecar.run_session``
   over an in-memory byte pair.  Then the wire pump (``session/pump.py``),
   the same traffic on both routes: (a) 256 x (32 ``change()`` records +
   one 1 MiB blob), about 256 MiB, through ``sidecar.run_session`` over
   loopback TCP with ``rx_fd``/``tx_fd`` (the batched route:
   ``recv_pump``, the gather writer) and with the socket's callables only
   (the plain Python pump), five alternating turns with the obs gate
   off: every reply digest equal to ``hashlib``'s in submit order, both
   routes' GiB/s, medians and their ratio; then one gated turn a route
   (the one place before phase 13 with the gate on) for the
   ``transport.pump.*`` counters and ``transport.pump.native.seconds``
   (the plain route's must be 0); (b) a 64 MiB wire to 8 fd peers on
   socketpairs, each drained by a reader that hashes it, through
   ``FanoutServer(native=True)`` and ``native=False`` in turns N P P N:
   every peer's length and BLAKE2b the wire's, MiB/s a route, and on a
   gated native turn ``transport.pump.gather.bytes`` ==
   ``fanout.sent.bytes``; (c) ``io_for_socket``'s batched writer to a
   peer that never reads, ``SO_SNDTIMEO`` 0.5 s: ``OSError(EAGAIN)``
   within 5 s (the JAX package's writer retries forever).  Every socket
   and fd path of the later phases runs on the batched route;
4. ``entry()`` at BASELINE.json configs[4]'s width: 2^20 payloads hashed
   and folded to a Merkle root, held against ``root_host``;
5. times on the device alone (a CUDA graph of the launches): B1
   at the session's blob and change buckets and at ``entry()``'s launch,
   each variant, the blob bucket also under a cold L2, and B2 at
   ``entry()``'s first level, beside their plain versions and their
   bounds; the blob bucket is held against ``hashlib`` whole and against
   its plain version on its 32 items' first 1,024 blocks (the plain
   version costs the host about 9 ms a block, whatever the items).  B1's bound is the largest of bytes, operations (walked from
   its SASS) and the chain: the longest item's blocks x the dependent
   path of one compression (from its SASS) x the dependent-issue latency
   of the integer pipes, which the probe ``csrc/chain_latency.cu``
   measures on the card; B2's operation bound is walked from its SASS;
6. the gear kernels B3-B6 against their plain versions on the card,
   byte-exact, at 64 rows of 128 KiB + 256 B (avg_bits 13, thin_bits 11)
   and at the tests' shape (2,048 B rows, avg_bits 8, thin_bits 9), for a
   stream head, a ragged last tile, a slab with real context and an
   all-zero row; B5 must equal B3's window reduction, B6 B5, viol 0;
   then the edges of B4's staged scan and of the window scan that B5 and
   B6 share: candidates planted in the first and last byte of spans and
   of a row's payload and only in a span's warm-up halo, a row count
   whose spans are not a multiple of the CTAs, B5 and B6 at thin_bits 8,
   11 and 16, B5 against its plain version, B6's ``first`` and the window
   reduction of B3 and B4, B6's ``occ`` against the OR of B3's words;
7. ``content_address`` at the reference's chunk parameters (avg_bits
   13, chunks of 2-32 KiB, 128 KiB tiles) over a 1.5 GiB blob made from
   the seed, on each of the four extraction routes: single residency,
   digests held against ``hashlib``, the root against ``root_host``,
   every chosen cut against a numpy window hash, chunk sizes against
   [min, max], identical cuts on all routes and no ``fused1p``
   refusal; then ``delta``/``reassemble`` of an edited copy; the chunk
   counts, both roots and the delta must equal the JAX package's
   (``REFERENCE``, from ``cdc_reference_witness.py``); the greedy cut
   pass (``cdc.greedy``) over the bitmask route's candidates is timed
   on the native route (``dat_greedy_select``) and the Python route,
   whose cuts must be equal;
8. ``chunk_stream`` over BASELINE.json configs[3]'s 10 GiB blob (phase
   7's blob is its first 1.5 GiB) in 1 GiB slabs: the same cut checks,
   and its cuts below 1.5 GiB - 32 KiB equal phase 7's; then
   ``content_address`` over the blob's first ``RESIDENCY_CAP`` + 64 MiB
   (2 GiB), which must take the slabbed route (its ``cdc.hash`` engine
   note ``two-pass-cuda``: ``chunk_stream``, ``hash_extents`` from
   256 MiB windows of the host buffer past 2^31 - 2^26, ``root_host``):
   every chunk digest against ``hashlib`` (on threads), the root against
   ``root_host``, the same cut checks, and its cuts below 1.5 GiB - 32
   KiB equal phase 7's;
9. times: B1 at phase 7's largest chunk bucket (each variant, as in
   phase 5), B1's main-path launches by bucket (blob, change, sidecar,
   ``entry()``, chunk, phase 8's slabbed chunks and each later phase's),
   and B3-B6 on a 1 GiB slab, each held byte-exact
   against its plain version there (B6 with viol 0), timed in turns
   beside the plain versions' times, the bounds and their registers.
   The operation bounds walk the SASS of the built libraries
   (``cuobjdump -sass``) and count what each pipe issues, the staged
   B4's per span and CTA.  B3 (the one-thread scan of ``gear.cuh``) is
   B4's control; B5 is B6's window scan without the occupancy fold.  B4
   and B6 also get the bound of the same work as B3 and B5 issue it, the
   smaller of the two counting; B3 and B5 count their own;
10. reconciliation at BASELINE.json configs[4]'s width: two snapshots
   of 2^20 change records (40-200-byte values, the port's change codec,
   hashed by ``feed.hash_extents_device`` on B1), B with 1% of the
   values rewritten; ``diff_snapshots`` and ``diff_root_guided_packed``
   over the 2^21 concatenated leaves (20 B2 levels) must equal a dense
   compare and the rewritten rows, both roots ``root_host``;
   ``update_leaves`` of 1,024 leaves must equal a rebuild and leave its
   input unchanged; 64 proofs must verify and a flipped byte or a wrong
   index must not; ``LogSummary``/``reconcile`` of 1M + 1M + 1,000
   records (bench.py bench_merkle's shape, 2^21 slots) must equal
   ``hashlib`` + ``np.add.at`` and find exactly the inserted keys'
   slots, and ``tree_sync`` over the two tables' B2 trees the same
   slots; coded symbols of 2^20 digests against a set with k = 1,000
   (500 only on each side) must decode exactly the symmetric
   difference with its signs, the device-built cells equal to
   ``build_symbols_host``.  Then the diff's entries/s (median of 10
   warm reps), B2 at the 2^21 -> 2^20 level beside its plain version
   and bound, ``update_leaves`` ms, the sketch scatter-add's device ms
   and two warm reconcile repeats;
11. change-log replay at BASELINE.json configs[1], uncut: bench.py
   bench_replay's block of 4,096 records repeated to 1,003,520 rows,
   framed three ways (per record; ``encode_batch_frames`` at 65,536
   rows a frame; per-record runs between batch frames with a blob).
   ``replay_log`` of each must give the same rows (its
   ``encode_change_columns`` is the per-record wire byte for byte), the
   batch and mixed wires must be shorter than the per-record wire;
   ``leaves_from_columns`` of the
   per-record columns (wire extents, B1) and of the batch columns (the
   canonical re-encode, B1) must equal ``hashlib`` of each payload, and
   the root of the padded leaves (20 B2 levels) ``root_host``;
   ``decode_batch_device`` of every batch frame must equal
   ``decode_change_batch``; three digest sessions of the rows with four
   blobs opened mid-run (a ``CudaEncoder`` negotiated to
   ``CAP_CHANGE_BATCH`` piped into ``decode(backend="cuda")`` with a
   ``change_batch`` handler, the same with a per-row ``change`` handler
   over the first quarter of the rows (cut for time), and the per-record
   session) must give the same change digests, in
   order, on both ends, equal to ``hashlib``.  All of that runs on the
   native codec route; the three wires also replay on the Python route
   (``native=False``): frame index, columns field by field and every
   encoder's bytes must equal the native route's, and the
   ``change_batch`` session runs on the Python route too, over the first
   quarter of the rows (cut for time; the per-row sessions, the phase's
   dearest part, run on the native route only).
   Then rows/s of split, decode and encode on each route, replay rows/s
   of each wire, ``encode_change_columns`` rows/s,
   ``canonical_change_extents`` seconds, leaves + root ms with B1's and
   B2's device ms inside it, ``decode_batch_device`` ms, the sessions'
   rows/s and the wire bytes.

12. the streaming hasher and the mesh.  12a: ``Blake2bStream`` over a
   256 MiB stream made from the seed, in 4 MiB segments fed in 1 MiB
   pieces, and streams of 0, 1, 127, 128, 129, 4 MiB and 4 MiB + 1 bytes,
   each against ``hashlib``; B1's chained entry (``dat_blake2b_update``)
   against its plain version on the card, both variants, byte for byte:
   at the stream's width (an eighth of its first segment, one item of
   4,096 blocks, then a last segment of 64 KiB + 129 bytes bucketed to
   1,024 blocks; the whole segment is held against ``hashlib`` by the
   stream), on the first eighth of 64 items of a 4 MiB segment (the
   whole items, with a last segment of 1 B to 4 MiB, against
   ``hashlib``), and at 64 items of 256 blocks with t_hi 0 and 1 and
   counters that carry.  Past 256 blocks the plain version runs as its
   own calls over 64-block pieces replayed from a CUDA graph (eager, its
   launches cost the host about 10 ms a block; from the graph about 0.8
   ms a block, whatever the items).  Then the row's times at the
   stream's shape (one item of 32,768 blocks), the stream's MiB/s beside
   ``hashlib``'s on this host, the 64-item batch's and one item's, and
   the chain bound of a segment.  12b: a one-rank ``nccl`` group (a
   ``FileStore`` in a temp dir) and ``make_mesh(1)``:
   ``digest_root_step`` over phase 4's 2^20 payloads (leaves ==
   ``hashlib``, root == ``root_host``, exact byte count),
   ``sharded_hash_begin`` over phase 3's changes and 32 of its blobs (==
   ``hashlib``), ``sharded_diff`` over phase 10's snapshots (mask == the
   dense compare, roots == ``root_host``), ``sharded_sketch`` over phase
   10's first log of 1M records (== ``sketch_table``) and
   ``sharded_gear_scan`` over phase 7's blob in 128 KiB tiles (== B3
   over ``candidates_begin``'s rows), each also equal to its
   single-device counterpart; then each call's warm ms beside the
   counterpart's.  With one card the collectives run across one rank
   only; the tests run them across 2 and 4 ``gloo`` ranks on the CPU.
13. telemetry, the only phase with the obs gate on (phases 1-12 run with
   it off, but for phase 3's two gated pump turns).  13a: phase 3's session at 256 blobs, five times with the
   gate off and five times with it on, alternating; the medians and
   their ratio are the gate's cost on this host.  13b: one gated run
   whose span ring is widened to hold it whole: the counters must equal the session's truth (``decoder.changes``/``blobs``/
   ``bytes`` and ``encoder.bytes`` its counts and wire bytes,
   ``decoder.digests`` the digests held against ``hashlib``,
   ``device.dispatch.batches`` the pipeline's dispatches), each kernel
   site's calls its wrapper's launches, and both ends' frame tags must
   tile the wire; then the host split of the session (seconds inside
   ``device.dispatch``, inside ``device.deliver``, the rest) and the
   device gauges; then phase 3's ``change_many`` session at 256 blobs,
   gated, under the same checks, with one ``decoder.frame.run`` tag for
   each C change run.  One more gated run under ``torch.profiler``
   (``utils.trace.trace_to``): the same counters, and every
   ``utils.trace.span`` name among the profiler's events.  13c: a gated
   ``content_address`` of phase 7's blob on ``fused1p``, twice (summary
   == phase 7's, ``cdc.fused.*`` == its bytes and chunks, sites ==
   launches, and in 13b and 13c no ``device.jit.recompile_budget``
   event) and each call's split by span, with the ``cdc.hash``
   engine note.  13d: the
   rings of 13b exported with ``export_chrome_trace`` beside the
   profiler's trace under ``build/phase13/``; their record counts.
14. anti-entropy over the wire, gate off.  14a (BASELINE configs[4]'s
   width, bench.py config 11's middle arm): two change logs of 1,000,000
   records each in phase 11's record shape (values from the seed),
   sharing 999,500, with 500 own on each side (k = 1,000).  Log B is
   served by ``python -m dat_replication_protocol_tpu_torch.sidecar --tcp
   127.0.0.1:0 --reconcile B.log`` in a subprocess; ``run_initiator
   (RatelessReplica(A))`` runs here over ``io_for_socket``.  The records
   each side receives must be exactly the other's own, against a
   ``hashlib`` digest of every canonical record and its set difference
   in numpy; the replicas' B1 digests must equal those; the socket's
   bytes each way, the symbols and the rounds must equal
   ``reconcile_local``'s for the same pair.  The same at k = 10, and
   two corrupt arms (a byte of the first SYMBOLS frame flipped in
   flight: its start index, and cell 0's key sum) must each end within
   30 s in one ``ProtocolError``, a closed socket and the sidecar's
   ``ok: False``, or with exactly the oracle's records each way: never
   a wrong record set.  B1's device ms in the replica build and B1's and
   B6's in materialize come from a ``utils.trace.trace_to`` profile of
   those calls (kernel records summed by name; a kernel whose records
   are fewer than its launches prints ``None``, not a partial sum;
   traces under ``build/phase14/``).  14b (bench.py config 12): a 1 GiB dataset
   from the seed, ``SnapshotSource`` (B6 for the cuts, B1 for the chunk
   digests; cuts checked by phase 7's window hash, the root against
   ``root_host`` of ``hashlib`` digests) served by ``serve_tcp`` in a
   thread; a cold joiner, a joiner with 2% of its chunks rewritten
   (its chunk and wire bytes equal to ``snapshot_local``'s), a flash
   crowd of 2 cold joiners at once (bench.py's 8, cut for time; B1 and
   B6 not launched over it, the cold log served twice) and a joiner torn inside a CHUNKS frame (one
   ``ProtocolError`` within 30 s), each assembled dataset byte-exact.
15. the replication hub.  15a (bench.py config 9, uncut): 16 sessions of
   16,384 change rows and one 2 MiB blob each on one
   ``ReplicationHub(device="cuda")`` with config 9's settings, all
   started together, every digest held against ``hashlib`` in its
   session's order; aggregate GiB/s and fairness (the slowest session's
   GiB/s over the median's) with the gate off, then once more with it on,
   over 4 of the 16 sessions (cut for time), for the ``hub.*`` counters
   and the dispatcher's turn latency; items per dispatch of both runs.
   15b
   (config 13's hub arm, uncut): ``python -m
   dat_replication_protocol_tpu_torch.sidecar --tcp 127.0.0.1:0 --hub
   --stats-fd FD`` in a subprocess serves 1, 4 and 16 concurrent clients
   of an 8 MiB wire (a change run of ~1.5% of it, then 1 MiB blobs), each
   reply held against ``hashlib``, every stats line parsed and its hub
   breakdown checked against the live connections, the wire cost ledger
   tiling every connection, the last record's ``pump.route`` ``native``
   with ``transport.pump.batches`` above 0; the same clients on a sidecar without
   ``--stats-fd`` (telemetry off), each reply held against ``hashlib``
   and timed; then a ``--hub-max-sessions 2`` sidecar
   holding two clients halfway: a third must read EOF and be logged
   ``rejected``, the two finish byte-exact; the telemetry-on sidecar's
   items per dispatch (``hub.dispatch.items`` / ``hub.dispatch.batches``).
   15c: a ``nowait`` session
   that never polls floods 1 MiB blobs past a 64 MiB parked budget while
   three neighbours run whole sessions: one ``SessionShed
   ("parked-budget")`` for it, one ``hub.shed`` event naming it,
   ``hub.completions.dropped`` equal to its items in the pipeline at the
   shed.  15d: the hub on ``make_mesh()`` over a one-rank ``nccl`` group,
   four of 15a's sessions, every batch through ``sharded_hash_begin``.
   B1's launches of 15a, 15c and 15d form the ``hub`` bucket; 15b's are
   the subprocess's, read from its kernel sentinel.
16. fan-out and resume.  16a (bench.py config 10, uncut): a source wire
   of 16,384 change rows with 64-byte values and one 2 MiB blob is
   decoded once by ``decode(backend="cuda")`` (digests held against
   ``hashlib`` in submit order) while it is published into a
   ``FanoutServer`` with 1, 8, 64 and 256 accounting-only peers: the
   aggregate delivered MiB/s per count, and the hash-once proof
   (``device.submit.bytes``, ``device.h2d.bytes`` and B1's launches the
   same at every count); the wire published again to peers that hash
   what they get (each peer's length and BLAKE2b equal the wire's); the
   stalled arm (8 peers, one taking nothing past half the wire for 3.0
   s) beside the same without the staller, no peer shed.  16b: ``python
   -m dat_replication_protocol_tpu_torch.sidecar --tcp 127.0.0.1:0
   --fanout --hub --stats-fd FD``: a probe connection gives the source
   claim back, then the source connects, 8 subscribers connect, the
   source sends the wire; its reply against ``hashlib``, every
   subscriber's bytes against the wire; then ``--fanout --snapshot DATA
   --fanout-retention 1048576`` over a 64 MiB dataset (cut from config
   12's 1 GiB: phase 14b times that bootstrap): a late subscriber reads
   one ``snapshot_needed`` record whose hint names the bootstrap port,
   and ``run_snapshot_joiner`` from there assembles the dataset byte for
   byte; B1's and B6's launches read from each sidecar's sentinel.  16c
   (bench.py config 6): a journaled 20,000-row wire into a
   ``CudaDecoder`` under ``run_resumable`` with a drop at half the wire,
   20 reps (cut from 100), each rep's digests held against ``hashlib``,
   fault -> first re-delivered frame in ms; ``FaultPlan.for_sweep``
   seeds 0..15 over a 2,000-row wire with a 64 KiB blob (byte-at-a-time
   plans over the full wire would take minutes of Python), each ending
   with the clean digest sequence, and a flipped type byte ending in one
   ``ProtocolError``; an armed flight recorder keeps one ``recovered``
   bundle a session, with its checkpoint, up to half of its budget.
   16d (bench.py config 12's chaos arm): a ``SnapshotSource`` over a 4
   MiB window of the dataset (B6 and B1), a stale joiner's wire recorded
   in a ``WireJournal``, torn inside the first CHUNKS frame and resumed
   through ``run_resumable``: byte-exact, every wanted chunk verified
   once, none delivered twice.  B1's launches of 16a, 16c and 16d form
   the ``fanout`` bucket; 16b's are the subprocesses'.
17. the event-driven edge and the asyncio transport.  17a (bench.py
   config 15, uncut): an ``EdgeLoop`` on ``ReplicationHub(device="cuda",
   max_sessions=N+8, linger_s=0.002)`` with alternating latency and
   throughput classes, ``tick=0.02``, ``drain_timeout=60``, the obs gate
   on (the loop's profiler lit); N = 1, 100, 1,000 and 10,000 clients of
   config 15's one-change wire run in a subprocess (``python3
   chip_smoke.py --edge-client N PORT WIRE``, its own fds; this process
   raises its fd limit toward N + 512, and a count the hard limit cannot
   carry is dropped and printed), ramp and park mid-wire until the whole
   cohort is in the table (the loop's peak occupancy must equal it), then
   finish at once.  Each distinct reply must hold one change equal to
   ``hashlib`` of the change payload; rejected and shed must be 0; the
   flood's sessions/s, p99, ramp and finish seconds, ``loop_lag_max_s``,
   ``p99_turn_s`` and the loop's turns are printed.  17b: one
   ``EdgeLoop`` on one ``ReplicationHub(device="cuda")`` serving 16
   sessions of 15b's 8 MiB wire, two broadcast groups (16a's wire under
   two key prefixes, each claimed by its source, 8 subscribers each), a
   reconcile leg serving 14a's replica B to its replica A (k = 1,000)
   and a snapshot leg over a 64 MiB dataset from the seed (B6 and B1 in
   materialize), all connected first (every fd in the table must be
   non-blocking), then run at once: every reply against ``hashlib``,
   every subscriber's length and BLAKE2b against its wire, the
   reconcile records against 14a's oracle with socket bytes equal to
   ``reconcile_local``'s, the cold joiner byte-exact; the session
   records against the threaded legs' (``run_session`` on the same hub
   and wire, ``run_snapshot_session`` on the same source, 14a's
   sidecar record of the same pair).  17c: 16 healthy sessions of
   ``SESSION_4``'s shape beside one faulted by ``FaultPlan``'s session
   axis, seeds 0-7 (stall, truncate, flip), each on its own loop on one
   hub: the neighbours byte-exact, exactly one record not ok; the
   neighbours' worst latency beside a run without the fault.  17d:
   ``python -m dat_replication_protocol_tpu_torch.sidecar --tcp
   127.0.0.1:0 --edge --stats-fd FD --obs-http 0``: 16 clients of 15b's
   wire held halfway until a stats record's ``edge`` section holds all
   16 (by kind and class, each named in the hub's breakdown by its
   client port), ``/healthz`` 200 with its ``loop_lag`` stage, then
   released: each reply against ``hashlib``, every stats line parsed,
   the sidecar's peak RSS (its ``VmRSS`` sampled every 0.1 s) printed
   (17a prints this process's ``ru_maxrss``); then ``--edge --hub-max-sessions 2``: a third client reads EOF and is
   logged ``rejected``, the two held finish byte-exact.  17e:
   ``session_over_asyncio`` over 13a's 256-blob session into
   ``decode(backend="cuda")``, every digest against ``hashlib`` in submit
   order before finalize, its GiB/s beside 13a's gate-off median through
   ``pipe``; then ``recv_over_async`` under ``AsyncFaultyReader``, seeds
   0-7 (``for_sweep``'s plans without the faults that end a session),
   over 16c's 2,000-row wire with a 64 KiB blob: the clean digests each
   time.  B1's launches of 17a, 17b, 17c and 17e form the ``edge``
   bucket (17b's B6 launches join B6's row); 17d's are the
   subprocesses'.
18. the gossip mesh (``cluster/``, ``obs/propagation.py``, the sidecar's
   ``--replica``, the edge's replica leg).  18a (bench.py config 14,
   uncut): ``ClusterSim(N, seed=20240, chaos=False, records_per=192,
   divergence=24, device="cuda")`` at N = 4, 16 and 64 with the obs gate
   on: the expected digest and every replica's content digest equal to a
   ``hashlib`` oracle of the union (each canonical record hashed by
   ``hashlib``, the unique digests sorted by their little-endian 64-bit
   words and hashed again), ``rounds`` within ``rounds_bound()``; each
   N's rounds, seconds, wire and divergence bytes, ``wire_x``,
   ``exchange_p99_s``, goodput and overhead from the wire cost ledger and
   B1's launches.  18b: four ``python -m
   dat_replication_protocol_tpu_torch.sidecar --tcp 127.0.0.1:P --replica
   LOG --gossip-peers ... --gossip-interval 0.2 --stats-fd FD`` sidecars
   on the card, one of them with ``--edge`` (its inbound exchanges served
   by ``replica_machine``), each dialling the other three; each log holds
   the same 262,144 records and 1,024 of its own in phase 14a's record
   shape (configs[4]'s 1M records a replica, cut to 262,144 for the time
   limit), 266,240 in the union.  Converged: every sidecar's stats record
   carries ``gossip.digest`` equal to the ``hashlib`` oracle of the union
   in the delivered form and 266,240 records; then a further round of
   each driver (``exchanges_ok`` grows) applies and ships nothing.  The
   seconds from the last ``listening`` line to convergence, each
   replica's counters, each sidecar's B1 launches (its sentinel) and the
   edge section are printed.  18c: ``test_cluster_faults.py``'s
   scenarios for seeds 0-7 (N = 4, 16, 64, a partition that heals, chaos
   links, churn with a 2,048-byte retention, a flash crowd, the
   wrong-symbol and wrong-chunk arms) on ``device="cuda"``, with the
   sweep's asserts (convergence within the bound, identical healthy
   replicas, the exact union with no byzantine replica, no exchange
   across the cut, every quarantine explained); each seed's rounds,
   bootstraps (seed 6's flash crowd always bootstraps over
   ``snapshot_local``: B6 and B1), quarantines and seconds.  B1's
   launches of 18a and 18c form the ``cluster`` bucket (18c's B6
   launches join B6's row); 18b's are the subprocesses'.  18a's N = 16
   run also writes its events and spans to ``build/phase19/mesh16.jsonl``;
   18b's sidecars also run ``--obs-http 0 --trace-jsonl
   build/phase19/rI.jsonl``, and the whole run's tx bytes are each
   sidecar's last stats record's (written after its driver stopped).
19. the offline obs tools (``obs/fleet.py``, ``obs/__main__.py``) over
   phase 18's replicas; no assertion hinges on a live latency reading.
   19a: once 18b has settled (every driver two exchanges past
   convergence, nothing applied or sent), one sample a sidecar is
   recorded under ``build/phase19/``: its ``/snapshot`` with its
   ``/healthz`` record under ``healthz`` (``rI.sample.jsonl``), and r1's
   ``--stats-fd`` records so far (``r1.stats.jsonl``); the dashboard
   polls the live endpoints once (every target reachable, every
   ``gossip.digest`` the oracle's).  The SLO gate (``gossip``:
   ``require_converged``, ``max_quarantined`` 0,
   ``max_convergence_rounds`` ``mesh_rounds_floor(4)``;
   ``require_healthz``) runs over those five files twice, with
   ``run_fleet_check`` and with ``python -m
   dat_replication_protocol_tpu_torch.obs fleet --check``: the same rows
   and exit code, every gossip row OK, each ``require_healthz`` row as
   the target's saved record says (a degraded r0, its edge loop behind
   while it rebuilds a replica, is printed as a finding, its row FAIL and
   the exit 1 as expected); the breach arm (``max_exchange_p99_s`` 1e-9)
   on the same files exits 1 with that one FAIL row.  19b: the CLI in
   this process over the run's logs: ``meshdoctor`` over 18a's sink (its
   convergence round == the run's rounds, its bound ==
   ``rounds_bound()``), ``costdoctor`` over the four sidecar logs (each
   replica's tx wire bytes == its ledger's), ``loopdoctor`` over r0's
   ``edge.turn`` spans (no tiling flag; stall flags are printed, and the
   exit code agrees with them), ``export-trace`` of r0's log (one trace
   event a span and event record) and ``timeline`` of r0's and r1's
   logs (its exit code agrees with its flags).

A failure prints ``chip_smoke: phase N failed: TYPE: MESSAGE`` to stdout
and to stderr (the traceback on stderr) and exits 1.

Every launch counter (B1's per variant and per block count, and its
chained entry's per variant, too) is set to 0 just before each main-path
phase (3, 4, 7, 8, 10, 11, 12a's stream, 12b's mesh calls, 13's gated
runs; in 14a the replicas and both clean arms, in 14b materialize and
the cold and stale joiners, then the crowd; 15a, 15c, 15d; 16a, 16c,
16d; 17a, 17b, 17c, 17e; 18a, 18c) and read just after; a
kernel or B1 variant that the phases did not launch fails the run.
Phase 19 launches nothing in this process: its tools read files and
HTTP.
The lines before the last carry the card, the per-kernel JSON (each row
also names the ``shape`` its ``ms`` was timed at and the ``plain_shape``
of its ``plain_ms``) and the times; the last line is ``{"ok": true,
"device": {...}}``.  Without a card it exits 2 and prints no result.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
MIB = 1 << 20

# H100 SXM rates for the bounds (NVIDIA's data sheet and Hopper white
# paper): HBM3 at 3.35 TB/s; 132 SMs at the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
SM_COUNT = 132
SM_HZ = 1.98e9

# the two variants of kernel B1 (csrc/blake2b.cu), by the name their
# launch counts are reported under, and their lanes per item
B1_VARIANTS = {"blake2b_thread": 1, "blake2b_quad": 4}
# read_counters' entries that are breakdowns, not launch counts
NOT_COUNTS = ("b1_blocks", "b1u_lanes")

# phase 3 shape: 32 changes, then one blob, 2,048 times
N_BLOBS = 2048
P3_TURNS = 5  # turns of phase 3's two sessions at 256 blobs
BLOB_BYTES = MIB
CHANGES_PER_BLOB = 32
ENTRY_LEAVES = 1 << 20
# the plain B1 at the blob bucket: its 32 items' first 1,024 blocks (the
# bucket's 8,192 blocks took 73 s of the host, H100 80GB HBM3, 700 W)
PLAIN_B1_BLOCKS = 1024


def log(msg: str) -> None:
    print(msg, flush=True)


# the phase main() is in, for the failure line, and the run's start
PHASE = {"now": "1", "t0": time.perf_counter()}


def enter(phase: str) -> None:
    PHASE["now"] = phase
    log(f"[{time.perf_counter() - PHASE['t0']:.1f} s] phase {phase}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by the name its launch count is
    reported under."""
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        blake2b_packed_kernel, blake2b_update_kernel)
    from dat_replication_protocol_tpu_torch.ops.fused_cdc_hash import (
        gear_window_first_checked_kernel)
    from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
        merkle_level_kernel)
    from dat_replication_protocol_tpu_torch.ops.rabin_cuda import (
        gear_candidates_kernel, gear_first_kernel, gear_window_first_kernel)

    return {"blake2b": blake2b_packed_kernel,
            "blake2b_update": blake2b_update_kernel,
            "merkle_level": merkle_level_kernel,
            "gear_candidates": gear_candidates_kernel,
            "gear_first": gear_first_kernel,
            "gear_window_first": gear_window_first_kernel,
            "gear_window_first_checked": gear_window_first_checked_kernel}


def reset_counters() -> None:
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for b1 in (wrappers["blake2b"], wrappers["blake2b_update"]):
        b1.launches_by_lanes = dict.fromkeys(b1.launches_by_lanes, 0)
    wrappers["blake2b"].launches_by_blocks = {}


def read_counters() -> dict:
    """Launches of every kernel wrapper, and of each B1 variant; B1's by
    block count under ``b1_blocks``, its chained entry's by lanes per item
    under ``b1u_lanes``."""
    wrappers = _wrappers()
    out = {name: fn.launches for name, fn in wrappers.items()}
    b1 = wrappers["blake2b"]
    out.update({name: b1.launches_by_lanes[lanes]
                for name, lanes in B1_VARIANTS.items()})
    out["b1_blocks"] = dict(sorted(b1.launches_by_blocks.items()))
    out["b1u_lanes"] = dict(wrappers["blake2b_update"].launches_by_lanes)
    return out


def b1_buckets(session, side, ent, cdc, streamed) -> dict:
    """B1's main-path launches by bucket, from each phase's launches by
    block count: phase 3's blob buckets (1 MiB blobs) and change buckets,
    the sidecar's, ``entry()``'s, phase 7's chunk buckets and phase 8's
    under ``slabbed`` (the slabbed ``content_address``'s chunks;
    ``chunk_stream`` hashes nothing)."""
    blob = BLOB_BYTES // 128
    by = session["b1_blocks"]
    return {"blob": by.get(blob, 0),
            "change": sum(n for b, n in by.items() if b != blob),
            "sidecar": sum(side["b1_blocks"].values()),
            "entry": sum(ent["b1_blocks"].values()),
            "chunk": sum(cdc["b1_blocks"].values()),
            "slabbed": sum(streamed["b1_blocks"].values())}


def merged_launches(a: dict, b: dict) -> dict:
    """Two runs' launch counts, summed key by key (and bucket by bucket
    in the ``NOT_COUNTS`` breakdowns)."""
    out = {}
    for k, n in a.items():
        if isinstance(n, dict):
            out[k] = {x: n.get(x, 0) + b[k].get(x, 0)
                      for x in n.keys() | b[k].keys()}
        else:
            out[k] = n + b[k]
    return out


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def blake(data) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def max_abs_err(got, want) -> int:
    """Largest absolute difference between two (hi, lo) int32 pairs, with
    each pair read as one unsigned 64-bit word per element."""
    import torch

    diff = 0
    for a, b in zip(got, want):
        d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
        diff = max(diff, int(d))
    return diff


# ---------------------------------------------------------------------------
# phase 1: the host libraries of the native codec route
# ---------------------------------------------------------------------------


def build_host_libraries() -> dict:
    """Build ``native/dat_native.cpp`` and ``native/dat_fastpath.cpp``
    with ``g++`` from the checkout and load both; the host's ``g++``
    version, whether ``Python.h`` and ``triton`` are there."""
    import importlib.util
    import sysconfig

    from dat_replication_protocol_tpu_torch.runtime import fastpath, native

    gxx = subprocess.run(["g++", "--version"], stdout=subprocess.PIPE,
                         text=True, timeout=60).stdout.splitlines()[0]
    out = {"gxx": gxx}
    for name, mod in (("dat_native", native), ("dat_fastpath", fastpath)):
        rep = mod.build()
        out[name] = (f"built in {rep['seconds']} s" if rep
                     else "found built")
    native.get_lib()
    fastpath.get()
    caps = native.pump_probe()  # the wire pump's batched syscalls
    out["pump"] = {"recvmmsg": bool(caps & 1), "sendmmsg": bool(caps & 2)}
    include = sysconfig.get_paths()["include"]
    out["python_h"] = os.path.isfile(os.path.join(include, "Python.h"))
    out["triton"] = importlib.util.find_spec("triton") is not None
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(device, b1_lengths=(0, 1, 127, 128, 129, 255, 256, 1000,
                                      131072), b2_leaves=1 << 16) -> None:
    import torch

    from dat_replication_protocol_tpu_torch.ops import blake2b as b2b
    from dat_replication_protocol_tpu_torch.ops import merkle
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        LANES, launch)
    from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
        merkle_level_kernel)

    rng = np.random.default_rng(SEED)
    payloads = [rng.bytes(n) for n in b1_lengths]
    if b2b.blake2b_batch(payloads, device=device) != [
            blake(p) for p in payloads]:
        raise AssertionError("B1 batch digests differ from hashlib")
    # every variant on the edge lengths' power-of-two buckets and on
    # buckets of 1, 31, 32 and 33 items (a warp of the one-thread variant
    # holds 32 items, of the four-lane variant 8), against the plain
    # version and hashlib
    cases: dict[str, list[bytes]] = {}
    for p in payloads:
        nb = b2b._bucket_nblocks(b2b._need_blocks(len(p)))
        cases.setdefault(f"edge lengths, nblocks {nb}", []).append(p)
    if len(cases) < 3:
        raise AssertionError(f"B1 edge lengths span {len(cases)} buckets")
    for n in (1, 31, 32, 33):
        cases[f"{n} items"] = [rng.bytes(int(k))
                               for k in rng.integers(0, 3000, n)]
    for case, items in cases.items():
        mh, ml, lengths = (t.to(device) for t in b2b.pack_payloads(items))
        plain = b2b.blake2b_packed(mh, ml, lengths)
        for lanes in LANES:
            got = launch(mh, ml, lengths, b2b.DIGEST_SIZE, lanes)
            sync(device)
            if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                raise AssertionError(f"B1 ({lanes} lanes per item) differs "
                                     f"from its plain version ({case})")
            if b2b.digests_to_bytes(got[0].cpu(), got[1].cpu()) != [
                    blake(p) for p in items]:
                raise AssertionError(f"B1 ({lanes} lanes per item) differs "
                                     f"from hashlib ({case})")
    # an item of 8,192 blocks, the blob bucket's width, among ragged ones:
    # against hashlib only (the plain version takes a minute at this width)
    items = [rng.bytes(n) for n in (8192 * 128, 8192 * 128 - 77, 0, 5, 300)]
    mh, ml, lengths = (t.to(device) for t in b2b.pack_payloads(items))
    for lanes in LANES:
        got = launch(mh, ml, lengths, b2b.DIGEST_SIZE, lanes)
        if b2b.digests_to_bytes(got[0].cpu(), got[1].cpu()) != [
                blake(p) for p in items]:
            raise AssertionError(f"B1 ({lanes} lanes per item) differs from "
                                 f"hashlib on an item of 8,192 blocks")
    log(f"phase 2: B1 byte-exact with {list(LANES)} lanes per item vs plain "
        f"and hashlib on {list(cases)}, and vs hashlib on an item of 8,192 "
        f"blocks")

    words = rng.integers(0, 1 << 32, (2, b2_leaves, 4), dtype=np.uint64)
    hh, hl = (torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)
              for w in words)
    got = merkle_level_kernel(hh, hl)
    plain = merkle.merkle_level(hh, hl)
    sync(device)
    if not all(torch.equal(a, b) for a, b in zip(got, plain)):
        raise AssertionError("B2 differs from its plain version")
    leaves = merkle.digests_from_device(hh[:64], hl[:64])
    parents = merkle.digests_from_device(got[0][:32], got[1][:32])
    if parents != merkle.host_tree(leaves)[1]:
        raise AssertionError("B2 differs from hashlib parents")
    log(f"phase 2: B2 byte-exact vs plain on {b2_leaves} leaves")


# ---------------------------------------------------------------------------
# phase 3: the digest session and the sidecar
# ---------------------------------------------------------------------------


def make_session(n_blobs, blob_bytes, changes_per_blob, seed=SEED):
    """Blob bytes (one buffer) and change records, from one seed."""
    rng = np.random.default_rng(seed)
    blob_buf = rng.bytes(n_blobs * blob_bytes)
    n_changes = n_blobs * changes_per_blob
    value_lens = rng.integers(40, 201, n_changes)
    value_buf = rng.bytes(int(value_lens.sum()))
    offs = np.concatenate([[0], np.cumsum(value_lens)])
    changes = [{"key": f"row-{i}", "change": i + 1, "from": 0, "to": 1,
                "value": value_buf[offs[i]:offs[i + 1]]}
               for i in range(n_changes)]
    return memoryview(blob_buf), changes


def run_session(device, n_blobs=N_BLOBS, blob_bytes=BLOB_BYTES,
                changes_per_blob=CHANGES_PER_BLOB, bulk=False,
                keep_wire=False, inputs=None) -> dict:
    """Phase 3's session on the decoder's native codec route; the C
    change runs are counted with the frames they covered.  Each change
    is one ``change()`` call (the session of every PR before the native
    route), or with ``bulk`` each blob's changes are one ``change_many``
    run, which reaches the decoder as one write and so its C dispatch
    loop.  With ``keep_wire`` the decoder's writes are kept
    (``"wire"``); ``inputs`` reuses an earlier session's blobs and
    changes."""
    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
        DEFAULT_STREAM_THRESHOLD)

    if blob_bytes >= DEFAULT_STREAM_THRESHOLD:
        raise ValueError("phase 3 blobs must take the batch path")
    blobs, changes = inputs or make_session(n_blobs, blob_bytes,
                                            changes_per_blob)
    enc = protocol.encode()
    dec = protocol.decode(backend="cuda", device=device)
    wire = []
    if keep_wire:
        write = dec.write

        def kept(data, *args):
            wire.append(data)
            return write(data, *args)

        dec.write = kept
    runs = {"runs": 0, "frames": 0}
    note_run = dec._note_change_run

    def counted(st, f0, k):
        runs["runs"] += 1
        runs["frames"] += k
        note_run(st, f0, k)

    dec._note_change_run = counted
    got = {"change": [], "blob": []}
    at_finalize = []
    dec.on_digest(lambda kind, seq, d: got[kind].append((seq, d)))
    dec.change(lambda c, done: done())
    dec.finalize(lambda done: (at_finalize.append(
        len(got["change"]) + len(got["blob"])), done()))

    reset_counters()
    t0 = time.perf_counter()
    protocol.pipe(enc, dec)
    for b in range(n_blobs):
        run = changes[b * changes_per_blob:(b + 1) * changes_per_blob]
        if bulk:
            # the same wire bytes as one change() a record
            enc.change_many(run)
        else:
            for c in run:
                enc.change(c)
        enc.blob(blob_bytes).end(blobs[b * blob_bytes:(b + 1) * blob_bytes])
    enc.finalize()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = read_counters()

    if not dec.finished or dec.destroyed:
        raise AssertionError("phase 3 session did not finish")
    pipeline = dec.digest_pipeline
    total = len(changes) + n_blobs
    if at_finalize != [total]:
        raise AssertionError(f"digests before finalize: {at_finalize}, "
                             f"want {total}")
    if pipeline.streamed or pipeline.batched != total:
        raise AssertionError(f"batch path took {pipeline.batched} of "
                             f"{total}, host streams {pipeline.streamed}")
    if [s for s, _ in got["change"]] != list(range(len(changes))):
        raise AssertionError("change digests out of order")
    if [s for s, _ in got["blob"]] != list(range(n_blobs)):
        raise AssertionError("blob digests out of order")
    for (_, d), c in zip(got["change"], changes):
        if d != blake(protocol.encode_change(c)):
            raise AssertionError("a change digest differs from hashlib")
    for b, (_, d) in enumerate(got["blob"]):
        if d != blake(blobs[b * blob_bytes:(b + 1) * blob_bytes]):
            raise AssertionError(f"blob {b} digest differs from hashlib")
    if launches["blake2b"] == 0:
        raise AssertionError("phase 3 never launched B1")
    if bulk and runs["runs"] == 0:
        raise AssertionError("phase 3's change_many session ran no C "
                             "change run")
    return {"seconds": seconds, "wire_bytes": dec.bytes,
            "enc_bytes": enc.bytes,
            "gib_per_s": dec.bytes / seconds / (1 << 30),
            "changes": len(changes), "blobs": n_blobs,
            "dispatches": pipeline.dispatches, "launches": launches,
            "c_runs": runs, "digests": got, "wire": wire,
            "inputs": (blobs, changes)}


def replay_session_wire(device, session: dict, native: bool) -> dict:
    """Phase 3's recorded wire, in its recorded writes, into a digest
    decoder on the native or the Python codec route (``native=False``):
    its digests must be the recording session's, in order."""
    import dat_replication_protocol_tpu_torch as protocol

    route = "native" if native else "Python"
    dec = protocol.decode(backend="cuda", device=device, native=native)
    got = {"change": [], "blob": []}
    dec.on_digest(lambda kind, seq, d: got[kind].append((seq, d)))
    dec.change(lambda c, done: done())
    sync(device)
    t0 = time.perf_counter()
    for data in session["wire"]:
        dec.write(data)
    dec.end()
    sync(device)
    seconds = time.perf_counter() - t0
    if not dec.finished or dec.bytes != session["wire_bytes"]:
        raise AssertionError(f"phase 3's wire did not finish on the {route} "
                             f"route")
    if got != session["digests"]:
        raise AssertionError(f"phase 3's digests differ on the {route} "
                             f"route's decode of the recorded wire")
    return {"seconds": seconds,
            "gib_per_s": dec.bytes / seconds / (1 << 30),
            "writes": len(session["wire"])}


def profile_session(device, n_blobs=256, bulk=False) -> dict:
    """Device time by kernel and copy over a shorter session, from
    ``torch.profiler``; the busy share is their sum over the session's
    host-clock seconds (one stream, so nothing overlaps).  The ranges
    that ``record_function`` spans leave on the device's timeline
    (``digest.dispatch``) enclose kernels counted already: they are
    kept apart (``"annotations"``), as ``torch.profiler``'s own totals
    keep them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        session = run_session(device, n_blobs=n_blobs, bulk=bulk)
    # only events that ran on the card: host ops (aten::copy_) and
    # runtime calls (cudaLaunchKernel) also carry their kernels' time
    rows, notes = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            row = (e.self_device_time_total / 1e3, e.key, e.count)
            (notes if getattr(e, "is_user_annotation", False)
             else rows).append(row)
    if not rows:
        raise AssertionError("the profiled session shows no device time")
    busy_s = sum(ms for ms, _, _ in rows) / 1e3
    return {"seconds": session["seconds"], "busy_share":
            busy_s / session["seconds"], "rows": sorted(rows, reverse=True),
            "annotations": sorted(notes, reverse=True),
            "c_runs": session["c_runs"]}


def run_sidecar(device, n_changes=16, n_blobs=4, blob_bytes=64 << 10) -> dict:
    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch import sidecar

    blobs, changes = make_session(n_blobs, blob_bytes,
                                  n_changes // n_blobs, seed=SEED + 1)
    enc = protocol.encode()
    want = []
    for b in range(n_blobs):
        per = n_changes // n_blobs
        for i, c in enumerate(changes[b * per:(b + 1) * per]):
            enc.change(c)
            want.append(("change", b * per + i, blake(
                protocol.encode_change(c))))
        blob = blobs[b * blob_bytes:(b + 1) * blob_bytes]
        enc.blob(blob_bytes).end(blob)
        want.append(("blob", b, blake(blob)))
    enc.finalize()
    wire = bytearray()
    while (chunk := enc.read()) is not None:
        wire += chunk
    reply = bytearray()

    reset_counters()
    out = sidecar.run_session(io.BytesIO(bytes(wire)).read, reply.extend,
                              device=device)
    launches = read_counters()
    if not out["ok"]:
        raise AssertionError(f"sidecar session failed: {out}")
    dec = protocol.decode()
    replies = []
    dec.change(lambda c, done: (replies.append(c), done()))
    dec.write(bytes(reply))
    dec.end()
    if not dec.finished:
        raise AssertionError("sidecar reply is not a complete session")
    got = sorted(((c.subset.split(":")[1], c.change, c.value)
                  for c in replies), key=lambda r: (r[0], r[1]))
    if got != sorted(want, key=lambda r: (r[0], r[1])):
        raise AssertionError("sidecar digest replies differ from hashlib")
    for c in replies:
        kind = c.subset.split(":")[1]
        if c.key != f"{kind}-{c.change}":
            raise AssertionError(f"sidecar reply key {c.key!r}")
    if launches["blake2b"] == 0:
        raise AssertionError("the sidecar session never launched B1")
    return {"digests": out["digests"], "launches": launches}


# ---------------------------------------------------------------------------
# phase 3, the wire pump: the batched route against the plain one
# ---------------------------------------------------------------------------

PUMP_BLOBS = 256  # the loopback session: phase 3's shape at 256 blobs
PUMP_TURNS = 5  # alternating turns of each route's loopback session
PUMP_FAN_BYTES = 64 * MIB  # the gather's wire
PUMP_FAN_PEERS = 8
PUMP_SNDTIMEO_S = 0.5  # the send-timeout arm's SO_SNDTIMEO
PUMP_COUNTERS = ("batches", "msgs", "syscalls", "syscalls_saved", "bytes")


def pump_session_wire(n_blobs=PUMP_BLOBS) -> tuple:
    """Phase 3's shape at ``n_blobs`` (32 ``change()`` records, then one
    1 MiB blob, each time) as one encoded wire, and its ``hashlib``
    digests by kind in submit order."""
    import dat_replication_protocol_tpu_torch as protocol

    blobs, changes = make_session(n_blobs, BLOB_BYTES, CHANGES_PER_BLOB,
                                  seed=SEED + 190)
    enc = protocol.encode()
    want = {"change": [], "blob": []}
    parts = []
    for b in range(n_blobs):
        for c in changes[b * CHANGES_PER_BLOB:(b + 1) * CHANGES_PER_BLOB]:
            enc.change(c)
            want["change"].append(blake(protocol.encode_change(c)))
        blob = blobs[b * BLOB_BYTES:(b + 1) * BLOB_BYTES]
        enc.blob(BLOB_BYTES).end(blob)
        want["blob"].append(blake(blob))
        while chunk := enc.read(1 << 24):
            parts.append(chunk)
    enc.finalize()
    while (chunk := enc.read(1 << 24)) is not None:
        parts.append(chunk)
    return b"".join(parts), want


def reply_digests(raw: bytes) -> dict:
    """The sidecar's reply stream as digests by kind, in its order, with
    each kind's sequence numbers checked to run 0, 1, 2, ..."""
    import dat_replication_protocol_tpu_torch as protocol

    dec = protocol.decode()
    got = {"change": [], "blob": []}
    dec.change(lambda c, done: (got[c.subset.split(":")[1]].append(
        (c.change, bytes(c.value))), done()))
    dec.write(raw)
    dec.end()
    if not dec.finished:
        raise AssertionError("phase 3's pump: a reply is not a whole session")
    for kind, rows in got.items():
        if [seq for seq, _ in rows] != list(range(len(rows))):
            raise AssertionError(f"phase 3's pump: {kind} replies out of "
                                 f"order")
    return {kind: [d for _, d in rows] for kind, rows in got.items()}


def pump_session_turn(device, wire: bytes, native: bool) -> dict:
    """One digest session over loopback TCP: ``sidecar.run_session`` on
    the accepted socket, with its fds (the batched route) or with its
    callables only (the plain Python pump), against a client that sends
    the wire and reads the reply to EOF.  Seconds from the connect to
    the reply's EOF."""
    import socket
    import threading

    from dat_replication_protocol_tpu_torch import sidecar

    srv = socket.create_server(("127.0.0.1", 0))
    rec = {}

    def serve():
        conn, _ = srv.accept()
        try:
            fds = ({"rx_fd": conn.fileno(), "tx_fd": conn.fileno()}
                   if native else {})
            rec.update(sidecar.run_session(
                conn.recv, conn.sendall,
                close_write=lambda: conn.shutdown(socket.SHUT_WR),
                device=device, **fds))
        finally:
            conn.close()

    reply = bytearray()

    def read_reply(sock):
        while d := sock.recv(1 << 20):
            reply.extend(d)

    server = threading.Thread(target=serve, daemon=True)
    server.start()
    t0 = time.perf_counter()
    sock = socket.create_connection(srv.getsockname())
    try:
        reader = threading.Thread(target=read_reply, args=(sock,),
                                  daemon=True)
        reader.start()
        sock.sendall(wire)
        sock.shutdown(socket.SHUT_WR)
        reader.join(600)
        server.join(600)
        seconds = time.perf_counter() - t0
    finally:
        sock.close()
        srv.close()
    if reader.is_alive() or server.is_alive() or not rec.get("ok"):
        raise AssertionError(f"phase 3's pump: the {('plain', 'native')[native]}"
                             f" session failed: {rec}")
    return {"seconds": seconds, "gib_s": len(wire) / seconds / (1 << 30),
            "digests": reply_digests(bytes(reply)), "record": rec}


def pump_counters(snap: dict) -> dict:
    c = snap["counters"]
    out = {k: c.get(f"transport.pump.{k}", 0) for k in PUMP_COUNTERS}
    h = snap["histograms"].get("transport.pump.native.seconds", {})
    out["native_s"] = {"count": h.get("count", 0), "sum": h.get("sum", 0.0)}
    out["gather_bytes"] = c.get("transport.pump.gather.bytes", 0)
    out["fanout_sent"] = c.get("fanout.sent.bytes", 0)
    return out


def pump_fanout_turn(wire: bytes, native: bool) -> dict:
    """``wire`` through a ``FanoutServer(native=native)`` to
    ``PUMP_FAN_PEERS`` fd peers on socketpairs, each drained by a thread
    that hashes what it reads: every peer's length and BLAKE2b must be
    the wire's.  Seconds from the first publish to the last reader's
    EOF."""
    import socket
    import threading

    from dat_replication_protocol_tpu_torch.fanout import FanoutServer

    srv = FanoutServer(retention_budget=len(wire) + MIB, stall_timeout=60.0,
                       max_peers=PUMP_FAN_PEERS, native=native)
    pairs, peers, readers, got = [], [], [], {}

    def drain(i, sock):
        h = hashlib.blake2b(digest_size=32)
        n = 0
        while d := sock.recv(1 << 20):
            h.update(d)
            n += len(d)
        got[i] = (n, h.digest())

    try:
        for i in range(PUMP_FAN_PEERS):
            a, b = socket.socketpair()
            pairs.append((a, b))
            peers.append(srv.attach_peer(f"p{i}", fd=a.fileno(), offset=0))
            t = threading.Thread(target=drain, args=(i, b), daemon=True)
            t.start()
            readers.append(t)
        view = memoryview(wire)
        t0 = time.perf_counter()
        for off in range(0, len(wire), MIB):
            srv.publish(view[off:off + MIB])
        srv.seal()
        if not srv.drain(300):
            raise AssertionError("phase 3's pump: the fan-out did not drain")
        for peer, (a, _) in zip(peers, pairs):
            peer.close()
            a.close()
        srv.close()  # its owned fd dups close: the readers see EOF
        for t in readers:
            t.join(120)
        seconds = time.perf_counter() - t0
    finally:
        srv.close()
        for a, b in pairs:
            a.close()
            b.close()
    want = (len(wire), blake(wire))
    if any(got.get(i) != want for i in range(PUMP_FAN_PEERS)):
        raise AssertionError(f"phase 3's pump: a fan-out peer "
                             f"({('plain', 'native')[native]}) did not read "
                             f"the wire byte for byte")
    return {"seconds": seconds,
            "mib_s": PUMP_FAN_PEERS * len(wire) / seconds / MIB}


def pump_send_timeout() -> dict:
    """The batched writer of ``io_for_socket`` against a peer that never
    reads, under ``SO_SNDTIMEO``: ``OSError(EAGAIN)`` within 5 s (the
    JAX package's writer retries EAGAIN forever)."""
    import errno
    import socket
    import struct

    from dat_replication_protocol_tpu_torch.session.pump import io_for_socket

    a, b = socket.socketpair()
    try:
        usec = int(PUMP_SNDTIMEO_S * 1e6)
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                     struct.pack("ll", usec // 1_000_000, usec % 1_000_000))
        _, wr = io_for_socket(a)
        t0 = time.perf_counter()
        try:
            wr(bytes(64 * MIB))
        except OSError as e:
            seconds = time.perf_counter() - t0
            if e.errno != errno.EAGAIN or seconds > 5.0:
                raise AssertionError(f"phase 3's pump: the send timeout "
                                     f"raised {e!r} after {seconds} s")
            return {"seconds": seconds, "error": type(e).__name__}
        raise AssertionError("phase 3's pump: 64 MiB reached a peer that "
                             "never reads")
    finally:
        a.close()
        b.close()


def run_wire_pump(device) -> dict:
    """Phase 3's wire pump: (a) the 256-blob session over loopback TCP on
    each route in ``PUMP_TURNS`` alternating turns, gate off, then one
    gated turn a route for the ``transport.pump.*`` counters; (b) the
    fan-out gather, two alternating turns a route and a gated native
    one; (c) the send timeout.  B1's launches come back under
    ``launches``."""
    from dat_replication_protocol_tpu_torch import obs

    t0 = time.perf_counter()
    wire, want = pump_session_wire()
    make_s = time.perf_counter() - t0
    reset_counters()
    turns = {True: [], False: []}
    for i in range(PUMP_TURNS):
        for native in ((True, False) if i % 2 == 0 else (False, True)):
            run = pump_session_turn(device, wire, native)
            if run["digests"] != want:
                raise AssertionError(f"phase 3's pump: the "
                                     f"{('plain', 'native')[native]} "
                                     f"route's digests differ from hashlib's")
            turns[native].append(run["gib_s"])
    gated = {}
    obs_reset()
    try:
        for native in (True, False):
            obs.enable()
            run = pump_session_turn(device, wire, native)
            obs.disable()
            if run["digests"] != want:
                raise AssertionError("phase 3's pump: a gated turn's "
                                     "digests differ from hashlib's")
            gated[native] = dict(pump_counters(obs.snapshot()),
                                 gib_s=run["gib_s"])
            obs_reset()
    finally:
        obs.disable()
        obs_reset()
    launches = read_counters()
    if gated[True]["batches"] == 0 or gated[False]["batches"] != 0:
        raise AssertionError(f"phase 3's pump: transport.pump.batches "
                             f"{gated[True]['batches']} native, "
                             f"{gated[False]['batches']} plain")
    session_s = time.perf_counter() - t0
    wire_bytes = len(wire)
    del wire

    t1 = time.perf_counter()
    fan_wire = np.random.default_rng(SEED + 191).bytes(PUMP_FAN_BYTES)
    fan = {True: [], False: []}
    for native in (True, False, False, True):
        fan[native].append(pump_fanout_turn(fan_wire, native)["mib_s"])
    obs_reset()
    obs.enable()
    try:
        pump_fanout_turn(fan_wire, True)
        fan_gated = pump_counters(obs.snapshot())
    finally:
        obs.disable()
        obs_reset()
    sent = PUMP_FAN_PEERS * PUMP_FAN_BYTES
    if not fan_gated["gather_bytes"] == fan_gated["fanout_sent"] == sent:
        raise AssertionError(f"phase 3's pump: transport.pump.gather.bytes "
                             f"{fan_gated['gather_bytes']}, fanout.sent.bytes"
                             f" {fan_gated['fanout_sent']}, want {sent}")
    fan_s = time.perf_counter() - t1
    return {"wire_bytes": wire_bytes, "make_s": make_s, "turns": turns,
            "median": {k: float(np.median(v)) for k, v in turns.items()},
            "gated": gated, "fan": fan, "fan_gated": fan_gated,
            "timeout": pump_send_timeout(), "session_s": session_s,
            "fan_s": fan_s, "launches": launches}


# ---------------------------------------------------------------------------
# phase 4: entry() at 2^20 leaves
# ---------------------------------------------------------------------------


def run_entry(device, n_leaves=ENTRY_LEAVES) -> dict:
    from dat_replication_protocol_tpu_torch import entry
    from dat_replication_protocol_tpu_torch.ops import merkle

    rng = np.random.default_rng(SEED + 2)
    lens = rng.integers(40, 201, n_leaves)
    buf = rng.bytes(int(lens.sum()))
    offs = np.concatenate([[0], np.cumsum(lens)])
    payloads = [buf[offs[i]:offs[i + 1]] for i in range(n_leaves)]
    fn, args = entry.entry(device=device, payloads=payloads)

    reset_counters()
    t0 = time.perf_counter()
    root_hh, root_hl = fn(*args)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = read_counters()

    root = merkle.digests_from_device(root_hh, root_hl)[0]
    digests = [blake(p) for p in payloads]
    if root != merkle.root_host(digests):
        raise AssertionError("entry() root differs from root_host")
    if launches["merkle_level"] == 0 or launches["blake2b"] == 0:
        raise AssertionError(f"entry() launches {launches}")
    return {"seconds": seconds, "leaves": n_leaves, "launches": launches,
            "root": root.hex(), "step": (fn, args), "digests": digests,
            "total": int(lens.sum())}


# ---------------------------------------------------------------------------
# phase 5: times and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, after a warm-up,
    from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def largest(**times_ms) -> tuple[float, str]:
    """The largest of named least times, and its name."""
    by, ms = max(times_ms.items(), key=lambda kv: kv[1])
    return ms, by


def b1_bound(lengths, sass: dict, latency: float, item_bytes: int = 68,
             min_blocks: int = 1) -> dict:
    """Least ms for B1 over items of ``lengths`` bytes: the largest of
    bytes (messages read once, and ``item_bytes`` an item: lengths read,
    digests written), operations (one thread per item as B1's SASS issues
    them, each pipe over its rate) and the chain (the longest item's
    blocks, one after another, each the dependent path of one compression
    at ``latency`` cycles a step).  An item compresses at least
    ``min_blocks`` blocks.  ``bound_by`` says which."""
    blocks = np.maximum(min_blocks,
                        -(-np.asarray(lengths, dtype=np.int64) // 128))
    nbytes = int(blocks.sum()) * 128 + item_bytes * len(blocks)
    cycles = max((len(blocks) * sass["per_item"][k]
                  + int(blocks.sum()) * sass["per_block"][k]) / LANES[k]
                 for k in LANES)
    out = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "ops_ms": cycles / (SM_COUNT * SM_HZ) * 1e3,
           "chain_ms": int(blocks.max()) * sass["chain"] * latency / SM_HZ
           * 1e3}
    out["bound_ms"], out["bound_by"] = largest(
        bytes=out["bytes_ms"], operations=out["ops_ms"], chain=out["chain_ms"])
    return out


def b2_bound(parents: int) -> dict:
    """Least ms for one B2 level of ``parents`` parents: bytes (two child
    digests in, one parent out) or the operations one thread issues in
    B2's SASS, each pipe over its rate."""
    one = sass_path(parse_sass(sass_listing("merkle_level"),
                               "merkle_level_kernel"))
    cycles = max(parents * one[k] / LANES[k] for k in LANES)
    out = {"bytes_ms": 96 * parents / HBM_BYTES_PER_S * 1e3,
           "ops_ms": cycles / (SM_COUNT * SM_HZ) * 1e3, "sass": one}
    out["bound_ms"], out["bound_by"] = largest(bytes=out["bytes_ms"],
                                               operations=out["ops_ms"])
    return out


def device_ms(fn, reps: int) -> float:
    """Mean device time of one ``fn()`` from a CUDA graph of ``reps``
    calls, timed by CUDA events around one replay after a warm-up: the
    card launches the calls back to back, without the host's launch
    gaps.  (``torch.profiler``'s kernel records, as ``profile_session``
    reads them, came back empty here after the CDC phases.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def b1_inputs(device, payloads):
    """A bucket staged as ``blake2b_batch_begin`` stages it: power-of-two
    batch and block count, split into hi/lo halves on the card."""
    import torch

    from dat_replication_protocol_tpu_torch.ops import blake2b as b2b

    nb = b2b._bucket_nblocks(b2b._need_blocks(max(map(len, payloads))))
    batch = list(payloads) + [b""] * (b2b._bucket_nblocks(len(payloads))
                                      - len(payloads))
    return (b2b.stage_batch(batch, nb, torch.device(device)),
            [len(p) for p in batch])


def time_b1(label: str, args, lengths, sass: dict, latency: float,
            reps: int) -> dict:
    """B1 at one main-path shape: device ms of each variant, the bounds,
    and the variant the wrapper's rule picks there."""
    from dat_replication_protocol_tpu_torch.ops.blake2b import DIGEST_SIZE
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        LANES, launch, lanes_per_item)

    B, nblocks = args[0].shape[:2]
    ms = {lanes: device_ms(lambda: launch(*args, DIGEST_SIZE, lanes), reps)
          for lanes in LANES}
    out = {"label": label, "shape": [B, nblocks], "ms_by_lanes": ms,
           "lanes": lanes_per_item(B), **b1_bound(lengths, sass, latency)}
    out["ms"] = ms[out["lanes"]]
    log(f"phase 5: B1 at {label} {out['shape']} (items x blocks): device ms "
        f"by lanes per item {ms}; the rule picks {out['lanes']}; bound "
        f"{out['bound_ms']} ms ({out['bound_by']}): bytes {out['bytes_ms']},"
        f" operations {out['ops_ms']}, chain {out['chain_ms']} ms; the "
        f"picked variant at {out['ms'] / out['chain_ms']} x the chain bound")
    return out


def b1_row(name: str, timed: dict, launches: int, plain_ms: float,
           err: int) -> dict:
    return {"name": name, "route": "cuda",
            "source": "dat_replication_protocol_tpu_torch/csrc/blake2b.cu",
            "replaces":
                "dat_replication_protocol_tpu/ops/blake2b_pallas.py:228",
            "launches": launches, "max_abs_err": err, "ms": timed["ms"],
            "plain_ms": plain_ms, "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"], "library_ms": None,
            "shape": timed["shape"], "plain_shape": timed["plain_shape"]}


def time_kernels(device, launches: dict, entry_step, sass: dict,
                 latency: float) -> list[dict]:
    """Phase 5: B1 at the session's blob and change buckets and at
    entry()'s launch, each variant on the device alone beside the bounds,
    the blob bucket also under a cold L2; B2 at entry()'s first level;
    build_tree and entry()'s whole step."""
    import torch

    from dat_replication_protocol_tpu_torch import encode_change
    from dat_replication_protocol_tpu_torch.ops import blake2b as b2b
    from dat_replication_protocol_tpu_torch.ops import merkle
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        blake2b_packed_kernel)
    from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
        merkle_level_kernel)

    # the session's blob bucket: each batch of 1,024 items holds 31 blobs
    # (32 changes per blob), padded to a batch of 32 x 8,192 blocks
    blobs, _ = make_session(31, BLOB_BYTES, 0, seed=SEED + 3)
    args, lens = b1_inputs(device, [blobs[i * BLOB_BYTES:(i + 1) * BLOB_BYTES]
                                    for i in range(31)])
    blob = time_b1("the blob bucket", args, lens, sass, latency, reps=3)
    # under a cold L2: 256 MiB written before each launch, its own time
    # taken off
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    cold = (device_ms(lambda: (flush.zero_(), blake2b_packed_kernel(*args)),
                      3) - device_ms(flush.zero_, 3))
    del flush
    log(f"phase 5: B1 at the blob bucket under a cold L2: {cold} ms "
        f"(warm {blob['ms']} ms)")
    # the whole bucket against hashlib; against the plain version on its
    # items' first PLAIN_B1_BLOCKS blocks (eager, the plain version costs
    # the host about 9 ms a block whatever the items: 73 s at 8,192)
    got = b2b.digests_to_bytes(*(t.cpu() for t in
                                 blake2b_packed_kernel(*args)))[:31]
    if got != [blake(blobs[i * BLOB_BYTES:(i + 1) * BLOB_BYTES])
               for i in range(31)]:
        raise AssertionError("B1 differs from hashlib at the blob bucket")
    cut = (args[0][:, :PLAIN_B1_BLOCKS].contiguous(),
           args[1][:, :PLAIN_B1_BLOCKS].contiguous(),
           args[2].clamp(max=PLAIN_B1_BLOCKS * 128))
    t0 = time.perf_counter()
    plain = b2b.blake2b_packed(*cut)
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(blake2b_packed_kernel(*cut), plain)
    blob["plain_shape"] = list(cut[0].shape[:2])
    log(f"phase 5: B1 at the blob bucket == hashlib; == its plain version "
        f"at {blob['plain_shape']} (the bucket's items, their first "
        f"{PLAIN_B1_BLOCKS} blocks): plain {plain_ms} ms, max_abs_err {err}")

    # the session's change bucket: 1,024 payloads of 2 blocks
    _, recs = make_session(1, 0, 1024, seed=SEED + 4)
    args_c, lens_c = b1_inputs(device, [encode_change(c) for c in recs])
    change = time_b1("the change bucket", args_c, lens_c, sass, latency,
                     reps=50)
    plain_c = time_ms(lambda: b2b.blake2b_packed(*args_c), reps=3)
    err_c = max_abs_err(blake2b_packed_kernel(*args_c),
                        b2b.blake2b_packed(*args_c))
    log(f"phase 5: B1 at the change bucket: plain {plain_c} ms, max_abs_err "
        f"{err_c}")

    # entry()'s launch: 2^20 payloads of 2 blocks
    fn, step_args = entry_step
    args_e = step_args[:3]
    ent = time_b1("entry()'s launch", args_e, args_e[2].cpu().numpy(), sass,
                  latency, reps=10)
    ent["plain_shape"] = ent["shape"]
    plain_e = time_ms(lambda: b2b.blake2b_packed(*args_e), reps=1)
    err_e = max_abs_err(blake2b_packed_kernel(*args_e),
                        b2b.blake2b_packed(*args_e))
    if err or err_c or err_e:
        raise AssertionError("B1 differs from its plain version in phase 5")
    rows = [b1_row(name, timed, launches[name], p_ms, e)
            for name, timed, p_ms, e in (("blake2b_quad", blob, plain_ms, err),
                                         ("blake2b_thread", ent, plain_e,
                                          err_e))]
    for name, timed in (("blake2b_quad", blob), ("blake2b_thread", ent)):
        if timed["lanes"] != B1_VARIANTS[name]:
            raise AssertionError(f"the rule picks {timed['lanes']} lanes per "
                                 f"item at {timed['label']}, not {name}'s")

    # B2 at the first level of entry()'s 2^20-leaf tree
    rng = np.random.default_rng(SEED + 5)
    words = rng.integers(0, 1 << 32, (2, ENTRY_LEAVES, 4), dtype=np.uint64)
    hh, hl = (torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)
              for w in words)
    ms2 = device_ms(lambda: merkle_level_kernel(hh, hl), 20)
    plain2 = time_ms(lambda: merkle.merkle_level(hh, hl), reps=3)
    err2 = max_abs_err(merkle_level_kernel(hh, hl), merkle.merkle_level(hh, hl))
    if err2:
        raise AssertionError("B2 differs from its plain version in phase 5")
    b2 = b2_bound(ENTRY_LEAVES // 2)
    log(f"phase 5: B2 at {ENTRY_LEAVES} -> {ENTRY_LEAVES // 2}: device "
        f"{ms2} ms; bound {b2['bound_ms']} ms ({b2['bound_by']}): bytes "
        f"{b2['bytes_ms']}, operations {b2['ops_ms']} ms; SASS walk, one "
        f"thread: {b2['sass']}")
    rows.append({
        "name": "merkle_level", "route": "cuda",
        "source": "dat_replication_protocol_tpu_torch/csrc/merkle_level.cu",
        "replaces": "dat_replication_protocol_tpu/ops/merkle_pallas.py:69",
        "launches": launches["merkle_level"], "max_abs_err": err2,
        "ms": ms2, "plain_ms": plain2, "bound_ms": b2["bound_ms"],
        "bound_by": b2["bound_by"], "library_ms": None,
        "shape": [ENTRY_LEAVES, 4], "plain_shape": [ENTRY_LEAVES, 4]})

    # the whole tree, all 20 levels, and entry()'s whole step warm
    tree_ms = time_ms(lambda: merkle.build_tree(hh, hl), reps=5)
    log(f"phase 5: build_tree over {ENTRY_LEAVES} leaves: {tree_ms} ms")
    step_ms = time_ms(lambda: fn(*step_args), reps=5)
    log(f"phase 5: entry() step over {ENTRY_LEAVES} leaves warm: {step_ms} "
        f"ms")
    return rows


# ---------------------------------------------------------------------------
# phase 6: gear kernels B3-B6 against their plain versions
# ---------------------------------------------------------------------------


def gear_rows(device, case: str, T: int, stride: int, seed: int):
    """Rows for one phase-6 case, built as ``candidates_begin`` builds
    them: ``head`` is a stream head (zero-seeded prefix), ``ragged`` a
    head whose last tile is cut short (nbytes a multiple of neither the
    tile nor 4, zero-padded), ``context`` a slab with 64 real bytes of
    preceding stream, ``zero-row`` a slab with one all-zero tile."""
    import torch

    from dat_replication_protocol_tpu_torch.ops import rabin

    rng = np.random.default_rng(seed)
    nbytes = T * stride - (stride // 3 + 1 if case == "ragged" else 0)
    data = np.zeros(T * stride, dtype=np.uint8)
    data[:nbytes] = np.frombuffer(rng.bytes(nbytes), dtype=np.uint8)
    if case == "zero-row":
        data[stride:2 * stride] = 0
    pre = np.zeros(rabin._PREFIX, dtype=np.uint8)
    if case == "context":
        pre[-rabin.WINDOW:] = np.frombuffer(rng.bytes(rabin.WINDOW), np.uint8)
    words = torch.from_numpy(data.view(np.int32)).to(device)
    pre_row = torch.from_numpy(pre.view(np.int32)).to(device)
    return rabin._build_rows(words, pre_row, T, stride)


# (rows, stride, avg_bits, thin_bits): the chunking shape, then the tests'
GEAR_SHAPES = ((64, 1 << 17, 13, 11), (64, 2048, 8, 9))
GEAR_CASES = ("head", "ragged", "context", "zero-row")


def check_gear_kernels(device) -> None:
    import torch

    from dat_replication_protocol_tpu_torch.ops import rabin
    from dat_replication_protocol_tpu_torch.ops.fused_cdc_hash import (
        gear_window_first_checked_kernel)
    from dat_replication_protocol_tpu_torch.ops.rabin_cuda import (
        gear_candidates_kernel, gear_first_kernel, gear_window_first_kernel)

    for T, stride, avg_bits, thin_bits in GEAR_SHAPES:
        for i, case in enumerate(GEAR_CASES):
            rows = gear_rows(device, case, T, stride, SEED + 10 + i)
            bits = gear_candidates_kernel(rows, avg_bits)
            first = gear_first_kernel(rows, avg_bits)
            wfirst = gear_window_first_kernel(rows, avg_bits, thin_bits)
            cfirst, viol = gear_window_first_checked_kernel(
                rows, avg_bits, thin_bits)
            pairs = {
                "B3": (bits, rabin.gear_candidates_tiled(rows, avg_bits)),
                "B4": (first, rabin.gear_first_tiled(rows, avg_bits)),
                "B5": (wfirst, rabin.gear_window_first(rows, avg_bits,
                                                       thin_bits)),
                "B6": (cfirst, rabin.gear_window_first_checked(
                    rows, avg_bits, thin_bits)[0]),
            }
            sync(device)
            for name, (got, plain) in pairs.items():
                if not torch.equal(got, plain):
                    bad = int((got != plain).sum())
                    raise AssertionError(
                        f"{name} differs from its plain version in {bad} "
                        f"words ({case}, T={T}, stride={stride}, avg_bits="
                        f"{avg_bits}, thin_bits={thin_bits})")
            wpw = (1 << thin_bits) // rabin.PACK
            from_b3 = rabin._first_bit_per_window(
                bits[:, rabin._PREFIX // rabin.PACK:].reshape(-1, wpw))
            if not torch.equal(wfirst, from_b3):
                raise AssertionError(f"B5 differs from B3's window "
                                     f"reduction ({case})")
            if not torch.equal(cfirst, wfirst) or int(viol) != 0:
                raise AssertionError(f"B6 differs from B5 or viol "
                                     f"{int(viol)} ({case})")
            if not bool((wfirst < (1 << 30)).any()):
                raise AssertionError(f"weak phase-6 input: no candidates "
                                     f"({case})")
        log(f"phase 6: B3-B6 byte-exact vs plain at {T} rows x {stride} B + "
            f"256 B, avg_bits {avg_bits}, thin_bits {thin_bits}, cases "
            f"{list(GEAR_CASES)}; B5 == B3's window reduction, B6 == B5, "
            f"viol 0")


def plant_hit(row: np.ndarray, p: int, avg_bits: int) -> None:
    """Make byte ``p`` of ``row`` (one row's bytes, its gear state zero at
    byte 0; p >= 71) a candidate by rewriting bytes p-7..p: the first of
    2^17 random 8-byte runs (drawn from ``p``) that hits, stepped from the
    state at p-8 by the window hash.  (Fewer bytes do not reach every
    13-bit value: the high word of g is linear in the byte.)"""
    from dat_replication_protocol_tpu_torch.ops import rabin

    table = np.array([rabin._gear_g(b) for b in range(256)], dtype=np.uint64)
    runs = np.random.default_rng(p).integers(0, 256, (1 << 17, 8))
    h = np.full(len(runs), window_hashes(row, np.array([p - 8]))[0],
                dtype=np.uint64)
    for j in range(8):
        h = (h << np.uint64(1)) + table[runs[:, j]]
    hits = np.flatnonzero(((h >> np.uint64(32))
                           & np.uint64((1 << avg_bits) - 1)) == 0)
    if not len(hits):
        raise AssertionError(f"no byte run makes byte {p} a candidate")
    row[p - 7:p + 1] = runs[hits[0]]


def check_staged_edges(device, rows: int = 1000) -> dict:
    """Phase 6, the edges: B4, B5 and B6 byte-exact against their plain
    versions on random rows of 128 KiB + 256 B (avg_bits 13) with
    candidates planted in the first and the last byte of B4's spans (one
    that crosses a row boundary among them) and of a row's payload, one
    only in a span's warm-up halo, and a row count whose spans are not a
    multiple of B4's CTAs; B5 and B6 at thin_bits 8, 11 and 16, B5 also
    against B6's ``first`` and the window reduction of the plain B3 and
    B4, B6's ``occ`` against the OR of the plain B3 words over each
    window, its viol 0."""
    import torch

    from dat_replication_protocol_tpu_torch.ops import rabin, rabin_cuda
    from dat_replication_protocol_tpu_torch.ops.fused_cdc_hash import (
        gear_window_first_checked_kernel)

    a = CDC_AVG_BITS
    S = TILE_BYTES + rabin._PREFIX
    ng = S // rabin.GROUP
    sms = rabin_cuda.sm_count(torch.device(device))
    for T in range(rows, 2 * rows + 64):
        # spans not a multiple of the CTAs, and more than them
        g4 = rabin_cuda.staged_geometry(T, S, sms=sms)
        if g4.total_spans % g4.ctas and g4.total_spans > g4.ctas:
            break
    else:
        raise AssertionError("no row count gives ragged persistent loops")
    data = np.frombuffer(np.random.default_rng(SEED + 40).bytes(T * S),
                         dtype=np.uint8).copy().reshape(T, S)
    planted = []
    # B4: first and last byte of span 1, the last byte of the first span
    # that crosses a row boundary (in the next row)
    span = rabin_cuda.STAGED_THREADS
    cross = next(s for s in range(g4.total_spans)
                 if (s * span) // ng != (s * span + span - 1) // ng)
    for flat in (span, 2 * span - 1, cross * span + span - 1):
        r, g = divmod(flat, ng)
        planted.append((r, g * rabin.GROUP + (rabin.GROUP - 1
                                              if flat % span else 0)))
    # B6: the first byte of a row's payload (its first window) and the
    # last byte of a row (its last window)
    planted += [(3, rabin.GROUP), (4, S - 1)]
    for r, p in planted:
        plant_hit(data[r], p, a)
    # a candidate only in the halo of span 3 of B4: the last byte before
    # it, with none in the span's first group
    halo = 3 * span
    hr, hg = divmod(halo, ng)
    plant_hit(data[hr], hg * rabin.GROUP - 1, a)
    rows = torch.from_numpy(data.reshape(T, -1).view(np.int32)).to(device)
    bits = rabin.gear_candidates_tiled(rows, a)
    firsts = rabin.gear_first_tiled(rows, a)
    for r, p in planted + [(hr, hg * rabin.GROUP - 1)]:
        word = int(bits[r, p // 32]) & 0xFFFFFFFF
        if not (word >> (p % 32)) & 1:
            raise AssertionError(f"planted candidate at row {r} byte {p} "
                                 f"is not one")
    if int(firsts[hr, hg]) != rabin.NO_HIT or int(
            firsts[hr, hg - 1]) != rabin.GROUP - 1:
        raise AssertionError("the halo case needs a candidate in the halo "
                             "only")
    got = rabin_cuda.gear_first_kernel(rows, a)
    sync(device)
    if not torch.equal(got, firsts):
        raise AssertionError(f"B4 differs from its plain version in "
                             f"{int((got != firsts).sum())} groups at the "
                             f"span edges")
    for t in (8, 11, 16):
        want, _ = rabin.gear_window_first_checked(rows, a, t)
        first, viol = gear_window_first_checked_kernel(rows, a, t)
        nwin = want.numel()
        f2 = torch.empty(nwin, dtype=torch.int32, device=device)
        occ = torch.empty_like(f2)
        rabin_cuda._launch("gear_window_first_checked", rows, (f2, occ), a, t)
        reduced, want_occ = rabin_cuda.window_reduce(bits, firsts, t)
        b5 = rabin_cuda.gear_window_first_kernel(rows, a, t)
        want5 = rabin.gear_window_first(rows, a, t)
        sync(device)
        if (not torch.equal(first, want) or not torch.equal(f2, want)
                or int(viol) or not torch.equal(occ, want_occ)):
            raise AssertionError(f"B6 at thin_bits {t} differs from its "
                                 f"plain version, viol {int(viol)}")
        for what, other in (("its plain version", want5),
                            ("B6's first", first),
                            ("the window reduction", reduced)):
            if not torch.equal(b5, other):
                raise AssertionError(
                    f"B5 at thin_bits {t} differs from {what} in "
                    f"{int((b5 != other).sum())} windows at the edges")
    return {"rows": T, "planted": len(planted) + 1,
            "spans": (g4.total_spans, g4.ctas)}


# ---------------------------------------------------------------------------
# phases 7 and 8: content addressing and chunk_stream
# ---------------------------------------------------------------------------

CDC_AVG_BITS = 13
CDC_MIN = 2 << 10
CDC_MAX = 32 << 10
CONTENT_BYTES = 3 << 29  # 1.5 GiB: under RESIDENCY_CAP
STREAM_BYTES = 10 << 30  # BASELINE.json configs[3]'s 10 GiB blob
TILE_BYTES = 1 << 17
SLAB_TILES = 8192
# the JAX package's content_address of phase 7's blob and of its edited
# copy, and their delta, as cdc_reference_witness.py prints them
REFERENCE = {
    "chunks": 158774, "edited_chunks": 158737, "delta": 1606,
    "root": "8bac71ee56542810f42720553bd595879dfd731a0aed4982aaeb8f4cd1fc5fb5",
    "edited_root":
        "c3fbd6825a46ce84df6dbf0951ff60192acfd972fa8d9546319baf399addc021"}


BLOB_PIECE = 64 << 20  # make_blob's pieces, one a worker at a time
BLOB_WORKERS = 8


def make_blob(nbytes: int, seed: int = SEED + 20) -> np.ndarray:
    """``nbytes`` random bytes from ``seed``: the bytes of
    ``np.random.default_rng(seed).bytes(nbytes)``, made in pieces on
    ``BLOB_WORKERS`` threads.  ``Generator.bytes`` draws one 64-bit word
    of ``PCG64`` for each 8 bytes, so the piece at byte ``at`` (a
    multiple of 8) starts from the generator advanced by ``at // 8``
    draws; numpy fills each piece without the GIL."""
    from concurrent.futures import ThreadPoolExecutor

    out = np.empty(nbytes, dtype=np.uint8)

    def fill(at: int) -> None:
        bits = np.random.PCG64(seed)
        bits.advance(at // 8)
        n = min(BLOB_PIECE, nbytes - at)
        out[at:at + n] = np.frombuffer(np.random.Generator(bits).bytes(n),
                                       dtype=np.uint8)

    with ThreadPoolExecutor(BLOB_WORKERS) as pool:
        list(pool.map(fill, range(0, nbytes, BLOB_PIECE)))
    return out


def edit_blob(blob: np.ndarray, seed: int = SEED + 21) -> np.ndarray:
    """A copy of ``blob`` with three 100-byte inserts and one 1 KiB
    delete at places drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    at = np.sort(rng.integers(1 << 20, len(blob) - (1 << 20), 4))
    ins = [np.frombuffer(rng.bytes(100), np.uint8) for _ in range(3)]
    return np.concatenate([blob[:at[0]], ins[0], blob[at[0]:at[1]], ins[1],
                           blob[at[1]:at[2]], ins[2], blob[at[2]:at[3]],
                           blob[at[3] + 1024:]])


class GreedyTimer:
    """Adds up the seconds spent in the greedy pass while active
    (``_greedy_select`` is looked up by name at each call) and keeps the
    first call's arguments."""

    def __enter__(self):
        from dat_replication_protocol_tpu_torch.ops import (fused_cdc_hash,
                                                            rabin)

        self.modules = (rabin, fused_cdc_hash)
        self.seconds = 0.0
        self.first = None
        fn = self.saved = rabin._greedy_select

        def timed(*args, **kwargs):
            if self.first is None:
                self.first = args
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0

        for m in self.modules:
            m._greedy_select = timed
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m._greedy_select = self.saved


def window_hashes(buf: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """The gear state at each position from its 64-byte window, in numpy
    uint64 by the closed form h = sum_k g(b[p-k]) << k: a formulation
    independent of the kernels' chains."""
    from dat_replication_protocol_tpu_torch.ops import rabin

    table = np.array([rabin._gear_g(b) for b in range(256)], dtype=np.uint64)
    shifts = np.arange(rabin.WINDOW - 1, -1, -1, dtype=np.uint64)
    out = np.empty(len(pos), dtype=np.uint64)
    for at in range(0, len(pos), 1 << 18):
        p = pos[at:at + (1 << 18)]
        idx = p[:, None] + np.arange(-rabin.WINDOW + 1, 1)[None, :]
        out[at:at + len(p)] = np.sum(table[buf[idx]] << shifts, axis=1,
                                     dtype=np.uint64)
    return out


def check_cuts(buf: np.ndarray, cuts, what: str) -> int:
    """Chunk lengths within [min, max] (the last may be short), and every
    cut that is neither forced nor the end a candidate by the window
    hash.  Returns how many candidate cuts were checked."""
    ends = np.asarray(cuts, dtype=np.int64)
    sizes = np.diff(np.concatenate([[0], ends]))
    if ends[-1] != len(buf) or (sizes > CDC_MAX).any() or (
            sizes[:-1] < CDC_MIN).any():
        raise AssertionError(f"{what}: chunk sizes outside "
                             f"[{CDC_MIN}, {CDC_MAX}]")
    chosen = ends[:-1][sizes[:-1] != CDC_MAX]
    h = window_hashes(buf, chosen)
    if ((h >> np.uint64(32)) & np.uint64((1 << CDC_AVG_BITS) - 1)).any():
        raise AssertionError(f"{what}: a cut is not a candidate")
    return len(chosen)


def run_content(device, blob: np.ndarray) -> dict:
    """Phase 7: content_address over ``blob`` on each route, held against
    hashlib, root_host and the window hash; then delta and reassemble of
    an edited copy."""
    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch.ops import merkle, rabin

    results = {}
    refusals0 = rabin.candidates_begin.refusals
    with GreedyTimer() as greedy:
        for route in rabin.ROUTES:
            sync(device)
            t0 = time.perf_counter()
            s = protocol.content_address(blob, CDC_AVG_BITS, CDC_MIN,
                                         CDC_MAX, route=route, device=device)
            results[route] = (s, time.perf_counter() - t0)
    refusals = rabin.candidates_begin.refusals - refusals0
    s = results["bitmask"][0]
    for route, (other, _) in results.items():
        if other != s or not np.array_equal(other.digests, s.digests):
            raise AssertionError(f"route {route} differs from bitmask")
    if refusals:
        raise AssertionError(f"{refusals} fused1p extractions refused")
    offs, lens = s.extents()
    for i in range(s.nchunks):
        o = int(offs[i])
        if s.digests[i].tobytes() != blake(blob[o:o + int(lens[i])]):
            raise AssertionError(f"chunk {i} digest differs from hashlib")
    if s.root != merkle.root_host(s.digests):
        raise AssertionError("content_address root differs from root_host")
    checked = check_cuts(blob, s.cuts, "phase 7")
    greedy_routes = time_greedy_routes(greedy.first, s.cuts)

    # the JAX package's figures for this blob and edit
    # (cdc_reference_witness.py)
    if s.root.hex() != REFERENCE["root"]:
        raise AssertionError("content_address root differs from the "
                             "reference's")
    edited = edit_blob(blob)
    new = protocol.content_address(edited, CDC_AVG_BITS, CDC_MIN, CDC_MAX,
                                   device=device)
    need = protocol.delta(s, new)
    if new.root.hex() != REFERENCE["edited_root"] or (
            s.nchunks, new.nchunks, len(need)) != (
            REFERENCE["chunks"], REFERENCE["edited_chunks"],
            REFERENCE["delta"]):
        raise AssertionError(
            f"after the edit: {new.nchunks} chunks, delta {len(need)}, root "
            f"{new.root.hex()}; the reference's: {REFERENCE}")
    noffs, nlens = new.extents()
    sent = {i: edited[int(noffs[i]):int(noffs[i] + nlens[i])].tobytes()
            for i in need}
    if protocol.reassemble(new, blob, s, sent) != edited.tobytes():
        raise AssertionError("reassemble did not rebuild the edited bytes")
    return {"summary": s, "seconds": {r: t for r, (_, t) in results.items()},
            "greedy_s": greedy.seconds / len(results), "checked": checked,
            "delta": len(need), "nchunks_new": new.nchunks,
            "greedy_routes": greedy_routes}


def time_greedy_routes(args, cuts) -> dict:
    """The greedy cut pass (``cdc.greedy``) over the first route's
    candidates on each codec route: seconds, candidates and cuts; the
    cuts must be equal on both and to ``content_address``'s."""
    from dat_replication_protocol_tpu_torch.ops import rabin

    out = {"candidates": len(args[0])}
    for name, native in (("native", True), ("python", False)):
        t0 = time.perf_counter()
        got = rabin._greedy_select(*args, native=native)
        out[name] = time.perf_counter() - t0
        if got != list(cuts):
            raise AssertionError(f"the greedy pass on the {name} route "
                                 f"differs from content_address's cuts")
    out["cuts"] = len(cuts)
    return out


def run_chunk_stream(device, blob: np.ndarray, content_cuts) -> dict:
    """Phase 8: chunk_stream over the whole blob in 1 GiB slabs; its cuts
    below phase 7's blob end, less one max chunk, must be phase 7's."""
    import dat_replication_protocol_tpu_torch as protocol

    with GreedyTimer() as greedy:
        sync(device)
        t0 = time.perf_counter()
        cuts = protocol.chunk_stream(blob, CDC_AVG_BITS, CDC_MIN, CDC_MAX,
                                     TILE_BYTES, SLAB_TILES, route="bitmask",
                                     device=device)
        seconds = time.perf_counter() - t0
    checked = check_cuts(blob, cuts, "phase 8")
    limit = CONTENT_BYTES - CDC_MAX
    head = [c for c in cuts if c < limit]
    if head != [c for c in content_cuts if c < limit]:
        raise AssertionError("chunk_stream cuts differ from phase 7's")
    return {"cuts": len(cuts), "seconds": seconds, "greedy_s":
            greedy.seconds, "checked": checked, "shared": len(head),
            "gib_per_s": len(blob) / seconds / (1 << 30)}


SLABBED_EXTRA = 64 << 20  # phase 8's slabbed blob: RESIDENCY_CAP + this
SLAB_HASH_THREADS = 8


def run_slabbed(device, blob: np.ndarray, content_cuts) -> dict:
    """Phase 8: ``content_address`` over the blob's first ``RESIDENCY_CAP``
    + ``SLABBED_EXTRA`` bytes, which must take the slabbed route (its
    ``cdc.hash`` engine note, read with the gate on for the call); every
    chunk digest against ``hashlib`` on threads (``hashlib`` releases the
    GIL), the root against ``root_host``, the cut checks, and its cuts
    below phase 7's blob end, less one max chunk, phase 7's."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch import obs
    from dat_replication_protocol_tpu_torch.ops import merkle
    from dat_replication_protocol_tpu_torch.ops.fused_cdc_hash import (
        RESIDENCY_CAP)

    view = blob[:RESIDENCY_CAP + SLABBED_EXTRA]
    obs_reset()
    obs.enable()
    try:
        sync(device)
        t0 = time.perf_counter()
        s = protocol.content_address(view, CDC_AVG_BITS, CDC_MIN, CDC_MAX,
                                     device=device)
        seconds = time.perf_counter() - t0
        engines = [e["fields"]["engine"]
                   for e in obs.EVENTS.events("device.engine.select")
                   if e["fields"]["component"] == "cdc.hash"]
    finally:
        obs.disable()
        obs_reset()
    if engines != [f"two-pass-{torch.device(device).type}"]:
        raise AssertionError(f"phase 8: content_address over {len(view)} B "
                             f"took {engines}, not the slabbed route")
    t1 = time.perf_counter()
    offs, lens = s.extents()
    got = bytearray(32 * s.nchunks)

    def hash_range(lo: int) -> None:
        for i in range(lo, min(lo + (1 << 14), s.nchunks)):
            o = int(offs[i])
            got[32 * i:32 * i + 32] = blake(view[o:o + int(lens[i])])

    with ThreadPoolExecutor(SLAB_HASH_THREADS) as pool:
        list(pool.map(hash_range, range(0, s.nchunks, 1 << 14)))
    hashed = time.perf_counter() - t1
    if bytes(got) != s.digests.tobytes():
        raise AssertionError("phase 8: a slabbed chunk digest differs from "
                             "hashlib")
    if s.root != merkle.root_host(s.digests):
        raise AssertionError("phase 8: the slabbed root differs from "
                             "root_host")
    checked = check_cuts(view, s.cuts, "phase 8's slabbed content_address")
    limit = CONTENT_BYTES - CDC_MAX
    head = [c for c in s.cuts if c < limit]
    if head != [c for c in content_cuts if c < limit]:
        raise AssertionError("phase 8: the slabbed cuts differ from phase "
                             "7's")
    return {"bytes": len(view), "engines": engines, "chunks": s.nchunks,
            "last_offset": int(offs[-1]), "root": s.root.hex(),
            "seconds": seconds, "gib_per_s": len(view) / seconds / (1 << 30),
            "hashlib_s": hashed, "checked": checked, "shared": len(head),
            "check_s": time.perf_counter() - t1}


# ---------------------------------------------------------------------------
# phase 9: gear and chunk-hash times
# ---------------------------------------------------------------------------

# Per SM and clock of an H100 (compute capability 9.0; the CUDA C++
# programming guide's table of arithmetic instruction throughput): 64
# lanes of 32-bit integer ALU (add, logic, shift, compare, select, LEA),
# 64 of integer multiply-add on the FMA pipe (IMAD in all its forms), and
# four schedulers that each issue one warp instruction = 128 thread
# instructions.  Opcodes in neither set (loads, stores, branches, the
# uniform datapath, VIADD, whose pipe is not documented) count against the
# issue rate only, so the bound stays at or below the least time.
SASS_ALU = frozenset({"IADD3", "LOP3", "LEA", "SEL", "SHF", "ISETP", "PLOP3",
                      "MOV", "PRMT", "IMNMX", "IABS"})
SASS_FMA = frozenset({"IMAD"})
LANES = {"alu": 64, "fma": 64, "issued": 128}
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


_SASS_REG = re.compile(r"(?<![A-Za-z0-9_])(U?[RP])([0-9]+)(\.64)?(?![0-9])")
_SASS_DEST = re.compile(r"U?[RP]([0-9]+|Z|T)(\.64)?")
_SASS_PRED = re.compile(r"P[0-9T]")
# opcodes whose first operand is read, not written
_SASS_NO_DEST = frozenset({"BRA", "EXIT", "WARPSYNC", "BAR", "NOP", "CALL",
                           "RET", "BSSY", "BSYNC"})
_SASS_TEXT: dict[str, str] = {}


def sass_listing(name: str) -> str:
    """``cuobjdump -sass`` of the built library ``name``."""
    from dat_replication_protocol_tpu_torch.ops import _build

    if name not in _SASS_TEXT:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        _SASS_TEXT[name] = subprocess.run(
            [tool, "-sass", str(_build.library_path(name))],
            capture_output=True, text=True, timeout=120, check=True).stdout
    return _SASS_TEXT[name]


def parse_sass(text: str, kernel: str) -> list[tuple]:
    """``(address, guard, opcode, operands)`` of every instruction of the
    one function in a ``cuobjdump -sass`` listing named ``kernel``; the
    guard is the predicate (``@!P0``), or empty."""
    funcs = [f for f in text.split("Function : ")[1:]
             if kernel in f.split("\n", 1)[0]]
    if len(funcs) != 1:
        raise AssertionError(f"{len(funcs)} SASS functions match {kernel}")
    return [(int(a, 16), p.strip(), op, args.strip())
            for a, p, op, args in _SASS_LINE.findall(funcs[0])]


def _sass_regs(text: str) -> list[str]:
    """Registers and predicates named in ``text``; ``R8.64`` is R8 and R9."""
    out = []
    for kind, n, wide in _SASS_REG.findall(text):
        out.append(f"{kind}{n}")
        if wide:
            out.append(f"{kind}{int(n) + 1}")
    return out


def _sass_operands(op: str, args: str) -> tuple[list, list]:
    """(written, read) registers and predicates of one instruction: the
    first operand is written when it is a register, with the predicates
    right after it (carry-outs, compare results); SHFL also writes its
    second operand."""
    ops = [o.strip() for o in args.split(",")] if args else []
    if (not ops or op.split(".")[0] in _SASS_NO_DEST
            or not _SASS_DEST.fullmatch(ops[0])):
        return [], _sass_regs(args)
    k = 2 if op.startswith("SHFL") else 1
    while k < len(ops) and _SASS_PRED.fullmatch(ops[k]):
        k += 1
    return ([r for o in ops[:k] for r in _sass_regs(o)],
            [r for o in ops[k:] for r in _sass_regs(o)])


def _branch_target(args: str) -> int:
    return int(re.findall(r"0x[0-9a-f]+", args)[-1], 16)


def sass_loop_body(insts) -> list[tuple]:
    """The instructions of the function's largest innermost loop, from
    the target of a guarded backward branch to that branch."""
    at = {ins[0]: i for i, ins in enumerate(insts)}
    loops = [(at[_branch_target(args)], i)
             for i, (addr, guard, op, args) in enumerate(insts)
             if op.split(".")[0] == "BRA" and guard
             and _branch_target(args) <= addr]
    inner = [(h, t) for h, t in loops
             if not any(h <= t2 < t for _, t2 in loops)]
    if not inner:
        raise AssertionError("no loop in the SASS")
    head, tail = max(inner, key=lambda lo: lo[1] - lo[0])
    return insts[head:tail + 1]


def sass_chain(insts) -> int:
    """The longest dependent path through one pass of the body of the
    function's largest innermost loop, in integer ALU and IMAD
    instructions: each of them is one step past the latest register or
    predicate it reads; any other instruction (a load, a shuffle) passes
    its inputs' depth on at no step, so the path is a lower bound on the
    chain."""
    depth: dict[str, int] = {}
    longest = 0
    for _, guard, op, args in sass_loop_body(insts):
        written, read = _sass_operands(op, args)
        base = op.split(".")[0]
        d = max((depth.get(r, 0) for r in read + _sass_regs(guard)),
                default=0) + (base in SASS_ALU or base in SASS_FMA)
        for r in written:
            depth[r] = d
        longest = max(longest, d)
    return longest


def b1_sass(thread: str = "blake2b_thread_kernel",
            quad: str = "blake2b_quad_kernel") -> dict:
    """B1's one-thread variant from its SASS: what one thread issues, by
    pipe, as a part per item and a part per block (the walk is linear in
    the loop's trips), and the dependent path of one compression (the
    loop body is one block); and the instructions of the four-lane
    variant's block loop, one lane's share of a compression.  The chained
    entry's kernels are walked by naming them."""
    insts = parse_sass(sass_listing("blake2b"), thread)
    one, two = sass_path(insts, 1), sass_path(insts, 2)
    quad = parse_sass(sass_listing("blake2b"), quad)
    return {"per_block": {k: two[k] - one[k] for k in LANES},
            "per_item": {k: 2 * one[k] - two[k] for k in LANES},
            "chain": sass_chain(insts),
            "quad_per_block": len(sass_loop_body(quad))}


def chain_latency(device) -> dict:
    """Cycles per dependent step of the G mix's integer instructions,
    measured on the card: the probe ``csrc/chain_latency.cu`` runs a
    serial chain of 64-bit xor, rotate and add for 2,048 and 4,096 loop
    trips and reads the SM clock around them; the difference over 2,048
    trips (the launch and clock reads cancel) over the dependent path of
    its loop body, read from its SASS."""
    import torch

    from dat_replication_protocol_tpu_torch.ops import _build

    lib = _build.load("chain_latency")
    out = torch.zeros(1, dtype=torch.int32, device=device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)

    def run(iters: int) -> int:
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.dat_chain_latency(out.data_ptr(), cycles.data_ptr(), iters,
                                   SEED, stream)
        if rc != 0:
            raise RuntimeError(f"chain probe launch failed: cudaError {rc}")
        torch.cuda.synchronize()
        return int(cycles.item())

    run(16)
    short = min(run(2048) for _ in range(3))
    long = min(run(4096) for _ in range(3))
    per_trip = (long - short) / 2048
    chain = sass_chain(parse_sass(sass_listing("chain_latency"),
                                  "chain_latency_kernel"))
    return {"cycles": per_trip / chain, "chain": chain,
            "cycles_per_trip": per_trip}


def _is_wait_loop(insts, head: int, tail: int) -> bool:
    """Whether the loop from ``insts[head]`` to its branch ``insts[tail]``
    spins on an ``mbarrier`` try-wait: such a loop runs as often as the
    copy it waits for takes, so the walk counts it once.  A loop around
    one (another backward branch inside) is not a wait loop."""
    body = insts[head:tail]
    return any("TRYWAIT" in op for _, _, op, _ in body) and not any(
        op.split(".")[0] == "BRA" and _branch_target(args) <= addr
        for addr, _, op, args in body)


def sass_path(insts, trips=None, skip_warm: bool = False) -> dict:
    """Instructions one thread issues, by pipe, walking the kernel's
    control flow from its entry: a guarded EXIT falls through (the thread
    is in range); a forward branch over a CALL is taken (the 64-bit
    division's slow path, which only 2^32 threads or more need); another
    forward branch falls through, but ``skip_warm`` takes the first of
    them (a group-0 thread skipping its warm-up).  A guarded backward
    branch closes a loop: an ``mbarrier`` wait loop runs once; every other
    loop runs as many times as ``trips`` gives it each time it is entered
    (an inner loop starts counting again when its outer loop comes back).
    ``trips`` is None for a kernel without loops, an int for a kernel with
    exactly one, or one count per loop in the order the walk first closes
    them (for nested loops, inner before outer)."""
    at = {ins[0]: i for i, ins in enumerate(insts)}
    counts = {"alu": 0, "fma": 0, "issued": 0}
    per_loop = [] if trips is None else (
        [trips] if isinstance(trips, int) else list(trips))
    order: list[int] = []  # loop branches, in the order first closed
    seen: dict[int, int] = {}
    i = 0
    while True:
        addr, guarded, op, args = insts[i]
        base = op.split(".")[0]
        counts["issued"] += 1
        counts["alu"] += base in SASS_ALU
        counts["fma"] += base in SASS_FMA
        if base == "EXIT" and not guarded:
            break
        if base in ("CALL", "RET"):
            raise AssertionError(f"SASS walk reached {op} at {addr:#x}")
        if base == "BRA":
            target = _branch_target(args)
            jump = not guarded
            if guarded and target <= addr:
                if _is_wait_loop(insts, at[target], i):
                    jump = False
                else:
                    if trips is None:
                        raise AssertionError(f"unexpected loop at {addr:#x}")
                    if addr not in order:
                        order.append(addr)
                        if len(order) > len(per_loop):
                            raise AssertionError(_loops_expected(
                                len(order), len(per_loop)))
                    seen[addr] = seen.get(addr, 0) + 1
                    jump = seen[addr] < per_loop[order.index(addr)]
                    if not jump:
                        seen[addr] = 0
            elif guarded and any(ins[2].startswith("CALL")
                                 for ins in insts[i + 1:at[target]]):
                jump = True
            elif guarded and skip_warm:
                jump, skip_warm = True, False
            if jump:
                i = at[target]
                continue
        i += 1
    if len(order) != len(per_loop):
        raise AssertionError(_loops_expected(len(order), len(per_loop)))
    return counts


def _loops_expected(found: int, want: int) -> str:
    return (f"{found} loops where one was expected" if want == 1 else
            f"{found} loops where {want} were expected")


def sass_bound(name: str, nthreads: int, warm_skips: int = 0,
               trips: int | None = None) -> tuple[float, dict]:
    """Least ms for the instructions that kernel ``name`` issues over
    ``nthreads`` threads, ``warm_skips`` of them skipping the warm-up,
    from ``cuobjdump -sass`` of its built library: each pipe's count
    over its rate, the largest of them.  Also returns one thread's counts
    by pipe."""
    insts = parse_sass(sass_listing(name), f"{name}_kernel")
    one = sass_path(insts, trips)
    short = sass_path(insts, trips, skip_warm=True)
    cycles = max(((nthreads - warm_skips) * one[k] + warm_skips * short[k])
                 / LANES[k] for k in LANES)
    return cycles / (SM_COUNT * SM_HZ) * 1e3, one


def staged_sass(name: str) -> tuple[dict, dict]:
    """One thread of the staged kernel ``name`` (B4, ``gear_first``)
    from its SASS: the instructions it issues by pipe per span and once
    per CTA.  The walk runs the span loop once and twice (it is linear in
    that loop's trips) and falls through every forward branch, so it
    counts the issue of the next span's copies at every span."""
    insts = parse_sass(sass_listing(name), f"{name}_kernel")
    one, two = (sass_path(insts, k) for k in (1, 2))
    return ({k: two[k] - one[k] for k in LANES},
            {k: 2 * one[k] - two[k] for k in LANES})


def staged_bound(name: str, geom) -> tuple[float, dict]:
    """Least ms for the instructions the staged kernel ``name`` issues
    over ``geom``'s spans and CTAs, each pipe over its rate, the largest
    of them; and one thread's counts per span."""
    from dat_replication_protocol_tpu_torch.ops.rabin_cuda import (
        STAGED_THREADS)

    per_span, per_cta = staged_sass(name)
    cycles = max(STAGED_THREADS * (geom.total_spans * per_span[k]
                                   + geom.ctas * per_cta[k]) / LANES[k]
                 for k in LANES)
    return cycles / (SM_COUNT * SM_HZ) * 1e3, per_span


def res_usage(name: str) -> dict:
    """Registers and static shared bytes of every function in the built
    library ``name``, from ``cuobjdump -res-usage``, by function name."""
    from dat_replication_protocol_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-res-usage", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return {f: {"registers": int(r), "static_shared": int(sh)} for f, r, sh in
            re.findall(r"Function ([^:\s]+):\s*REG:(\d+)\s.*?SHARED:(\d+)",
                       text)}


def _in_turns(fns: dict, reps: int) -> dict:
    """Device ms of each ``fns`` entry by CUDA events over ``reps``
    launches, timed in turns (the list, then the list reversed) after one
    untimed turn of the whole list: the faster of the two turns and both
    readings.  (Without the untimed turn, the first kernels timed right
    after the plain versions read about 20% high.)"""
    for fn in fns.values():
        time_ms(fn, reps)
    got = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        got[name].append(time_ms(fns[name], reps))
    return {name: (min(v), v) for name, v in got.items()}


def time_gear_kernels(device, launches: dict) -> list[dict]:
    """B3-B6 on one 1 GiB slab of random rows (8,192 x 128 KiB + 256 B),
    held byte-exact against the plain versions at the same shape and
    timed in turns beside them and the bounds.  B3 (the one-thread scan
    of gear.cuh) is B4's control; B5 is B6's window scan without the
    occupancy fold.  B4's and B6's bound is also given for the same work
    as B3 and B5 issue it."""
    import torch

    from dat_replication_protocol_tpu_torch.ops import rabin, rabin_cuda
    from dat_replication_protocol_tpu_torch.ops.fused_cdc_hash import (
        gear_window_first_checked_kernel)
    from dat_replication_protocol_tpu_torch.ops.rabin_cuda import (
        gear_candidates_kernel, gear_first_kernel, gear_window_first_kernel)

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 30)
    S = TILE_BYTES + rabin._PREFIX
    rows = torch.randint(-(1 << 31), 1 << 31, (SLAB_TILES, S // 4),
                         dtype=torch.int32, device=device, generator=gen)
    a, t = CDC_AVG_BITS, 11
    nbytes = rows.numel() * 4
    ngroups = SLAB_TILES * (S // rabin.GROUP)
    nwin = SLAB_TILES * (TILE_BYTES >> t)
    gpw = (1 << t) // rabin.GROUP
    geom = rabin_cuda.staged_geometry(
        SLAB_TILES, S, sms=rabin_cuda.sm_count(torch.device(device)))
    # (name, source, TPU kernel, kernel, plain version, output bytes,
    #  threads, threads that skip the warm-up, loop trips, the kernel
    #  that issues the same work)
    specs = [
        ("gear_candidates", "gear_candidates.cu", "ops/rabin_pallas.py:112",
         lambda: (gear_candidates_kernel(rows, a),),
         lambda: (rabin.gear_candidates_tiled(rows, a),), nbytes // 8,
         ngroups, SLAB_TILES, None, None),
        ("gear_first", "gear_first.cu", "ops/rabin_pallas.py:407",
         lambda: (gear_first_kernel(rows, a),),
         lambda: (rabin.gear_first_tiled(rows, a),), nbytes // 64,
         ngroups, SLAB_TILES, None, "gear_candidates"),
        ("gear_window_first", "gear_window_first.cu",
         "ops/rabin_pallas.py:284",
         lambda: (gear_window_first_kernel(rows, a, t),),
         lambda: (rabin.gear_window_first(rows, a, t),), 4 * nwin,
         nwin, 0, gpw, None),
        ("gear_window_first_checked", "gear_window_first_checked.cu",
         "ops/fused_cdc_hash_pallas.py:163",
         lambda: gear_window_first_checked_kernel(rows, a, t),
         lambda: rabin.gear_window_first_checked(rows, a, t), 8 * nwin,
         nwin, 0, gpw, "gear_window_first"),
    ]
    plain_ms, own_ops = {}, {}
    for name, _, _, kernel, plain, *_ in specs:
        torch.cuda.empty_cache()
        plain_ms[name] = time_ms(plain, reps=1)
        want = plain()
        got = kernel()
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        if err:
            raise AssertionError(f"{name} differs from its plain version on "
                                 f"the 1 GiB slab: max_abs_err {err}")
        if name == "gear_window_first_checked" and int(got[1]) != 0:
            raise AssertionError(f"B6 viol {int(got[1])} on the 1 GiB slab")
        del want, got
    torch.cuda.empty_cache()
    timed = _in_turns({name: kernel for name, _, _, kernel, *_ in specs},
                      reps=10)
    out = []
    for (name, src, replaces, kernel, plain, out_bytes, nthreads, skips,
         trips, same_work) in specs:
        ops_ms, per_thread = staged_bound(name, geom) if (
            name == "gear_first") else sass_bound(name, nthreads, skips,
                                                  trips)
        row = {"name": name, "route": "cuda",
               "source": f"dat_replication_protocol_tpu_torch/csrc/{src}",
               "replaces": f"dat_replication_protocol_tpu/{replaces}",
               "launches": launches[name], "max_abs_err": 0,
               "ms": timed[name][0], "turns_ms": timed[name][1],
               "plain_ms": plain_ms[name], "library_ms": None,
               "shape": list(rows.shape), "plain_shape": list(rows.shape),
               "sass_per_thread": per_thread,
               "bytes_ms": (nbytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
               "ops_ms": ops_ms}
        use = [v for f, v in res_usage(name).items() if f"{name}_kernel" in f]
        row["registers"] = use[0]["registers"] if use else None
        own_ops[name] = ops_ms
        if same_work is not None:
            # the bound of the same work as same_work issues it; the
            # smaller of the two operation bounds is the one that counts
            row.update({"same_work": same_work,
                        "same_work_ms": timed[same_work][0],
                        "ops_same_work_ms": own_ops[same_work]})
            ops_ms = min(ops_ms, own_ops[same_work])
        if name == "gear_first":
            row["geometry"] = {**geom._asdict(),
                               "threads": rabin_cuda.STAGED_THREADS,
                               "smem_bytes": rabin_cuda.STAGED_SMEM}
        row["bound_ms"], row["bound_by"] = largest(operations=ops_ms,
                                                   bytes=row["bytes_ms"])
        out.append(row)

    return out


def time_chunk_bucket(device, blob: np.ndarray, cuts, sass: dict,
                      latency: float) -> dict:
    """B1 at the chunk bucket with the most bytes in phase 7's cuts: one
    launch of it as ``hash_cuts_device`` packs it (at most 64 MiB of
    padded messages), each variant beside the plain version and the
    bounds."""
    import torch

    from dat_replication_protocol_tpu_torch.batch.feed import (
        bucketed_extents)
    from dat_replication_protocol_tpu_torch.ops import blake2b as b2b
    from dat_replication_protocol_tpu_torch.ops import rabin
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        blake2b_packed_kernel)
    from dat_replication_protocol_tpu_torch.ops.fused_cdc_hash import (
        pack_extents_device)

    ends = np.asarray(cuts, dtype=np.int64)
    offs = np.concatenate([[0], ends[:-1]])
    lens = ends - offs
    buckets = bucketed_extents(lens)
    nb = max(buckets, key=lambda b: len(buckets[b]) * b)
    idx = buckets[nb][:max(1, (64 << 20) // (nb * 128))]
    T = -(-len(blob) // TILE_BYTES)
    words = rabin.stage_words(blob, T * TILE_BYTES // 4, torch.device(device))
    args = pack_extents_device(words.view(torch.uint8), offs[idx], lens[idx],
                               nb)
    out = time_b1("phase 7's largest chunk bucket", args, lens[idx], sass,
                  latency, reps=10)
    out["plain_ms"] = time_ms(lambda: b2b.blake2b_packed(*args), reps=1)
    if max_abs_err(blake2b_packed_kernel(*args), b2b.blake2b_packed(*args)):
        raise AssertionError("B1 differs from its plain version at the "
                             "chunk bucket")
    out["buckets"] = {int(b): len(v) for b, v in sorted(buckets.items())}
    return out


# ---------------------------------------------------------------------------
# phase 10: reconciliation at BASELINE.json configs[4]'s width
# ---------------------------------------------------------------------------

DIFF_LEAVES = 1 << 20  # leaves per snapshot
SKETCH_ROWS = 1_000_000  # records per sketch log, as bench.py bench_merkle
SKETCH_INSERTS = 1_000
SKETCH_LOG2_SLOTS = 21
RATELESS_K = 1_000  # symmetric difference, half only in each set
N_UPDATES = 1024
N_PROOFS = 64


def encode_rows(values, rows) -> list[bytes]:
    """Change records of row numbers ``rows`` with ``values``, encoded by
    the port's change codec."""
    from dat_replication_protocol_tpu_torch import encode_change

    return [encode_change({"key": f"row-{i}", "change": i + 1, "from": 0,
                           "to": 1, "value": v})
            for i, v in zip(map(int, rows), values)]


def random_values(rng, n: int) -> list[bytes]:
    lens = rng.integers(40, 201, n)
    buf = rng.bytes(int(lens.sum()))
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [buf[offs[i]:offs[i + 1]] for i in range(n)]


def hash_records(records, device):
    """BLAKE2b-256 of each record by ``feed.hash_extents_device`` (B1):
    (n, 4) hi/lo halves on the card."""
    from dat_replication_protocol_tpu_torch.batch.feed import (
        hash_extents_device)

    lens = np.array([len(r) for r in records], dtype=np.int64)
    buf = np.frombuffer(b"".join(records), np.uint8)
    return hash_extents_device(buf, np.cumsum(lens) - lens, lens,
                               device=device)


def host_sketch(records, keys, log2_slots: int):
    """The sketch table and slots from ``hashlib`` digests and
    ``np.add.at``: the independent reference of ``LogSummary``."""
    nslots = 1 << log2_slots
    rd = np.frombuffer(b"".join(blake(r) for r in records), "<u4")
    kd = np.frombuffer(b"".join(blake(k) for k in keys), "<u4")
    slots = kd.reshape(-1, 8)[:, 0] & np.uint32(nslots - 1)
    table = np.zeros((nslots, 8), dtype=np.uint32)
    np.add.at(table, slots, rd.reshape(-1, 8))
    return table, slots.astype(np.int64)


def run_reconcile(device, n=DIFF_LEAVES, rows=SKETCH_ROWS,
                  inserts=SKETCH_INSERTS, log2_slots=SKETCH_LOG2_SLOTS,
                  k=RATELESS_K, n_updates=N_UPDATES,
                  n_proofs=N_PROOFS) -> dict:
    """Phase 10's main path, once: the tree diff of two change-log
    snapshots, ``update_leaves``, proofs, the sketch reconcile, the
    tree-sync descent over the sketches and the rateless decode, each
    held against an independent reference.  The launch counters are set
    to 0 at the start and read at the end."""
    import torch

    from dat_replication_protocol_tpu_torch import weights
    from dat_replication_protocol_tpu_torch.ops import merkle, rateless
    from dat_replication_protocol_tpu_torch.ops import reconcile as rec
    from dat_replication_protocol_tpu_torch.runtime.tree_sync import (
        TreeSyncSession, sync as tree_sync)

    rng = np.random.default_rng(SEED + 40)
    half = k // 2
    out = {"leaves": n, "sketch_records": 2 * rows + inserts}

    # 1. two snapshots: A's records (and k/2 more, only in the rateless
    # step's B set), B = A with 1% of the values rewritten
    t0 = time.perf_counter()
    recs_a = encode_rows(random_values(rng, n + half), range(n + half))
    rewritten = np.sort(rng.choice(n, n // 100, replace=False))
    recs_b = recs_a[:n]
    for i, r in zip(rewritten, encode_rows(random_values(rng, len(rewritten)),
                                           rewritten)):
        recs_b[i] = r
    out["encode_s"] = time.perf_counter() - t0
    digests_a = [blake(r) for r in recs_a[:n]]
    digests_b = [blake(r) for r in recs_b]

    reset_counters()
    a_all = hash_records(recs_a, device)
    a_hh, a_hl = a_all[0][:n], a_all[1][:n]
    b_hh, b_hl = hash_records(recs_b, device)
    idx = merkle.diff_snapshots(a_hh, a_hl, b_hh, b_hl)
    bits, root_a, root_b = merkle.diff_root_guided_packed(a_hh, a_hl, b_hh,
                                                          b_hl)
    packed_idx = np.nonzero(merkle.unpack_mask(bits, n))[0]
    dense = np.nonzero((merkle.digest_matrix(a_hh, a_hl)
                        != merkle.digest_matrix(b_hh, b_hl)).any(axis=1))[0]
    for name, got in (("diff_snapshots", idx), ("the packed diff",
                                                 packed_idx)):
        if not (np.array_equal(got, dense)
                and np.array_equal(got, rewritten)):
            raise AssertionError(f"{name} finds {len(got)} leaves; the dense "
                                 f"compare {len(dense)}, rewritten "
                                 f"{len(rewritten)}")
    roots = [merkle.digests_from_device(*r)[0] for r in (root_a, root_b)]
    if roots != [merkle.root_host(digests_a), merkle.root_host(digests_b)]:
        raise AssertionError("a diff root differs from root_host")
    out["differing"] = len(idx)

    # 2. K leaf updates on A's tree against a rebuild
    levels_hh, levels_hl = merkle.build_tree(a_hh, a_hl)
    kept = [t.clone() for t in levels_hh + levels_hl]
    pos = np.sort(rng.choice(n, n_updates, replace=False))
    words = rng.integers(0, 1 << 32, (2, n_updates, 4), dtype=np.uint64)
    new_hh, new_hl = (torch.from_numpy(w.astype(np.uint32).view(np.int32))
                      .to(device) for w in words)
    up_hh, up_hl = merkle.update_leaves(levels_hh, levels_hl, pos, new_hh,
                                        new_hl)
    at = torch.as_tensor(pos, device=device)
    leaf_hh, leaf_hl = a_hh.clone(), a_hl.clone()
    leaf_hh[at], leaf_hl[at] = new_hh, new_hl
    want_hh, want_hl = merkle.build_tree(leaf_hh, leaf_hl)
    if not all(torch.equal(x, y) for x, y in zip(up_hh + up_hl,
                                                  want_hh + want_hl)):
        raise AssertionError("update_leaves differs from a rebuild")
    if not all(torch.equal(x, y) for x, y in zip(levels_hh + levels_hl,
                                                  kept)):
        raise AssertionError("update_leaves wrote into its input tree")
    del kept, leaf_hh, leaf_hl, want_hh, want_hl
    out["update"] = (levels_hh, levels_hl, pos, new_hh, new_hl)

    # 3. proofs against A's root, and two that must fail
    root = roots[0]
    for i in rng.choice(n, n_proofs, replace=False).tolist():
        path = merkle.prove(levels_hh, levels_hl, i)
        if not merkle.verify_proof(root, digests_a[i], i, path, n):
            raise AssertionError(f"the proof of leaf {i} does not verify")
    bad = list(path)
    bad[len(bad) // 2] = bytes([bad[len(bad) // 2][0] ^ 1]) + bad[
        len(bad) // 2][1:]
    if (merkle.verify_proof(root, digests_a[i], i, bad, n)
            or merkle.verify_proof(root, digests_a[i], i ^ 1, path, n)):
        raise AssertionError("a tampered proof or a wrong index verifies")

    # 4. the sketch reconcile at bench_merkle's shape
    keys_a = [b"row-%07d" % i for i in range(rows)]
    srecs_a = [b"value-of:" + key for key in keys_a]
    keys_b, srecs_b = list(keys_a), list(srecs_a)
    at_rows = sorted(rng.integers(0, rows, inserts).tolist(), reverse=True)
    for j, p in enumerate(at_rows):
        keys_b.insert(p, b"new-%d" % j)
        srecs_b.insert(p, b"value-of-new-%d" % j)
    t0 = time.perf_counter()
    sa = rec.LogSummary(srecs_a, keys_a, log2_slots, device=device)
    sb = rec.LogSummary(srecs_b, keys_b, log2_slots, device=device)
    diff = rec.reconcile(sa, sb)
    out["reconcile_s"] = time.perf_counter() - t0
    for s, recs, keys in ((sa, srecs_a, keys_a), (sb, srecs_b, keys_b)):
        table, slots = host_sketch(recs, keys, log2_slots)
        if not (np.array_equal(weights.table_to_numpy(s.table), table)
                and np.array_equal(s.slots, slots)):
            raise AssertionError("a sketch differs from hashlib + np.add.at")
    new_keys = {b"new-%d" % j for j in range(inserts)}
    if not new_keys <= set(diff["b_keys"]):
        raise AssertionError("an inserted key is missing from b_keys")
    new_slots = np.unique(sb.slots[[i for i, key in enumerate(keys_b)
                                    if key in new_keys]])
    if not np.array_equal(diff["slots"], new_slots):
        raise AssertionError("the differing slots are not the inserted "
                             "keys' slots")
    out["sketch"] = (srecs_a, keys_a, srecs_b, keys_b)
    out["slots"] = len(diff["slots"])

    # 5. the tree-sync descent over the two sketch tables' B2 trees
    ta = TreeSyncSession(*merkle.build_tree(*rec.table_leaves(sa.table)))
    tb = TreeSyncSession(*merkle.build_tree(*rec.table_leaves(sb.table)))
    transcript = []
    if tree_sync(ta, tb, transcript) != diff["slots"].tolist():
        raise AssertionError("tree_sync's slots differ from the sketch diff")
    out["sync_bytes"] = sum(nb for _, nb in transcript)
    out["sync_messages"] = len(transcript)
    del sa, sb, ta, tb

    # 6. rateless: A's leaf digests against B = A less the first k/2,
    # plus k/2 records only in B (bench.py config 11's split)
    a_el = merkle.digest_matrix(a_hh, a_hl)
    b_el = np.concatenate([a_el[half:],
                           merkle.digest_matrix(a_all[0][n:], a_all[1][n:])])
    t0 = time.perf_counter()
    sender = rateless.CodedSymbols(rateless.dedupe_digests(a_el)[0],
                                   device=device)
    decoder = rateless.PeelDecoder(b_el, device=device)
    sent, m, got = 0, 0, None
    while got is None:
        if m > 64 * k:
            raise AssertionError(f"no decode after {m} symbols")
        m = 128 if m == 0 else 2 * m
        decoder.add_symbols(sent, sender.extend(m)[sent:])
        sent = m
        got = decoder.try_decode()
    out["decode_s"] = time.perf_counter() - t0
    out["symbols"] = m
    digests, signs = got
    want = {+1: {d.tobytes() for d in a_el[:half]},
            -1: {d.tobytes() for d in b_el[-half:]}}
    for sign, elems in want.items():
        if {d.tobytes() for d in digests[signs == sign]} != elems:
            raise AssertionError(f"the rateless decode's sign {sign} set "
                                 "differs from the true difference")
    if len(digests) != k:
        raise AssertionError(f"decoded {len(digests)} elements, not {k}")
    for prefix, el in ((sender, sender.digests),
                       (decoder.local, decoder.local.digests)):
        e, i = rateless.IndexCursor(el).advance(m)
        host = rateless.build_symbols_host(rateless.element_rows(el), e, i, m)
        if not np.array_equal(prefix.extend(m), host):
            raise AssertionError("device-built coded symbols differ from "
                                 "build_symbols_host")
    out["launches"] = read_counters()
    if min(out["launches"]["blake2b"], out["launches"]["merkle_level"]) == 0:
        raise AssertionError(f"phase 10 launches {out['launches']}")
    out["diff"] = (a_hh, a_hl, b_hh, b_hl)
    out["dense"], out["roots"] = dense, roots
    return out


def time_reconcile(device, run: dict) -> dict:
    """Phase 10's times: the diff's entries/s (median of 10 warm reps,
    packed-mask D2H and index extraction included, as bench_merkle
    times it), B2 at the 2^21 -> 2^20 level beside its plain version and
    bound, ``update_leaves`` ms and two warm repeats of the sketch
    reconcile."""
    import statistics

    import torch

    from dat_replication_protocol_tpu_torch.ops import merkle
    from dat_replication_protocol_tpu_torch.ops import reconcile as rec
    from dat_replication_protocol_tpu_torch.ops.merkle_cuda import (
        merkle_level_kernel)

    a_hh, a_hl, b_hh, b_hl = run["diff"]
    n = a_hh.shape[0]

    def diff():
        bits, _, _ = merkle.diff_root_guided_packed(a_hh, a_hl, b_hh, b_hl)
        return np.nonzero(merkle.unpack_mask(bits, n))[0]

    diff()
    reps = []
    for _ in range(10):
        t0 = time.perf_counter()
        diff()
        reps.append(time.perf_counter() - t0)
    out = {"diff_s": reps, "diff_entries_s": n / statistics.median(reps)}

    hh, hl = torch.cat([a_hh, b_hh]), torch.cat([a_hl, b_hl])
    out["b2_ms"] = device_ms(lambda: merkle_level_kernel(hh, hl), 20)
    out["b2_plain_ms"] = time_ms(lambda: merkle.merkle_level(hh, hl), reps=1)
    out["b2_err"] = max_abs_err(merkle_level_kernel(hh, hl),
                                merkle.merkle_level(hh, hl))
    if out["b2_err"]:
        raise AssertionError("B2 differs from its plain version at 2^21")
    out["b2"] = b2_bound(n)
    out["update_ms"] = time_ms(lambda: merkle.update_leaves(*run["update"]),
                               reps=10)

    srecs_a, keys_a, srecs_b, keys_b = run["sketch"]
    # the summary's scatter-add alone, on the device, from A's digests
    hh, hl = hash_records(srecs_a + keys_a, device)
    out["summarize_ms"] = time_ms(lambda: rec._summarize(
        hh, hl, len(srecs_a), SKETCH_LOG2_SLOTS), reps=5)
    del hh, hl
    out["reconcile_s"] = []
    for _ in range(2):
        t0 = time.perf_counter()
        rec.reconcile(rec.LogSummary(srecs_a, keys_a, SKETCH_LOG2_SLOTS,
                                     device=device),
                      rec.LogSummary(srecs_b, keys_b, SKETCH_LOG2_SLOTS,
                                     device=device))
        out["reconcile_s"].append(time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# phase 11: change-log replay at BASELINE.json configs[1]
# ---------------------------------------------------------------------------

REPLAY_BLOCK = 4096  # distinct records, as bench.py bench_replay builds
REPLAY_REPS = 245  # the block repeated to 1,003,520 rows
REPLAY_BATCH_ROWS = 65536  # rows a ChangeBatch frame (bench_wire_batch)
SESSION_ROWS = REPLAY_BLOCK * REPLAY_REPS  # rows of each digest session
# the per-row handler's session: a quarter of them (all took 18-23 s of the
# host, H100 80GB HBM3, 700 W; it checks a delivery path, not a metric)
PER_ROW_ROWS = SESSION_ROWS // 4
# the change_batch session on the Python codec route: a quarter too (the
# full session took 23.4 s, H100 80GB HBM3, 700 W, within 6% of the
# native route's; it checks the route's deliveries and digests)
PY_BATCH_ROWS = SESSION_ROWS // 4
SESSION_BLOBS = 4


def replay_records() -> list[dict]:
    """bench_replay's block of distinct Change records."""
    return [{"key": f"key-{i:07d}", "change": i, "from": i, "to": i + 1,
             "value": b"v" * (i % 48), "subset": "s" if i % 3 else None}
            for i in range(REPLAY_BLOCK)]


def same_rows(cols, wire: bytes, what: str) -> None:
    """``cols`` holds the rows of the per-record ``wire``: its per-record
    re-encode is that wire byte for byte."""
    from dat_replication_protocol_tpu_torch.runtime import replay

    if replay.encode_change_columns(cols) != wire:
        raise AssertionError(f"the {what} wire's rows differ from the "
                             "per-record wire's")


def mixed_wire(wire: bytes, cols, frames) -> bytes:
    """Runs of per-record frames (cut from ``wire``) between batch frames
    of REPLAY_BATCH_ROWS rows, alternately, and one blob frame."""
    from dat_replication_protocol_tpu_torch.runtime import replay
    from dat_replication_protocol_tpu_torch.wire.framing import (
        TYPE_BLOB, frame)

    ends = (frames.starts + frames.lens).tolist()
    parts = []
    for k, lo in enumerate(range(0, len(cols), REPLAY_BATCH_ROWS)):
        hi = min(len(cols), lo + REPLAY_BATCH_ROWS)
        if k % 2:
            parts.append(wire[ends[lo - 1]:ends[hi - 1]])
        else:
            parts.append(replay.encode_batch_frames(
                replay._slice_columns(cols, lo, hi), REPLAY_BATCH_ROWS))
        if k == 1:
            parts.append(frame(TYPE_BLOB, b"a blob between the runs"))
    return b"".join(parts)


def replay_session(device, records, negotiated: bool, batch_handler: bool,
                   n_rows: int, native: bool = True) -> dict:
    """A digest session of ``n_rows`` rows (``records`` repeated) with
    SESSION_BLOBS blobs opened mid-run, through ``pipe`` into
    ``decode(backend="cuda")`` on one codec route: the encoder negotiated
    to CAP_CHANGE_BATCH with the default BatchPolicy, or not; the decoder
    with a ``change_batch`` handler or a per-row ``change`` one."""
    import dat_replication_protocol_tpu_torch as protocol

    enc = protocol.encode(backend="cuda", device=device)
    if negotiated:
        enc.negotiate(protocol.CAP_CHANGE_BATCH)
    dec = protocol.decode(backend="cuda", device=device, native=native)
    sent, got = [], []
    rows = 0

    def on_batch(cols, done):
        nonlocal rows
        rows += len(cols)
        done()

    def on_change(_c, done):
        nonlocal rows
        rows += 1
        done()

    enc.on_digest(lambda kind, seq, d: sent.append((kind, seq, d)))
    dec.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))
    if batch_handler:
        dec.change_batch(on_batch)
    dec.change(on_change)
    blob_at = [n_rows * (i + 1) // (SESSION_BLOBS + 1) + 7
               for i in range(SESSION_BLOBS)]
    t0 = time.perf_counter()
    protocol.pipe(enc, dec)
    at = 0
    while at < n_rows:
        run = records[:min(len(records), n_rows - at)]
        lo = 0
        for cut in (b - at for b in blob_at if at <= b < at + len(run)):
            # rows pending when the blob opens flush first
            enc.change_many(run[lo:cut])
            enc.blob(64 << 10).end(bytes(64 << 10))
            lo = cut
        if lo:
            for r in run[lo:]:
                enc.change(r)
        else:
            enc.change_many(run)
        at += len(run)
    enc.finalize()
    sync(device)
    seconds = time.perf_counter() - t0
    if not dec.finished or rows != n_rows:
        raise AssertionError(f"the replay session delivered {rows} of "
                             f"{n_rows} rows")
    changes = [d for kind, _, d in got if kind == "change"]
    if [d for kind, _, d in sent if kind == "change"] != changes:
        raise AssertionError("encoder and decoder change digests differ")
    if [s for kind, s, _ in got if kind == "change"] != list(range(n_rows)):
        raise AssertionError("change digests out of order")
    return {"seconds": seconds, "rows_s": n_rows / seconds, "rows": n_rows,
            "wire_bytes": dec.bytes, "changes": changes,
            "blobs": [d for kind, _, d in got if kind == "blob"]}


def replay_routes(wires: dict, cols, frames, replayed: dict) -> dict:
    """The three wires on the Python codec route against the native
    route's results (``cols``/``frames`` of the per-record wire,
    ``replayed`` of the others): frame index, columns field by field and
    every encoder's bytes equal.  Seconds of split, decode and encode of
    the per-record wire on each route, and of the Python route's replays
    and batch encode."""
    from dat_replication_protocol_tpu_torch import weights
    from dat_replication_protocol_tpu_torch.runtime import replay

    wire = wires["per-record"]
    want_of = dict(replayed, **{"per-record": (cols, frames)})
    out = {}
    for route, native in (("native", True), ("python", False)):
        t = {}
        t0 = time.perf_counter()
        idx = replay.split_frames(np.frombuffer(wire, np.uint8),
                                  native=native)
        t["split"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dcols = replay.decode_change_columns(idx.buf, idx.starts, idx.lens,
                                             native)
        t["decode"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        enc = replay.encode_change_columns(dcols, native)
        t["encode"] = time.perf_counter() - t0
        if enc != wire:
            raise AssertionError(f"encode_change_columns on the {route} "
                                 "route differs from the wire")
        out[route] = t
    t = out["python"]
    for what, w in wires.items():
        t0 = time.perf_counter()
        got_cols, got_idx = replay.replay_log(np.frombuffer(w, np.uint8),
                                              native=False)
        t[f"replay {what}"] = time.perf_counter() - t0
        want_cols, want_idx = want_of[what]
        for f in ("starts", "lens", "ids"):
            if not np.array_equal(getattr(got_idx, f), getattr(want_idx, f)):
                raise AssertionError(f"the {what} wire's frame {f} differ "
                                     "by route")
        got_np = weights.columns_to_numpy(got_cols)
        for f, a in weights.columns_to_numpy(want_cols).items():
            if not np.array_equal(np.asarray(got_np[f]), np.asarray(a)):
                raise AssertionError(f"the {what} wire's column {f} differs "
                                     "by route")
    t0 = time.perf_counter()
    if replay.encode_batch_frames(cols, REPLAY_BATCH_ROWS,
                                  native=False) != wires["batch"]:
        raise AssertionError("encode_batch_frames differs by route")
    t["encode_batch"] = time.perf_counter() - t0
    ext = replay.canonical_change_extents(replayed["batch"][0], native=False)
    if ext[0].tobytes() != wire:
        raise AssertionError("canonical_change_extents differs by route")
    return out


def run_replay(device, card: str) -> dict:
    """Phase 11's main path, once: BASELINE configs[1] at full size."""
    import torch

    from dat_replication_protocol_tpu_torch.batch import feed
    from dat_replication_protocol_tpu_torch.ops import merkle
    from dat_replication_protocol_tpu_torch.runtime import replay
    from dat_replication_protocol_tpu_torch.wire import batch_codec

    records = replay_records()
    wire = replay.encode_change_log(records) * REPLAY_REPS
    n = REPLAY_BLOCK * REPLAY_REPS
    out = {"rows": n, "replay_s": {}, "wire_bytes": {"per-record": len(wire)}}

    t0 = time.perf_counter()
    cols, frames = replay.replay_log(np.frombuffer(wire, np.uint8))
    out["replay_s"]["per-record"] = time.perf_counter() - t0
    if len(cols) != n:
        raise AssertionError(f"replayed {len(cols)} rows, want {n}")
    t0 = time.perf_counter()
    same_rows(cols, wire, "per-record")
    out["encode_columns_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bwire = replay.encode_batch_frames(cols, REPLAY_BATCH_ROWS)
    out["encode_batch_s"] = time.perf_counter() - t0
    mwire = mixed_wire(wire, cols, frames)
    replayed = {}
    for what, w in (("batch", bwire), ("mixed", mwire)):
        out["wire_bytes"][what] = len(w)
        t0 = time.perf_counter()
        replayed[what] = replay.replay_log(np.frombuffer(w, np.uint8))
        out["replay_s"][what] = time.perf_counter() - t0
        same_rows(replayed[what][0], wire, what)
    if max(len(bwire), len(mwire)) >= len(wire):
        raise AssertionError(f"wire bytes {out['wire_bytes']}: the batch "
                             "and mixed wires must be shorter than the "
                             "per-record wire")
    bcols, bframes = replayed["batch"]
    t0 = time.perf_counter()
    ext = replay.canonical_change_extents(bcols)
    out["canonical_s"] = time.perf_counter() - t0
    if ext[0].tobytes() != wire:
        raise AssertionError("canonical extents differ from the wire")
    out["routes"] = replay_routes(
        {"per-record": wire, "batch": bwire, "mixed": mwire}, cols, frames,
        replayed)

    reset_counters()
    t0 = time.perf_counter()
    leaves = feed.leaves_from_columns(cols, frames, device=device)
    hh, hl = merkle.digests_to_device([leaves.tobytes()], device=device)
    root = merkle.digests_from_device(*merkle.root(
        *merkle.pad_leaves(hh, hl)))[0]
    out["leaves_root_ms"] = (time.perf_counter() - t0) * 1e3
    leaves_b = feed.leaves_from_columns(bcols, bframes, device=device)
    t0 = time.perf_counter()
    dev_batches = [feed.decode_batch_device(
        bwire[s:s + ln], device=device)
        for s, ln in zip(bframes.starts.tolist(), bframes.lens.tolist())]
    sync(device)
    out["decode_device_ms"] = (time.perf_counter() - t0) * 1e3
    out["batch_frames"] = len(dev_batches)
    sessions = {}
    for name, negotiated, whole, n_rows, native in (
            ("batch, change_batch", True, True, SESSION_ROWS, True),
            ("batch, change_batch, Python route", True, True, PY_BATCH_ROWS,
             False),
            ("batch, per-row change", True, False, PER_ROW_ROWS, True),
            ("per-record", False, False, SESSION_ROWS, True)):
        sessions[name] = replay_session(device, records, negotiated, whole,
                                        n_rows, native)
    out["launches"] = read_counters()
    if min(out["launches"]["blake2b"], out["launches"]["merkle_level"]) == 0:
        raise AssertionError(f"phase 11 launches {out['launches']}")

    # the references, on the host
    data = memoryview(wire)
    want = np.frombuffer(b"".join(
        blake(data[s:s + ln]) for s, ln in zip(frames.starts.tolist(),
                                               frames.lens.tolist())),
        np.uint8).reshape(n, 32)
    if not (np.array_equal(leaves, want) and np.array_equal(leaves_b, want)):
        raise AssertionError("replay leaves differ from hashlib")
    if root != merkle.root_host(list(map(bytes, want))):
        raise AssertionError("the replay root differs from root_host")
    out["root"] = root.hex()
    for k, s, ln in zip(range(len(dev_batches)), bframes.starts.tolist(),
                        bframes.lens.tolist()):
        host = batch_codec.decode_change_batch(bwire[s:s + ln])
        dev = dev_batches[k]
        for name in ("change", "from_", "to", "val_off", "val_len"):
            t = getattr(dev, name)
            if t.device.type != torch.device(device).type or not np.array_equal(
                    t.cpu().numpy(), getattr(host, name).astype(np.int64)):
                raise AssertionError(f"decode_batch_device {name} differs")
        if not torch.equal(dev.buf.cpu(), torch.from_numpy(host.buf.copy())):
            raise AssertionError("decode_batch_device buf differs")
    ref = sessions["per-record"]["changes"]
    if ref != list(map(bytes, want[:SESSION_ROWS])):
        raise AssertionError("per-record session digests differ from hashlib")
    for name, sess in sessions.items():
        if sess["changes"] != ref[:sess["rows"]]:
            raise AssertionError(f"the {name} session's digests differ from "
                                 "the per-record session's")
        if sess["blobs"] != [blake(bytes(64 << 10))] * SESSION_BLOBS:
            raise AssertionError(f"the {name} session's blob digests differ "
                                 "from hashlib")
        del sess["changes"], sess["blobs"]
    out["sessions"] = sessions
    out["leaves_args"] = (frames.buf, frames.starts, frames.lens, hh, hl)
    return out


def time_replay(device, run: dict) -> dict:
    """B1's and B2's device ms inside phase 11's leaves + root: B1 on the
    chunks ``hash_extents`` launches, B2 on the 20 levels, each from a
    CUDA graph of the launches (CUDA events)."""
    import torch

    from dat_replication_protocol_tpu_torch.batch import feed
    from dat_replication_protocol_tpu_torch.ops import merkle
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        blake2b_packed_kernel)

    buf, offs, lens, hh, hl = run["leaves_args"]
    b1_ms = 0.0
    for nb, idx in feed.bucketed_extents(lens).items():
        chunk = max(1, feed.PIPELINE_BYTES // (nb * feed.BLOCK_BYTES))
        for c0 in range(0, len(idx), chunk):
            sub = idx[c0:c0 + chunk]
            args = [torch.from_numpy(a.view(np.int32)).to(device)
                    for a in feed.pack_ragged(buf, offs[sub], lens[sub], nb)]
            b1_ms += device_ms(lambda: blake2b_packed_kernel(*args), 2)
    ph, pl = merkle.pad_leaves(hh, hl)
    b2_ms = device_ms(lambda: merkle.build_tree(ph, pl), 2)
    return {"b1_ms": b1_ms, "b2_ms": b2_ms}


# ---------------------------------------------------------------------------
# phase 12: the streaming hasher on B1's chained entry, and the mesh
# ---------------------------------------------------------------------------

STREAM12_BYTES = 256 << 20
SEGMENT_BYTES = 4 << 20
BATCH12_ITEMS = 64
# the extra checks' segment: 64 items of 256 blocks, t_hi 0 and 1
EDGE12_BLOCKS = 256
# the last segment after the first at the stream's shape: 514 blocks,
# bucketed to 1,024 (8,194 to 16,384 before: its plain version took 6 s)
TAIL12_BYTES = (64 << 10) + 129
# blocks of each call of the plain version in its CUDA graph
PLAIN12_CHUNK = 64
# the plain chained entry runs on an eighth of a 4 MiB segment: 4,096
# blocks at 0.8 ms a block from its graph, whatever the items (a whole
# segment took 25.7 s at one item and 28.1 s at 64, H100 80GB HBM3, 700 W)
PLAIN12_BLOCKS = SEGMENT_BYTES // 128 // 8


def plain_update_graphed(args, chunk: int = PLAIN12_CHUNK):
    """The plain version of B1's chained entry, ``blake2b_update``, over
    one segment on the card, run as its own calls over the segment's
    ``chunk``-block pieces in turn, replayed from a CUDA graph of one
    call.  By the chaining rule the stream rests on, the pieces' updates
    in turn are the segment's: a piece's length is the part of the item's
    length inside it, and the item's last flag goes on the piece that
    holds its last byte (piece 0 for an empty last segment).  Pieces past
    every item's end change nothing and are not run.  Eager, the plain
    version's launches cost the host about 10 ms a block, minutes at a
    4 MiB segment's 32,768 blocks; the graph replays the same launches
    without the host.  Returns the outputs and the device ms of the whole
    chain, the pieces' copies included."""
    import torch

    from dat_replication_protocol_tpu_torch.ops import blake2b as b2b

    hh, hl, t_hi, t_lo, mh, ml, seg, last = args
    B, nblocks, _ = mh.shape
    chunk = min(chunk, nblocks)
    if nblocks % chunk:
        raise ValueError(f"{nblocks} blocks do not split into {chunk}")
    span = chunk * 128
    seg64 = seg.to(torch.int64) & 0xFFFFFFFF
    ends = torch.clamp_min((seg64 + span - 1) // span - 1, 0)
    pieces = int(ends.max()) + 1
    state = [t.clone() for t in (hh, hl, t_hi, t_lo)]
    s_mh = torch.empty((B, chunk, 16), dtype=torch.int32, device=mh.device)
    s_ml = torch.empty_like(s_mh)
    s_len = torch.empty_like(seg)
    s_last = torch.empty_like(last)

    def load(j: int) -> None:
        s_mh.copy_(mh[:, j * chunk:(j + 1) * chunk])
        s_ml.copy_(ml[:, j * chunk:(j + 1) * chunk])
        s_len.copy_((seg64 - j * span).clamp(0, span))
        s_last.copy_(last & (ends == j))

    def step() -> None:
        out = b2b.blake2b_update(*state, s_mh, s_ml, s_len, s_last)
        for dst, src in zip(state, out):
            dst.copy_(src)

    load(0)
    step()  # warm-up: the plain version's constants land on the card
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for dst, src in zip(state, (hh, hl, t_hi, t_lo)):
        dst.copy_(src)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for j in range(pieces):
        load(j)
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return tuple(state), start.elapsed_time(end)


def update_args(device, rng, t_hi: int, nblocks: int = EDGE12_BLOCKS,
                items: int = BATCH12_ITEMS) -> tuple:
    """Chained-entry operands: random states, counters at ``t_hi`` with
    low words that carry within the segment, ragged segment lengths (whole
    blocks where not last, zero-length and bucketed-past tails where last)
    and random words in the blocks past each length."""
    import torch

    last = rng.integers(0, 2, items).astype(bool)
    lengths = np.where(last, rng.integers(0, nblocks * 128 + 1, items),
                       rng.integers(0, nblocks + 1, items) * 128)
    lengths[:4] = (0, 1, nblocks * 128, nblocks * 64 + 3)
    last[:4] = True
    words = rng.integers(0, 1 << 32, (2, items, nblocks, 16), dtype=np.uint64)
    raw = np.zeros((items, nblocks, 32), np.uint32)
    raw[..., 1::2], raw[..., 0::2] = words.astype(np.uint32)
    raw8 = raw.view(np.uint8).reshape(items, -1)
    for i, n in enumerate(lengths):
        raw8[i, n:-(-n // 128) * 128] = 0
    state = rng.integers(0, 1 << 32, (2, items, 8), dtype=np.uint64)
    t_lo = rng.integers(0, 1 << 32, items, dtype=np.uint64) & ~np.uint64(127)
    t_lo[:8] = (1 << 32) - 128
    # the empty message where t_hi is 0: one zero block compressed
    t_lo[8], lengths[8], last[8] = 0, 0, True
    cols = [state[0], state[1], np.full(items, t_hi), t_lo,
            raw[..., 1::2], raw[..., 0::2], lengths]
    args = [torch.from_numpy(np.ascontiguousarray(c).astype(np.uint32)
                             .view(np.int32)).to(device) for c in cols]
    return (*args[:7], torch.from_numpy(last).to(device))


def check_update_edges(device) -> dict:
    """B1's chained entry against its plain version (eager) on the card,
    both variants, byte for byte, at 64 items of 256 blocks: states at
    t_hi = 0 and 1 (a stream past 4 GiB), counters that carry into t_hi
    inside the segment, the empty message, empty and bucketed-past last
    segments.  Returns the largest error and the eager plain ms at t_hi
    = 1."""
    from dat_replication_protocol_tpu_torch.ops import blake2b as b2b
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        LANES, launch_update)

    rng = np.random.default_rng(SEED + 60)
    err = 0
    for t_hi in (0, 1):
        args = update_args(device, rng, t_hi)
        t0 = time.perf_counter()
        plain = b2b.blake2b_update(*args)
        sync(device)
        plain_s = time.perf_counter() - t0
        for lanes in LANES:
            e = max_abs_err(launch_update(*args, lanes), plain)
            if e:
                raise AssertionError(f"B1's chained entry ({lanes} lanes) "
                                     f"differs from its plain version at "
                                     f"t_hi {t_hi}")
            err = max(err, e)
    return {"max_abs_err": err, "plain_eager_ms": plain_s * 1e3,
            "shape": [BATCH12_ITEMS, EDGE12_BLOCKS]}


def check_update_stream_shape(device, data: np.ndarray, sass: dict,
                              latency: float) -> dict:
    """B1's chained entry at the stream's width against its plain version
    on the card (:func:`plain_update_graphed`), both variants, byte for
    byte: an eighth of the stream's first segment (one item of
    ``PLAIN12_BLOCKS`` blocks from h0 at t = 0, not last), then a last
    segment of ``TAIL12_BYTES`` bucketed to a power of two of blocks,
    chained on; the digest also == hashlib (the whole segment is held
    against hashlib by the stream itself).  Then the row at the first
    segment's shape: each variant's device ms, the plain version's at its
    eighth, and the bound."""
    import torch

    from dat_replication_protocol_tpu_torch.ops import blake2b as b2b
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        LANES, launch_update, lanes_per_item)

    dev = torch.device(device)
    head = data[:PLAIN12_BLOCKS * 128].tobytes()
    tail = data[SEGMENT_BYTES:SEGMENT_BYTES + TAIL12_BYTES].tobytes()
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    first = (*b2b.initial_state(1, device=dev), zero, zero,
             *b2b.stage_batch([head], PLAIN12_BLOCKS, dev),
             torch.zeros(1, dtype=torch.bool, device=dev))
    tail_blocks = b2b._bucket_nblocks(b2b._need_blocks(len(tail)))
    last = (*b2b.stage_batch([tail], tail_blocks, dev),
            torch.ones(1, dtype=torch.bool, device=dev))
    plain_first, plain_ms = plain_update_graphed(first)
    plain_last, _ = plain_update_graphed((*plain_first, *last))
    err = 0
    for lanes in LANES:
        got = launch_update(*first, lanes)
        e = max_abs_err(got, plain_first)
        got = launch_update(*got, *last, lanes)
        e = max(e, max_abs_err(got, plain_last))
        if e:
            raise AssertionError(f"B1's chained entry ({lanes} lanes) differs "
                                 f"from its plain version at the stream's "
                                 f"shape")
        err = max(err, e)
    if b2b.digests_to_bytes(plain_last[0].cpu(), plain_last[1].cpu()) != \
            [blake(head + tail)]:
        raise AssertionError("the plain chain differs from hashlib")
    # the row's shape: the stream's whole first segment
    whole = (*first[:4], *b2b.stage_batch([data[:SEGMENT_BYTES].tobytes()],
                                          SEGMENT_BYTES // 128, dev),
             first[-1])
    lanes = lanes_per_item(1)
    ms = {k: device_ms(lambda: launch_update(*whole, k), 3) for k in LANES}
    # per item: length and last flag read, state and counter in and out
    bound = b1_bound([SEGMENT_BYTES], sass, latency, item_bytes=149,
                     min_blocks=0)
    return {"name": "blake2b_update", "route": "cuda",
            "source": "dat_replication_protocol_tpu_torch/csrc/blake2b.cu",
            "replaces": "dat_replication_protocol_tpu/ops/blake2b.py:383",
            "launches": 0, "max_abs_err": err, "ms": ms[lanes],
            "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": None,
            "shape": [1, SEGMENT_BYTES // 128],
            "plain_shape": [1, PLAIN12_BLOCKS], "ms_by_lanes": ms,
            "lanes": lanes, "tail_blocks": tail_blocks,
            **{k: bound[k] for k in ("bytes_ms", "ops_ms", "chain_ms")}}


def stream_digest(device, data, pieces: int = 1) -> bytes:
    from dat_replication_protocol_tpu_torch.ops.blake2b import Blake2bStream

    s = Blake2bStream(segment_bytes=SEGMENT_BYTES, device=device)
    view = memoryview(data)
    step = -(-len(view) // pieces) if len(view) else 1
    for at in range(0, len(view), step):
        s.update(view[at:at + step])
    return s.digest()


def run_stream(device, data: np.ndarray) -> dict:
    """Phase 12a's main path: ``Blake2bStream`` over the stream in 4 MiB
    segments, fed in 1 MiB pieces, against hashlib; the launch counters
    are set to 0 before it and read after."""
    sync(device)
    reset_counters()
    t0 = time.perf_counter()
    got = stream_digest(device, data, pieces=len(data) // MIB)
    seconds = time.perf_counter() - t0
    launches = read_counters()
    t0 = time.perf_counter()
    want = blake(data)
    host_s = time.perf_counter() - t0
    if got != want:
        raise AssertionError("Blake2bStream differs from hashlib")
    if launches["blake2b_update"] != len(data) // SEGMENT_BYTES:
        raise AssertionError(f"the stream launched the chained entry "
                             f"{launches['blake2b_update']} times")
    edges = (0, 1, 127, 128, 129, SEGMENT_BYTES, SEGMENT_BYTES + 1)
    rng = np.random.default_rng(SEED + 61)
    for n in edges:
        part = rng.bytes(n)
        for pieces in (1, 3):
            if stream_digest(device, part, pieces) != blake(part):
                raise AssertionError(f"a stream of {n} B in {pieces} "
                                     f"pieces differs from hashlib")
    return {"seconds": seconds, "mib_s": len(data) / MIB / seconds,
            "hashlib_mib_s": len(data) / MIB / host_s, "edges": edges,
            "launches": launches}


def run_update_batch(device, sass: dict, latency: float) -> dict:
    """64 items of two segments each (a 4 MiB middle segment, then a last
    one of 1 B to 4 MiB) through each variant of the chained entry: the
    middle segment's first eighth against its plain version on the card
    (:func:`plain_update_graphed`), byte for byte, and the digests of the
    whole items against hashlib.  The middle segment's device ms gives
    the batch's MiB/s, one item's alone the stream's kernel rate."""
    import torch

    from dat_replication_protocol_tpu_torch.ops import blake2b as b2b
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        LANES, launch_update)

    rng = np.random.default_rng(SEED + 62)
    n = BATCH12_ITEMS
    tails = rng.integers(1, SEGMENT_BYTES + 1, n)
    items = [rng.bytes(SEGMENT_BYTES + int(k)) for k in tails]
    want = [blake(p) for p in items]
    nb = SEGMENT_BYTES // 128
    segs = []
    for cut, last in ((slice(0, SEGMENT_BYTES), False),
                      (slice(SEGMENT_BYTES, None), True)):
        mh, ml, lengths = b2b.stage_batch([p[cut] for p in items], nb,
                                          torch.device(device))
        segs.append((mh, ml, lengths,
                     torch.full((n,), last, device=device)))
    hh, hl = b2b.initial_state(n, device=device)
    zero = torch.zeros(n, dtype=torch.int32, device=device)
    # against the plain version on the middle segment's first eighth
    mh, ml, lengths, last = segs[0]
    cut = (mh[:, :PLAIN12_BLOCKS].contiguous(),
           ml[:, :PLAIN12_BLOCKS].contiguous(),
           lengths.clamp(max=PLAIN12_BLOCKS * 128), last)
    plain, plain_ms = plain_update_graphed((hh, hl, zero, zero, *cut))
    ms = {}
    for lanes in LANES:
        if max_abs_err(launch_update(hh, hl, zero, zero, *cut, lanes),
                       plain):
            raise AssertionError(f"B1's chained entry ({lanes} lanes) "
                                 f"differs from its plain version on the "
                                 f"{n} x {PLAIN12_BLOCKS}-block segment")
        state = launch_update(hh, hl, zero, zero, *segs[0], lanes)
        state = launch_update(*state, *segs[1], lanes)
        if b2b.digests_to_bytes(state[0].cpu(), state[1].cpu()) != want:
            raise AssertionError(f"B1's chained entry ({lanes} lanes) "
                                 f"differs from hashlib on the 64-item batch")
        ms[lanes] = device_ms(
            lambda: launch_update(hh, hl, zero, zero, *segs[0], lanes), 3)
    one = b2b.stage_batch([items[0][:SEGMENT_BYTES]], nb,
                          torch.device(device))
    last = torch.zeros(1, dtype=torch.bool, device=device)
    one_ms = {lanes: device_ms(lambda: launch_update(
        hh[:1], hl[:1], zero[:1], zero[:1], *one, last, lanes), 3)
        for lanes in LANES}
    chain_ms = nb * sass["chain"] * latency / SM_HZ * 1e3
    return {"ms": ms, "mib_s": {k: n * SEGMENT_BYTES / MIB / (v / 1e3)
                                for k, v in ms.items()},
            "plain_ms": plain_ms, "plain_shape": [n, PLAIN12_BLOCKS],
            "one_ms": one_ms, "one_mib_s": {
                k: SEGMENT_BYTES / MIB / (v / 1e3) for k, v in one_ms.items()},
            "chain_ms": chain_ms,
            "chain_mib_s": SEGMENT_BYTES / MIB / (chain_ms / 1e3)}


def wall_ms(fn, reps: int) -> float:
    """Mean host-clock ms of ``fn()`` run to completion on the card, after
    a warm-up: for calls that read results back themselves."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def mesh_inputs(device, session: dict, ent: dict, recon: dict,
                blob: np.ndarray) -> dict:
    """Phase 12b's inputs, the earlier phases' own: phase 4's staged
    batch, digests, root and byte count; phase 3's change payloads and its
    first 32 blobs; phase 10's two snapshots, dense compare and roots, and
    its first sketch log's records hashed on B1 with their key slots;
    phase 7's blob as words on the card."""
    import torch

    from dat_replication_protocol_tpu_torch import encode_change
    from dat_replication_protocol_tpu_torch.ops import reconcile as rec

    blobs, changes = session["inputs"]
    hashes = [encode_change(c) for c in changes] + [
        bytes(blobs[i * BLOB_BYTES:(i + 1) * BLOB_BYTES]) for i in range(32)]
    srecs, keys = recon["sketch"][:2]
    rec_hh, rec_hl = hash_records(srecs, device)
    _, key_hl = hash_records(keys, device)
    return {"entry": {"args": ent["step"][1][:3], "digests": ent["digests"],
                      "root": ent["root"], "total": ent["total"]},
            "hash_payloads": hashes, "hash_want": [blake(p) for p in hashes],
            "diff": recon["diff"], "dense": recon["dense"],
            "roots": recon["roots"],
            "sketch": (rec_hh, rec_hl,
                       rec.key_slots(key_hl, SKETCH_LOG2_SLOTS)),
            "gear_words": torch.from_numpy(blob.view(np.int32)).to(device)}


def mesh_pass(mesh, device, mesh_in: dict) -> dict:
    """The five mesh calls on ``mesh_in`` over a one-rank mesh, each held
    against the same work on the card without the mesh (and against
    hashlib or root_host where the inputs carry them); the launch counters
    are set to 0 before the first calls and read after them.  Then each
    call's warm ms beside its single-device counterpart."""
    import torch

    from dat_replication_protocol_tpu_torch.ops import merkle, rabin
    from dat_replication_protocol_tpu_torch.ops import reconcile as rec
    from dat_replication_protocol_tpu_torch.ops.blake2b import (
        blake2b_batch_begin)
    from dat_replication_protocol_tpu_torch.ops.blake2b_cuda import (
        blake2b_packed_kernel)
    from dat_replication_protocol_tpu_torch.ops.rabin_cuda import (
        gear_candidates_kernel)
    from dat_replication_protocol_tpu_torch.parallel import (
        digest_root_step, sharded_diff, sharded_gear_scan,
        sharded_hash_begin, sharded_sketch)

    ent = mesh_in["entry"]
    step_args = ent["args"]
    hashes = mesh_in["hash_payloads"]
    a_hh, a_hl, b_hh, b_hl = mesh_in["diff"]
    rec_hh, rec_hl, slots = mesh_in["sketch"]
    words = mesh_in["gear_words"]
    T = words.shape[0] // (TILE_BYTES // 4)
    payload = words.view(T, TILE_BYTES // 4)
    pre = torch.zeros(rabin._PREFIX_WORDS, dtype=torch.int32, device=device)

    def one_digest_root():
        hh, hl = blake2b_packed_kernel(*step_args)
        leaves = hh[:, :4].contiguous(), hl[:, :4].contiguous()
        return leaves, merkle.root(*leaves)

    calls = {
        "digest_root_step": (lambda: digest_root_step(mesh, *step_args),
                             one_digest_root),
        "sharded_hash_begin": (
            lambda: sharded_hash_begin(mesh, hashes)(),
            lambda: blake2b_batch_begin(hashes, device=device)()),
        "sharded_diff": (
            lambda: sharded_diff(mesh, a_hh, a_hl, b_hh, b_hl),
            lambda: merkle.diff_root_guided(a_hh, a_hl, b_hh, b_hl)),
        "sharded_sketch": (
            lambda: sharded_sketch(mesh, rec_hh, rec_hl, slots,
                                   SKETCH_LOG2_SLOTS),
            lambda: rec.sketch_table(rec_hh, rec_hl, slots,
                                     1 << SKETCH_LOG2_SLOTS)),
        "sharded_gear_scan": (
            lambda: sharded_gear_scan(mesh, payload, avg_bits=CDC_AVG_BITS),
            lambda: gear_candidates_kernel(rabin._build_rows(
                words, pre, T, TILE_BYTES), CDC_AVG_BITS)),
    }
    out = {}
    sync(device)
    reset_counters()
    got = {name: mesh_fn() for name, (mesh_fn, _) in calls.items()}
    sync(device)
    out["launches"] = read_counters()
    single = {name: one() for name, (_, one) in calls.items()}

    leaf_hh, leaf_hl, root_hh, root_hl, total = got["digest_root_step"]
    (one_hh, one_hl), one_root = single["digest_root_step"]
    if not (torch.equal(leaf_hh, one_hh) and torch.equal(leaf_hl, one_hl)
            and merkle.digests_from_device(leaf_hh, leaf_hl)
            == ent["digests"]):
        raise AssertionError("digest_root_step leaves differ from hashlib")
    root = merkle.digests_from_device(root_hh, root_hl)[0]
    if (root.hex() != ent["root"]
            or root != merkle.digests_from_device(*one_root)[0]):
        raise AssertionError("digest_root_step root differs from root_host")
    if total != ent["total"]:
        raise AssertionError(f"digest_root_step counts {total} bytes, not "
                             f"{ent['total']}")
    if not (got["sharded_hash_begin"] == single["sharded_hash_begin"]
            == mesh_in["hash_want"]):
        raise AssertionError("sharded_hash_begin differs from hashlib")
    mask, ra, rb = got["sharded_diff"]
    if not (np.array_equal(np.nonzero(mask.cpu().numpy())[0],
                           mesh_in["dense"])
            and torch.equal(mask, single["sharded_diff"][0])):
        raise AssertionError("sharded_diff's mask differs from the dense "
                             "compare")
    if [merkle.digests_from_device(*r)[0] for r in (ra, rb)] != \
            mesh_in["roots"]:
        raise AssertionError("sharded_diff's roots differ from root_host")
    if not torch.equal(got["sharded_sketch"], single["sharded_sketch"]):
        raise AssertionError("sharded_sketch differs from sketch_table")
    if not torch.equal(got["sharded_gear_scan"],
                       single["sharded_gear_scan"]):
        raise AssertionError("sharded_gear_scan differs from B3 over "
                             "candidates_begin's rows")
    del got, single
    reps = {"sharded_gear_scan": 3, "sharded_hash_begin": 2}
    out["ms"] = {name: (wall_ms(mesh_fn, reps.get(name, 5)),
                        wall_ms(one, reps.get(name, 5)))
                 for name, (mesh_fn, one) in calls.items()}
    return out


class one_rank_group:
    """A one-rank ``nccl`` process group on a ``FileStore`` in a temp
    dir, its bootstrap socket on the loopback interface, for the length
    of a ``with``; ``init_s`` is its set-up time."""

    def __init__(self, device):
        self.device = device

    def __enter__(self) -> "one_rank_group":
        import datetime
        import tempfile

        import torch
        import torch.distributed as dist

        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        self._tmp = tempfile.TemporaryDirectory()
        t0 = time.perf_counter()
        store = dist.FileStore(f"{self._tmp.name}/store", 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300),
                                device_id=torch.device(self.device, 0))
        self.init_s = time.perf_counter() - t0
        return self

    def __exit__(self, *exc) -> None:
        import torch.distributed as dist

        try:
            dist.destroy_process_group()
        finally:
            self._tmp.cleanup()


def run_mesh(device, mesh_in: dict) -> dict:
    """Phase 12b's main path: :func:`mesh_pass` over a one-rank group."""
    from dat_replication_protocol_tpu_torch.parallel import make_mesh

    with one_rank_group(device) as group:
        out = mesh_pass(make_mesh(1, device=device), device, mesh_in)
    out["init_s"] = group.init_s
    return out


# ---------------------------------------------------------------------------
# phase 13: telemetry
# ---------------------------------------------------------------------------

# the bring-up and build's deadline: the records show builds of ~3 s and
# runs of 220-440 s, so only a wedged init reaches it
INIT_DEADLINE_S = 300.0
CHIP_LOCK_WAIT_S = 60.0
P13_BLOBS = 256  # phase 3's profiled session
P13_REPS = 5
# span records a gated P13_BLOBS session leaves: two frame tags a frame
# (8,448 frames), the dispatch spans and their profiler twins
P13_SPAN_CAPACITY = 1 << 15
P13_OUT = "build/phase13"  # .gitignore lists build/
# kernel-sentinel site -> the name _wrappers() reports its launches under
SITE_WRAPPERS = {
    "ops.blake2b_cuda.packed": "blake2b",
    "ops.blake2b_cuda.update": "blake2b_update",
    "ops.merkle_cuda.level": "merkle_level",
    "ops.rabin_cuda.candidates": "gear_candidates",
    "ops.rabin_cuda.first": "gear_first",
    "ops.rabin_cuda.window_first": "gear_window_first",
    "ops.fused_cdc_hash.window_first_checked": "gear_window_first_checked",
}


def obs_reset() -> None:
    """Zero the port's registry, rings, sentinel and engine notes."""
    from dat_replication_protocol_tpu_torch import obs

    obs.REGISTRY.reset()
    obs.EVENTS.clear()
    obs.SPANS.clear()
    obs.SENTINEL.reset_for_tests()
    obs.reset_engine_notes()


def check_sites(launches: dict, what: str) -> dict:
    """Each kernel site's calls must equal its wrapper's launches, and no
    site may pass its signature budget: the main path's shapes are
    bucketed."""
    from dat_replication_protocol_tpu_torch import obs

    snap = obs.SENTINEL.snapshot()
    for site, name in SITE_WRAPPERS.items():
        calls = snap.get(site, {}).get("calls", 0)
        if calls != launches[name]:
            raise AssertionError(f"{what}: site {site} counted {calls} calls, "
                                 f"its wrapper {launches[name]} launches")
    over = obs.EVENTS.events("device.jit.recompile_budget")
    if over:
        raise AssertionError(f"{what}: sites past their signature budget: "
                             f"{[e['fields'] for e in over]}")
    return {site: snap[site] for site in SITE_WRAPPERS if site in snap}


def check_session_counters(s: dict, what: str) -> dict:
    """Phase 13's counters against the session's own truth."""
    from dat_replication_protocol_tpu_torch import obs

    c = obs.snapshot()["counters"]
    want = {"decoder.changes": s["changes"], "decoder.blobs": s["blobs"],
            "decoder.bytes": s["wire_bytes"], "encoder.bytes": s["wire_bytes"],
            "decoder.digests": s["changes"] + s["blobs"],
            "device.dispatch.batches": s["dispatches"]}
    got = {k: c.get(k, 0) for k in want}
    if got != want or s["enc_bytes"] != s["wire_bytes"]:
        raise AssertionError(f"{what}: counters {got}, the session's truth "
                             f"{want} (encoder bytes {s['enc_bytes']})")
    return got


def check_tiles(records: list, name: str, total: int) -> int:
    """``name``'s frame tags, sorted by offset, must tile [0, total); a
    decoder's ``decoder.frame.run`` (one tag for a C change run) tiles
    with its ``decoder.frame`` tags."""
    names = (name, name + ".run")
    frames = sorted((r["fields"]["offset"], r["fields"]["wire_len"])
                    for r in records if r.get("span") in names)
    end = 0
    for off, wire_len in frames:
        if off != end:
            raise AssertionError(f"{name} tags do not tile the wire: a tag "
                                 f"at {off}, coverage ends at {end}")
        end = off + wire_len
    if end != total:
        raise AssertionError(f"{name} tags cover {end} of {total} bytes")
    return len(frames)


def span_seconds(records: list, name: str, **match) -> float:
    return sum(r["dur"] for r in records if r.get("span") == name
               and all(r["fields"].get(k) == v for k, v in match.items()))


def run_telemetry(device, content_blob, content_summary,
                  n_blobs=P13_BLOBS, blob_bytes=BLOB_BYTES,
                  out_dir=P13_OUT) -> dict:
    """Phase 13 (see the module docstring); leaves the gate off."""
    from dat_replication_protocol_tpu_torch import obs
    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch.obs.tracing import (
        DEFAULT_SPAN_CAPACITY as tracing_capacity)
    from dat_replication_protocol_tpu_torch.utils.trace import trace_to

    out = {"launches": {}}

    def add(launches):
        for k, n in launches.items():
            if k not in NOT_COUNTS:
                out["launches"][k] = out["launches"].get(k, 0) + n

    # 13a: the gate's cost, alternating so drift hits both alike
    secs = {False: [], True: []}
    try:
        for _ in range(P13_REPS):
            for gate in (False, True):
                obs.OBS.on = gate
                obs_reset()
                s = run_session(device, n_blobs, blob_bytes)
                secs[gate].append(s["seconds"])
                add(s["launches"])
    finally:
        obs.disable()
    off, on = (float(np.median(secs[g])) for g in (False, True))
    out["gate"] = {"off_s": secs[False], "on_s": secs[True],
                   "median_off_s": off, "median_on_s": on, "ratio": on / off}

    # 13b: one gated run, every span kept: counters, tiling, split
    os.makedirs(out_dir, exist_ok=True)
    obs_reset()
    obs.SPANS.resize(P13_SPAN_CAPACITY)
    obs.enable()
    try:
        s = run_session(device, n_blobs, blob_bytes)
        obs.sample_device_gauges()
    finally:
        obs.disable()
    add(s["launches"])
    out["counters"] = check_session_counters(s, "phase 13b")
    out["sites"] = check_sites(s["launches"], "phase 13b")
    out["gauges"] = obs.snapshot()["gauges"]
    recs = obs.SPANS.spans()
    if obs.SPANS.dropped:
        raise AssertionError(f"phase 13b: {obs.SPANS.dropped} span records "
                             f"dropped from a ring of {P13_SPAN_CAPACITY}")
    out["tags"] = {name: check_tiles(recs, name, s["wire_bytes"])
                   for name in ("encoder.frame", "decoder.frame")}
    dispatch = span_seconds(recs, "device.dispatch")
    deliver = span_seconds(recs, "device.deliver")
    out["split"] = {"seconds": s["seconds"], "dispatch_s": dispatch,
                    "deliver_s": deliver,
                    "rest_s": s["seconds"] - dispatch - deliver,
                    "dispatches": s["dispatches"]}
    # 13d's export of the rings, while they hold the whole session
    ring = obs.export_chrome_trace(os.path.join(out_dir, "obs_trace.json"))
    with open(ring, encoding="utf-8") as f:
        out["ring_trace"] = (ring, len(json.load(f)["traceEvents"]))
    # 13b, continued: the change_many session, whose change runs go
    # through the decoder's C loop, under the same checks
    obs_reset()
    obs.enable()
    try:
        s = run_session(device, n_blobs, blob_bytes, bulk=True)
    finally:
        obs.disable()
    add(s["launches"])
    check_session_counters(s, "phase 13b (change_many)")
    check_sites(s["launches"], "phase 13b (change_many)")
    recs = obs.SPANS.spans()
    if obs.SPANS.dropped:
        raise AssertionError(f"phase 13b (change_many): {obs.SPANS.dropped} "
                             f"span records dropped")
    out["tags_bulk"] = {
        name: check_tiles(recs, name, s["wire_bytes"])
        for name in ("encoder.frame", "decoder.frame")}
    out["tags_bulk"]["decoder.frame.run"] = sum(
        r.get("span") == "decoder.frame.run" for r in recs)
    if out["tags_bulk"]["decoder.frame.run"] != s["c_runs"]["runs"]:
        raise AssertionError(f"phase 13b (change_many): "
                             f"{out['tags_bulk']['decoder.frame.run']} "
                             f"decoder.frame.run tags for "
                             f"{s['c_runs']['runs']} C change runs")
    obs.SPANS.resize(tracing_capacity)

    # 13b, continued: the same session under torch.profiler
    obs_reset()
    obs.enable()
    try:
        with trace_to(os.path.join(out_dir, "profile")) as prof:
            s = run_session(device, n_blobs, blob_bytes)
    finally:
        obs.disable()
    add(s["launches"])
    check_session_counters(s, "phase 13b (profiled)")
    check_sites(s["launches"], "phase 13b (profiled)")
    names = {e.name for e in prof.events()}
    spans = {r["span"] for r in obs.SPANS.spans()
             if r["fields"].get("src") == "torch"}
    if not spans or not spans <= names:
        raise AssertionError(f"utils.trace spans {sorted(spans)} missing "
                             f"from the profiler's events: "
                             f"{sorted(spans - names)}")
    out["profiled"] = {"seconds": s["seconds"], "spans": sorted(spans)}
    out["profile"] = os.path.join(out_dir, "profile", "trace.json")

    # 13c: content addressing, gated, twice: the first call after the
    # other phases, then a warm one
    out["cdc"] = []
    for _ in range(2):
        obs_reset()
        obs.enable()
        try:
            reset_counters()
            sync(device)
            t0 = time.perf_counter()
            summary = protocol.content_address(
                content_blob, CDC_AVG_BITS, CDC_MIN, CDC_MAX,
                route="fused1p", device=device)
            seconds = time.perf_counter() - t0
            launches = read_counters()
        finally:
            obs.disable()
        add(launches)
        if summary != content_summary:
            raise AssertionError("phase 13c's summary differs from phase 7's")
        c = obs.snapshot()["counters"]
        n = int(content_blob.size)
        want = {"cdc.fused.bytes": n, "cdc.fused.chunks": summary.nchunks,
                "device.d2h.bytes": 32 * summary.nchunks + 32}
        got = {k: c.get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"phase 13c: counters {got}, want {want}")
        sites = check_sites(launches, "phase 13c")
        recs = obs.SPANS.spans()
        split = {"seconds": seconds, "content_address_s": span_seconds(
            recs, "device.content.address")}
        for name in ("cdc.dispatch", "cdc.collect", "cdc.greedy"):
            split[name] = span_seconds(recs, name)
        split["hash_dispatch_s"] = span_seconds(
            recs, "device.dispatch", site="fused_cdc_hash.hash_cuts")
        split["rest_s"] = split["content_address_s"] - sum(
            split[k] for k in ("cdc.dispatch", "cdc.collect", "cdc.greedy",
                               "hash_dispatch_s"))
        out["cdc"].append({"split": split, "counters": got, "sites": sites,
                           "engines": [e["fields"] for e in obs.EVENTS.events(
                               "device.engine.select")]})

    # 13d: the profiler's trace beside the rings' (exported in 13b)
    with open(out["profile"], encoding="utf-8") as f:
        out["profile"] = (out["profile"], len(json.load(f)["traceEvents"]))
    obs_reset()
    return out


# ---------------------------------------------------------------------------
# phase 14: anti-entropy over the wire
# ---------------------------------------------------------------------------

# 14a: two change logs of 1,000,000 records (BASELINE configs[4]'s width,
# bench.py config 11's middle arm), 999,500 shared, 500 own on each side
AE_SHARED = 999_500
AE_OWN = 500
AE_SMALL_OWN = 5  # the k = 10 arm
# 14b: bench.py config 12's dataset and its 2% stale joiner; its crowd
# of 8 cut to 4, since phase 14 ran 185-189 s at 8, over its ~180 s, then
# to 2, since 4 joiners took 47-75 s of the host (H100 80GB HBM3, 700 W)
SNAP_BYTES = 1 << 30
SNAP_STALE = 0.02
SNAP_CROWD = 2
ARM_LIMIT_S = 30.0  # the corrupt and torn arms must end within this
SIDECAR_START_S = 300.0  # a sidecar builds its replica before listening


# the kernels phase 14 times, by launch counter: their names in the
# profiler's device records
P14_KERNELS = {"blake2b": ("blake2b_thread_kernel", "blake2b_quad_kernel"),
               "gear_window_first_checked": (
                   "gear_window_first_checked_kernel",)}
P14_OUT = "build/phase14"  # .gitignore lists build/


def profiled(fn, name: str, device) -> tuple:
    """``fn()`` under ``utils.trace.trace_to`` (its Chrome trace in
    ``P14_OUT/name``): the result, its host seconds (the profiler on),
    and the device ms and kernel records of B1 and B6 in it, summed over
    the profiler's device records by kernel name."""
    from torch.autograd import DeviceType

    from dat_replication_protocol_tpu_torch.utils.trace import trace_to

    with trace_to(os.path.join(P14_OUT, name), cuda=device == "cuda") as prof:
        t0 = time.perf_counter()
        res = fn()
        seconds = time.perf_counter() - t0
    ms = dict.fromkeys(P14_KERNELS, 0.0)
    calls = dict.fromkeys(P14_KERNELS, 0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for counter, kernels in P14_KERNELS.items():
            if any(k in e.key for k in kernels):
                ms[counter] += e.self_device_time_total / 1e3
                calls[counter] += e.count
    return res, seconds, ms, calls


def recorded_ms(ms: dict, calls: dict, counts: dict) -> dict:
    """Each kernel's device ms and its kernel records over the launches
    the counters saw: the ms where the profiler recorded every launch,
    else None (not measured: the profiler can drop a record, and a
    partial sum is not the kernel's time)."""
    return {n: {"ms": ms[n] if calls[n] == counts[n] else None,
                "records": calls[n], "launches": counts[n]}
            for n in P14_KERNELS}


def ae_records(lo: int, hi: int, rng) -> list[dict]:
    """Rows [lo, hi) in phase 11's record shape (``replay_records``:
    key, change, from, to, a value of row % 48 bytes, a subset absent on
    every third row), the values' bytes drawn from ``rng``."""
    lens = np.arange(lo, hi) % 48
    buf = rng.bytes(int(lens.sum()))
    ends = np.cumsum(lens)
    return [{"key": f"key-{i:07d}", "change": i, "from": i, "to": i + 1,
             "value": buf[e - n:e], "subset": "s" if i % 3 else None}
            for i, n, e in zip(range(lo, hi), lens.tolist(), ends.tolist())]


def canonical_digests(records) -> np.ndarray:
    """``hashlib`` BLAKE2b-256 of each record's per-record encoding, as
    (n, 32) uint8: the oracle of the replicas' elements."""
    from dat_replication_protocol_tpu_torch import encode_change

    return np.frombuffer(b"".join(blake(encode_change(r)) for r in records),
                         np.uint8).reshape(-1, 32)


def _v32(d: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(d).view(np.dtype((np.void, 32))).ravel()


def delivered(rec) -> tuple:
    """A record as a decoder delivers it (absent optionals as ''/b'')."""
    if isinstance(rec, dict):
        return (rec["key"], rec["change"], rec["from"], rec["to"],
                rec["value"] or b"", rec["subset"] or "")
    return (rec.key, rec.change, rec.from_, rec.to, rec.value or b"",
            rec.subset or "")


def batch_rows(wire: bytes) -> list:
    """Every row of the ChangeBatch frames in a recorded wire, as
    ``delivered`` tuples."""
    from dat_replication_protocol_tpu_torch.wire import batch_codec
    from dat_replication_protocol_tpu_torch.wire.framing import (
        TYPE_CHANGE_BATCH, iter_frames)

    out = []
    for _s, tid, p0, end in iter_frames(wire):
        if tid == TYPE_CHANGE_BATCH:
            cols = batch_codec.decode_change_batch(wire[p0:end])
            out += [delivered(cols.row(i)) for i in range(len(cols))]
    return out


class Sidecar:
    """``python -m dat_replication_protocol_tpu_torch.sidecar`` in a
    subprocess, as users start it, with its stderr lines collected and its
    port read from the ``listening on`` line."""

    def __init__(self, args: list[str], pass_fds=()):
        import threading

        root = os.path.dirname(os.path.abspath(__file__))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dat_replication_protocol_tpu_torch.sidecar",
             *args], cwd=root, stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": root}, pass_fds=pass_fds)
        self.peak_rss_kib = None  # sampled by sample_rss()
        self.lines: list[str] = []
        self.cond = threading.Condition()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        try:
            line = self.wait_for("listening on", SIDECAR_START_S)
        except AssertionError:
            self.close()  # a sidecar that never listened is stopped too
            raise
        self.port = int(line.rsplit(":", 1)[1])

    def _read(self) -> None:
        for line in self.proc.stderr:
            with self.cond:
                self.lines.append(line.rstrip("\n"))
                self.cond.notify_all()
        with self.cond:
            self.cond.notify_all()

    def wait_for(self, text: str, timeout: float, after: int = 0) -> str:
        deadline = time.monotonic() + timeout
        with self.cond:
            while True:
                for line in self.lines[after:]:
                    if text in line:
                        return line
                left = deadline - time.monotonic()
                if left <= 0 or (self.proc.poll() is not None
                                 and not self.reader.is_alive()):
                    raise AssertionError(
                        f"sidecar: no {text!r} line in {timeout} s; stderr "
                        f"{self.lines[-20:]}")
                self.cond.wait(min(left, 1.0))

    def sample_rss(self, period: float = 0.1) -> None:
        """Sample the sidecar's resident set (``VmRSS``) every ``period``
        seconds until it exits; the largest sample is ``peak_rss_kib``.
        (Its ``ru_maxrss`` would count this process's pages, which the
        fork shares with it before the exec.)"""
        import threading

        def run():
            path = f"/proc/{self.proc.pid}/status"
            while self.proc.poll() is None:
                try:
                    with open(path) as f:
                        for line in f:
                            if line.startswith("VmRSS:"):
                                self.peak_rss_kib = max(
                                    self.peak_rss_kib or 0,
                                    int(line.split()[1]))
                except OSError:
                    return  # it exited between the poll and the read
                time.sleep(period)

        threading.Thread(target=run, daemon=True).start()

    def close(self, sig=None) -> None:
        """Stop the sidecar: SIGTERM, or ``sig`` (SIGINT runs its
        shutdown: the hub closes and the last stats record is written)."""
        if sig is None:
            self.proc.terminate()
        else:
            self.proc.send_signal(sig)
        try:
            self.proc.wait(10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
        self.reader.join(10)


def _connect(port: int):
    import socket

    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    sock.settimeout(120)
    return sock


def counted_io(sock, flip=None):
    """``io_for_socket(sock)`` with every byte each way counted and kept;
    ``flip(data)`` may return a corrupted copy of an outgoing chunk."""
    from dat_replication_protocol_tpu_torch.session.pump import io_for_socket

    rd0, wr0 = io_for_socket(sock)
    seen = {"tx": bytearray(), "rx": bytearray()}

    def rd(n):
        data = rd0(n)
        seen["rx"] += data
        return data

    def wr(data):
        if flip is not None:
            data = flip(data)
        seen["tx"] += data
        wr0(data)

    return rd, wr, seen


class FlipFirstSymbols:
    """A ``counted_io`` flip of the low bit of one byte of the first
    SYMBOLS frame: its start index (0 -> 1) when ``cell`` is None, else
    the first byte of word ``word`` of cell ``cell`` (0 the count, 1-2
    the checksum, 3-10 the key sum).  It keeps the outgoing bytes only
    until that byte has gone by; ``flipped`` says whether it was hit."""

    def __init__(self, cell=None, word: int = 0):
        self.cell, self.word = cell, word
        self.head = bytearray()
        self.flipped = False
        self.done = False

    def _target(self):
        """The byte's offset in the stream, or None until the first
        SYMBOLS frame's header and varints are in ``head``."""
        from dat_replication_protocol_tpu_torch.ops.rateless import (
            SYMBOL_BYTES)
        from dat_replication_protocol_tpu_torch.wire.framing import (
            TYPE_RECONCILE, iter_frames)
        from dat_replication_protocol_tpu_torch.wire.reconcile_codec import (
            RC_SYMBOLS)
        from dat_replication_protocol_tpu_torch.wire.varint import (
            NeedMoreData, decode_uvarint)

        try:  # a header, subtype or varint cut by the chunk's end
            for _s, tid, p0, end in iter_frames(self.head):
                if tid == TYPE_RECONCILE and self.head[p0] == RC_SYMBOLS:
                    at = p0 + 1
                    if self.cell is None:
                        return at
                    for _ in range(2):  # the start and count varints
                        at += decode_uvarint(self.head, at)[1]
                    return at + self.cell * SYMBOL_BYTES + 4 * self.word
                if end > len(self.head):
                    return None
        except (IndexError, NeedMoreData):
            pass
        return None

    def __call__(self, data: bytes) -> bytes:
        if self.done:
            return data
        base = len(self.head)
        self.head += data
        at = self._target()
        if at is None:
            return data
        self.done, self.head = True, bytearray()
        if base <= at < base + len(data):
            out = bytearray(data)
            out[at - base] ^= 0x01
            self.flipped = True
            return bytes(out)
        return data


def reconcile_arm(sidecar, replica, want_a_only, want_b_only,
                  local: dict) -> dict:
    """One initiator session against the sidecar over a counted socket,
    held against the oracle's record sets and ``reconcile_local``'s
    metering of the same pair."""
    import socket

    from dat_replication_protocol_tpu_torch.runtime.reconcile_driver import (
        run_initiator)

    n_lines = len(sidecar.lines)
    t0 = time.perf_counter()
    sock = _connect(sidecar.port)
    try:
        rd, wr, seen = counted_io(sock)
        res = run_initiator(replica, rd, wr,
                            close_write=lambda: sock.shutdown(
                                socket.SHUT_WR))
        line = sidecar.wait_for("'reconcile': True", 120, after=n_lines)
        seconds = time.perf_counter() - t0
    finally:
        sock.close()
    if "'ok': True" not in line:
        raise AssertionError(f"sidecar session failed: {line}")
    got = sorted(delivered(c) for c in res["received"])
    if got != sorted(want_b_only):
        raise AssertionError(f"the initiator received {len(got)} records, "
                             f"not the sidecar's {len(want_b_only)} own")
    shipped = sorted(batch_rows(bytes(seen["tx"])))
    if shipped != sorted(want_a_only):
        raise AssertionError(f"the initiator shipped {len(shipped)} records,"
                             f" not its {len(want_a_only)} own")
    if f"'records_received': {len(want_a_only)}" not in line:
        raise AssertionError(f"the sidecar's record count: {line}")
    wire = {"a2b": len(seen["tx"]), "b2a": len(seen["rx"])}
    metered = {"a2b": local["wire_a2b"], "b2a": local["wire_b2a"]}
    if wire != metered or res["symbols"] != local["symbols"] \
            or res["rounds"] != local["rounds"]:
        raise AssertionError(
            f"socket bytes {wire}, symbols {res['symbols']}, rounds "
            f"{res['rounds']}; reconcile_local meters {metered}, "
            f"{local['symbols']}, {local['rounds']}")
    return {"seconds": seconds, "symbols": res["symbols"],
            "rounds": res["rounds"], "wire": wire,
            "received": len(got), "sent": len(shipped),
            "record": session_record(line)}


def session_record(line: str) -> dict:
    """The record dict of a sidecar's ``sidecar: PEER {...}`` line."""
    import ast

    return ast.literal_eval(line[line.index("{"):])


def run_anti_entropy_reconcile(device, shared=AE_SHARED, own=AE_OWN,
                               small_own=AE_SMALL_OWN,
                               seed=SEED + 140) -> dict:
    """Phase 14a (see the module docstring)."""
    import tempfile

    from dat_replication_protocol_tpu_torch.runtime import replay
    from dat_replication_protocol_tpu_torch.runtime.reconcile_driver import (
        RatelessReplica, reconcile_local)

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    both = ae_records(0, shared, rng)
    a_own = ae_records(shared, shared + own, rng)
    b_own = ae_records(shared + own, shared + 2 * own, rng)
    w_shared = replay.encode_change_log(both)
    w_b_own = replay.encode_change_log(b_own)
    wire_a = w_shared + replay.encode_change_log(a_own)
    wire_b = w_shared + w_b_own
    # the k = 10 arm's initiator: B's log less its last few own records,
    # plus a few of A's
    wire_a10 = (w_shared + replay.encode_change_log(b_own[:own - small_own])
                + replay.encode_change_log(a_own[:small_own]))
    make_s = time.perf_counter() - t0

    # the oracle: hashlib digests of every canonical record, the set
    # differences in numpy
    t0 = time.perf_counter()
    d_both, d_a, d_b = (canonical_digests(r) for r in (both, a_own, b_own))
    set_a = _v32(np.concatenate([d_both, d_a]))
    set_b = _v32(np.concatenate([d_both, d_b]))
    only_a, only_b = np.setdiff1d(set_a, set_b), np.setdiff1d(set_b, set_a)
    if not (np.array_equal(np.sort(only_a), np.sort(_v32(d_a)))
            and np.array_equal(np.sort(only_b), np.sort(_v32(d_b)))):
        raise AssertionError("the oracle's set difference is not the logs' "
                             "own records")
    oracle_s = time.perf_counter() - t0

    out = {"records": (len(both) + own, len(both) + own), "make_s": make_s,
           "oracle_s": oracle_s}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "B.log")
        with open(path, "wb") as f:
            f.write(wire_b)
        t0 = time.perf_counter()
        side = Sidecar(["--tcp", "127.0.0.1:0", "--reconcile", path,
                        "--device", str(device)])
        out["sidecar_start_s"] = time.perf_counter() - t0
        try:
            reset_counters()
            rep_a, out["build_s"], ms, calls = profiled(
                lambda: RatelessReplica(wire_a, device=device),
                "replica_a", device)
            out["b1"] = recorded_ms(ms, calls, read_counters())["blake2b"]
            rep_b = RatelessReplica(wire_b, device=device)
            if not (np.array_equal(np.sort(_v32(rep_a.digests)),
                                   np.sort(set_a))
                    and np.array_equal(np.sort(_v32(rep_b.digests)),
                                       np.sort(set_b))):
                raise AssertionError("the replicas' B1 digests are not the "
                                     "oracle's hashlib digests")
            t0 = time.perf_counter()
            local = reconcile_local(rep_a, rep_b)
            out["local_s"] = time.perf_counter() - t0
            a_rows = [delivered(r) for r in a_own]
            b_rows = [delivered(r) for r in b_own]
            out["k1000"] = reconcile_arm(side, rep_a, a_rows, b_rows, local)

            rep_a10 = RatelessReplica(wire_a10, device=device)
            local10 = reconcile_local(rep_a10, rep_b)
            out["k10"] = reconcile_arm(
                side, rep_a10, [delivered(r) for r in a_own[:small_own]],
                b_rows[own - small_own:], local10)
            out["launches"] = read_counters()
            # phase 17b serves rep_b from an edge loop to rep_a again
            out["edge"] = {"rep_a": rep_a, "rep_b": rep_b, "a_rows": a_rows,
                           "b_rows": b_rows, "local": local}
            del rep_a10, local10

            # the corrupt arms: one byte of the first SYMBOLS frame
            # flipped, in its start index and in cell 0's key sum
            out["corrupt"] = {
                what: corrupt_arm(side, rep_a, flip, a_rows, b_rows)
                for what, flip in (("start", FlipFirstSymbols()),
                                   ("key sum", FlipFirstSymbols(0, 3)))}
        finally:
            side.close()
    return out


def corrupt_arm(side, replica, flip, a_rows, b_rows) -> dict:
    """One initiator session against the sidecar with ``flip`` applied
    to its outgoing bytes.  It must end within ``ARM_LIMIT_S`` in one
    ``ProtocolError``, a closed socket and the sidecar's ``ok: False``,
    or with exactly the oracle's records each way and the sidecar's
    ``ok: True``: never a wrong record set."""
    import socket

    from dat_replication_protocol_tpu_torch.runtime.reconcile_driver import (
        run_initiator)
    from dat_replication_protocol_tpu_torch.wire.framing import ProtocolError

    n_lines = len(side.lines)
    t0 = time.perf_counter()
    sock = _connect(side.port)
    sock.settimeout(ARM_LIMIT_S)
    errors, res = [], None
    try:
        rd, wr, seen = counted_io(sock, flip=flip)
        try:
            res = run_initiator(replica, rd, wr, close_write=lambda:
                                sock.shutdown(socket.SHUT_WR))
        except ProtocolError as e:
            errors.append(e)
        closed = sock.recv(1) == b""
    finally:
        sock.close()
    line = side.wait_for("'reconcile': True", ARM_LIMIT_S, after=n_lines)
    seconds = time.perf_counter() - t0
    if not flip.flipped:
        raise AssertionError("corrupt arm: the flip never met its byte")
    if res is not None:
        exact = (sorted(delivered(c) for c in res["received"])
                 == sorted(b_rows)
                 and sorted(batch_rows(bytes(seen["tx"]))) == sorted(a_rows))
        ok = exact and "'ok': True" in line and closed
    else:
        ok = len(errors) == 1 and closed and "'ok': False" in line
    if not ok or seconds > ARM_LIMIT_S:
        raise AssertionError(
            f"corrupt arm: errors {errors}, result "
            f"{None if res is None else (res['symbols'], res['rounds'])}, "
            f"socket closed {closed}, {seconds} s, sidecar {line}")
    return {"seconds": seconds, "tx_bytes": len(seen["tx"]),
            "outcome": str(errors[0]) if errors else
            f"the exact difference in {res['symbols']} symbols",
            "sidecar": line}


def snapshot_joiner_arm(port: int, have=None, device="cuda", cut_at=None):
    """One ``run_snapshot_joiner`` over a counted socket; ``cut_at``
    ends the joiner's input (EOF) at that byte.  Returns the result (or
    the ProtocolError), seconds and the socket's bytes."""
    import socket

    from dat_replication_protocol_tpu_torch.runtime.snapshot_driver import (
        run_snapshot_joiner)
    from dat_replication_protocol_tpu_torch.wire.framing import ProtocolError

    t0 = time.perf_counter()
    sock = _connect(port)
    try:
        rd, wr, seen = counted_io(sock)
        if cut_at is not None:
            rd0 = rd

            def rd(n):
                left = cut_at - len(seen["rx"])
                if left <= 0:
                    sock.shutdown(socket.SHUT_RDWR)
                    return b""
                return rd0(min(n, left))
        try:
            res = run_snapshot_joiner(rd, wr, close_write=lambda:
                                      sock.shutdown(socket.SHUT_WR),
                                      have=have, device=device)
        except ProtocolError as e:
            res = e
    finally:
        sock.close()
    return res, time.perf_counter() - t0, {"rx": len(seen["rx"]),
                                            "tx": len(seen["tx"])}


def run_anti_entropy_snapshot(device, nbytes=SNAP_BYTES, crowd=SNAP_CROWD,
                              stale=SNAP_STALE, seed=SEED + 141) -> dict:
    """Phase 14b (see the module docstring)."""
    import threading

    from dat_replication_protocol_tpu_torch import sidecar
    from dat_replication_protocol_tpu_torch.ops import merkle
    from dat_replication_protocol_tpu_torch.runtime.snapshot_driver import (
        SnapshotSource, snapshot_local)
    from dat_replication_protocol_tpu_torch.wire.framing import (
        ProtocolError, TYPE_SNAPSHOT, iter_frames)
    from dat_replication_protocol_tpu_torch.wire.snapshot_codec import (
        SN_CHUNKS)

    data = make_blob(nbytes, seed=seed)
    out = {"bytes": nbytes}
    # one count over materialize, the cold joiner and the stale joiner
    reset_counters()
    src, out["materialize_s"], ms, calls = profiled(
        lambda: SnapshotSource(data, device=device), "materialize", device)
    out["materialize_launches"] = read_counters()
    out["materialize_ms"] = recorded_ms(ms, calls,
                                        out["materialize_launches"])
    cuts = (src.offs + src.lens).tolist()
    out["checked"] = check_cuts(data, cuts, "snapshot materialize")
    root = merkle.root_host([blake(data[o:o + n])
                             for o, n in zip(src.offs.tolist(),
                                             src.lens.tolist())])
    if root != src.manifest.root:
        raise AssertionError("the manifest root is not root_host of the "
                             "hashlib digests at its cuts")
    out["chunks"] = len(cuts)

    ready = threading.Event()
    port = {}
    server = threading.Thread(
        target=sidecar.serve_tcp, daemon=True,
        args=("127.0.0.1", 0),
        kwargs={"max_sessions": 3 + crowd, "snapshot_source": src,
                "device": device,
                "ready_cb": lambda p: (port.setdefault("p", p),
                                       ready.set())})
    server.start()
    if not ready.wait(60):
        raise AssertionError("serve_tcp did not start listening")
    port = port["p"]

    def exact(res, what: str) -> None:
        if isinstance(res, Exception):
            raise AssertionError(f"{what}: {res}")
        if not np.array_equal(np.frombuffer(res["data"], np.uint8), data):
            raise AssertionError(f"{what}: the assembled bytes differ")

    # the cold joiner
    res, seconds, cold_wire = snapshot_joiner_arm(port, device=device)
    exact(res, "cold joiner")
    out["cold"] = {"seconds": seconds, "wire": cold_wire,
                   "gib_s": nbytes / (1 << 30) / seconds}
    out["cold_launches"] = read_counters()
    del res

    # the stale joiner: 2% of the chunks rewritten (bench.py's recipe)
    rng = np.random.default_rng(seed + 1)
    pick = rng.choice(len(cuts), size=max(1, int(len(cuts) * stale)),
                      replace=False)
    have = data.copy()
    have[src.offs[pick]] ^= 0x5A
    res, seconds, stale_wire = snapshot_joiner_arm(port, have=have,
                                                   device=device)
    exact(res, "stale joiner")
    out["launches"] = read_counters()
    local = snapshot_local(src, have, device=device)
    if (res["bytes_received"] != local["bytes_received"]
            or stale_wire["rx"] != local["wire_s2j"]
            or stale_wire["tx"] != local["wire_j2s"]):
        raise AssertionError(
            f"stale joiner: chunk bytes {res['bytes_received']}, socket "
            f"{stale_wire}; snapshot_local {local['bytes_received']}, "
            f"{local['wire_s2j']} / {local['wire_j2s']}")
    out["stale"] = {"seconds": seconds, "wire": stale_wire,
                    "chunk_bytes": res["bytes_received"],
                    "reused": res["chunks_reused"],
                    "symbols": res["symbols"], "rounds": res["rounds"],
                    "ratio": (stale_wire["rx"] + stale_wire["tx"])
                    / (cold_wire["rx"] + cold_wire["tx"])}
    del res, have, local

    # the flash crowd: cold joiners at once, each compared then dropped
    reset_counters()
    lock = threading.Lock()
    crowd_out = []

    def join_one() -> None:
        r, s, w = snapshot_joiner_arm(port, device=device)
        ok = not isinstance(r, Exception) and np.array_equal(
            np.frombuffer(r["data"], np.uint8), data)
        with lock:
            crowd_out.append((ok, s, w, None if ok else str(r)[:200]))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=join_one, daemon=True)
               for _ in range(crowd)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    crowd_s = time.perf_counter() - t0
    grew = read_counters()
    if len(crowd_out) != crowd or not all(o[0] for o in crowd_out):
        raise AssertionError(f"flash crowd: {crowd_out}")
    if grew["blake2b"] or grew["gear_window_first_checked"]:
        raise AssertionError(f"the flash crowd launched kernels: {grew}")
    # each joiner's stream is the BEGIN frame, then the cold log
    log_len = src.cold_log().end - src.cold_log().start
    begin_len = cold_wire["rx"] - log_len
    served = sum(o[2]["rx"] - begin_len for o in crowd_out)
    if served != crowd * log_len:
        raise AssertionError(f"flash crowd: {served} bytes of the cold log "
                             f"served, not {crowd} x its {log_len}")
    out["crowd"] = {"joiners": crowd, "seconds": crowd_s,
                    "gib_s": crowd * nbytes / (1 << 30) / crowd_s,
                    "served": served, "cold_log": log_len}

    # the torn arm: the joiner's socket cut in the middle of a CHUNKS
    # frame (the cold stream's second frame)
    first = None
    raw = src.cold_log().read_slices(src.cold_log().start, 4 << 20)
    head = b"".join(bytes(v) for v in raw)
    for _s, tid, p0, end in iter_frames(head):
        if end > len(head):
            break
        if tid == TYPE_SNAPSHOT and head[p0] == SN_CHUNKS:
            first = (p0, end)
            break
    cut = begin_len + (first[0] + first[1]) // 2
    res, seconds, _w = snapshot_joiner_arm(port, device=device, cut_at=cut)
    if not isinstance(res, ProtocolError) or seconds > ARM_LIMIT_S:
        raise AssertionError(f"torn arm: {res!r} in {seconds} s")
    out["torn"] = {"seconds": seconds, "cut_at": cut, "error": str(res)}
    server.join(30)
    return out


# ---------------------------------------------------------------------------
# phase 15: the replication hub
# ---------------------------------------------------------------------------

# 15a: bench.py config 9 at its full shape (bench_hub_soak, not quick)
HUB_SESSIONS = 16
HUB_ROWS = 16_384
HUB_BLOB = 2 * MIB
HUB_STEP = 1 << 18  # config 9 writes 256 KiB at a time
HUB_SOAK = {"linger_s": 0.002, "window_items": 1 << 16,
            "window_bytes": 64 << 20, "parked_budget": 1 << 30}
# 15b: bench.py config 13's hub arm: 1, 4 and 16 concurrent sessions of an
# 8 MiB wire each (max(4, 64 // 8) MiB), ~1.5% of it a change run
HUB_COUNTS = (1, 4, 16)
# 15a's gated run: 4 of the 16 sessions (all 16 took 59 s with the gate
# on, H100 80GB HBM3, 700 W)
HUB_GATED_SESSIONS = 4
HUB_WIRE_MIB = 8
HUB_STATS_S = 0.5
# 15c: the shedding arm's budget and the offender's blob
HUB_SHED_BUDGET = 64 * MIB
HUB_SHED_BLOB = MIB
# 15d: sessions on the one-rank mesh
HUB_MESH_SESSIONS = 4


def wire_of(enc) -> bytes:
    out = bytearray()
    while (chunk := enc.read(MIB)) is not None:
        out += chunk
    return bytes(out)


def wire_digests(wire: bytes) -> list:
    """``(kind, seq, digest)`` of every change and blob frame of a wire in
    order, by ``hashlib``: what a digest session owes for it."""
    from dat_replication_protocol_tpu_torch.wire.framing import (
        TYPE_BLOB, TYPE_CHANGE, iter_frames)

    out, seqs = [], {"change": 0, "blob": 0}
    mv = memoryview(wire)
    for _s, tid, p0, end in iter_frames(wire):
        kind = {TYPE_CHANGE: "change", TYPE_BLOB: "blob"}[tid]
        out.append((kind, seqs[kind], blake(mv[p0:end])))
        seqs[kind] += 1
    return out


def hub_soak_wires(n: int = HUB_SESSIONS) -> list:
    """Config 9's per-session wires: a per-record change run of 64-byte
    values, then one blob (seeded bytes, so each session's differ)."""
    import dat_replication_protocol_tpu_torch as protocol

    rng = np.random.default_rng(SEED + 150)
    wires = []
    for i in range(n):
        e = protocol.encode()
        e.change_many([{"key": f"s{i}-{j:06d}", "change": j, "from": j,
                        "to": j + 1, "value": b"v" * 64}
                       for j in range(HUB_ROWS)])
        e.blob(HUB_BLOB).end(rng.bytes(HUB_BLOB))
        e.finalize()
        wires.append(wire_of(e))
    return wires


def drive_hub(hub, wires: list, want: list, what: str,
              start=None) -> dict:
    """One digest session a wire on ``hub``, registered first, then all
    started together, each on its own thread (``start()`` runs between);
    every session's digests must be ``want``'s, in its own order.
    Returns the wall time and each session's seconds."""
    import threading

    import dat_replication_protocol_tpu_torch as protocol

    n = len(wires)
    done: list = [None] * n
    errors: list = []
    gate = threading.Event()
    sessions = [hub.register(f"s{i}") for i in range(n)]

    def run_one(i: int) -> None:
        try:
            gate.wait(60)
            t0 = time.perf_counter()
            s = sessions[i]
            dec = protocol.decode(backend="cuda", pipeline=s)
            got: list = []
            dec.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))
            wire = wires[i]
            for off in range(0, len(wire), HUB_STEP):
                dec.write(wire[off:off + HUB_STEP])
            dec.end()
            if not dec.finished or dec.destroyed:
                raise AssertionError("the session did not finish")
            s.close()
            done[i] = (time.perf_counter() - t0, got)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(f"session {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run_one, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    if start is not None:
        start()
    t0 = time.perf_counter()
    gate.set()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(d is None for d in done):
        raise AssertionError(f"{what}: {errors or 'a session hung'}")
    for i in range(n):
        if done[i][1] != want[i]:
            raise AssertionError(f"{what}: session {i}'s digests differ from "
                                 f"hashlib's or from its own order")
    return {"seconds": wall, "session_s": [d[0] for d in done],
            "digests": sum(len(d[1]) for d in done)}


def run_hub_soak(device, wires: list, want: list) -> dict:
    """15a: config 9 on one card's hub, the gate off (the measurement),
    then again with it on, over ``HUB_GATED_SESSIONS`` of the sessions,
    for the hub.* counters and the dispatcher's turns."""
    from dat_replication_protocol_tpu_torch import obs
    from dat_replication_protocol_tpu_torch.hub import ReplicationHub

    runs = []
    for gated in (False, True):
        if gated:
            wires = wires[:HUB_GATED_SESSIONS]
            want = want[:HUB_GATED_SESSIONS]
            obs_reset()
            obs.enable()
        n = len(wires)
        total = sum(len(w) for w in wires)
        hub = ReplicationHub(device=device, max_sessions=n + 1, **HUB_SOAK)
        try:
            r = drive_hub(hub, wires, want, "phase 15a")
            r["dispatches"] = hub._pipeline.dispatches
        finally:
            hub.close()
            if gated:
                snap = obs.snapshot()
                counters = snap["counters"]
                lat = snap["histograms"]["hub.dispatch.latency"]
                obs.disable()
        per = sorted(len(wires[i]) / r["session_s"][i] for i in range(n))
        r["sessions"] = n
        r["gib_s"] = total / r["seconds"] / (1 << 30)
        r["fairness"] = per[0] / per[n // 2]
        r["session_gib_s"] = (per[0] / (1 << 30), per[n // 2] / (1 << 30))
        runs.append(r)
    hub_counters = {k: counters[k] for k in (
        "hub.admitted", "hub.dispatch.batches", "hub.dispatch.items",
        "hub.dispatch.bytes", "hub.shed", "hub.rejected")}
    if hub_counters["hub.dispatch.items"] != runs[1]["digests"]:
        raise AssertionError(f"phase 15a: hub.dispatch.items "
                             f"{hub_counters} != {runs[1]['digests']} digests")
    if hub_counters["hub.dispatch.batches"] != runs[1]["dispatches"]:
        raise AssertionError(f"phase 15a: hub.dispatch.batches "
                             f"{hub_counters} != the pipeline's "
                             f"{runs[1]['dispatches']} dispatches")
    # the dispatcher's turns: the sum over the run's wall time is the
    # share of the run the dispatcher spent in turns
    turns = {"count": lat["count"], "sum_s": lat["sum"], "p50_s": lat["p50"],
             "p99_s": lat["p99"], "share": lat["sum"] / runs[1]["seconds"]}
    return {"runs": runs, "counters": hub_counters, "turns": turns}


def hub_client_wire(seed: int, mib: int = HUB_WIRE_MIB) -> bytes:
    """Config 13's session wire: a change run of ~1.5% of the bytes (64-byte
    values, ~89 wire bytes a row), then 1 MiB blobs of seeded bytes."""
    import dat_replication_protocol_tpu_torch as protocol

    rng = np.random.default_rng(SEED + 160 + seed)
    rows = (mib << 20) // 64 // 89
    e = protocol.encode()
    e.change_many([{"key": f"s{seed}-{j:07d}", "change": j, "from": j,
                    "to": j + 1, "value": b"v" * 64} for j in range(rows)])
    for _ in range(max(1, mib - mib // 64)):
        e.blob(MIB).end(rng.bytes(MIB))
    e.finalize()
    return wire_of(e)


class StatsReader:
    """The ``--stats-fd`` pipe of a sidecar, read on a thread from the
    moment it is made: every line must parse as one JSON object.  The
    sidecar's stats fd is non-blocking and a record it cannot finish
    within 2 s latches its emitter dead, so the pipe is drained while the
    sidecar starts, not only once it listens."""

    def __init__(self):
        import threading

        self.r, self.w = os.pipe()
        self.records: list = []
        self.errors: list = []
        self.cond = threading.Condition()
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def start(self) -> "StatsReader":
        """Close this process's write end, once the sidecar holds its own:
        the reader then sees EOF when the sidecar exits."""
        if self.w is not None:
            os.close(self.w)
            self.w = None
        return self

    def _read(self) -> None:
        buf = b""
        while chunk := os.read(self.r, 1 << 20):
            buf += chunk
            *lines, buf = buf.split(b"\n")
            for line in lines:
                try:
                    rec = json.loads(line)
                except ValueError as e:
                    self.errors.append(f"{e}: {line[:200]!r}")
                    continue
                with self.cond:
                    self.records.append(rec)
                    self.cond.notify_all()
        if buf:
            self.errors.append(f"a torn last line {buf[:200]!r}")
        with self.cond:
            self.cond.notify_all()

    def wait_for(self, ok, timeout: float, after: int = 0) -> dict:
        deadline = time.monotonic() + timeout
        with self.cond:
            while True:
                for rec in self.records[after:]:
                    if ok(rec):
                        return rec
                left = deadline - time.monotonic()
                if left <= 0 or not self.thread.is_alive():
                    raise AssertionError(
                        f"no stats record as wanted in {timeout} s")
                self.cond.wait(min(left, 1.0))

    def close(self) -> None:
        self.start()
        self.thread.join(30)
        os.close(self.r)


def hub_clients(port: int, wires: list, hold=None) -> dict:
    """One TCP client a wire, all at once: each sends its wire (a sender
    thread) and reads its reply to EOF; the reply's digests must be
    ``hashlib``'s of the wire's payloads, in order.  ``hold`` (an Event)
    makes every client stop halfway until it is set."""
    import socket
    import threading

    n = len(wires)
    replies: list = [None] * n
    errors: list = []
    ports: list = [None] * n
    started = threading.Barrier(n + 1)

    def client(i: int) -> None:
        try:
            sock = _connect(port)
            ports[i] = sock.getsockname()[1]
            wire = wires[i]
            half = len(wire) // 2 if hold is not None else len(wire)

            def send() -> None:
                sock.sendall(wire[:half])
                if hold is not None:
                    hold.wait(120)
                    sock.sendall(wire[half:])
                sock.shutdown(socket.SHUT_WR)

            sender = threading.Thread(target=send, daemon=True)
            started.wait(60)
            sender.start()
            reply = bytearray()
            while chunk := sock.recv(1 << 20):
                reply += chunk
            sender.join(120)
            sock.close()
            replies[i] = bytes(reply)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    started.wait(60)
    t0 = time.perf_counter()
    if hold is not None:
        return {"threads": threads, "t0": t0, "replies": replies,
                "errors": errors, "ports": ports}
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    return {"seconds": wall, "replies": replies, "errors": errors,
            "ports": ports}


def check_replies(out: dict, want: list, what: str) -> None:
    import dat_replication_protocol_tpu_torch as protocol

    if out["errors"] or any(r is None for r in out["replies"]):
        raise AssertionError(f"{what}: {out['errors'] or 'a client hung'}")
    for i, reply in enumerate(out["replies"]):
        got = []
        dec = protocol.decode()
        dec.change(lambda c, done: (got.append(
            (c.subset.split(":")[1], c.change, bytes(c.value))), done()))
        dec.write(reply)
        dec.end()
        if not dec.finished or got != want[i]:
            raise AssertionError(f"{what}: client {i}'s reply digests differ "
                                 f"from hashlib's")


def check_stats_lines(records: list, live: set, what: str) -> int:
    """Every record of an arm: the hub's session count is its breakdown's
    size, and each session it names is one of the arm's connections
    (``c<n>:127.0.0.1:<client port>``).  The sidecar starts its emitter
    before it builds the hub, so records before the first with a
    ``hub`` section have none to check; a later record without one
    fails."""
    named = 0
    seen_hub = False
    for rec in records:
        if "hub" not in rec and not seen_hub:
            continue  # emitted before the hub was installed
        seen_hub = True
        sessions = rec.get("sessions", {})
        if rec["hub"]["sessions"] != len(sessions):
            raise AssertionError(f"{what}: hub {rec['hub']} vs sessions "
                                 f"{sorted(sessions)}")
        for key in sessions:
            c, host, cport = key.split(":")
            if not c.startswith("c") or host != "127.0.0.1" \
                    or int(cport) not in live:
                raise AssertionError(f"{what}: stats name {key!r}, not one "
                                     f"of the arm's connections")
        named += len(sessions)
    if not seen_hub:
        raise AssertionError(f"{what}: no stats record carried the hub")
    return named


def run_hub_sidecar(device) -> dict:
    """15b: ``--tcp --hub --stats-fd`` in a subprocess at 1, 4 and 16
    concurrent clients, the same clients again on a ``--tcp --hub``
    sidecar with telemetry off (``--stats-fd`` turns it on), then a
    ``--hub-max-sessions 2`` sidecar with three."""
    import signal
    import threading

    stats = StatsReader()
    side = Sidecar(["--tcp", "127.0.0.1:0", "--hub", "--device", device,
                    "--stats-fd", str(stats.w),
                    "--stats-interval", str(HUB_STATS_S)],
                   pass_fds=(stats.w,))
    stats.start()
    arms = {}
    clients = {}
    digests = 0
    try:
        seed = 0
        for count in HUB_COUNTS:
            wires = [hub_client_wire(seed + i) for i in range(count)]
            seed += count
            want = [wire_digests(w) for w in wires]
            clients[count] = (wires, want)
            digests += sum(len(w) for w in want)
            first = len(stats.records)
            out = hub_clients(side.port, wires)
            check_replies(out, want, f"phase 15b, {count} clients")
            # a record after the arm: its sessions are gone
            stats.wait_for(lambda r: r["hub"]["sessions"] == 0, 30,
                           after=len(stats.records))
            named = check_stats_lines(stats.records[first:],
                                      set(out["ports"]),
                                      f"phase 15b, {count} clients")
            total = sum(len(w) for w in wires)
            arms[count] = {"gib_s": total / out["seconds"] / (1 << 30),
                           "seconds": out["seconds"], "bytes": total,
                           "records": len(stats.records) - first,
                           "named": named}
    finally:
        side.close(signal.SIGINT)
        stats.close()
    if stats.errors:
        raise AssertionError(f"phase 15b: stats lines {stats.errors[:3]}")
    final = stats.records[-1]
    counters = final["metrics"]["counters"]
    b1 = final["jit_sites"].get("ops.blake2b_cuda.packed", {}).get("calls", 0)
    if counters.get("hub.dispatch.items") != digests or b1 == 0:
        raise AssertionError(f"phase 15b: the sidecar hashed "
                             f"{counters.get('hub.dispatch.items')} items "
                             f"(want {digests}) with {b1} B1 launches")
    links = final.get("wirecost", {}).get("links", {})
    residual = {k: v["residual_bytes"] for k, v in links.items()}
    if len(links) != 2 * sum(HUB_COUNTS) or any(residual.values()):
        raise AssertionError(f"phase 15b: wire cost links {residual}")
    pump_batches = counters.get("transport.pump.batches", 0)
    if final["pump"]["route"] != "native" or pump_batches == 0:
        raise AssertionError(f"phase 15b: the stats record's pump "
                             f"{final['pump']}, {pump_batches} batches")
    out = {"arms": arms, "b1_launches": b1, "records": len(stats.records),
           "pump": final["pump"], "pump_batches": pump_batches,
           "counters": {k: counters[k] for k in (
               "hub.admitted", "hub.dispatch.batches", "hub.dispatch.items")},
           "emit_seq": final["emit_seq"]}

    # the same clients with telemetry off: the socket rate the gate costs
    side = Sidecar(["--tcp", "127.0.0.1:0", "--hub", "--device", device])
    out["arms_off"] = {}
    try:
        for count, (wires, want) in clients.items():
            res = hub_clients(side.port, wires)
            check_replies(res, want, f"phase 15b, gate off, {count} clients")
            total = sum(len(w) for w in wires)
            out["arms_off"][count] = {
                "gib_s": total / res["seconds"] / (1 << 30),
                "seconds": res["seconds"], "bytes": total}
    finally:
        side.close(signal.SIGINT)
    del clients

    # the rejected arm: two clients hold the hub's two slots halfway
    stats = StatsReader()
    side = Sidecar(["--tcp", "127.0.0.1:0", "--hub", "--device", device,
                    "--hub-max-sessions", "2", "--stats-fd", str(stats.w),
                    "--stats-interval", str(HUB_STATS_S)],
                   pass_fds=(stats.w,))
    stats.start()
    try:
        wires = [hub_client_wire(100 + i) for i in range(2)]
        hold = threading.Event()
        held = hub_clients(side.port, wires, hold=hold)
        rec = stats.wait_for(lambda r: len(r.get("sessions", {})) == 2, 60)
        if rec["healthz"]["stages"]["admission"]["open"]:
            raise AssertionError("phase 15b: admission open at capacity")
        t0 = time.perf_counter()
        sock = _connect(side.port)  # the surplus client
        eof = sock.recv(1 << 16)
        surplus_s = time.perf_counter() - t0
        sock.close()
        line = side.wait_for("'rejected': True", 30)
        hold.set()
        for t in held["threads"]:
            t.join(600)
        check_replies(held, [wire_digests(w) for w in wires],
                      "phase 15b, the held clients")
        if eof != b"":
            raise AssertionError(f"phase 15b: the surplus client read "
                                 f"{len(eof)} B, not EOF")
    finally:
        side.close(signal.SIGINT)
        stats.close()
    out["rejected"] = {"record": line.split(" ", 2)[-1], "eof_s": surplus_s,
                       "breakdown": sorted(rec["sessions"])}
    return out


def run_hub_shed(device) -> dict:
    """15c: a nowait session that never polls submits 1 MiB blobs past a
    64 MiB parked budget while three neighbours run whole sessions."""
    import threading

    from dat_replication_protocol_tpu_torch import obs
    from dat_replication_protocol_tpu_torch.hub import (ReplicationHub,
                                                        SessionShed)

    class Hub(ReplicationHub):
        """Records what the victim held in the pipeline when shed."""

        def _shed_locked(self, st, reason):
            self.at_shed = {"key": st.key, "out_items": st.out_items,
                            "queued": st.q_items, "undelivered":
                            st.comp_items}
            super()._shed_locked(st, reason)

    wires = [hub_client_wire(200 + i, mib=2) for i in range(3)]
    want = [wire_digests(w) for w in wires]
    blob = np.random.default_rng(SEED + 170).bytes(HUB_SHED_BLOB)
    obs_reset()
    obs.enable()
    hub = Hub(device=device, parked_budget=HUB_SHED_BUDGET,
              window_bytes=8 * MIB, linger_s=0.002)
    try:
        offender = hub.register("offender", nowait=True)
        shed: list = []

        def flood() -> None:
            # paced, so that some blobs are hashed (their digests wait,
            # never polled) and some are in the pipeline at the shed
            try:
                while True:
                    offender.submit(blob, lambda d: None)
                    time.sleep(0.002)
            except SessionShed as e:
                shed.append(e)

        t = threading.Thread(target=flood, daemon=True)
        t0 = time.perf_counter()
        neighbours = drive_hub(hub, wires, want, "phase 15c's neighbours",
                               start=t.start)
        t.join(120)
        seconds = time.perf_counter() - t0
        if not shed:
            raise AssertionError("phase 15c: the offender was never shed")
        e = shed[0]
        if (e.key, e.reason) != ("offender", "parked-budget") \
                or hub.at_shed["key"] != "offender":
            raise AssertionError(f"phase 15c: shed {e!r}, {hub.at_shed}")
        events = [ev["fields"] for ev in obs.EVENTS.events("hub.shed")]
        if [ev["key"] for ev in events] != ["offender"]:
            raise AssertionError(f"phase 15c: hub.shed events {events}")
        dropped = obs.REGISTRY.counter("hub.completions.dropped")
        deadline = time.monotonic() + 30
        while (dropped.value < hub.at_shed["out_items"]
               and time.monotonic() < deadline):
            time.sleep(0.01)
        if dropped.value != hub.at_shed["out_items"]:
            raise AssertionError(f"phase 15c: {dropped.value} completions "
                                 f"dropped, {hub.at_shed} in flight")
        stats = offender.stats()
        offender.close()
        if hub.snapshot()["parked_bytes"] != 0:
            raise AssertionError(f"phase 15c: {hub.snapshot()} after close")
    finally:
        hub.close()
        obs.disable()
    return {"shed": str(e), "parked_bytes": e.parked_bytes,
            "event": events[0], "at_shed": hub.at_shed,
            "dropped": dropped.value, "submitted": stats["submitted"],
            "neighbours_s": neighbours["seconds"],
            "neighbour_digests": neighbours["digests"], "seconds": seconds}


def run_hub_mesh(device, wires: list, want: list) -> dict:
    """15d: the hub on ``make_mesh()`` over a one-rank ``nccl`` group; every
    batch must go through ``sharded_hash_begin``."""
    from dat_replication_protocol_tpu_torch.hub import ReplicationHub
    from dat_replication_protocol_tpu_torch.parallel import make_mesh
    from dat_replication_protocol_tpu_torch.parallel import mesh as pmesh

    calls = [0]
    sharded = pmesh.sharded_hash_begin

    def counted(mesh, payloads, *args, **kw):
        calls[0] += 1
        return sharded(mesh, payloads, *args, **kw)

    pmesh.sharded_hash_begin = counted
    try:
        with one_rank_group(device) as group:
            hub = ReplicationHub(mesh=make_mesh(device=device),
                                 max_sessions=len(wires) + 1, **HUB_SOAK)
            try:
                r = drive_hub(hub, wires, want, "phase 15d")
                dispatches = hub._pipeline.dispatches
            finally:
                hub.close()
    finally:
        pmesh.sharded_hash_begin = sharded
    if calls[0] == 0 or calls[0] != dispatches:
        raise AssertionError(f"phase 15d: {calls[0]} sharded_hash_begin "
                             f"calls for {dispatches} dispatches")
    total = sum(len(w) for w in wires)
    return {"seconds": r["seconds"], "gib_s": total / r["seconds"] / (1 << 30),
            "digests": r["digests"], "sharded_calls": calls[0],
            "init_s": group.init_s}


# ---------------------------------------------------------------------------
# phase 16: fan-out and resume
# ---------------------------------------------------------------------------

# 16a: bench.py config 10 (bench_fanout), uncut
FAN_ROWS = 16_384
FAN_BLOB = 2 * MIB
FAN_PEERS = (1, 8, 64, 256)
FAN_STALL_PEERS = 8
FAN_STALL_S = 3.0
FAN_STEP = 1 << 18
# 16b: the sidecar's subscribers, and the snapshot composition's dataset
# (cut from config 12's 1 GiB: phase 14b times that bootstrap already)
FAN_SUBSCRIBERS = 8
FAN_SNAP_BYTES = 64 * MIB
FAN_RETENTION = MIB
# 16c: bench.py config 6 (bench_resume): 20,000 rows, a drop at half the
# wire; its reps cut from 100 to 20
RESUME_ROWS = 20_000
RESUME_REPS = 20
# the sweep and the flight arm run a 2,000-row wire (config 6's quick
# size, with a 64 KiB blob): byte-at-a-time plans over the full wire
# would take minutes of Python a seed
SWEEP_ROWS = 2_000
SWEEP_SEEDS = 16
# 16d: bench.py config 12's chaos arm, a 4 MiB window of the dataset
CHAOS_BYTES = 4 * MIB
P16_OUT = "build/phase16"  # .gitignore lists build/


def fanout_wire(prefix: str = "f") -> bytes:
    """Config 10's source wire: a change run of 64-byte values, then one
    2 MiB blob of zeros (``prefix`` starts every key)."""
    import dat_replication_protocol_tpu_torch as protocol

    e = protocol.encode()
    e.change_many([{"key": f"{prefix}-{j:06d}", "change": j, "from": j,
                    "to": j + 1, "value": b"v" * 64}
                   for j in range(FAN_ROWS)])
    e.blob(FAN_BLOB).end(bytes(FAN_BLOB))
    e.finalize()
    return wire_of(e)


class CheckSink:
    """A fan-out peer that takes every view and keeps its length and a
    BLAKE2b of what it was given; ``count_only`` keeps the length only
    (config 10's accounting-only consumer)."""

    def __init__(self, count_only: bool = False):
        self.n = 0
        self.h = None if count_only else hashlib.blake2b(digest_size=32)

    def __call__(self, views) -> int:
        for v in views:
            self.n += len(v)
            if self.h is not None:
                self.h.update(v)
        return sum(len(v) for v in views)


def fanout_once(device, wire: bytes, want: list, n: int) -> dict:
    """One source decode of ``wire`` on B1 published to ``n``
    accounting-only peers: the digests against ``want``, the seconds
    from the first publish to the drain, the digest-work counters and
    B1's launches."""
    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch import obs
    from dat_replication_protocol_tpu_torch.fanout import FanoutServer

    srv = FanoutServer(retention_budget=len(wire) + MIB, stall_timeout=60.0)
    try:
        sinks = [CheckSink(count_only=True) for _ in range(n)]
        peers = [srv.attach_peer(f"p{i}", sink=s)
                 for i, s in enumerate(sinks)]
        dec = protocol.decode(backend="cuda", device=device)
        got = []
        dec.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))
        c0 = obs.snapshot()["counters"]
        b0 = read_counters()["blake2b"]
        t0 = time.perf_counter()
        for off in range(0, len(wire), FAN_STEP):
            chunk = wire[off:off + FAN_STEP]
            srv.publish(chunk)  # the fan-out: bytes only
            dec.write(chunk)  # the digest work: once
        dec.end()
        srv.seal()
        if not srv.drain(300):
            raise AssertionError(f"phase 16a: {n} peers did not drain")
        seconds = time.perf_counter() - t0
        c1 = obs.snapshot()["counters"]
        if not dec.finished or got != want:
            raise AssertionError(f"phase 16a: {n} peers: the source's "
                                 f"digests differ from hashlib's")
        stats = [p.stats() for p in peers]
        if any(s.n != len(wire) for s in sinks) or not all(
                st["done"] and st["shed"] is None for st in stats):
            raise AssertionError(f"phase 16a: {n} peers: a peer did not "
                                 f"get the whole wire")
        work = {k: c1.get(k, 0) - c0.get(k, 0)
                for k in ("device.submit.bytes", "device.h2d.bytes")}
        p99 = [st["lat_p99_ms"] for st in stats
               if st["lat_p99_ms"] is not None]
        return {"seconds": seconds, "work": work,
                "b1": read_counters()["blake2b"] - b0,
                "mib_s": n * len(wire) / seconds / MIB,
                "p99_ms": max(p99) if p99 else None}
    finally:
        srv.close()


def fanout_check(wire: bytes, n: int) -> None:
    """``wire`` published to ``n`` peers that hash what they get: every
    peer's length and BLAKE2b must be the wire's."""
    from dat_replication_protocol_tpu_torch.fanout import FanoutServer

    want = blake(wire)
    srv = FanoutServer(retention_budget=len(wire) + MIB, stall_timeout=60.0)
    try:
        sinks = [CheckSink() for _ in range(n)]
        for i, s in enumerate(sinks):
            srv.attach_peer(f"c{i}", sink=s)
        for off in range(0, len(wire), FAN_STEP):
            srv.publish(wire[off:off + FAN_STEP])
        srv.seal()
        if not srv.drain(300):
            raise AssertionError(f"phase 16a: the {n}-peer check hung")
        bad = [i for i, s in enumerate(sinks)
               if s.n != len(wire) or s.h.digest() != want]
        if bad:
            raise AssertionError(f"phase 16a: peers {bad[:8]} of {n} did "
                                 f"not get the wire byte for byte")
    finally:
        srv.close()


def stalled_arm(wire: bytes, stall_s: float) -> dict:
    """Config 10's stalled arm: ``FAN_STALL_PEERS`` peers, one of them
    taking nothing past half the wire for ``stall_s`` seconds (0: no
    staller, the unstalled arm); the other peers' worst p99 append ->
    delivery latency, and no peer shed."""
    from dat_replication_protocol_tpu_torch.fanout import FanoutServer

    srv = FanoutServer(retention_budget=len(wire) + MIB,
                       stall_timeout=max(60.0, stall_s * 4))
    try:
        gate: list = []
        held = CheckSink(count_only=True)

        def stall_sink(views) -> int:
            if not gate:
                gate.append(time.perf_counter() + stall_s)
            budget = (len(wire) // 2 - held.n
                      if time.perf_counter() < gate[0] else 1 << 60)
            if budget <= 0:
                return 0
            take = 0
            for v in views:
                take += min(len(v), budget - take)
                if take >= budget:
                    break
            held.n += take
            return take

        first = srv.attach_peer("staller", sink=(
            stall_sink if stall_s else CheckSink(count_only=True)))
        others = [srv.attach_peer(f"h{i}", sink=CheckSink(count_only=True))
                  for i in range(FAN_STALL_PEERS - 1)]
        t0 = time.perf_counter()
        for off in range(0, len(wire), FAN_STEP):
            srv.publish(wire[off:off + FAN_STEP])
        srv.seal()
        if not srv.drain(120 + stall_s):
            raise AssertionError("phase 16a: the stalled arm hung")
        seconds = time.perf_counter() - t0
        stats = [p.stats() for p in others]
        shed = [st["shed"] for st in stats] + [first.stats()["shed"]]
        if any(shed) or not all(st["done"] for st in stats):
            raise AssertionError(f"phase 16a: a peer was shed: {shed}")
        if stall_s and seconds < stall_s:
            raise AssertionError("phase 16a: the staller did not stall")
        return {"p99_ms": max(st["lat_p99_ms"] for st in stats),
                "seconds": seconds}
    finally:
        srv.close()


def run_fanout(device, wire: bytes, want: list) -> dict:
    """16a (see the module docstring)."""
    from dat_replication_protocol_tpu_torch import obs

    obs_reset()
    obs.enable()  # the hash-once counters
    try:
        arms = {n: fanout_once(device, wire, want, n) for n in FAN_PEERS}
    finally:
        obs.disable()
    for n in FAN_PEERS:
        fanout_check(wire, n)
    base = arms[FAN_PEERS[0]]
    for n, arm in arms.items():
        if arm["work"] != base["work"] or arm["b1"] != base["b1"]:
            raise AssertionError(f"phase 16a: the digest work grew with "
                                 f"the peers: {n}: {arm['work']}, B1 "
                                 f"{arm['b1']}; 1: {base['work']}, B1 "
                                 f"{base['b1']}")
    if base["b1"] == 0 or base["work"]["device.h2d.bytes"] == 0:
        raise AssertionError(f"phase 16a: the source hashed off the card: "
                             f"{base}")
    return {"arms": arms, "stalled": stalled_arm(wire, FAN_STALL_S),
            "unstalled": stalled_arm(wire, 0.0)}


def sentinel_launches(record: dict) -> dict:
    """B1's and B6's launches, from a stats record's kernel sentinel."""
    sites = record["jit_sites"]
    return {"blake2b": sites.get("ops.blake2b_cuda.packed", {}).get(
        "calls", 0),
            "gear_window_first_checked": sites.get(
                "ops.fused_cdc_hash.window_first_checked", {}).get(
                "calls", 0)}


def read_to_eof(sock) -> bytes:
    out = bytearray()
    while chunk := sock.recv(1 << 20):
        out += chunk
    return bytes(out)


def run_fanout_sidecar(device, wire: bytes, want: list) -> dict:
    """16b (see the module docstring)."""
    import signal
    import socket
    import threading

    from dat_replication_protocol_tpu_torch.runtime.snapshot_driver import (
        run_snapshot_joiner)
    from dat_replication_protocol_tpu_torch.wire.framing import CAP_SNAPSHOT

    out = {}
    stats = StatsReader()
    side = Sidecar(["--tcp", "127.0.0.1:0", "--fanout", "--hub", "--device",
                    device, "--stats-fd", str(stats.w), "--stats-interval",
                    "3600"], pass_fds=(stats.w,))
    stats.start()
    try:
        probe = _connect(side.port)  # a health check: no byte sent
        probe.close()
        # its session gives the source claim back before its record is
        # printed (the hub's first session may take a while to end)
        side.wait_for("'bytes': 0, 'digests': 0", 60)
        src = _connect(side.port)
        time.sleep(0.5)  # the source's session claims the slot
        subs = [_connect(side.port) for _ in range(FAN_SUBSCRIBERS)]
        got: list = [None] * FAN_SUBSCRIBERS

        def read_sub(i: int) -> None:
            got[i] = read_to_eof(subs[i])

        readers = [threading.Thread(target=read_sub, args=(i,), daemon=True)
                   for i in range(FAN_SUBSCRIBERS)]
        for t in readers:
            t.start()
        time.sleep(0.2)
        t0 = time.perf_counter()
        sender = threading.Thread(target=lambda: (
            src.sendall(wire), src.shutdown(socket.SHUT_WR)), daemon=True)
        sender.start()
        reply = read_to_eof(src)
        sender.join(120)
        for t in readers:
            t.join(120)
        out["seconds"] = time.perf_counter() - t0
        src.close()
        for s in subs:
            s.close()
        check_replies({"errors": [], "replies": [reply]}, [want],
                      "phase 16b, the source")
        if any(g is None or len(g) != len(wire) or blake(g) != blake(wire)
               for g in got):
            raise AssertionError("phase 16b: a subscriber did not read the "
                                 "wire byte for byte")
        side.wait_for(f"'digests': {len(want)}", 30)
    finally:
        side.close(signal.SIGINT)
        stats.close()
    final = stats.records[-1]
    c = final["metrics"]["counters"]
    out["hub"] = sentinel_launches(final)
    out["sent"] = c.get("fanout.sent.bytes", 0)
    if out["hub"]["blake2b"] == 0 or \
            out["sent"] != FAN_SUBSCRIBERS * len(wire):
        raise AssertionError(f"phase 16b: B1 {out['hub']}, fanout.sent.bytes"
                             f" {out['sent']}")

    # the snapshot composition: a late subscriber is redirected
    os.makedirs(P16_OUT, exist_ok=True)
    data = make_blob(FAN_SNAP_BYTES, seed=SEED + 161)
    path = os.path.join(P16_OUT, "snapshot.bin")
    data.tofile(path)
    stats = StatsReader()
    t0 = time.perf_counter()
    side = Sidecar(["--tcp", "127.0.0.1:0", "--fanout", "--snapshot", path,
                    "--fanout-retention", str(FAN_RETENTION), "--device",
                    device, "--stats-fd", str(stats.w), "--stats-interval",
                    "3600"], pass_fds=(stats.w,))
    stats.start()
    out["snap_start_s"] = time.perf_counter() - t0
    try:
        boot = side.wait_for("snapshot bootstrap on", 5)
        snap_port = int(boot.rsplit(":", 1)[1])
        src = _connect(side.port)
        sender = threading.Thread(target=lambda: (
            src.sendall(wire), src.shutdown(socket.SHUT_WR)), daemon=True)
        sender.start()
        reply = read_to_eof(src)
        sender.join(120)
        src.close()
        check_replies({"errors": [], "replies": [reply]}, [want],
                      "phase 16b, the composed source")
        late = _connect(side.port)
        rec = json.loads(read_to_eof(late))
        late.close()
        start, end = rec.get("retained", (None, None))
        if not (rec.get("snapshot_needed") and end == len(wire)
                and 0 < start and end - start <= FAN_RETENTION
                and rec.get("hint") == {"port": snap_port,
                                        "cap": CAP_SNAPSHOT}):
            raise AssertionError(f"phase 16b: the late subscriber read "
                                 f"{rec}")
        out["refusal"] = rec
        joiner = _connect(snap_port)
        t1 = time.perf_counter()
        res = run_snapshot_joiner(
            joiner.recv, joiner.sendall,
            close_write=lambda: joiner.shutdown(socket.SHUT_WR),
            device=device)
        out["bootstrap_s"] = time.perf_counter() - t1
        joiner.close()
        if not np.array_equal(np.frombuffer(res["data"], np.uint8), data):
            raise AssertionError("phase 16b: the bootstrap's dataset differs")
    finally:
        side.close(signal.SIGINT)
        stats.close()
        os.remove(path)
    out["snap"] = sentinel_launches(stats.records[-1])
    if min(out["snap"].values()) == 0:
        raise AssertionError(f"phase 16b: the composed sidecar's kernels "
                             f"{out['snap']}")
    return out


def resume_wire(rows: int, blob: int = 0) -> bytes:
    """Config 6's journaled wire: ``rows`` changes with values of
    ``i % 48`` bytes (and one blob of seeded bytes when ``blob``)."""
    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch.session import WireJournal

    enc = protocol.encode()
    journal = WireJournal()
    enc.attach_journal(journal)
    for i in range(rows):
        enc.change({"key": f"key-{i:07d}", "change": i, "from": i,
                    "to": i + 1, "value": b"v" * (i % 48)})
        if blob and i == rows // 2:
            enc.blob(blob).end(np.random.default_rng(SEED + 162).bytes(blob))
    enc.finalize()
    while enc.read(1 << 18) is not None:
        pass
    return journal.read_from(0)


def resumed(device, wire: bytes, plans, times=None) -> tuple:
    """One ``run_resumable`` of a ``CudaDecoder`` over ``wire`` with
    ``plans(ckpt, failures)`` giving each connection's ``FaultPlan``:
    the digests, the stats (or the ``ProtocolError``) and the decoder.
    ``times`` gets the fault's and the first re-delivered frame's
    clock."""
    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch.session import (
        BackoffPolicy, FaultyReader, TransportFault, run_resumable)
    from dat_replication_protocol_tpu_torch.session.faults import (
        bytes_reader)
    from dat_replication_protocol_tpu_torch.wire.framing import ProtocolError

    dec = protocol.decode(backend="cuda", device=device)
    got = []
    dec.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))

    class TimedReader(FaultyReader):
        def read(self, n):
            try:
                return super().read(n)
            except TransportFault:
                if times is not None:
                    times["fault"] = time.perf_counter()
                raise

    def on_change(c, done):
        if times is not None and "fault" in times \
                and "redeliver" not in times:
            times["redeliver"] = time.perf_counter()
        done()

    dec.change(on_change)

    def source(ckpt, failures):
        return TimedReader(bytes_reader(wire[ckpt.wire_offset:]),
                           plans(ckpt, failures), sleep=lambda s: None)

    try:
        stats = run_resumable(source, dec,
                              BackoffPolicy(base=0.0, max_retries=4, seed=0),
                              chunk_size=1 << 16, expected_total=len(wire),
                              stall_timeout=30)
    except ProtocolError as e:
        return got, e, dec
    return got, stats, dec


def run_resume(device) -> dict:
    """16c (see the module docstring)."""
    import tempfile

    from dat_replication_protocol_tpu_torch.obs import flight
    from dat_replication_protocol_tpu_torch.session import FaultPlan
    from dat_replication_protocol_tpu_torch.wire.framing import iter_frames

    os.makedirs(P16_OUT, exist_ok=True)
    out = {}
    wire = resume_wire(RESUME_ROWS)
    want = wire_digests(wire)
    drop = len(wire) // 2
    lat = []
    for rep in range(RESUME_REPS + 1):  # the first is the warm-up
        times: dict = {}
        got, stats, dec = resumed(
            device, wire, lambda ck, f: FaultPlan(
                seed=f, drop_at=(drop - ck.wire_offset) if f == 0 else None),
            times)
        if isinstance(stats, Exception) or not dec.finished \
                or stats["reconnects"] != 1 or got != want:
            raise AssertionError(f"phase 16c: rep {rep}: {stats}; digests "
                                 f"{'==' if got == want else '!='} hashlib")
        if rep:
            lat.append((times["redeliver"] - times["fault"]) * 1e3)
    lat.sort()
    out["resume_ms"] = {"median": lat[len(lat) // 2],
                        "p90": lat[int(0.9 * (len(lat) - 1))],
                        "all": lat}
    out["wire"] = len(wire)

    sweep = resume_wire(SWEEP_ROWS, blob=1 << 16)
    swant = wire_digests(sweep)
    scen = {}
    for seed in range(SWEEP_SEEDS):
        got, stats, dec = resumed(
            device, sweep,
            lambda ck, f, seed=seed: FaultPlan.for_sweep(seed, len(sweep), f))
        if isinstance(stats, Exception) or not dec.finished or got != swant:
            raise AssertionError(f"phase 16c: sweep seed {seed}: {stats}")
        plan = FaultPlan.for_sweep(seed, len(sweep), 0)
        kind = ("drop" if plan.drop_at is not None else
                "truncate" if plan.truncate_at is not None else
                "stall" if plan.stall_at is not None else "reseg")
        scen[kind] = scen.get(kind, 0) + 1
    out["sweep"] = scen
    # the flip arm: frame 700's type id flipped to an unknown one
    p0 = [f[2] for f in iter_frames(sweep)][700]
    got, err, dec = resumed(device, sweep, lambda ck, f: FaultPlan(
        flip_at=p0 - 1 - ck.wire_offset, flip_mask=0x40, max_segment=4096))
    if not isinstance(err, Exception) or err.frame != 700 \
            or got != swant[:len(got)]:
        raise AssertionError(f"phase 16c: the flip arm ended in {err!r}")
    out["flip"] = {"error": str(err), "digests_before": len(got)}

    # the flight recorder: each recovered session, one routine bundle,
    # up to half of the budget
    with tempfile.TemporaryDirectory(dir=P16_OUT) as d:
        flight.FLIGHT.arm(d, max_bundles=4)
        try:
            for _ in range(3):
                got, stats, dec = resumed(device, sweep, lambda ck, f: (
                    FaultPlan(drop_at=1000) if f == 0 else FaultPlan()))
                if isinstance(stats, Exception) or got != swant:
                    raise AssertionError(f"phase 16c: flight arm {stats}")
            names = sorted(n for n in os.listdir(d) if n.startswith("bundle"))
            man = flight.read_bundle(os.path.join(d, names[0]))["manifest"]
            suppressed = flight.FLIGHT.suppressed
        finally:
            flight.FLIGHT._reset_for_tests()
            from dat_replication_protocol_tpu_torch import obs

            obs.disable()  # arming turned the gate on
    if len(names) != 2 or not all(n.endswith("recovered") for n in names) \
            or suppressed != 1 \
            or man["checkpoint"]["wire_offset"] != len(sweep) \
            or man["checkpoint"]["digest"] != {"change_seq": SWEEP_ROWS,
                                               "blob_seq": 1}:
        raise AssertionError(f"phase 16c: bundles {names}, suppressed "
                             f"{suppressed}, manifest {man}")
    out["bundles"] = names
    out["checkpoint"] = man["checkpoint"]
    return out


def run_snapshot_chaos(device) -> dict:
    """16d (see the module docstring)."""
    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch.runtime.snapshot_driver import (
        SnapshotJoiner, SnapshotResponder, SnapshotSource)
    from dat_replication_protocol_tpu_torch.session import (
        BackoffPolicy, FaultPlan, FaultyReader, WireJournal, run_resumable)
    from dat_replication_protocol_tpu_torch.session.faults import (
        bytes_reader)
    from dat_replication_protocol_tpu_torch.wire import snapshot_codec as sn
    from dat_replication_protocol_tpu_torch.wire.framing import (
        CAP_SNAPSHOT, iter_frames)

    data = make_blob(FAN_SNAP_BYTES, seed=SEED + 161)[:CHAOS_BYTES].copy()
    t0 = time.perf_counter()
    src = SnapshotSource(data, device=device)
    materialize_s = time.perf_counter() - t0
    stale = data.copy()
    stale[src.offs[::max(1, len(src.offs) // 20)]] ^= 0x5A
    resp = SnapshotResponder(src)
    pilot = SnapshotJoiner(stale.tobytes(), device=device)
    e = protocol.encode(peer_caps=CAP_SNAPSHOT)
    journal = WireJournal()
    e.attach_journal(journal)
    pending = list(resp.begin_payloads())
    while pending and not pilot.done:
        replies = []
        for payload in pending:
            e.snapshot_frame(payload)
            replies.extend(pilot.handle(sn.decode_snapshot(payload)))
        pending = []
        for r in replies:
            pending.extend(resp.handle(sn.decode_snapshot(r)))
    e.finalize()
    while e.read(1 << 16) is not None:
        pass
    wanted = pilot.chunks_verified
    wire = journal.read_from(0)
    cut = next(p0 + (end - p0) // 2 for _s, _t, p0, end in iter_frames(wire)
               if wire[p0] == sn.SN_CHUNKS)

    joiner = SnapshotJoiner(stale.tobytes(), device=device)
    delivered = []
    dec = protocol.decode()

    def on_snapshot(msg, done):
        if msg.kind == sn.SN_CHUNKS:
            delivered.extend(bytes(d) for d, _c in msg.chunks)
        joiner.handle(msg)
        done()

    dec.snapshot(on_snapshot)

    def source(ckpt, failures):
        plan = (FaultPlan(truncate_at=cut - ckpt.wire_offset)
                if failures == 0 else FaultPlan())
        return FaultyReader(bytes_reader(wire[ckpt.wire_offset:]), plan)

    stats = run_resumable(source, dec,
                          BackoffPolicy(base=0.0005, cap=0.005,
                                        max_retries=4),
                          expected_total=len(wire))
    res = joiner.result()
    if stats["reconnects"] < 1 or not np.array_equal(
            np.frombuffer(res["data"], np.uint8), data) \
            or joiner.chunks_verified != wanted \
            or len(set(delivered)) != len(delivered):
        raise AssertionError(f"phase 16d: reconnects {stats['reconnects']}, "
                             f"chunks verified {joiner.chunks_verified} of "
                             f"{wanted}, {len(delivered)} delivered, "
                             f"{len(set(delivered))} distinct")
    return {"chunks": len(src.offs), "wanted": wanted, "cut": cut,
            "wire": len(wire), "reconnects": stats["reconnects"],
            "delivered": len(delivered), "materialize_s": materialize_s}


# ---------------------------------------------------------------------------
# phase 17: the event-driven edge and the asyncio transport
# ---------------------------------------------------------------------------

# 17a: bench.py config 15, uncut: N concurrent one-change sessions
# through one EdgeLoop, the client cohort in a subprocess
EDGE_COUNTS = (1, 100, 1000, 10000)
EDGE_FD_SLACK = 512  # fds a side beyond one a session
EDGE_CONNECT_CHUNK = 128  # a client's outstanding connects (the backlog)
EDGE_LIMIT_S = 300.0
# 17b: the mixed table
EDGE_HUB_SESSIONS = 16  # phase 15b's 8 MiB wire each
EDGE_GROUP_SUBS = 8  # accounting-only subscribers a broadcast group
EDGE_SNAP_BYTES = 64 * MIB
# 17c: the chaos arm
EDGE_CHAOS_HEALTHY = 16
EDGE_CHAOS_SEEDS = 8
# 17e: phase 13a's session over asyncio, then the faulted reader; a plan
# that re-segments into reads of 1 byte reads at least this many (one
# byte a read took ~17 s of asyncio over the 0.2 MB wire on the H100's
# host)
AIO_SEEDS = 8
AIO_MIN_SEGMENT = 16


def edge_wire() -> tuple:
    """Config 15's session wire (one change of a 64-byte value) and the
    ``hashlib`` digest its reply must carry."""
    import dat_replication_protocol_tpu_torch as protocol

    rec = {"key": "edge-bench", "change": 0, "from": 0, "to": 1,
           "value": b"v" * 64}
    e = protocol.encode()
    e.change(rec)
    e.finalize()
    return wire_of(e), blake(protocol.encode_change(rec))


def edge_client_main(n: int, port: int, wire_hex: str) -> int:
    """17a's client cohort: ``python3 chip_smoke.py --edge-client N PORT
    WIRE_HEX``, run by phase 17a in a subprocess (its own fds: N sessions
    are N fds on each side).  Connects N clients, sends each half the
    wire and parks; prints ``HELD k``, waits for ``GO`` on stdin, sends
    every second half, reads every reply to EOF and prints one JSON line
    (the distinct replies, hex, with their counts)."""
    import selectors
    import socket

    wire = bytes.fromhex(wire_hex)
    half = len(wire) // 2
    addr = ("127.0.0.1", port)
    sel = selectors.DefaultSelector()
    clients = []  # [sock, state, t_sent, latency, reply]
    t_ramp0 = time.perf_counter()
    started = held = failures = 0
    deadline = time.monotonic() + EDGE_LIMIT_S
    while held + failures < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"edge client ramp stuck at {held}/{n}")
        while started < n and started - held - failures < EDGE_CONNECT_CHUNK:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setblocking(False)
            s.connect_ex(addr)
            row = [s, "connecting", 0.0, 0.0, bytearray()]
            clients.append(row)
            sel.register(s, selectors.EVENT_WRITE, row)
            started += 1
        for skey, _mask in sel.select(0.05):
            row = skey.data
            s = row[0]
            err = s.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            sel.unregister(s)
            if err:
                s.close()
                row[1] = "failed"
                failures += 1
                continue
            s.sendall(wire[:half])
            row[1] = "held"
            held += 1
    ramp_s = time.perf_counter() - t_ramp0
    print(f"HELD {held}", flush=True)
    if sys.stdin.readline().strip() != "GO":
        raise RuntimeError("edge client: no GO")
    t0 = time.perf_counter()
    reading = 0
    for row in clients:
        if row[1] != "held":
            continue
        s = row[0]
        s.sendall(wire[half:])
        s.shutdown(socket.SHUT_WR)
        row[1] = "reading"
        row[2] = time.perf_counter()
        sel.register(s, selectors.EVENT_READ, row)
        reading += 1
    done = 0
    while done < reading:
        if time.monotonic() > deadline:
            raise TimeoutError(f"edge client finish stuck at {done}/{reading}")
        for skey, _mask in sel.select(0.05):
            row = skey.data
            s = row[0]
            try:
                data = s.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                data = b""
            if data:
                row[4] += data
                continue
            row[3] = time.perf_counter() - row[2]
            row[1] = "done"
            sel.unregister(s)
            s.close()
            done += 1
    finish_s = time.perf_counter() - t0
    sel.close()
    replies: dict = {}
    for row in clients:
        if row[1] == "done":
            key = bytes(row[4]).hex()
            replies[key] = replies.get(key, 0) + 1
    lats = sorted(row[3] for row in clients if row[1] == "done")
    p99 = lats[max(0, int(0.99 * (len(lats) - 1)))] if lats else 0.0
    print(json.dumps({"held": held, "failures": failures, "done": done,
                      "ramp_s": ramp_s, "finish_s": finish_s, "p99_s": p99,
                      "replies": replies}), flush=True)
    return 0


def decoded_changes(raw: bytes) -> list:
    """The changes of a reply, decoded by the port's host decoder (which
    must finish)."""
    import dat_replication_protocol_tpu_torch as protocol

    got = []
    dec = protocol.decode()
    dec.change(lambda c, done: (got.append(c), done()))
    dec.write(raw)
    dec.end()
    if not dec.finished:
        raise AssertionError("a reply did not decode to its end")
    return got


def session_records() -> list:
    """The ``sidecar.session`` records in the port's event ring."""
    from dat_replication_protocol_tpu_torch import obs

    return [e["fields"] for e in obs.EVENTS.events("sidecar.session")]


def serve_loop(loop):
    """``loop.serve()`` on a thread of this process."""
    import threading

    port = loop.bind("127.0.0.1", 0)
    t = threading.Thread(target=loop.serve, daemon=True)
    t.start()
    return port, t


def run_edge_scaling(device) -> dict:
    """17a (see the module docstring): with the obs gate on, as config 15
    runs it (the loop's profiler lit)."""
    import resource
    import subprocess

    from dat_replication_protocol_tpu_torch import obs
    from dat_replication_protocol_tpu_torch.edge import EdgeLoop
    from dat_replication_protocol_tpu_torch.hub import ReplicationHub

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = max(EDGE_COUNTS) + EDGE_FD_SLACK
    if soft < want:
        cap = want if hard == resource.RLIM_INFINITY else min(want, hard)
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (cap, hard))
        except (ValueError, OSError):
            pass
        soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    counts = [n for n in EDGE_COUNTS if n + EDGE_FD_SLACK <= soft]
    out = {"fd_soft": soft, "fd_hard": hard,
           "dropped": [n for n in EDGE_COUNTS if n not in counts],
           "arms": {}}
    wire, digest = edge_wire()
    qos_of = lambda n, peer, mode: \
        "latency" if n % 2 else "throughput"  # noqa: E731
    obs.enable()
    try:
        for n in counts:
            obs_reset()
            b1_before = read_counters()["blake2b"]
            hub = ReplicationHub(device=device, max_sessions=n + 8,
                                 linger_s=0.002)
            loop = EdgeLoop(hub, qos_of=qos_of, max_sessions=n, tick=0.02,
                            drain_timeout=60.0, name=f"edge17a-{n}")
            port, server = serve_loop(loop)
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--edge-client",
                 str(n), str(port), wire.hex()],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
            try:
                line = proc.stdout.readline().strip()
                if not line.startswith("HELD "):
                    raise AssertionError(f"17a: the client cohort died in "
                                         f"its ramp: {line!r}")
                held = int(line.split()[1])
                deadline = time.monotonic() + 120
                peak = loop.snapshot()["sessions"]
                while peak < held and time.monotonic() < deadline:
                    time.sleep(0.01)
                    peak = max(peak, loop.snapshot()["sessions"])
                proc.stdin.write("GO\n")
                proc.stdin.flush()
                res = json.loads(proc.stdout.readline())
                proc.wait(60)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(10)
                loop.close()
            server.join(60)
            snap = loop.snapshot()
            hub.close()
            if server.is_alive():
                raise AssertionError(f"17a: the loop of {n} did not stop")
            if not (held == peak == res["done"] == snap["admitted"] == n):
                raise AssertionError(f"17a at {n}: held {held}, peak {peak},"
                                     f" done {res['done']}, admitted "
                                     f"{snap['admitted']}")
            if snap["rejected"] or snap["shed"]:
                raise AssertionError(f"17a at {n}: rejected "
                                     f"{snap['rejected']}, shed "
                                     f"{snap['shed']}")
            if sum(res["replies"].values()) != n:
                raise AssertionError(f"17a at {n}: {res['replies']} replies")
            for raw in res["replies"]:
                ch = decoded_changes(bytes.fromhex(raw))
                if len(ch) != 1 or bytes(ch[0].value) != digest:
                    raise AssertionError(f"17a at {n}: a reply is not the "
                                         f"change's hashlib digest")
            prof = snap["loop"]
            out["arms"][n] = {
                "sessions_s": n / res["finish_s"], "p99_s": res["p99_s"],
                "ramp_s": res["ramp_s"], "finish_s": res["finish_s"],
                "peak": peak, "admitted": snap["admitted"],
                "rejected": snap["rejected"], "shed": snap["shed"],
                "loop_lag_max_s": prof["lag_max_s"],
                "p99_turn_s": prof["p99_work_s"], "turns": prof["turns"],
                "distinct_replies": len(res["replies"]),
                "b1": read_counters()["blake2b"] - b1_before}
    finally:
        obs.disable()
        obs_reset()
    return out


def read_hashed(sock) -> tuple:
    """Read ``sock`` to EOF: its length and BLAKE2b-256."""
    h = hashlib.blake2b(digest_size=32)
    n = 0
    while chunk := sock.recv(1 << 20):
        h.update(chunk)
        n += len(chunk)
    return n, h.digest()


def hub_record(wire: bytes, want: list, session: str) -> dict:
    """The record a digest session of ``wire`` owes (``run_session``'s)."""
    kinds = [k for k, _s, _d in want]
    return {"changes": kinds.count("change"), "blobs": kinds.count("blob"),
            "bytes": len(wire), "digests": len(want), "ok": True,
            "session": session, "shed": None}


def run_edge_mixed(device, ae: dict) -> dict:
    """17b (see the module docstring).  ``ae`` is phase 14a's replica
    pair, its rows and ``reconcile_local``'s metering.  Reads the launch
    counters itself once the edge's sessions end, before the threaded
    legs it holds the records against."""
    import socket
    import threading

    from dat_replication_protocol_tpu_torch import obs, sidecar
    from dat_replication_protocol_tpu_torch.edge import EdgeLoop
    from dat_replication_protocol_tpu_torch.fanout import FanoutServer
    from dat_replication_protocol_tpu_torch.hub import ReplicationHub
    from dat_replication_protocol_tpu_torch.runtime.reconcile_driver import (
        run_initiator)
    from dat_replication_protocol_tpu_torch.runtime.snapshot_driver import (
        SnapshotSource, run_snapshot_joiner)

    out = {}
    data = make_blob(EDGE_SNAP_BYTES, seed=SEED + 170)
    t0 = time.perf_counter()
    source = SnapshotSource(data, device=device)  # B6 and B1
    out["materialize_s"] = time.perf_counter() - t0
    hub_wires = [hub_client_wire(200 + i) for i in range(EDGE_HUB_SESSIONS)]
    hub_want = [wire_digests(w) for w in hub_wires]
    fan_wires = {"a": fanout_wire("a"), "b": fanout_wire("b")}
    fan_want = {g: wire_digests(w) for g, w in fan_wires.items()}
    # the connection schedule: n -> (mode, group)
    plan = {}
    n = 0
    for _ in range(EDGE_HUB_SESSIONS):
        n += 1
        plan[n] = ("hub", None)
    for g in ("a", "b"):
        n += 1
        plan[n] = ("fanout", g)  # the group's source claims first
    for g in ("a", "b"):
        for _ in range(EDGE_GROUP_SUBS):
            n += 1
            plan[n] = ("fanout", g)
    plan[n + 1] = ("reconcile", None)
    plan[n + 2] = ("snapshot", None)
    fans = {"a": FanoutServer(), "b": FanoutServer()}
    hub = ReplicationHub(device=device)
    loop = EdgeLoop(hub, fanouts=fans, reconcile_replica=ae["rep_b"],
                    snapshot_source=source,
                    mode_of=lambda i, peer: plan[i][0],
                    group_of=lambda i, peer: plan[i][1],
                    drain_timeout=120.0, max_sessions=len(plan),
                    name="edge17b")
    obs.enable()
    obs_reset()
    results: dict = {}
    errors: list = []
    socks: dict = {}
    try:
        port, server = serve_loop(loop)
        socks = {}
        for i in sorted(plan):
            socks[i] = _connect(port)
            deadline = time.monotonic() + 60
            while loop.snapshot()["served"] < i:
                if time.monotonic() > deadline:
                    raise AssertionError(f"17b: connection {i} not served")
                time.sleep(0.002)
        table = list(loop._table.values())
        if any(os.get_blocking(s.fd) for s in table):
            raise AssertionError("17b: a blocking fd in the session table")
        out["table"] = loop.snapshot()["by_kind"]

        def guard(fn, *args):
            def run():
                try:
                    fn(*args)
                except BaseException as e:  # noqa: BLE001 — reported
                    errors.append(f"{fn.__name__}{args[:1]}: "
                                  f"{type(e).__name__}: {e}")
            return threading.Thread(target=run, daemon=True)

        def digest_client(i: int, wire: bytes) -> None:
            sock = socks[i]
            sender = threading.Thread(target=lambda: (
                sock.sendall(wire), sock.shutdown(socket.SHUT_WR)),
                daemon=True)
            sender.start()
            results[i] = read_to_eof(sock)
            sender.join(120)

        def subscriber(i: int) -> None:
            results[i] = read_hashed(socks[i])

        def reconcile(i: int) -> None:
            sock = socks[i]
            rd, wr, seen = counted_io(sock)
            res = run_initiator(ae["rep_a"], rd, wr, close_write=lambda:
                                sock.shutdown(socket.SHUT_WR))
            results[i] = (res, seen)

        def joiner(i: int) -> None:
            sock = socks[i]
            results[i] = run_snapshot_joiner(
                sock.recv, sock.sendall,
                close_write=lambda: sock.shutdown(socket.SHUT_WR),
                device=device)

        threads = []
        srcs = {}
        for i, (mode, g) in sorted(plan.items()):
            if mode == "hub":
                threads.append(guard(digest_client, i, hub_wires[i - 1]))
            elif mode == "fanout" and g not in srcs:
                srcs[g] = i
                threads.append(guard(digest_client, i, fan_wires[g]))
            elif mode == "fanout":
                threads.append(guard(subscriber, i))
            elif mode == "reconcile":
                threads.append(guard(reconcile, i))
            else:
                threads.append(guard(joiner, i))
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        out["seconds"] = time.perf_counter() - t0
        server.join(120)  # the loop ends once its table drains
        if server.is_alive():
            raise AssertionError(f"17b: sessions left {loop.snapshot()}")
        out["launches"] = read_counters()
        records = session_records()
    finally:
        loop.close()
        obs.disable()
        for f in fans.values():
            f.close()
        for s in socks.values():
            s.close()
    if errors:
        raise AssertionError(f"17b: {errors[:3]}")
    # the hub legs and the sources: every digest against hashlib, in order
    for i, (mode, g) in plan.items():
        if mode == "hub" or (mode == "fanout" and srcs[g] == i):
            want = hub_want[i - 1] if mode == "hub" else fan_want[g]
            check_replies({"errors": [], "replies": [results[i]]}, [want],
                          f"17b, connection {i}")
        elif mode == "fanout":
            wire = fan_wires[g]
            if results[i] != (len(wire), blake(wire)):
                raise AssertionError(f"17b: subscriber {i} of group {g} "
                                     f"read {results[i][0]} B, not the wire")
    res, seen = results[n + 1]
    got = sorted(delivered(c) for c in res["received"])
    shipped = sorted(batch_rows(bytes(seen["tx"])))
    local = ae["local"]
    wire = {"a2b": len(seen["tx"]), "b2a": len(seen["rx"])}
    if got != sorted(ae["b_rows"]) or shipped != sorted(ae["a_rows"]) \
            or wire != {"a2b": local["wire_a2b"],
                        "b2a": local["wire_b2a"]}:
        raise AssertionError(f"17b: the reconcile leg received {len(got)} "
                             f"and shipped {len(shipped)} records over "
                             f"{wire}")
    snap = results[n + 2]
    if not snap["ok"] or not np.array_equal(
            np.frombuffer(snap["data"], np.uint8), data):
        raise AssertionError("17b: the cold joiner's dataset differs")
    out["reconcile"] = {"symbols": res["symbols"], "rounds": res["rounds"],
                        "wire": wire}
    # the records, against what the threaded legs record for the same work
    by_key = {}
    for rec in records:
        key = rec.get("session") or rec.get("fanout_peer") or (
            "reconcile" if rec.get("reconcile") else "snapshot")
        by_key[key.split(":")[0]] = rec
    if len(by_key) != len(plan):
        raise AssertionError(f"17b: {len(records)} session records for "
                             f"{len(plan)} connections")
    for i, (mode, g) in plan.items():
        if mode == "hub" or (mode == "fanout" and srcs[g] == i):
            rec = by_key[f"c{i}"]
            wire = hub_wires[i - 1] if mode == "hub" else fan_wires[g]
            want = hub_want[i - 1] if mode == "hub" else fan_want[g]
            if rec != hub_record(wire, want, rec["session"]):
                raise AssertionError(f"17b: the record of {i}: {rec}")
        elif mode == "fanout":
            rec = by_key[f"p{i}"]
            if rec != {"fanout_peer": rec["fanout_peer"],
                       "sent_bytes": len(fan_wires[g]), "shed": None,
                       "ok": True}:
                raise AssertionError(f"17b: the record of {i}: {rec}")
    if by_key["reconcile"] != ae["record"]:
        raise AssertionError(f"17b: the reconcile record "
                             f"{by_key['reconcile']}, the threaded sidecar's "
                             f"in 14a {ae['record']}")
    # the threaded legs on the same inputs (not counted: after the read)
    a, b = socket.socketpair()
    try:
        threaded = {}
        t = threading.Thread(target=lambda: threaded.setdefault(
            "snapshot", sidecar.run_snapshot_session(
                a.recv, a.sendall, lambda: a.shutdown(socket.SHUT_WR),
                source, peer="threaded")), daemon=True)
        t.start()
        res = run_snapshot_joiner(b.recv, b.sendall,
                                  close_write=lambda: b.shutdown(
                                      socket.SHUT_WR), device=device)
        t.join(120)
    finally:
        a.close()
        b.close()
    if not res["ok"] or by_key["snapshot"] != threaded["snapshot"]:
        raise AssertionError(f"17b: the snapshot record {by_key['snapshot']}"
                             f", the threaded leg's {threaded['snapshot']}")
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=lambda: threaded.setdefault(
            "hub", sidecar.run_session(
                a.recv, a.sendall, lambda: a.shutdown(socket.SHUT_WR),
                hub=hub, session_key="c1:threaded")), daemon=True)
        t.start()
        sender = threading.Thread(target=lambda: (
            b.sendall(hub_wires[0]), b.shutdown(socket.SHUT_WR)),
            daemon=True)
        sender.start()
        read_to_eof(b)
        sender.join(120)
        t.join(120)
    finally:
        a.close()
        b.close()
        hub.close()
    edge_rec = dict(by_key["c1"], session="c1:threaded")
    if edge_rec != threaded["hub"]:
        raise AssertionError(f"17b: the hub record {by_key['c1']}, the "
                             f"threaded leg's {threaded['hub']}")
    out["records"] = len(records)
    out["snapshot_record"] = by_key["snapshot"]
    out["wire_bytes"] = (sum(map(len, hub_wires))
                         + sum(map(len, fan_wires.values())))
    return out


def chaos_wire() -> tuple:
    """``SESSION_4``'s shape (the tests' fixture): an 11-byte blob, then
    one change; its digests by ``hashlib``."""
    import dat_replication_protocol_tpu_torch as protocol

    e = protocol.encode()
    e.blob(11).end(b"hello world")
    e.change({"key": "key", "change": 1, "from": 0, "to": 1,
              "value": b"hello"})
    e.finalize()
    wire = wire_of(e)
    return wire, wire_digests(wire)


def faulty_client(port: int, wire: bytes, scenario: str) -> None:
    """One connection misbehaving as ``scenario`` says (the tests'
    ``stall`` / ``truncate`` / ``flip``)."""
    import socket

    sock = _connect(port)
    half = len(wire) // 2
    if scenario == "flip":
        bad = bytearray(wire)
        bad[half] ^= 0x40
        sock.sendall(bytes(bad))
        sock.shutdown(socket.SHUT_WR)
        read_to_eof(sock)
    elif scenario == "truncate":
        sock.sendall(wire[:half])
        sock.shutdown(socket.SHUT_WR)
        read_to_eof(sock)
    else:  # stall: park mid-wire, then go without a clean shutdown
        sock.sendall(wire[:half])
        time.sleep(0.3)
    sock.close()


def run_edge_chaos(device) -> dict:
    """17c (see the module docstring)."""
    import socket
    import threading

    from dat_replication_protocol_tpu_torch import obs
    from dat_replication_protocol_tpu_torch.edge import EdgeLoop
    from dat_replication_protocol_tpu_torch.hub import ReplicationHub
    from dat_replication_protocol_tpu_torch.session.faults import FaultPlan

    wire, want = chaos_wire()
    n = EDGE_CHAOS_HEALTHY + 1
    hub = ReplicationHub(device=device, linger_s=0.002)
    qos_of = lambda i, peer, mode: \
        "latency" if i % 2 else "throughput"  # noqa: E731
    out = {"arms": {}}
    obs.enable()
    try:
        for seed in [None, *range(EDGE_CHAOS_SEEDS)]:
            obs_reset()
            faulty = (None if seed is None
                      else FaultPlan.faulty_session(seed, n))
            scenario = (None if seed is None
                        else FaultPlan.session_scenario(seed, n))
            loop = EdgeLoop(hub, qos_of=qos_of, max_sessions=n,
                            drain_timeout=2.0, tick=0.02,
                            name=f"edge17c-{seed}")
            port, server = serve_loop(loop)
            times: dict = {}
            replies: dict = {}

            def healthy(i: int) -> None:
                t0 = time.perf_counter()
                sock = _connect(port)
                sock.sendall(wire)
                sock.shutdown(socket.SHUT_WR)
                replies[i] = read_to_eof(sock)
                times[i] = time.perf_counter() - t0
                sock.close()

            threads = []
            for i in range(n):
                target = ((lambda: faulty_client(port, wire, scenario))
                          if i == faulty else (lambda i=i: healthy(i)))
                threads.append(threading.Thread(target=target, daemon=True))
                threads[-1].start()
                time.sleep(0.002)  # the admission order is the start order
            for t in threads:
                t.join(60)
            server.join(60)
            if server.is_alive() or any(t.is_alive() for t in threads):
                raise AssertionError(f"17c seed {seed}: a hang")
            check_replies({"errors": [], "replies": [replies[i] for i in
                                                     sorted(replies)]},
                          [want] * len(replies), f"17c seed {seed}")
            recs = session_records()
            bad = [r for r in recs if not r["ok"]]
            if len(recs) != n or len(bad) != (0 if seed is None else 1):
                raise AssertionError(f"17c seed {seed} ({scenario}): records"
                                     f" {recs}")
            lats = sorted(times.values())
            out["arms"][seed] = {
                "scenario": scenario,
                "p99_ms": 1e3 * lats[max(0, int(0.99 * (len(lats) - 1)))],
                "healthy": len(lats)}
    finally:
        obs.disable()
        obs_reset()
        hub.close()
    return out


def healthz(url: str) -> tuple:
    """``GET url/healthz``: the status and the JSON body (503 included)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def run_edge_sidecar(device) -> dict:
    """17d (see the module docstring)."""
    import signal
    import threading

    out = {}
    stats = StatsReader()
    side = Sidecar(["--tcp", "127.0.0.1:0", "--edge", "--device", device,
                    "--stats-fd", str(stats.w), "--stats-interval",
                    str(HUB_STATS_S), "--obs-http", "0"],
                   pass_fds=(stats.w,))
    side.sample_rss()
    stats.start()
    try:
        url = side.wait_for("obs endpoint on", 5).split(" on ", 1)[1]
        wires = [hub_client_wire(300 + i) for i in range(EDGE_HUB_SESSIONS)]
        want = [wire_digests(w) for w in wires]
        # timed: all clients at once, as 15b's arms
        res = hub_clients(side.port, wires)
        check_replies(res, want, "17d, timed")
        out["seconds"] = res["seconds"]
        # held halfway: the table, its stats and /healthz at 16 sessions
        hold = threading.Event()
        held = hub_clients(side.port, wires, hold=hold)
        rec = stats.wait_for(lambda r: r.get("edge", {}).get("sessions")
                             == len(wires), 120)
        edge = rec["edge"]
        if edge["by_kind"] != {"hub": len(wires)} \
                or edge["by_class"] != {"throughput": len(wires)}:
            raise AssertionError(f"17d: the edge section {edge}")
        # the loop is still digesting the first halves when the table
        # fills: its lag may read "behind" (503) until it catches up
        deadline = time.monotonic() + 60
        out["healthz_503"] = []
        while True:
            status, hz = healthz(url)
            lag = hz["stages"].get("loop_lag")
            if status == 200 or time.monotonic() > deadline:
                break
            out["healthz_503"].append(
                {k: v for k, v in hz["stages"].items() if not v["ok"]})
            time.sleep(0.1)
        if status != 200 or lag is None or not lag["ok"] \
                or list(lag["lag_s"]) != [edge["loop"]["name"]]:
            raise AssertionError(f"17d: /healthz {status} {hz['stages']}")
        out["healthz"] = {"status": status, "loop_lag": lag}
        first = len(stats.records)
        hold.set()
        for t in held["threads"]:
            t.join(600)
        check_replies(held, want, "17d, held")
        stats.wait_for(lambda r: r.get("edge", {}).get("sessions") == 0, 60,
                       after=len(stats.records))
        live = set(held["ports"]) | set(res["ports"])
        out["named"] = check_stats_lines(stats.records, live, "17d")
        for r in stats.records:
            e = r.get("edge")
            if e is None:
                continue  # a record from before the loop was installed
            if sum(e["by_kind"].values()) != e["sessions"] or \
                    e["sessions"] > len(wires):
                raise AssertionError(f"17d: an edge section {e}")
        out["records_after_release"] = len(stats.records) - first
    finally:
        side.close(signal.SIGINT)
        stats.close()
    if stats.errors:
        raise AssertionError(f"17d: stats lines {stats.errors[:3]}")
    out["peak_rss_kib"] = side.peak_rss_kib
    final = stats.records[-1]
    out["launches"] = sentinel_launches(final)
    # the record at shutdown comes after the loop left the stats
    out["edge"] = next(r["edge"] for r in reversed(stats.records)
                       if "edge" in r)
    items = final["metrics"]["counters"].get("hub.dispatch.items")
    if out["launches"]["blake2b"] == 0 or items != 2 * sum(map(len, want)):
        raise AssertionError(f"17d: B1 {out['launches']}, items {items}")
    out["bytes"] = sum(map(len, wires))
    out["records"] = len(stats.records)

    # the rejected arm: two clients hold the hub's two slots halfway
    stats = StatsReader()
    side = Sidecar(["--tcp", "127.0.0.1:0", "--edge", "--device", device,
                    "--hub-max-sessions", "2", "--stats-fd", str(stats.w),
                    "--stats-interval", str(HUB_STATS_S)],
                   pass_fds=(stats.w,))
    stats.start()
    try:
        wires = [hub_client_wire(400 + i) for i in range(2)]
        hold = threading.Event()
        held = hub_clients(side.port, wires, hold=hold)
        stats.wait_for(lambda r: r.get("edge", {}).get("sessions") == 2, 60)
        sock = _connect(side.port)  # the surplus client
        eof = sock.recv(1 << 16)
        sock.close()
        line = side.wait_for("'rejected': True", 30)
        hold.set()
        for t in held["threads"]:
            t.join(600)
        check_replies(held, [wire_digests(w) for w in wires],
                      "17d, the held clients")
        if eof != b"":
            raise AssertionError(f"17d: the surplus client read {len(eof)} "
                                 f"B, not EOF")
        rec = stats.wait_for(lambda r: r.get("edge", {}).get("sessions")
                             == 0, 60, after=len(stats.records))
    finally:
        side.close(signal.SIGINT)
        stats.close()
    out["rejected"] = {"record": session_record(line),
                       "edge": {k: rec["edge"][k] for k in (
                           "served", "admitted", "rejected")}}
    if out["rejected"]["edge"] != {"served": 3, "admitted": 2,
                                   "rejected": 1}:
        raise AssertionError(f"17d: {out['rejected']}")
    return out


def run_aio(device, pipe_s: float, n_blobs=P13_BLOBS, blob_bytes=BLOB_BYTES,
            changes_per_blob=CHANGES_PER_BLOB) -> dict:
    """17e (see the module docstring): ``pipe_s`` is phase 13a's median
    gate-off seconds of the same session through ``pipe``."""
    import asyncio
    import dataclasses
    import socket

    import dat_replication_protocol_tpu_torch as protocol
    from dat_replication_protocol_tpu_torch.session.aio import (
        recv_over_async, session_over_asyncio)
    from dat_replication_protocol_tpu_torch.session.faults import (
        AsyncFaultyReader, FaultPlan)

    blobs, changes = make_session(n_blobs, blob_bytes, changes_per_blob)
    enc = protocol.encode()
    dec = protocol.decode(backend="cuda", device=device)
    got = []
    at_finalize = []
    dec.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))
    dec.change(lambda c, done: done())
    dec.finalize(lambda done: (at_finalize.append(len(got)), done()))

    async def feed() -> None:
        for b in range(n_blobs):
            for c in changes[b * changes_per_blob:(b + 1) * changes_per_blob]:
                enc.change(c)
            enc.blob(blob_bytes).end(blobs[b * blob_bytes:
                                           (b + 1) * blob_bytes])
            await asyncio.sleep(0)  # the pumps run between blobs
        enc.finalize()

    async def session() -> None:
        await asyncio.wait_for(asyncio.gather(
            feed(), session_over_asyncio(enc, dec)), 600)

    t0 = time.perf_counter()
    asyncio.run(session())
    sync(device)
    seconds = time.perf_counter() - t0
    total = len(changes) + n_blobs
    if not dec.finished or at_finalize != [total]:
        raise AssertionError(f"17e: finished {dec.finished}, digests before "
                             f"finalize {at_finalize} of {total}")
    want = ([("change", i, blake(protocol.encode_change(c)))
             for i, c in enumerate(changes)]
            + [("blob", b, blake(blobs[b * blob_bytes:(b + 1) * blob_bytes]))
               for b in range(n_blobs)])
    if [g for g in got if g[0] == "change"] != want[:len(changes)] or \
            [g for g in got if g[0] == "blob"] != want[len(changes):]:
        raise AssertionError("17e: the digests are not hashlib's in submit "
                             "order")
    out = {"seconds": seconds, "bytes": dec.bytes,
           "gib_s": dec.bytes / seconds / (1 << 30),
           "pipe_gib_s": dec.bytes / pipe_s / (1 << 30),
           "dispatches": dec.digest_pipeline.dispatches}

    # the faulted reader: every seed's plan, its faults that end a
    # session taken out, re-segments and delays the same wire
    wire = resume_wire(SWEEP_ROWS, blob=64 << 10)
    clean = wire_digests(wire)
    out["seeds"] = {}

    async def faulted(plan, dec) -> None:
        a, b = socket.socketpair()
        a.setblocking(False)
        b.setblocking(False)
        _, writer = await asyncio.open_connection(sock=a)
        reader, writer_b = await asyncio.open_connection(sock=b)
        try:
            writer.write(wire)
            writer.write_eof()
            await asyncio.wait_for(
                recv_over_async(dec, AsyncFaultyReader(reader, plan)), 120)
        finally:
            for w in (writer, writer_b):
                w.transport.abort()
            a.close()
            b.close()

    for seed in range(AIO_SEEDS):
        plan = FaultPlan.for_sweep(seed, len(wire), attempt=0)
        seg = plan.max_segment
        plan = dataclasses.replace(
            plan, drop_at=None, truncate_at=None, flip_at=None,
            max_segment=None if seg is None else max(seg, AIO_MIN_SEGMENT))
        dec = protocol.decode(backend="cuda", device=device)
        got = []
        dec.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))
        dec.change(lambda c, done: done())
        t0 = time.perf_counter()
        asyncio.run(faulted(plan, dec))
        if not dec.finished or got != clean:
            raise AssertionError(f"17e seed {seed}: {len(got)} digests, not "
                                 f"the clean {len(clean)}")
        out["seeds"][seed] = {"seconds": time.perf_counter() - t0,
                              "max_segment": (seg, plan.max_segment),
                              "stall_s": plan.stall_s}
    return out


# ---------------------------------------------------------------------------
# phase 18: the gossip mesh
# ---------------------------------------------------------------------------

# 18a: bench.py config 14, uncut: N in {4, 16, 64}, 192 base + 24 own
# records a replica, clean links, the fixed seed, the plane lit
CLUSTER_NS = (4, 16, 64)
CLUSTER_SEED = 20_240
CLUSTER_RECORDS = 192
CLUSTER_DIVERGENCE = 24
# 18b: four --replica sidecars; configs[4]'s 1M records a replica cut to
# 262,144 shared for the time limit, 1,024 own records each
MESH_REPLICAS = 4
MESH_SHARED = 262_144
MESH_OWN = 1_024
MESH_INTERVAL_S = 0.2
MESH_STATS_S = 0.5
MESH_LIMIT_S = 240.0
# 19: 18a's N = 16 run is logged to a JSONL sink for meshdoctor; 18b's
# sidecars log to build/phase19/ and the fleet gate reads its samples there
MESH_SINK_N = 16
P19_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "phase19")
# 18c: test_cluster_faults.py's scenarios, seeds 0-7
CLUSTER_CHAOS_SEEDS = 8
CLUSTER_BYZ_ARMS = ("wrong-symbol", "wrong-chunk", "feed-corrupt")


def content_oracle(digests) -> str:
    """The replica content digest's definition, in ``hashlib``: BLAKE2b-256
    over the unique 32-byte record digests, sorted by their four
    little-endian 64-bit words (the first word first)."""
    uniq = {bytes(d) for d in digests}
    order = sorted(uniq, key=lambda d: tuple(
        int.from_bytes(d[i:i + 8], "little") for i in (0, 8, 16, 24)))
    return hashlib.blake2b(b"".join(order), digest_size=32).hexdigest()


def wire_oracle(wire: bytes) -> str:
    """``content_oracle`` of every canonical record of a change-log wire,
    each record hashed by ``hashlib``."""
    from dat_replication_protocol_tpu_torch.runtime import replay

    cols, _ = replay.replay_log(np.frombuffer(wire, np.uint8))
    return content_oracle(blake(p)
                          for p in replay.canonical_change_payloads(cols))


def cost_totals(board_snapshot: dict) -> dict:
    """The goodput and overhead ratios bench.py prints: payload and
    framing bytes over the ledger bytes of every link of a wire cost
    snapshot."""
    payload = framing = total = 0
    for rec in board_snapshot["links"].values():
        payload += rec["payload_bytes"]
        framing += rec["framing_bytes"]
        total += rec["ledger_bytes"]
    return {"goodput": payload / total if total else None,
            "overhead": framing / total if total else None}


def run_cluster_converge(device, sink_path=None) -> dict:
    """18a (see the module docstring); the N = ``MESH_SINK_N`` run's
    events and spans also go to the JSONL file ``sink_path``."""
    from dat_replication_protocol_tpu_torch.cluster import ClusterSim
    from dat_replication_protocol_tpu_torch.obs import metrics as obs_metrics
    from dat_replication_protocol_tpu_torch.obs import tracing
    from dat_replication_protocol_tpu_torch.obs.propagation import (
        PROPAGATION)
    from dat_replication_protocol_tpu_torch.obs.wirecost import WIRECOST

    out = {}
    was_on = obs_metrics.OBS.on
    obs_metrics.enable()
    try:
        for n in CLUSTER_NS:
            PROPAGATION.reset_for_tests()
            WIRECOST.reset_for_tests()
            sink = (tracing.attach_jsonl_sink(sink_path)
                    if sink_path and n == MESH_SINK_N else None)
            b1 = read_counters()["blake2b"]
            t0 = time.perf_counter()
            sim = ClusterSim(n, seed=CLUSTER_SEED, chaos=False,
                             records_per=CLUSTER_RECORDS,
                             divergence=CLUSTER_DIVERGENCE, device=device)
            build_s = time.perf_counter() - t0
            want = wire_oracle(b"".join(nd.canonical_wire()
                                        for nd in sim.nodes.values()))
            if sim.expected_digest.hex() != want:
                raise AssertionError(f"18a n={n}: the expected digest is not "
                                     "the hashlib oracle's")
            t0 = time.perf_counter()
            try:
                res = sim.run()
            finally:
                if sink is not None:
                    tracing.EVENTS.detach_sink()
                    tracing.SPANS.detach_sink()
                    sink.close()
            seconds = time.perf_counter() - t0
            if not res["converged"] or res["rounds"] > sim.rounds_bound():
                raise AssertionError(f"18a n={n}: {res['rounds']} rounds of "
                                     f"{sim.rounds_bound()}, converged "
                                     f"{res['converged']}")
            got = {nd.content_digest().hex() for nd in sim.nodes.values()}
            if got != {want}:
                raise AssertionError(f"18a n={n}: replica digests {got} are "
                                     "not the hashlib oracle's")
            cost = cost_totals(WIRECOST.snapshot())
            out[n] = {"rounds": res["rounds"], "bound": sim.rounds_bound(),
                      "seconds": seconds, "build_s": build_s,
                      "wire_bytes": sim.wire_bytes,
                      "divergence_bytes": sim.divergence_bytes,
                      "wire_x": sim.wire_bytes / sim.divergence_bytes,
                      "exchange_p99_s": PROPAGATION.exchange_p99(),
                      "goodput": cost["goodput"],
                      "overhead": cost["overhead"],
                      "records": sim.nodes["r0"].record_count,
                      "b1": read_counters()["blake2b"] - b1}
    finally:
        PROPAGATION.reset_for_tests()
        WIRECOST.reset_for_tests()
        obs_metrics.OBS.on = was_on
        obs_reset()
    return out


def _free_ports(n: int) -> list:
    import socket

    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def mesh_logs(seed: int = SEED + 180) -> tuple:
    """18b's four change logs in phase 14a's record shape (a subset absent
    on every third row): the shared base and each replica's own records,
    and the ``hashlib`` oracle of the union in the delivered form the
    live replicas hold (absent optionals as ''/b'')."""
    from dat_replication_protocol_tpu_torch.runtime import replay

    rng = np.random.default_rng(seed)
    shared = ae_records(0, MESH_SHARED, rng)
    owns = [ae_records(MESH_SHARED + i * MESH_OWN,
                       MESH_SHARED + (i + 1) * MESH_OWN, rng)
            for i in range(MESH_REPLICAS)]
    w_shared = replay.encode_change_log(shared)
    logs = [w_shared + replay.encode_change_log(own) for own in owns]
    union = shared + [r for own in owns for r in own]
    as_delivered = [dict(r, value=r["value"] or b"", subset=r["subset"] or "")
                    for r in union]
    return logs, content_oracle(canonical_digests(as_delivered)), len(union)


def run_live_mesh(device, fleet_dir: str) -> dict:
    """18b (see the module docstring); each sidecar also serves
    ``--obs-http`` and logs its events and spans to
    ``fleet_dir/rI.jsonl``, and once the mesh has settled
    :func:`fleet_samples` records one sample of each for phase 19."""
    import signal
    import tempfile
    import threading

    t0 = time.perf_counter()
    logs, want, n_union = mesh_logs()
    out = {"make_s": time.perf_counter() - t0, "union": n_union,
           "digest": want}
    ports = _free_ports(MESH_REPLICAS)
    stats = [StatsReader() for _ in range(MESH_REPLICAS)]
    sides: list = [None] * MESH_REPLICAS
    listening: list = [None] * MESH_REPLICAS
    errors: list = []
    with tempfile.TemporaryDirectory() as tmp:
        def start(i: int) -> None:
            path = os.path.join(tmp, f"r{i}.log")
            with open(path, "wb") as f:
                f.write(logs[i])
            peers = ",".join(f"127.0.0.1:{p}" for j, p in enumerate(ports)
                             if j != i)
            args = ["--tcp", f"127.0.0.1:{ports[i]}", "--replica", path,
                    "--replica-key", f"r{i}", "--gossip-peers", peers,
                    "--gossip-interval", str(MESH_INTERVAL_S),
                    "--device", str(device), "--stats-fd", str(stats[i].w),
                    "--stats-interval", str(MESH_STATS_S), "--obs-http", "0",
                    "--trace-jsonl", os.path.join(fleet_dir, f"r{i}.jsonl")]
            if i == 0:
                args.append("--edge")  # replica_machine serves its inbound
            try:
                sides[i] = Sidecar(args, pass_fds=(stats[i].w,))
                listening[i] = time.time()
            except Exception as e:  # reported after every start is joined
                errors.append(e)

        t0 = time.perf_counter()
        starters = [threading.Thread(target=start, args=(i,))
                    for i in range(MESH_REPLICAS)]
        for t in starters:
            t.start()
        for t in starters:
            t.join()
        out["start_s"] = time.perf_counter() - t0
        try:
            for s in stats:
                s.start()
            if errors:
                raise errors[0]
            last_listen = max(listening)

            def converged(rec) -> bool:
                g = rec.get("gossip")
                return bool(g) and g["digest"] == want \
                    and g["records"] == n_union

            firsts = [s.wait_for(converged, MESH_LIMIT_S) for s in stats]
            t_conv = max(r["ts"] for r in firsts)
            out["converge_s"] = t_conv - last_listen

            def next_round(after_ts: float) -> list:
                """Each sidecar's first record at or after ``after_ts``,
                then its first record whose driver completed one more
                exchange than that one."""
                marks = [s.wait_for(lambda r: r["ts"] >= after_ts
                                    and "gossip" in r, 60) for s in stats]
                return [s.wait_for(
                    lambda r, m=m: r["ts"] >= m["ts"] and "gossip" in r
                    and r["gossip"]["exchanges_ok"]
                    > m["gossip"]["exchanges_ok"], 60) for s, m in
                    zip(stats, marks)]

            # an exchange in flight when the last replica converged may
            # still apply records the node holds already (duplicates are
            # harmless); once every driver completed one more exchange,
            # those have ended, and a further round of each driver must
            # apply and ship nothing
            settled = next_round(t_conv)
            base = next_round(max(r["ts"] for r in settled))
            base_ts = max(r["ts"] for r in base)
            after = [r["gossip"] for r in next_round(base_ts)]
            for b, a in zip(base, after):
                b = b["gossip"]
                if (a["repairs_applied"], a["repairs_sent"]) != \
                        (b["repairs_applied"], b["repairs_sent"]) \
                        or a["digest"] != want:
                    raise AssertionError(f"18b: {a['replica']} moved after "
                                         f"convergence: {b} -> {a}")
            # settled: phase 19's samples, taken while the sidecars live
            urls = [side.wait_for("obs endpoint on", 30).split(" on ", 1)[1]
                    for side in sides]
            out["fleet"] = fleet_samples(urls, stats[1], want, fleet_dir)
            out["replicas"] = {
                a["replica"]: {k: a[k] for k in (
                    "rounds", "exchanges_ok", "repairs_applied",
                    "repairs_sent", "transport_failures",
                    "corrupt_exchanges", "quarantines")}
                for a in after}
            out["edge"] = next(r["edge"] for r in reversed(stats[0].records)
                               if "edge" in r)
            # the kinds the edge's table held when a record was taken
            out["edge_kinds"] = sorted(set().union(*(
                r["edge"]["by_kind"] for r in stats[0].records
                if "edge" in r)))
            if out["edge"]["served"] == 0 or \
                    set(out["edge_kinds"]) - {"replica"}:
                raise AssertionError(f"18b: r0's edge section {out['edge']},"
                                     f" kinds {out['edge_kinds']}")
            out["propagation"] = all("propagation" in s.records[-1]
                                     for s in stats)
        finally:
            for s in sides:
                if s is not None:
                    s.close(signal.SIGINT)
            for s in stats:
                s.close()
    for s in stats:
        if s.errors:
            raise AssertionError(f"18b: stats lines {s.errors[:3]}")
    # the whole run's: each sidecar's last record is written after its
    # driver and server have stopped
    out["tx_bytes"] = {
        f"r{i}": sum(rec["ledger_bytes"] for name, rec in
                     s.records[-1].get("wirecost", {}).get(
                         "links", {}).items() if name.endswith("|tx"))
        for i, s in enumerate(stats)}
    out["b1"] = {f"r{i}": sentinel_launches(s.records[-1])["blake2b"]
                 for i, s in enumerate(stats)}
    if not out["propagation"] or min(out["b1"].values()) == 0:
        raise AssertionError(f"18b: propagation {out['propagation']}, B1 "
                             f"{out['b1']}")
    for side in sides:
        for line in side.lines:
            if line.startswith("sidecar: ('"):
                session_record(line)  # every session line one whole record
    return out


def cluster_scenario(seed: int) -> dict:
    """test_cluster_faults.py's scenario of ``seed``: N in {4, 16, 64}, a
    partition that heals, chaos links, and one of churn with a trim, a
    flash crowd or a byzantine replica."""
    n = (4, 16, 64)[seed % 3]
    kw: dict = {"n": n, "seed": seed, "chaos": True}
    if n == 64:
        kw.update(records_per=12, divergence=3)
    arm = None
    mode = seed % 4
    if mode == 1:
        kw.update(churn=True, fanout=True, fanout_retention=2048)
    elif mode == 2 and n <= 16:
        kw.update(flash_crowd=2)
    elif mode == 3:
        arm = CLUSTER_BYZ_ARMS[(seed // 4) % len(CLUSTER_BYZ_ARMS)]
        kw.update(byzantine=1 if n == 4 else 2, byzantine_arm=arm)
        if arm == "feed-corrupt":
            kw.update(fanout=True)
    return kw, arm


def check_chaos_seed(seed: int, sim, out: dict, arm) -> None:
    """test_cluster_faults.py's asserts on one run."""
    from dat_replication_protocol_tpu_torch.session.faults import FaultPlan

    what = f"18c seed {seed}"
    if not out["converged"] or out["rounds"] > out["bound"]:
        raise AssertionError(f"{what}: {out['rounds']} rounds of "
                             f"{out['bound']}, converged {out['converged']}")
    healthy = {sim.nodes[k].content_digest().hex() for k in sim.healthy()}
    if len(healthy) != 1:
        raise AssertionError(f"{what}: healthy replicas diverge")
    if sim.byzantine_key is None and healthy != {out["expected_digest"]}:
        raise AssertionError(f"{what}: converged to the wrong content")
    sc = out["partition"]
    minority = sc["groups"][0]
    for ev in sim.events:
        if not sc["cut_round"] <= ev["round"] < sc["heal_round"]:
            continue
        for ex in ev["exchanges"]:
            li = sim._index.get(ex["initiator"])
            lt = sim._index.get(ex["responder"])
            if ex["outcome"] != "ok" or li is None or lt is None \
                    or li >= sim.n0 or lt >= sim.n0:
                continue
            if (li in minority) != (lt in minority):
                raise AssertionError(f"{what}: {ex} crossed the cut")
    byz = sim.byzantine_key
    if byz is not None:
        if arm in ("wrong-symbol", "feed-corrupt") and not any(
                q["peer"] == byz for q in out["quarantines"]):
            raise AssertionError(f"{what}: byzantine ({arm}) never "
                                 "quarantined")
        lies = [ex for ev in sim.events for ex in ev["exchanges"]
                if ex["outcome"] == "corruption"
                and byz in (ex["initiator"], ex["responder"])]
        if arm == "wrong-chunk" and not any(
                f"repair records from '{byz}'" in ex["error"]
                for ex in lies):
            raise AssertionError(f"{what}: no wrong-chunk lie refused")
    for q in out["quarantines"]:
        if byz in (q["by"], q["peer"]):
            continue
        li, lt = sim._index[q["by"]], sim._index[q["peer"]]
        scen, _ = FaultPlan.link_scenario(seed, sim.n0,
                                          (min(li, lt), max(li, lt)))
        if scen != "flip":
            raise AssertionError(f"{what}: quarantine {q} unexplained "
                                 f"(link scenario {scen!r})")
    if out["wire_bytes"] <= 0:
        raise AssertionError(f"{what}: no wire moved")


def run_cluster_chaos(device) -> dict:
    """18c (see the module docstring)."""
    from dat_replication_protocol_tpu_torch.cluster import ClusterSim

    out = {}
    for seed in range(CLUSTER_CHAOS_SEEDS):
        kw, arm = cluster_scenario(seed)
        n = kw.pop("n")
        before = read_counters()
        t0 = time.perf_counter()
        sim = ClusterSim(n, device=device, **kw)
        res = sim.run()
        seconds = time.perf_counter() - t0
        check_chaos_seed(seed, sim, res, arm)
        now = read_counters()
        out[seed] = {"n": n, "rounds": res["rounds"], "bound": res["bound"],
                     "bootstraps": len(res["bootstraps"]) + sum(
                         len(ev["joined"]) for ev in sim.events),
                     "quarantines": len(res["quarantines"]),
                     "arm": arm, "seconds": seconds,
                     "b1": now["blake2b"] - before["blake2b"],
                     "b6": now["gear_window_first_checked"]
                     - before["gear_window_first_checked"]}
    return out


# ---------------------------------------------------------------------------
# phase 19: the offline obs tools over phase 18's replicas
# ---------------------------------------------------------------------------


def fleet_samples(urls: list, tee: "StatsReader", want: str,
                  fleet_dir: str) -> dict:
    """19a's recording, taken once 18b has settled: one sample a sidecar,
    one JSONL line in ``rI.sample.jsonl`` (its ``/snapshot`` with its
    ``/healthz`` record under ``healthz``), and r1's ``--stats-fd``
    records so far in ``r1.stats.jsonl``.  Then the dashboard, the one
    live arm: every endpoint reachable and every ``gossip.digest`` the
    oracle's."""
    from dat_replication_protocol_tpu_torch.obs.fleet import (
        FleetTarget, FleetView, render_dashboard)

    t0 = time.perf_counter()
    files = []
    for i, url in enumerate(urls):
        target = FleetTarget(url, name=f"r{i}")
        snap = target.poll()
        if snap is None:
            raise AssertionError(f"19a: r{i} at {url}: {target.last_error}")
        snap["healthz"] = target.poll_healthz()
        files.append(os.path.join(fleet_dir, f"r{i}.sample.jsonl"))
        with open(files[-1], "w", encoding="utf-8") as f:
            f.write(json.dumps(snap) + "\n")
    with tee.cond:
        records = list(tee.records)
    files.append(os.path.join(fleet_dir, "r1.stats.jsonl"))
    with open(files[-1], "w", encoding="utf-8") as f:
        f.writelines(json.dumps(r) + "\n" for r in records)
    sample_s = time.perf_counter() - t0
    view = FleetView(urls)
    live = view.poll(healthz=True)
    digests = {name: r["digest"] for name, r in live["gossip"].items()}
    if live["errors"] or digests != dict.fromkeys(urls, want):
        raise AssertionError(f"19a: the dashboard's poll: errors "
                             f"{live['errors']}, digests {digests}")
    return {"files": files, "sample_s": sample_s,
            "dashboard": render_dashboard(view, live).splitlines()}


def check_rows(text: str) -> list:
    """``fleet --check`` output: (mark, subject, detail) a row, and the
    summary line last."""
    lines = text.splitlines()
    return [tuple(ln.split(None, 2)) for ln in lines[:-1]], lines[-1]


def run_fleet_gate(files: list, want: str) -> dict:
    """19a's gate over the recorded samples, in this process and through
    ``python -m dat_replication_protocol_tpu_torch.obs fleet --check``:
    the same rows and exit code; every gossip row OK (one content digest,
    the oracle's, in every sample; none quarantined; converged within
    ``mesh_rounds_floor``); each ``require_healthz`` row as the target's
    saved record says.  Then the breach arm on the same files."""
    from dat_replication_protocol_tpu_torch.obs.fleet import (
        mesh_rounds_floor, run_fleet_check)

    root = os.path.dirname(os.path.abspath(__file__))
    slo = {"gossip": {"require_converged": True, "max_quarantined": 0,
                      "max_convergence_rounds":
                          mesh_rounds_floor(MESH_REPLICAS)},
           "require_healthz": True}
    slo_path = os.path.join(P19_OUT, "slo.json")
    with open(slo_path, "w", encoding="utf-8") as f:
        json.dump(slo, f)
    buf = io.StringIO()
    rc = run_fleet_check(files, slo_path, polls=1, out=buf)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "dat_replication_protocol_tpu_torch.obs",
         "fleet", *files, "--check", slo_path, "--polls", "1"],
        cwd=root, env={**os.environ, "PYTHONPATH": root},
        capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    if (cli.stdout, cli.returncode) != (buf.getvalue(), rc):
        raise AssertionError(f"19a: fleet --check (rc {cli.returncode}) "
                             f"{cli.stdout!r} {cli.stderr[-2000:]!r} differs "
                             f"from run_fleet_check (rc {rc}) "
                             f"{buf.getvalue()!r}")
    saved = {}
    for path in files:
        with open(path, encoding="utf-8") as f:
            saved[os.path.basename(path)] = json.loads(f.readlines()[-1])
    for name, rec in saved.items():
        if rec["gossip"]["digest"] != want or rec["gossip"]["quarantined"]:
            raise AssertionError(f"19a: {name}'s sample {rec['gossip']}")
    rows, summary = check_rows(buf.getvalue())
    marks = {subject: mark for mark, subject, _ in rows}
    gossip = {"gossip.require_converged[fleet]",
              "gossip.max_convergence_rounds[fleet]",
              *(f"gossip.max_quarantined[{n}]" for n in saved)}
    healthz = {f"require_healthz[{n}]": "OK" if rec["healthz"]["ok"]
               else "FAIL" for n, rec in saved.items()}
    if marks != {**dict.fromkeys(gossip, "OK"), **healthz}:
        raise AssertionError(f"19a: the gate's rows {rows}, want gossip "
                             f"OK and require_healthz {healthz}")
    if rc != ("FAIL" in healthz.values()):
        raise AssertionError(f"19a: the gate exited {rc}: {summary}")
    breach_path = os.path.join(P19_OUT, "breach.json")
    with open(breach_path, "w", encoding="utf-8") as f:
        json.dump({"gossip": {"max_exchange_p99_s": 1e-9}}, f)
    buf2 = io.StringIO()
    rc2 = run_fleet_check(files, breach_path, polls=1, out=buf2)
    b_rows, b_summary = check_rows(buf2.getvalue())
    if rc2 != 1 or [r[:2] for r in b_rows] != [
            ("FAIL", "gossip.max_exchange_p99_s[fleet]")]:
        raise AssertionError(f"19a: the breach arm (rc {rc2}) "
                             f"{buf2.getvalue()!r}")
    r0 = saved["r0.sample.jsonl"]["healthz"]
    return {"rc": rc, "rows": rows, "summary": summary, "cli_s": cli_s,
            "breach": b_rows[0][2], "r0_healthz_ok": r0["ok"],
            "r0_loop_lag": r0["stages"].get("loop_lag")}


def obs_cli(argv: list) -> tuple:
    """The port's offline CLI in this process: exit code and stdout."""
    import contextlib

    from dat_replication_protocol_tpu_torch.obs.__main__ import (
        main as obs_main)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_main(argv)
    return rc, buf.getvalue()


def run_doctors(sink: str, conv16: dict, mesh: dict) -> dict:
    """19b: the offline CLI over the run's own logs, each against an
    independent count: meshdoctor over 18a's N = 16 sink (its convergence
    round == the run's rounds), costdoctor over 18b's four logs (each
    replica's tx ``wire_bytes`` == 18b's ``tx_bytes`` of the wire cost
    ledger), loopdoctor over r0's ``edge.turn`` spans (the turns tile the
    loop's time; its exit code agrees with the flags it prints),
    export-trace of r0's log (one trace event a span and event record)
    and timeline over r0's and r1's logs."""
    logs = [os.path.join(P19_OUT, f"r{i}.jsonl")
            for i in range(MESH_REPLICAS)]
    out = {}
    rc, text = obs_cli(["meshdoctor", "--json", sink])
    rep = json.loads(text)
    if not rep["converged"] or rep["convergence_round"] != conv16["rounds"] \
            or rep["bound"] != conv16["bound"] \
            or rc != bool(rep["flags"]):
        raise AssertionError(f"19b: meshdoctor (rc {rc}) converged "
                             f"{rep['converged']} at round "
                             f"{rep['convergence_round']}, bound "
                             f"{rep['bound']}; 18a's {conv16['rounds']} "
                             f"rounds, bound {conv16['bound']}")
    out["mesh"] = {"rc": rc, "flags": rep["flags"],
                   **{k: rep[k] for k in ("convergence_round", "bound",
                                          "exchanges", "tree_digests",
                                          "distinct_frontiers")}}
    rc, text = obs_cli(["costdoctor", "--json", *logs])
    rep = json.loads(text)
    tx = {f"r{i}": sum(led["wire_bytes"] for name, led in
                       rep["ledgers"].items()
                       if name.endswith("|tx") and name.startswith(f"r{i}"))
          for i in range(MESH_REPLICAS)}
    if tx != mesh["tx_bytes"] or rc != bool(rep["flags"]):
        raise AssertionError(f"19b: costdoctor (rc {rc}) tx {tx}, the wire "
                             f"cost ledger's {mesh['tx_bytes']}; flags "
                             f"{rep['flags'][:4]}")
    out["cost"] = {"rc": rc, "tx": tx, "ledgers": len(rep["ledgers"]),
                   "flags": rep["flags"]}
    rc, text = obs_cli(["loopdoctor", "--json", logs[0]])
    rep = json.loads(text)
    tiling = [f for f in rep["flags"] if f["flag"].startswith("tile-")]
    if not rep["loops"] or tiling or rc != bool(rep["flags"]):
        raise AssertionError(f"19b: loopdoctor (rc {rc}) over r0: loops "
                             f"{list(rep['loops'])}, flags {rep['flags'][:4]}")
    out["loop"] = {"rc": rc, "flags": rep["flags"], "loops": {
        name: {k: r[k] for k in ("spans", "turns", "wall_s", "lag_max_s",
                                 "final_lag_s", "stall_s", "stall_turns",
                                 "threshold_s")}
        for name, r in rep["loops"].items()}}
    with open(logs[0], encoding="utf-8") as f:
        records = [json.loads(ln) for ln in f if ln.strip()]
    n_log = sum("span" in r or "event" in r for r in records)
    trace = os.path.join(P19_OUT, "r0.trace.json")
    rc, text = obs_cli(["export-trace", logs[0], "-o", trace])
    with open(trace, encoding="utf-8") as f:
        n_trace = len(json.load(f)["traceEvents"])
    if rc or n_trace != n_log or f": {n_trace} trace event(s)" not in text:
        raise AssertionError(f"19b: export-trace (rc {rc}) wrote {n_trace} "
                             f"events for {n_log} records: {text!r}")
    out["trace"] = {"events": n_trace, "spans": sum("span" in r
                                                    for r in records)}
    rc, text = obs_cli(["timeline", "--json", logs[0], logs[1]])
    rep = json.loads(text)
    if rc != bool(rep["flags"]) or not rep["timeline"]:
        raise AssertionError(f"19b: timeline (rc {rc}) flags "
                             f"{rep['flags'][:4]}")
    out["timeline"] = {"rc": rc, "rows": len(rep["timeline"]),
                       "flags": len(rep["flags"]),
                       "sender": rep["sender"], "receiver": rep["receiver"]}
    return out


def main() -> int:
    import torch

    try:
        from dat_replication_protocol_tpu_torch.utils.chiplock import (
            chip_lock)
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    # the card's mutex before the first CUDA call, held for the whole run
    with chip_lock(max_wait=CHIP_LOCK_WAIT_S) as lease:
        if not torch.cuda.is_available():
            print("chip_smoke: torch.cuda.is_available() is False; this "
                  "script needs one CUDA card", file=sys.stderr)
            return 2
        return run(lease)


def run(lease) -> int:
    """Every phase, with the card's mutex ``lease`` held."""
    import torch

    from dat_replication_protocol_tpu_torch.obs import BackendInitWatchdog
    from dat_replication_protocol_tpu_torch.ops import _build

    device = "cuda"
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"chip_lock: {lease.as_fields()} at {lease.path}"
        + ("" if lease.held else "; NOT held: another process may share "
           "the card, so this run's times may be polluted"))

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as pool:
        host_build = pool.submit(build_host_libraries)
        with BackendInitWatchdog(deadline_s=INIT_DEADLINE_S) as wd:
            wd.stage("platform_probe")
            name = torch.cuda.get_device_name(0)
            wd.stage("first_device_call")
            torch.ones(1, device=device).sum().item()
            wd.stage("first_compile")
            t0 = time.perf_counter()
            report = _build.build()
        log(f"phase 1: built {sorted(report)} in "
            f"{time.perf_counter() - t0:.2f} s (nvcc in parallel)")
        host = host_build.result()
    log(f"phase 1: host libraries of the native codec route: dat_native "
        f"{host['dat_native']}, dat_fastpath {host['dat_fastpath']} "
        f"({host['gxx']}; Python.h {host['python_h']}, triton importable "
        f"{host['triton']}); the wire pump's probe: {host['pump']}")
    log(f"phase 1: init watchdog on {name}: stages {wd.stages} (name, s "
        f"since start), done at {wd.elapsed_s:.3f} s of a "
        f"{INIT_DEADLINE_S} s deadline, stuck {wd.fired}")
    for name, r in sorted(report.items()):
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    enter("2")
    check_kernels(device)
    log(f"phase 2: {time.perf_counter() - t0:.2f} s")

    enter("3")
    session = run_session(device)
    log(f"phase 3: session of {session['blobs']} x 1 MiB blobs (cut from "
        f"BASELINE configs[2]'s 10k to fit the time limit) and "
        f"{session['changes']} changes, one change() call each (the "
        f"session of PRs 1-17): {session['wire_bytes']} wire bytes in "
        f"{session['seconds']} s = {session['gib_per_s']} GiB/s end to "
        f"end, {session['dispatches']} dispatches, launches "
        f"{session['launches']}; {session['c_runs']['runs']} C change runs "
        f"covered {session['c_runs']['frames']} frames; on {card}")
    bulk = run_session(device, bulk=True, keep_wire=True,
                       inputs=session["inputs"])
    log(f"phase 3: the same records, each blob's 32 changes as one "
        f"change_many run: {bulk['wire_bytes']} wire bytes in "
        f"{bulk['seconds']} s = {bulk['gib_per_s']} GiB/s end to end, "
        f"{bulk['dispatches']} dispatches; native codec route: "
        f"{bulk['c_runs']['runs']} C change runs covered "
        f"{bulk['c_runs']['frames']} frames; on {card}")
    if bulk["digests"] != session["digests"]:
        raise AssertionError("phase 3's digests differ between the change() "
                             "and the change_many session")
    del session["digests"]
    for native in (True, False):
        again = replay_session_wire(device, bulk, native)
        log(f"phase 3: the change_many session's wire ({again['writes']} "
            f"writes as the pipe made them) into decode(backend='cuda', "
            f"native={native}): {again['seconds']} s = "
            f"{again['gib_per_s']} GiB/s, digests == the session's, in "
            f"order; on {card}")
    session["launches"] = merged_launches(session["launches"],
                                          bulk["launches"])
    del bulk
    # the two sessions in turns at 256 blobs, neither keeping its writes,
    # so host drift and a session's leftovers fall on both alike
    turns = {False: [], True: []}
    for i in range(P3_TURNS):
        for arm in ((False, True) if i % 2 == 0 else (True, False)):
            run = run_session(device, n_blobs=P13_BLOBS, bulk=arm)
            turns[arm].append(run["seconds"])
            session["launches"] = merged_launches(session["launches"],
                                                  run["launches"])
    one, many = (float(np.median(turns[a])) for a in (False, True))
    log(f"phase 3: {P3_TURNS} turns at {P13_BLOBS} blobs, change() / "
        f"change_many: {turns[False]} / {turns[True]} s; medians {one} / "
        f"{many} s, change_many at {many / one} x; on {card}")
    for arm in (False, True):
        prof = profile_session(device, bulk=arm)
        log(f"phase 3: profiled {'change_many' if arm else 'change()'} "
            f"session of 256 blobs: {prof['seconds']} s, device busy share "
            f"{prof['busy_share']} (kernels and copies), "
            f"{prof['c_runs']['runs']} C change runs; on {card}")
        for ms, key, count in prof["rows"][:6]:
            log(f"  {ms} ms device in {count} x {key[:90]}")
        for ms, key, count in prof["annotations"]:
            log(f"  not counted: {ms} ms device in {count} x {key[:90]} "
                f"(a span's range around kernels above)")
    side = run_sidecar(device)
    log(f"phase 3: sidecar.run_session replied {side['digests']} digests, "
        f"launches {side['launches']}")
    pumped = run_wire_pump(device)
    session["launches"] = merged_launches(session["launches"],
                                          pumped["launches"])
    med = pumped["median"]
    log(f"phase 3, the wire pump (a): {PUMP_BLOBS} x ({CHANGES_PER_BLOB} "
        f"change() records + one 1 MiB blob), {pumped['wire_bytes']} wire "
        f"bytes (made in {pumped['make_s']:.2f} s), through "
        f"sidecar.run_session over loopback TCP, gate off, "
        f"{PUMP_TURNS} alternating turns: native (rx_fd/tx_fd) "
        f"{pumped['turns'][True]} GiB/s, plain (callables) "
        f"{pumped['turns'][False]} GiB/s; medians {med[True]} / {med[False]}"
        f" GiB/s, native at {med[True] / med[False]} x; every digest == "
        f"hashlib in submit order on both routes; on {card}")
    for native in (True, False):
        g = pumped["gated"][native]
        log(f"phase 3, the wire pump (a), gated {('plain', 'native')[native]}"
            f" turn ({g['gib_s']} GiB/s): transport.pump "
            f"{ {k: g[k] for k in PUMP_COUNTERS} }, "
            f"transport.pump.native.seconds {g['native_s']}")
    fan, fg = pumped["fan"], pumped["fan_gated"]
    log(f"phase 3, the wire pump (b): a {PUMP_FAN_BYTES} B wire to "
        f"{PUMP_FAN_PEERS} fd peers on socketpairs, each hashed by its "
        f"reader (length and BLAKE2b == the wire's): FanoutServer(native="
        f"True) {fan[True]} MiB/s, native=False {fan[False]} MiB/s "
        f"(turns N P P N); gated native turn: transport.pump.gather.bytes "
        f"{fg['gather_bytes']} == fanout.sent.bytes {fg['fanout_sent']}, "
        f"{fg['batches']} batches, {fg['syscalls']} syscalls; on {card}")
    log(f"phase 3, the wire pump (c): io_for_socket's writer to a peer that "
        f"never reads, SO_SNDTIMEO {PUMP_SNDTIMEO_S} s: "
        f"{pumped['timeout']['error']} (EAGAIN) after "
        f"{pumped['timeout']['seconds']} s")
    log(f"phase 3, the wire pump: (a) {pumped['session_s']:.2f} s, (b) "
        f"{pumped['fan_s']:.2f} s, B1 launches {pumped['launches']['blake2b']}")

    enter("4")
    ent = run_entry(device)
    log(f"phase 4: entry() over {ent['leaves']} leaves in {ent['seconds']} s,"
        f" root {ent['root']}, launches {ent['launches']}")

    t0 = time.perf_counter()
    enter("6")
    check_gear_kernels(device)
    edges = check_staged_edges(device)
    log(f"phase 6: B4, B5 and B6 byte-exact vs plain at the edges "
        f"({edges['rows']} rows x 128 KiB + 256 B, {edges['planted']} "
        f"planted candidates at span and payload first/last bytes, across "
        f"a row boundary and in a halo only; B4 spans, CTAs "
        f"{edges['spans']}); B5 and B6 at thin_bits 8, 11, 16, B5 == B6's "
        f"first == the window reduction, occ == the OR of B3's words, "
        f"viol 0")
    log(f"phase 6: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    enter("7")
    blob = make_blob(STREAM_BYTES)
    log(f"phase 7: made a {STREAM_BYTES} B blob from the seed in "
        f"{time.perf_counter() - t0:.2f} s; phase 7 takes its first "
        f"{CONTENT_BYTES} B")
    reset_counters()
    content = run_content(device, blob[:CONTENT_BYTES])
    cdc = read_counters()
    s = content["summary"]
    log(f"phase 7: content_address over {CONTENT_BYTES} B: {s.nchunks} "
        f"chunks, root {s.root.hex()}; seconds by route "
        f"{content['seconds']} = {CONTENT_BYTES / (1 << 30) / content['seconds']['bitmask']} "
        f"GiB/s on bitmask; greedy pass {content['greedy_s']} s a route; "
        f"digests == hashlib, root == root_host, {content['checked']} "
        f"candidate cuts checked by window hash, identical on all four "
        f"routes, 0 fused1p refusals; delta after 3 inserts + 1 delete: "
        f"{content['delta']} of {content['nchunks_new']} chunks, reassembled "
        f"exactly; chunk counts, delta and roots == the JAX package's; "
        f"launches {cdc}")
    g = content["greedy_routes"]
    log(f"phase 7: cdc.greedy over {g['candidates']} candidates -> "
        f"{g['cuts']} cuts: native route {g['native']} s, Python route "
        f"{g['python']} s, equal cuts; on {card}")
    for name, n in cdc.items():
        if n == 0 and name not in B1_VARIANTS and name != "blake2b_update":
            raise AssertionError(f"phase 7 never launched {name}")

    reset_counters()
    enter("8")
    stream = run_chunk_stream(device, blob, s.cuts)
    slabbed = run_slabbed(device, blob, s.cuts)
    streamed = read_counters()
    log(f"phase 8: chunk_stream over {STREAM_BYTES} B (BASELINE configs[3], "
        f"uncut) in 1 GiB slabs, route bitmask: {stream['cuts']} cuts in "
        f"{stream['seconds']} s = {stream['gib_per_s']} GiB/s end to end; "
        f"greedy pass {stream['greedy_s']} s; {stream['checked']} candidate "
        f"cuts checked; first {stream['shared']} cuts == phase 7's")
    log(f"phase 8: content_address over the blob's first {slabbed['bytes']} "
        f"B (RESIDENCY_CAP + 64 MiB), engine {slabbed['engines']}: "
        f"{slabbed['chunks']} chunks (last offset {slabbed['last_offset']}),"
        f" root {slabbed['root']}, in {slabbed['seconds']} s (gate on) = "
        f"{slabbed['gib_per_s']} GiB/s; every digest == hashlib "
        f"({slabbed['hashlib_s']:.2f} s on {SLAB_HASH_THREADS} threads), "
        f"root == root_host, {slabbed['checked']} candidate cuts checked, "
        f"sizes in [{CDC_MIN}, {CDC_MAX}], first {slabbed['shared']} cuts "
        f"== phase 7's; the whole check {slabbed['check_s']:.2f} s; on "
        f"{card}")
    log(f"phase 8: launches {streamed} (chunk_stream and the slabbed "
        f"content_address)")
    if streamed["gear_candidates"] == 0:
        raise AssertionError("phase 8 never launched B3")
    if streamed["blake2b"] == 0:
        raise AssertionError("phase 8's slabbed route never launched B1")

    launches = {k: session["launches"][k] + side["launches"][k]
                + ent["launches"][k] + cdc[k] + streamed[k]
                for k in session["launches"] if k not in NOT_COUNTS}
    enter("5")
    sass = b1_sass()
    latency = chain_latency(device)
    log(f"phase 5: dependent-issue latency {latency['cycles']} cycles a "
        f"step ({latency['cycles_per_trip']} cycles per trip of the probe "
        f"over its {latency['chain']}-step path); B1's SASS, one thread: "
        f"{sass['per_block']} a block and {sass['per_item']} an item by "
        f"pipe, a compression's dependent path {sass['chain']} steps; "
        f"the four-lane variant issues {sass['quad_per_block']} a block "
        f"per lane")
    rows = time_kernels(device, launches, ent["step"], sass,
                        latency["cycles"])
    enter("9")
    chunk = time_chunk_bucket(device, blob[:CONTENT_BYTES], s.cuts, sass,
                              latency["cycles"])
    content_blob = blob[:CONTENT_BYTES].copy()  # phase 12's gear scan
    del blob
    log(f"phase 9: B1 at phase 7's largest chunk bucket: plain "
        f"{chunk['plain_ms']} ms; chunks per bucket {chunk['buckets']}")
    rows += time_gear_kernels(device, launches)

    t0 = time.perf_counter()
    enter("10")
    recon = run_reconcile(device)
    p10 = recon["launches"]
    log(f"phase 10: two snapshots of {recon['leaves']} change records "
        f"(encoded in {recon['encode_s']:.2f} s), {recon['differing']} "
        f"rewritten: diff_snapshots and the packed diff over the 2^21 "
        f"concatenated leaves == the dense compare == the rewritten rows, "
        f"roots == root_host; update_leaves of {N_UPDATES} leaves == a "
        f"rebuild, input tree unchanged; {N_PROOFS} proofs verify, a "
        f"flipped byte and a wrong index do not")
    log(f"phase 10: sketch reconcile of {recon['sketch_records']} records "
        f"(BASELINE configs[4], bench_merkle's shape, log2_slots "
        f"{SKETCH_LOG2_SLOTS}) in {recon['reconcile_s']} s; tables and slots "
        f"== hashlib + np.add.at; {recon['slots']} differing slots == the "
        f"inserted keys' slots; tree_sync found the same slots in "
        f"{recon['sync_messages']} messages, {recon['sync_bytes']} bytes")
    log(f"phase 10: rateless over {recon['leaves']} digests, k "
        f"{RATELESS_K}: decoded the exact symmetric difference with its "
        f"signs from {recon['symbols']} symbols in {recon['decode_s']} s; "
        f"device-built cells == build_symbols_host; launches {p10}")
    times = time_reconcile(device, recon)
    b2 = times["b2"]
    log(f"phase 10: diff {times['diff_entries_s']} entries/s (median of 10 "
        f"warm reps, packed-mask D2H and index extraction included; s "
        f"{times['diff_s']})")
    log(f"phase 10: B2 at {2 * recon['leaves']} -> {recon['leaves']}: "
        f"device {times['b2_ms']} ms, plain {times['b2_plain_ms']} ms, "
        f"max_abs_err {times['b2_err']}; bound {b2['bound_ms']} ms "
        f"({b2['bound_by']}): bytes {b2['bytes_ms']}, operations "
        f"{b2['ops_ms']} ms")
    log(f"phase 10: update_leaves of {N_UPDATES} leaves: "
        f"{times['update_ms']} ms; the sketch scatter-add of one 1M-record "
        f"log on the device {times['summarize_ms']} ms; reconcile warm "
        f"{times['reconcile_s']} s "
        f"= {[recon['sketch_records'] / t for t in times['reconcile_s']]} "
        f"records/s (first pass {recon['sketch_records'] / recon['reconcile_s']});"
        f" rateless decode {recon['decode_s']} s")
    log(f"phase 10: {time.perf_counter() - t0:.2f} s")
    mesh_recon = {k: recon[k] for k in ("diff", "dense", "roots", "sketch")}
    del recon, times

    t0 = time.perf_counter()
    enter("11")
    rep = run_replay(device, card)
    p11 = rep["launches"]
    n = rep["rows"]
    log(f"phase 11: replay of {n} rows (BASELINE configs[1], uncut; "
        f"bench_replay's {REPLAY_BLOCK}-record block x {REPLAY_REPS}): the "
        f"per-record, batch ({REPLAY_BATCH_ROWS} rows a frame) and mixed "
        f"wires replay to the same rows, encode_change_columns of each == "
        f"the per-record wire; leaves of the per-record columns (wire "
        f"extents) and of the batch columns (canonical re-encode) == hashlib,"
        f" root {rep['root']} == root_host; decode_batch_device of the batch "
        f"wire's {rep['batch_frames']} frames == decode_change_batch; "
        f"launches {p11}")
    log(f"phase 11: wire bytes {rep['wire_bytes']}; replay rows/s "
        f"{ {k: n / v for k, v in rep['replay_s'].items()} } (s "
        f"{rep['replay_s']}); encode_change_columns {n / rep['encode_columns_s']}"
        f" rows/s; encode_batch_frames {rep['encode_batch_s']} s; "
        f"canonical_change_extents {rep['canonical_s']} s; on {card}")
    for route, t in rep["routes"].items():
        log(f"phase 11: {route} codec route, per-record wire: split "
            f"{n / t['split']} rows/s, decode {n / t['decode']} rows/s, "
            f"encode {n / t['encode']} rows/s (s {t}); on {card}")
    log("phase 11: the Python route's frame index, columns and encoders' "
        "bytes == the native route's on all three wires")
    rt = time_replay(device, rep)
    log(f"phase 11: leaves + root {rep['leaves_root_ms']} ms host clock, of "
        f"it B1 {rt['b1_ms']} ms and B2 {rt['b2_ms']} ms on the device (CUDA "
        f"events over a graph of the same launches); decode_batch_device of "
        f"{n} rows {rep['decode_device_ms']} ms; on {card}")
    for name, sess in rep["sessions"].items():
        log(f"phase 11: digest session ({name}) of {sess['rows']} rows and "
            f"{SESSION_BLOBS} blobs: {sess['rows_s']} rows/s ({sess['seconds']}"
            f" s, {sess['wire_bytes']} wire bytes); every change digest == "
            f"the per-record session's == hashlib; on {card}")
    log(f"phase 11: B1 launches by block count {p11['b1_blocks']}")
    log(f"phase 11: {time.perf_counter() - t0:.2f} s")
    del rep

    t0 = time.perf_counter()
    enter("12a")
    sass_u = b1_sass("blake2b_update_thread_kernel",
                     "blake2b_update_quad_kernel")
    data = make_blob(STREAM12_BYTES, seed=SEED + 63)
    st = run_stream(device, data)
    p12a = st["launches"]
    log(f"phase 12: Blake2bStream over {STREAM12_BYTES} B in "
        f"{SEGMENT_BYTES} B segments, fed in 1 MiB pieces, == hashlib: "
        f"{st['mib_s']} MiB/s ({st['seconds']} s), hashlib "
        f"{st['hashlib_mib_s']} MiB/s on this host; streams of "
        f"{list(st['edges'])} B in 1 and 3 pieces == hashlib; the chained "
        f"entry launched {p12a['blake2b_update']} times, by lanes per item "
        f"{p12a['b1u_lanes']}")
    t1 = time.perf_counter()
    upd = check_update_stream_shape(device, data, sass_u, latency["cycles"])
    del data
    upd["launches"] = p12a["blake2b_update"]
    log(f"phase 12: B1's chained entry byte-exact vs plain with "
        f"{list(upd['ms_by_lanes'])} lanes per item at the stream's width: "
        f"an eighth of its first segment {upd['plain_shape']} (items x "
        f"blocks), not last, then a last segment of {TAIL12_BYTES} B "
        f"bucketed to {upd['tail_blocks']} blocks; the plain chain == "
        f"hashlib; {time.perf_counter() - t1:.2f} s; device ms at "
        f"{upd['shape']} by lanes {upd['ms_by_lanes']}, the rule picks "
        f"{upd['lanes']}; plain {upd['plain_ms']} ms at "
        f"{upd['plain_shape']} (its launches from a CUDA graph, "
        f"{PLAIN12_CHUNK} blocks a call); bound {upd['bound_ms']} ms "
        f"({upd['bound_by']}): bytes {upd['bytes_ms']}, operations "
        f"{upd['ops_ms']}, chain {upd['chain_ms']} ms; its SASS, one thread: "
        f"{sass_u['per_block']} a block, a compression's dependent path "
        f"{sass_u['chain']} steps; the four-lane variant issues "
        f"{sass_u['quad_per_block']} a block per lane; on {card}")
    t1 = time.perf_counter()
    batch = run_update_batch(device, sass_u, latency["cycles"])
    log(f"phase 12: {BATCH12_ITEMS} items of a 4 MiB segment, its first "
        f"eighth {batch['plain_shape']} == the plain version "
        f"({batch['plain_ms']} ms from its graph), the whole and a last "
        f"one of 1 B-4 MiB == hashlib, each variant; "
        f"{time.perf_counter() - t1:.2f} s; one 4 MiB segment "
        f"of the {BATCH12_ITEMS} items: device ms by lanes {batch['ms']} = "
        f"{batch['mib_s']} MiB/s; of one item {batch['one_ms']} = "
        f"{batch['one_mib_s']} MiB/s; chain bound of a segment "
        f"{batch['chain_ms']} ms = {batch['chain_mib_s']} MiB/s a stream; "
        f"on {card}")
    edges = check_update_edges(device)
    log(f"phase 12: B1's chained entry byte-exact vs plain (eager, "
        f"{edges['plain_eager_ms']} ms at t_hi 1) at {edges['shape']}, both "
        f"variants, t_hi 0 and 1, counters carrying into t_hi, the empty "
        f"message, empty and bucketed-past last segments")
    rows.append(upd)
    log(f"phase 12a: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    enter("12b")
    mesh_in = mesh_inputs(device, session, ent, mesh_recon, content_blob)
    del mesh_recon
    mesh = run_mesh(device, mesh_in)
    del mesh_in
    p12 = mesh["launches"]
    log(f"phase 12: a one-rank nccl group (FileStore, initialized in "
        f"{mesh['init_s']:.2f} s) and make_mesh(1): digest_root_step over "
        f"phase 4's {ENTRY_LEAVES} payloads (leaves == hashlib, root == "
        f"root_host, total bytes exact), sharded_hash_begin over phase 3's "
        f"{session['changes']} changes and 32 of its blobs (== hashlib == "
        f"blake2b_batch_begin), sharded_diff over phase 10's snapshots (mask "
        f"== the dense compare, roots == root_host), sharded_sketch over "
        f"phase 10's {SKETCH_ROWS} records (== sketch_table) and "
        f"sharded_gear_scan over phase 7's {CONTENT_BYTES} B (== B3 over "
        f"candidates_begin's rows); launches {p12}")
    for name, (mesh_ms, one_ms) in mesh["ms"].items():
        log(f"phase 12: {name} warm {mesh_ms} ms on the one-rank mesh, "
            f"{one_ms} ms on one device without it ({mesh_ms / one_ms} x); "
            f"on {card}")
    for name in ("blake2b", "merkle_level", "gear_candidates"):
        if p12[name] == 0:
            raise AssertionError(f"phase 12's mesh calls never launched "
                                 f"{name}")
    log(f"phase 12b: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    enter("13")
    tel = run_telemetry(device, content_blob, s)
    del content_blob
    p13 = tel["launches"]
    g = tel["gate"]
    log(f"phase 13: the {P13_BLOBS}-blob session, gate off / on alternating:"
        f" off {g['off_s']} s, on {g['on_s']} s; medians {g['median_off_s']}"
        f" / {g['median_on_s']} s, ratio {g['ratio']}; on {card}")
    sp = tel["split"]
    log(f"phase 13: gated session: counters {tel['counters']} == its truth; "
        f"kernel sites {tel['sites']} == the wrappers' launches; frame tags "
        f"{tel['tags']} tile the wire at both ends; host split of "
        f"{sp['seconds']} s: device.dispatch {sp['dispatch_s']} s "
        f"({sp['dispatches']} dispatches), device.deliver {sp['deliver_s']} "
        f"s, rest (wire parse, framing, Python) {sp['rest_s']} s; gauges "
        f"after it {tel['gauges']}; on {card}")
    log(f"phase 13: the gated change_many session: counters == its truth, "
        f"sites == launches, frame tags {tel['tags_bulk']} (a C change run "
        f"is one decoder.frame.run tag) tile the wire at both ends")
    log(f"phase 13: the same session under torch.profiler in "
        f"{tel['profiled']['seconds']} s: counters == its truth, sites == "
        f"launches, utils.trace spans {tel['profiled']['spans']} all among "
        f"the profiler's events")
    for i, cdc_run in enumerate(tel["cdc"]):
        cs = cdc_run["split"]
        log(f"phase 13: gated content_address {i + 1} of 2 of {CONTENT_BYTES}"
            f" B on fused1p == phase 7's summary in {cs['seconds']} s; "
            f"counters {cdc_run['counters']}; kernel sites "
            f"{cdc_run['sites']} == launches; split: device.content.address "
            f"{cs['content_address_s']} s = cdc.dispatch {cs['cdc.dispatch']}"
            f" + cdc.collect {cs['cdc.collect']} + cdc.greedy "
            f"{cs['cdc.greedy']} + chunk hash device.dispatch "
            f"{cs['hash_dispatch_s']} + rest (staging, root fold, readback) "
            f"{cs['rest_s']} s; engine notes {cdc_run['engines'][:2]}; on "
            f"{card}")
    log(f"phase 13: obs rings as a Chrome trace: {tel['ring_trace'][1]} "
        f"records in {tel['ring_trace'][0]}; the profiler's trace: "
        f"{tel['profile'][1]} records in {tel['profile'][0]}; launches {p13}")
    log(f"phase 13: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    enter("14a")
    ae = run_anti_entropy_reconcile(device)
    a, b = ae["k1000"], ae["k10"]
    n_ae = sum(ae["records"])
    log(f"phase 14a: two change logs of {ae['records']} records "
        f"({AE_SHARED} shared, {AE_OWN} own on each side; made and encoded "
        f"in {ae['make_s']:.2f} s; the hashlib oracle of every canonical "
        f"record and its numpy set difference in {ae['oracle_s']:.2f} s); "
        f"the --tcp --reconcile sidecar subprocess listening after "
        f"{ae['sidecar_start_s']:.2f} s; RatelessReplica(A) built in "
        f"{ae['build_s']} s (profiled), of it B1 {ae['b1']['ms']} ms on "
        f"the device ({ae['b1']['records']} kernel records for "
        f"{ae['b1']['launches']} launches); replica digests == hashlib; "
        f"reconcile_local of the pair {ae['local_s']} s; on {card}")
    for name, arm in (("k = 1000", a), ("k = 10", b)):
        log(f"phase 14a: {name}: run_initiator over the socket received "
            f"{arm['received']} and shipped {arm['sent']} records == the "
            f"oracle's difference, the sidecar logged ok; "
            f"{n_ae / arm['seconds']} records/s ({arm['seconds']} s from "
            f"connect to both results); {arm['symbols']} symbols in "
            f"{arm['rounds']} rounds; wire bytes {arm['wire']} == "
            f"reconcile_local's metering; on {card}")
    for what, c in ae["corrupt"].items():
        log(f"phase 14a: corrupt arm (the first SYMBOLS frame's {what} "
            f"flipped in flight): {c['outcome']}; the socket closed, the "
            f"sidecar logged {c['sidecar']}; {c['tx_bytes']} B sent, in "
            f"{c['seconds']} s")
    enter("14b")
    snap = run_anti_entropy_snapshot(device)
    ms, m = snap["materialize_ms"], snap["materialize_launches"]
    log(f"phase 14b: SnapshotSource over {snap['bytes']} B: "
        f"{snap['chunks']} chunks in {snap['materialize_s']} s (profiled), "
        f"of it on the device (ms, the profiler's kernel records, the "
        f"launches; ms None where a record is missing) B6 "
        f"{ms['gear_window_first_checked']} and B1 {ms['blake2b']}; "
        f"{snap['checked']} candidate cuts checked by window hash; manifest "
        f"root == root_host of hashlib digests; on {card}")
    cold, stale, crowd = snap["cold"], snap["stale"], snap["crowd"]
    log(f"phase 14b: cold joiner over loopback (serve_tcp in a thread): "
        f"byte-exact, {cold['gib_s']} GiB/s ({cold['seconds']} s, wire "
        f"{cold['wire']}); on {card}")
    log(f"phase 14b: stale joiner ({SNAP_STALE:.0%} of the chunks "
        f"rewritten): byte-exact, {stale['seconds']} s, chunk bytes "
        f"{stale['chunk_bytes']}, wire {stale['wire']} == snapshot_local's, "
        f"{stale['reused']} chunks reused, {stale['symbols']} symbols in "
        f"{stale['rounds']} rounds; wire over the cold joiner's "
        f"{stale['ratio']}; on {card}")
    log(f"phase 14b: flash crowd of {crowd['joiners']} cold joiners at once:"
        f" each byte-exact; {crowd['served']} B of the cold log served == "
        f"{crowd['joiners']} x {crowd['cold_log']}; B1 and B6 launched 0 "
        f"times over the crowd; {crowd['gib_s']} GiB/s aggregate "
        f"({crowd['seconds']} s); on {card}")
    t = snap["torn"]
    log(f"phase 14b: torn arm (socket cut at byte {t['cut_at']}, inside the"
        f" first CHUNKS frame): one ProtocolError ({t['error']}) in "
        f"{t['seconds']} s, no dataset")
    p14 = {k: ae["launches"][k] + snap["launches"][k] for k in launches}
    for name in ("blake2b", "gear_window_first_checked"):
        if p14[name] == 0:
            raise AssertionError(f"phase 14 never launched {name}")
    grew = {what: {k: b[k] - a[k] for k in P14_KERNELS}
            for what, a, b in (("cold joiner", m, snap["cold_launches"]),
                               ("stale joiner", snap["cold_launches"],
                                snap["launches"]))}
    log(f"phase 14: launches 14a {ae['launches']}; 14b {snap['launches']}: "
        f"materialize B1 {m['blake2b']}, B6 "
        f"{m['gear_window_first_checked']}, then {grew}")
    log(f"phase 14: {time.perf_counter() - t0:.2f} s")
    edge_in = dict(ae["edge"], record=a["record"])  # phase 17b's reconcile
    del ae, snap

    t0 = time.perf_counter()
    enter("15a")
    wires = hub_soak_wires()
    want = [wire_digests(w) for w in wires]
    log(f"phase 15a: {HUB_SESSIONS} session wires of {HUB_ROWS} change rows "
        f"and one {HUB_BLOB} B blob (bench.py config 9, uncut), "
        f"{sum(len(w) for w in wires)} B, and their hashlib digests in "
        f"{time.perf_counter() - t0:.2f} s")
    reset_counters()
    soak = run_hub_soak(device, wires, want)
    p15a = read_counters()
    for i, r in enumerate(soak["runs"]):
        log(f"phase 15a: hub soak, gate {('off', 'on')[i]}: "
            f"{r['sessions']} sessions on one ReplicationHub(device='cuda', "
            f"{HUB_SOAK}), every digest == hashlib in its session's order: "
            f"{r['digests']} digests, {r['gib_s']} GiB/s aggregate "
            f"({r['seconds']} s), fairness min/median {r['fairness']} "
            f"(session GiB/s min, median {r['session_gib_s']}), "
            f"{r['dispatches']} dispatches; on {card}")
    log(f"phase 15a: items per dispatch, gate off / on: "
        f"{[r['digests'] / r['dispatches'] for r in soak['runs']]}; on "
        f"{card}")
    log(f"phase 15a: B1 launches {p15a['blake2b']} (by block count "
        f"{p15a['b1_blocks']}); counters of the gated run {soak['counters']}; "
        f"its dispatch turns (hub.dispatch.latency) {soak['turns']}")
    del soak
    enter("15b")
    out = run_hub_sidecar(device)
    for count, arm in out["arms"].items():
        log(f"phase 15b: --tcp --hub --stats-fd sidecar (telemetry on), "
            f"{count} concurrent client(s) of a {HUB_WIRE_MIB} MiB wire "
            f"(bench.py config 13's hub arm): every reply == hashlib; "
            f"{arm['gib_s']} GiB/s aggregate ({arm['seconds']} s, "
            f"{arm['bytes']} B); {arm['records']} stats records parsed, "
            f"{arm['named']} session entries, each a live connection; "
            f"on {card}")
    for count, arm in out["arms_off"].items():
        log(f"phase 15b: --tcp --hub sidecar (telemetry off), {count} "
            f"concurrent client(s), the same wires: every reply == hashlib; "
            f"{arm['gib_s']} GiB/s aggregate ({arm['seconds']} s, "
            f"{arm['bytes']} B); on {card}")
    rej = out["rejected"]
    c = out["counters"]
    log(f"phase 15b: items per dispatch (hub.dispatch.items / "
        f"hub.dispatch.batches) {c['hub.dispatch.items']} / "
        f"{c['hub.dispatch.batches']} = "
        f"{c['hub.dispatch.items'] / c['hub.dispatch.batches']}; on {card}")
    log(f"phase 15b: the sidecar's kernel sentinel counted "
        f"{out['b1_launches']} B1 launches; its counters {out['counters']}; "
        f"{out['records']} stats records up to emit_seq {out['emit_seq']}, "
        f"the wire cost ledger tiles every connection (residual 0); pump "
        f"{out['pump']}, transport.pump.batches {out['pump_batches']}")
    log(f"phase 15b: --hub-max-sessions 2 with 2 clients held in the hub "
        f"(breakdown {rej['breakdown']}): the third read EOF in "
        f"{rej['eof_s']} s and the sidecar logged {rej['record']}; the held "
        f"clients' replies == hashlib")
    reset_counters()
    enter("15c")
    shed = run_hub_shed(device)
    p15c = read_counters()
    log(f"phase 15c: a never-polling nowait session flooding 1 MiB blobs "
        f"past a {HUB_SHED_BUDGET} B parked budget: {shed['shed']}; one "
        f"hub.shed event {shed['event']}; at the shed {shed['at_shed']}, "
        f"hub.completions.dropped {shed['dropped']} == its in-flight items; "
        f"{shed['submitted']} blobs submitted; 3 neighbours' "
        f"{shed['neighbour_digests']} digests == hashlib in "
        f"{shed['neighbours_s']} s; B1 launches {p15c['blake2b']}")
    reset_counters()
    enter("15d")
    mesh15 = run_hub_mesh(device, wires[:HUB_MESH_SESSIONS],
                          want[:HUB_MESH_SESSIONS])
    p15d = read_counters()
    del wires, want
    log(f"phase 15d: the hub on make_mesh() over a one-rank nccl group "
        f"(set up in {mesh15['init_s']:.2f} s): {HUB_MESH_SESSIONS} "
        f"sessions, {mesh15['digests']} digests == hashlib, "
        f"{mesh15['sharded_calls']} sharded_hash_begin calls == the "
        f"pipeline's dispatches, {mesh15['gib_s']} GiB/s aggregate "
        f"({mesh15['seconds']} s); B1 launches {p15d['blake2b']}; on {card}")
    p15 = {k: p15a[k] + p15c[k] + p15d[k] for k in launches}
    for what, n in (("15a", p15a), ("15c", p15c), ("15d", p15d)):
        if n["blake2b"] == 0:
            raise AssertionError(f"phase {what} never launched B1")
    log(f"phase 15: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    enter("16a")
    fwire = fanout_wire()
    fwant = wire_digests(fwire)
    reset_counters()
    fan = run_fanout(device, fwire, fwant)
    p16a = read_counters()
    for n, arm in fan["arms"].items():
        log(f"phase 16a: config 10's {len(fwire)} B wire ({FAN_ROWS} rows, "
            f"a {FAN_BLOB} B blob) decoded once by decode(backend='cuda'), "
            f"digests == hashlib in submit order, published to {n} "
            f"accounting-only peers: {arm['mib_s']} MiB/s delivered in "
            f"aggregate ({arm['seconds']} s from the first publish to the "
            f"drain), peers' worst p99 append -> delivery {arm['p99_ms']} "
            f"ms; digest work {arm['work']}, B1 launches {arm['b1']}; on "
            f"{card}")
    log(f"phase 16a: hash once: device.submit.bytes, device.h2d.bytes and "
        f"B1's launches equal at {list(FAN_PEERS)} peers; each peer of a "
        f"second publish at each count read the wire byte for byte (its "
        f"length and BLAKE2b)")
    log(f"phase 16a: {FAN_STALL_PEERS} peers, one stalled for {FAN_STALL_S} "
        f"s at half the wire: the others' worst p99 "
        f"{fan['stalled']['p99_ms']} ms ({fan['stalled']['seconds']} s); "
        f"without the staller {fan['unstalled']['p99_ms']} ms "
        f"({fan['unstalled']['seconds']} s); no peer shed; on {card}")
    enter("16b")
    fs = run_fanout_sidecar(device, fwire, fwant)
    log(f"phase 16b: --tcp --fanout --hub sidecar: a probe connection gave "
        f"the source claim back; the source's reply == hashlib; "
        f"{FAN_SUBSCRIBERS} subscribers read the wire byte for byte and "
        f"EOF ({fs['seconds']} s from the source's first byte; "
        f"fanout.sent.bytes {fs['sent']}); its sentinel: {fs['hub']}; on "
        f"{card}")
    log(f"phase 16b: --fanout --snapshot over {FAN_SNAP_BYTES} B (listening "
        f"after {fs['snap_start_s']:.2f} s), --fanout-retention "
        f"{FAN_RETENTION}: the late subscriber read {fs['refusal']}; the "
        f"bootstrap from the hinted port byte-exact in {fs['bootstrap_s']} "
        f"s; its sentinel: {fs['snap']}; on {card}")
    reset_counters()
    enter("16c")
    rs = run_resume(device)
    p16c = read_counters()
    r_ms = rs["resume_ms"]
    log(f"phase 16c: config 6 ({RESUME_ROWS} rows, {rs['wire']} B, a drop "
        f"at half the wire) into a CudaDecoder under run_resumable, "
        f"{RESUME_REPS} reps (cut from 100): fault -> first re-delivered "
        f"frame median {r_ms['median']} ms, p90 {r_ms['p90']} ms (all "
        f"{r_ms['all']}); every rep's digests 0..{RESUME_ROWS - 1} once "
        f"each == hashlib; on {card}")
    log(f"phase 16c: for_sweep seeds 0..{SWEEP_SEEDS - 1} over a "
        f"{SWEEP_ROWS}-row wire with a 64 KiB blob (scenarios {rs['sweep']}) "
        f"each ended with the clean digest sequence; the flip arm: "
        f"{rs['flip']}; the armed recorder kept bundles {rs['bundles']} "
        f"(routine, half of 4), checkpoint {rs['checkpoint']}")
    reset_counters()
    enter("16d")
    ch = run_snapshot_chaos(device)
    p16d = read_counters()
    log(f"phase 16d: config 12's chaos arm: SnapshotSource over "
        f"{CHAOS_BYTES} B ({ch['chunks']} chunks, {ch['materialize_s']:.3f} "
        f"s), a joiner's {ch['wire']} B wire torn at byte {ch['cut']} inside "
        f"the first CHUNKS frame and resumed from a WireJournal "
        f"({ch['reconnects']} reconnect): byte-exact, chunks verified "
        f"{ch['wanted']} == wanted, {ch['delivered']} chunks delivered, none "
        f"twice")
    p16 = {k: p16a[k] + p16c[k] + p16d[k] for k in launches}
    for what, n in (("16a", p16a), ("16c", p16c), ("16d", p16d)):
        if n["blake2b"] == 0:
            raise AssertionError(f"phase {what} never launched B1")
    if p16d["gear_window_first_checked"] == 0:
        raise AssertionError("phase 16d never launched B6")
    log(f"phase 16: launches 16a {p16a}; 16c {p16c}; 16d {p16d}")
    log(f"phase 16: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    reset_counters()
    enter("17a")
    sc = run_edge_scaling(device)
    p17a = read_counters()
    log(f"phase 17a: RLIMIT_NOFILE soft {sc['fd_soft']} hard {sc['fd_hard']}"
        f"; counts dropped for fds: {sc['dropped']}")
    for n, arm in sc["arms"].items():
        log(f"phase 17a: config 15, {n} concurrent one-change sessions "
            f"(alternating latency/throughput) through one EdgeLoop on "
            f"ReplicationHub(device='cuda'), gate on: peak table {arm['peak']}"
            f" == held; {arm['sessions_s']} sessions/s in the finish flood "
            f"({arm['finish_s']} s), p99 {arm['p99_s']} s, ramp "
            f"{arm['ramp_s']} s; admitted {arm['admitted']}, rejected "
            f"{arm['rejected']}, shed {arm['shed']}; loop_lag_max_s "
            f"{arm['loop_lag_max_s']}, p99_turn_s {arm['p99_turn_s']}, "
            f"{arm['turns']} turns; B1 launches {arm['b1']}; every reply one "
            f"change == hashlib ({arm['distinct_replies']} distinct); on "
            f"{card}")
    import resource

    log(f"phase 17a: B1 launches {p17a['blake2b']}; this process's peak "
        f"RSS after it {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} "
        f"KiB (ru_maxrss); {time.perf_counter() - t0:.2f} s")
    t1 = time.perf_counter()
    reset_counters()
    enter("17b")
    mx = run_edge_mixed(device, edge_in)
    p17b = mx["launches"]
    del edge_in
    log(f"phase 17b: one EdgeLoop, one ReplicationHub(device='cuda'): "
        f"{EDGE_HUB_SESSIONS} hub sessions of phase 15b's {HUB_WIRE_MIB} MiB "
        f"wire, two broadcast groups (16a's wire, {EDGE_GROUP_SUBS} "
        f"subscribers each), phase 14a's reconcile pair (k = 1000) and a "
        f"snapshot leg over {EDGE_SNAP_BYTES} B (materialized in "
        f"{mx['materialize_s']:.3f} s); table {mx['table']}, every fd "
        f"non-blocking; every reply == hashlib, every subscriber's length "
        f"and BLAKE2b == the wire's, the reconcile records == the oracle's "
        f"with socket bytes {mx['reconcile']['wire']} == reconcile_local's, "
        f"the joiner byte-exact; {mx['records']} records == the threaded "
        f"legs'; {mx['wire_bytes']} request bytes, all legs in "
        f"{mx['seconds']} s; launches B1 {p17b['blake2b']}, B6 "
        f"{p17b['gear_window_first_checked']}; on {card}")
    log(f"phase 17b: {time.perf_counter() - t1:.2f} s")
    t1 = time.perf_counter()
    reset_counters()
    enter("17c")
    ch17 = run_edge_chaos(device)
    p17c = read_counters()
    base = ch17["arms"][None]["p99_ms"]
    for seed, arm in ch17["arms"].items():
        if seed is not None:
            log(f"phase 17c: seed {seed} ({arm['scenario']}): "
                f"{arm['healthy']} neighbours byte-exact, worst "
                f"{arm['p99_ms']} ms (without a fault {base} ms), the "
                f"faulted session's record not ok; on {card}")
    log(f"phase 17c: B1 launches {p17c['blake2b']}; "
        f"{time.perf_counter() - t1:.2f} s")
    t1 = time.perf_counter()
    enter("17d")
    sd = run_edge_sidecar(device)
    log(f"phase 17d: --tcp --edge --stats-fd --obs-http sidecar, "
        f"{EDGE_HUB_SESSIONS} concurrent clients of a {HUB_WIRE_MIB} MiB "
        f"wire: every reply == hashlib, "
        f"{sd['bytes'] / sd['seconds'] / (1 << 30)} GiB/s ({sd['seconds']} "
        f"s, {sd['bytes']} B); on {card}")
    log(f"phase 17d: the same {EDGE_HUB_SESSIONS} clients held halfway in "
        f"the table (the edge section named each, by kind and class), "
        f"/healthz {sd['healthz']['status']} with loop_lag "
        f"{sd['healthz']['loop_lag']} (503 before it {len(sd['healthz_503'])}"
        f" times, the first failing {sd['healthz_503'][:1]}); released: "
        f"every reply == hashlib; {sd['records']} stats records parsed; the "
        f"last edge section "
        f"{ {k: sd['edge'][k] for k in ('served', 'admitted', 'shed')} }; "
        f"its sentinel: {sd['launches']}; the sidecar's peak RSS "
        f"{sd['peak_rss_kib']} KiB (the largest VmRSS sampled every 0.1 s); "
        f"on {card}")
    log(f"phase 17d: --edge --hub-max-sessions 2: the third client read EOF"
        f" and the sidecar logged {sd['rejected']['record']}; "
        f"{sd['rejected']['edge']}; the held clients' replies == hashlib; "
        f"{time.perf_counter() - t1:.2f} s on {card}")
    t1 = time.perf_counter()
    reset_counters()
    enter("17e")
    aio = run_aio(device, tel["gate"]["median_off_s"])
    p17e = read_counters()
    log(f"phase 17e: session_over_asyncio over phase 13a's {P13_BLOBS}-blob "
        f"session into decode(backend='cuda'): every digest == hashlib in "
        f"submit order, before finalize; {aio['gib_s']} GiB/s ({aio['seconds']}"
        f" s, {aio['bytes']} B, {aio['dispatches']} dispatches) beside pipe "
        f"{aio['pipe_gib_s']} GiB/s (13a's gate-off median); on {card}")
    log(f"phase 17e: recv_over_async under AsyncFaultyReader, seeds "
        f"0..{AIO_SEEDS - 1} (for_sweep's plans without the faults that end "
        f"a session): the clean digests each time {aio['seeds']}; B1 "
        f"launches {p17e['blake2b']}; {time.perf_counter() - t1:.2f} s on "
        f"{card}")
    p17 = {k: p17a[k] + p17b[k] + p17c[k] + p17e[k] for k in launches}
    for what, n in (("17a", p17a), ("17b", p17b), ("17c", p17c),
                    ("17e", p17e)):
        if n["blake2b"] == 0:
            raise AssertionError(f"phase {what} never launched B1")
    if p17b["gear_window_first_checked"] == 0:
        raise AssertionError("phase 17b never launched B6")
    log(f"phase 17: launches 17a {p17a}; 17b {p17b}; 17c {p17c}; 17e {p17e}")
    log(f"phase 17: {time.perf_counter() - t0:.2f} s")

    enter("18a")
    t0 = time.perf_counter()
    shutil.rmtree(P19_OUT, ignore_errors=True)
    os.makedirs(P19_OUT)
    sink = os.path.join(P19_OUT, f"mesh{MESH_SINK_N}.jsonl")
    reset_counters()
    conv = run_cluster_converge(device, sink)
    p18a = read_counters()
    for n, r in conv.items():
        log(f"phase 18a: bench.py config 14, uncut: ClusterSim({n}, "
            f"seed={CLUSTER_SEED}, chaos=False, records_per="
            f"{CLUSTER_RECORDS}, divergence={CLUSTER_DIVERGENCE}, "
            f"device='cuda'), gate on: converged in {r['rounds']} rounds "
            f"(bound {r['bound']}) in {r['seconds']} s (the replicas built "
            f"in {r['build_s']} s); every replica's content digest == the "
            f"hashlib oracle of the union ({r['records']} records); wire "
            f"{r['wire_bytes']} B over a divergence of "
            f"{r['divergence_bytes']} B, wire_x {r['wire_x']}; "
            f"exchange_p99_s {r['exchange_p99_s']}; goodput {r['goodput']}, "
            f"overhead {r['overhead']} (wire cost ledger); B1 launches "
            f"{r['b1']}; on {card}")
    if p18a["blake2b"] == 0:
        raise AssertionError("phase 18a never launched B1")
    log(f"phase 18a: {time.perf_counter() - t0:.2f} s")
    enter("18b")
    t1 = time.perf_counter()
    mesh = run_live_mesh(device, P19_OUT)
    log(f"phase 18b: {MESH_REPLICAS} --tcp --replica sidecars on the card "
        f"(r0 with --edge), --gossip-interval {MESH_INTERVAL_S}, each "
        f"dialling the other three; {MESH_SHARED} shared records + "
        f"{MESH_OWN} own each (configs[4]'s 1M a replica cut for time), "
        f"{mesh['union']} in the union (logs made in {mesh['make_s']:.2f} "
        f"s, sidecars listening after {mesh['start_s']:.2f} s): every "
        f"--stats-fd gossip.digest == the hashlib oracle {mesh['digest'][:16]}"
        f"... with {mesh['union']} records {mesh['converge_s']} s after the "
        f"last listening line (stats every {MESH_STATS_S} s); a further "
        f"round of each driver shipped nothing; on {card}")
    log(f"phase 18b: replicas {mesh['replicas']}; tx bytes (wire cost "
        f"ledger) {mesh['tx_bytes']}; B1 launches by sidecar (sentinels) "
        f"{mesh['b1']}; r0's edge section "
        f"{ {k: mesh['edge'][k] for k in ('served', 'admitted', 'rejected', 'shed')} }"
        f", the kinds its table held in a record {mesh['edge_kinds']}; "
        f"{time.perf_counter() - t1:.2f} s on {card}")
    enter("18c")
    t1 = time.perf_counter()
    reset_counters()
    chaos = run_cluster_chaos(device)
    p18c = read_counters()
    for seed, r in chaos.items():
        log(f"phase 18c: seed {seed} (n={r['n']}, arm {r['arm']}): converged "
            f"in {r['rounds']} rounds (bound {r['bound']}), {r['bootstraps']}"
            f" bootstraps, {r['quarantines']} quarantines, "
            f"{r['seconds']} s; B1 {r['b1']}, B6 {r['b6']} launches; on "
            f"{card}")
    for name in ("blake2b", "gear_window_first_checked"):
        if p18c[name] == 0:
            raise AssertionError(f"phase 18c never launched {name}")
    p18 = {k: p18a[k] + p18c[k] for k in launches}
    log(f"phase 18c: {time.perf_counter() - t1:.2f} s")
    log(f"phase 18: launches 18a {p18a}; 18c {p18c}")
    log(f"phase 18: {time.perf_counter() - t0:.2f} s")

    enter("19a")
    t0 = time.perf_counter()
    fl = mesh["fleet"]
    gate = run_fleet_gate(fl["files"], mesh["digest"])
    names = [os.path.basename(f) for f in fl["files"]]
    log(f"phase 19a: one sample a target recorded once 18b had settled, in "
        f"{fl['sample_s']:.3f} s, under {P19_OUT}: {names} (four /snapshot "
        f"records with their /healthz, r1's --stats-fd tee); "
        f"run_fleet_check and `python -m dat_replication_protocol_tpu_torch"
        f".obs fleet --check` (in {gate['cli_s']:.2f} s) over those files: "
        f"the same {len(gate['rows'])} rows, exit {gate['rc']}; every "
        f"sample's gossip.digest == the hashlib oracle {mesh['digest'][:16]}"
        f"..., 0 quarantined; on {card}")
    for mark, subject, detail in gate["rows"]:
        log(f"phase 19a: gate: {mark:<4} {subject} {detail}")
    log(f"phase 19a: gate: {gate['summary']}")
    if not gate["r0_healthz_ok"]:
        log(f"phase 19a: finding: r0's saved /healthz is degraded, its "
            f"require_healthz row FAIL as the record says; its loop_lag "
            f"stage {gate['r0_loop_lag']} (the edge loop rebuilds the "
            f"263k-record replica on its own thread); on {card}")
    else:
        log(f"phase 19a: r0's saved /healthz ok, loop_lag stage "
            f"{gate['r0_loop_lag']}; on {card}")
    log(f"phase 19a: the breach arm (gossip.max_exchange_p99_s 1e-9) on the "
        f"same files: exit 1, one row FAIL gossip.max_exchange_p99_s[fleet] "
        f"{gate['breach']}; on {card}")
    for line in fl["dashboard"]:
        log(f"phase 19a: dashboard: {line}")
    log(f"phase 19a: {time.perf_counter() - t0:.2f} s on {card}")
    enter("19b")
    t1 = time.perf_counter()
    doc = run_doctors(sink, conv[MESH_SINK_N], mesh)
    m = doc["mesh"]
    log(f"phase 19b: meshdoctor over 18a's N = {MESH_SINK_N} sink: exit "
        f"{m['rc']}, converged at round {m['convergence_round']} == the "
        f"run's {conv[MESH_SINK_N]['rounds']} rounds, bound {m['bound']}; "
        f"{m['exchanges']} exchanges, {m['tree_digests']} digests tracked, "
        f"flags {m['flags']}; on {card}")
    c = doc["cost"]
    kinds: dict = {}
    for f in c["flags"]:
        kinds[f["flag"]] = kinds.get(f["flag"], 0) + 1
    log(f"phase 19b: costdoctor over 18b's four logs: exit {c['rc']}, "
        f"{c['ledgers']} ledgers; tx wire bytes by replica {c['tx']} == the "
        f"wire cost ledger's tx_bytes; flags by kind {kinds} (a log holds "
        f"many sessions, each from wire offset 0); on {card}")
    lp = doc["loop"]
    log(f"phase 19b: loopdoctor over r0's edge.turn spans: exit {lp['rc']}, "
        f"the turns tile the loop's time; {lp['loops']}; on {card}")
    for f in lp["flags"]:
        log(f"phase 19b: loopdoctor finding {f}")
    log(f"phase 19b: export-trace of r0's log: {doc['trace']['events']} trace"
        f" events == its span and event records ({doc['trace']['spans']} "
        f"spans); on {card}")
    tl = doc["timeline"]
    log(f"phase 19b: timeline of r0's and r1's logs: exit {tl['rc']}, "
        f"{tl['rows']} rows, {tl['flags']} flags; sender {tl['sender']}, "
        f"receiver {tl['receiver']}; on {card}")
    log(f"phase 19b: {time.perf_counter() - t1:.2f} s on {card}")
    log(f"phase 19: {time.perf_counter() - t0:.2f} s on {card}")
    enter("report")

    for k in launches:
        launches[k] += (p10[k] + p11[k] + p12[k] + p13[k] + p14[k] + p15[k]
                        + p16[k] + p17[k] + p18[k])
    for r in rows:
        n = r["name"]
        r["launches"] += (p10[n] + p11[n] + p12[n] + p13[n] + p14[n]
                          + p15[n] + p16[n] + p17[n] + p18[n])
    buckets = b1_buckets(session["launches"], side["launches"],
                         ent["launches"], cdc, streamed)
    buckets["reconcile"] = sum(p10["b1_blocks"].values())
    buckets["replay"] = sum(p11["b1_blocks"].values())
    buckets["mesh"] = sum(p12["b1_blocks"].values())
    buckets["telemetry"] = p13["blake2b"]
    buckets["anti_entropy"] = p14["blake2b"]
    buckets["hub"] = p15["blake2b"]
    buckets["fanout"] = p16["blake2b"]
    buckets["edge"] = p17["blake2b"]
    buckets["cluster"] = p18["blake2b"]
    if sum(buckets.values()) != launches["blake2b"]:
        raise AssertionError(f"B1's launches by bucket {buckets} do not sum "
                             f"to its {launches['blake2b']} launches")
    log(f"phase 9: B1's {launches['blake2b']} main-path launches by bucket "
        f"{buckets}; B1 in phase 10 by block count {p10['b1_blocks']}, in "
        f"phase 11 {p11['b1_blocks']}")
    for r in rows:
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} was not launched on the "
                                 "main path")
        log(f"phase 9: {r['name']} at {r['shape']}: {r['ms']} ms, plain "
            f"{r['plain_ms']} ms at {r['plain_shape']}, bound {r['bound_ms']} "
            f"ms ({r['bound_by']}),"
            f" {r['launches']} launches on the main path, library none")
        if "sass_per_thread" in r:
            per = " per span" if "geometry" in r else ""
            log(f"  SASS walk, one thread{per}: {r['sass_per_thread']}; "
                f"bytes alone {r['bytes_ms']} ms, "
                f"operations {r['ops_ms']} ms; in turns {r['turns_ms']} ms; "
                f"{r['registers']} registers")
        if "geometry" in r:
            geom = r["geometry"]
            log(f"  staged: {geom['threads']} threads a CTA and groups a "
                f"span, 2 stages, {geom['smem_bytes']} B shared a CTA, "
                f"{geom['ctas']} CTAs over {geom['total_spans']} spans")
        if "same_work" in r:
            log(f"  its own SASS bound {r['ops_ms']} ms, the same work as "
                f"{r['same_work']} issues it {r['ops_same_work_ms']} ms: "
                f"{r['ms'] / r['bound_ms']} x the smaller; "
                f"{r['same_work']} {r['same_work_ms']} ms in the same turns")
        elif "sass_per_thread" in r:
            log(f"  {r['ms'] / r['bound_ms']} x its bound")
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "plain_shape")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--edge-client"]:
        sys.exit(edge_client_main(int(sys.argv[2]), int(sys.argv[3]),
                                  sys.argv[4]))
    try:
        sys.exit(main())
    except Exception as e:
        import traceback

        line = (f"chip_smoke: phase {PHASE['now']} failed: "
                f"{type(e).__name__}: {e}")
        print(line, flush=True)
        traceback.print_exc()
        print(line, file=sys.stderr, flush=True)
        sys.exit(1)
