"""Smoke run of redisson_tpu_torch on one CUDA card.

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version at the main path's shapes, then drives
the main path through the public client at full size:

  phase 0  device, nvidia-smi name and power limit, kernel build
  phase 1  kernel K1 (csrc/cms_seq.cu) vs its plain version and golden_seq,
           bit for bit, at d=5, w=65536, B=32768 and at the edge shapes of
           K1_EDGES; kernel and plain times for zipf(1.2), uniform and
           one-key streams at the main shape, and the bound
  phase 2  RBloomFilter at 1M keys / 1% FPP: add_all_async, contains_many,
           contains_each; the tenant row vs the golden bitmap; measured FPP
           vs the expected rate for the 2**20 keys loaded
  phase 3  1000 tenants, mixed add/contains/mixed runs from 4 threads
           through the coalescer; every per-op result vs the golden model
  phase 4  RCountMinSketch(5, 65536) add_all_seq over 2M zipf(1.2) events;
           table vs golden, first chunk vs golden_seq, top-10 recall, K1
           launches
  phase 5  config 2, RHyperLogLog PFADD: a 2**21-key warm-up, then 4
           disjoint batches of 2**21 keys issued together and resolved
           with collect (10,485,760 distinct keys); registers vs the golden
           model, count() vs its Ertl estimate and within 5% of the truth,
           per-op changed flags of a 2**16-key chunk with repeats vs the
           sequential model; PFADD ops/s and count() latency
  phase 6  config 3, RBitSet of 2**30 bits: set(2**30 - 1), then 8
           alternating set_many_async / get_many_async of 2**21 uniform
           indexes resolved with collect; every per-op result, the final
           row, cardinality() and length() vs a numpy bitmap updated in
           order; ops/s
  phase 7  4 threads, each owning 16 bitsets and 16 HLLs, issue random
           SET/CLEAR/FLIP/GET batches and PFADDs through the coalescer (one
           burst of more than 1024 runs, one of fewer); every per-op result
           vs each tenant's sequential model
  phase 8  the RObject lifecycle on the phases 2-6 keyspace (about 0.55 GiB
           of pools): Bloom count() vs the golden bitmap's; DUMP/RESTORE of
           the four config-sized objects (rows equal on the card, re-dumps
           equal, BUSYKEY); CMS merge (numpy uint32 sum, wrapping) and
           reset; rename; a TTL reaped within 5 s and its row zeroed; one
           batch of 326 sync-named calls vs direct calls on twins, with
           fewer dispatches than calls; a whole-keyspace snapshot restored
           on create by a second client (every pool byte-equal, equal
           answers), then 2**18 events through add_all_seq on both CMSes
           (K1 launches on the restored one; equal tables)
  phase 9  failure and overload on a fresh client (breakers open on the
           second failure): per kind (config 1 Bloom loaded with 2**20 keys,
           a config 2 HLL, a config 3 2**30-bit BitSet), a chaos rule on the
           kind's dispatch methods opens its breaker, a degraded window is
           served by the host mirror and held to the golden model op for op,
           and after clearing, the breaker closes and the reconciled row
           equals the golden state on the card; config 5 streams 2**20
           events on K1, 2**18 on the mirror (whole-call estimates), 2**20
           on K1 again (K1 launches; the table is the uint32 sum of every
           event); a seeded 5% schedule over dispatch, fetch and staged H2D
           under 4 threads loses no acknowledged write; 1000 calls under a
           50 ms deadline shed under injected pressure without a launch; a
           burster tenant is throttled while a 3-thread victim completes
           every op; a sleep kernel ahead of one launch outlasts
           fetch_timeout_ms (DispatchTimeoutError, a breaker failure, and
           the op still lands).  Phases 2-8 end with no op served degraded
           and every breaker closed
  phase 10 the host tiers on fresh clients: (10a) 102,400 Bloom tenants
           of 10,000 keys / 1% over a 1024-row device budget (all but
           1016 born on the host; a 32 MiB host cap spills the cold tail
           to blobs under build/), a 5,120-op zipf(1.1) stream of
           128-key ops, every per-op result equal to an all-resident
           client's and 256 sampled tenants byte-equal across the tiers;
           four CMS(5, 65536), two HLLs and two 2**24-bit BitSets forced
           through demote, spill, load and promote with their bytes
           unchanged, then K1 on each promoted CMS row equal to
           golden_seq; the hot pass of the 256 hottest tenants tiered
           against all-resident (hot_ratio); transition p50/p99.
           (10b) config 1's filter with 100,000 keys, 1024 + 1024 zipf(1.3)
           single-key contains with the near cache on and off: equal
           answers, a cached negative retired by an add.  (10c) the first
           batch per bucket with and without pre-warm, each arm in a
           child process (``--p10c-child``); no first launch after
           prewarm_wait.  (10d) phase 3's run with the near cache on and
           off, in turns.  Then the BitSet answers past 2**31 bits
  phase 11 the RESP front door on fresh card clients, with the native
           codec required (RTPU_REQUIRE_NATIVE_RESP=1): (11a) config 1 over
           the wire — BF.RESERVE cfg1 0.01 1000000, 2**20 keys as BF.MADD
           commands of 1024 keys from 4 pipelining connections, every flag
           within the golden model's bounds, the row equal to the golden
           bitmap, 131,072 outside keys through BF.MEXISTS equal to golden
           and the FPP within 3 sigma; wire ops/s.  (11b) config 6's
           pipelined stream (4 connections, 256-deep batches, zipf(1.3)
           spans of Bloom, strings and bitmap) on a vectorizing and a
           sequential server: every connection's replies and the rows
           byte-identical; cmds/s, fusion ratio, response-cache hit rate,
           and the device idle share over one pass.  (11c) config 8: 1000
           idle connections and 32 closed-loop single-command clients in
           child processes, reactor against thread-per-connection: a fixed
           serving-thread count, replies equal to a sequential replay;
           cmds/s, p50/p99.  (11d) ``python -m redisson_tpu_torch --device
           cuda`` with a snapshot directory: a session over every family,
           SIGTERM (drain, snapshot, exit 0), a reboot that answers every
           read as before; INFO server names the card
  phase 12 the data grid on fresh card clients: (12a) config 5 through
           its real pipe at bench_config5_stream_topk's shape — CMS(5,
           65536) with top-20 tracking, 16,000,000 zipf(1.2) % 100,000
           uint64 events published as 32,768-event array messages (one
           warm message first) through RTopic -> TopicCmsBridge ->
           add_all_async -> cms_add -> coalescer -> cms_update_estimate;
           the table equals the golden count-min over every event,
           total_count() and events_ingested equal the event count, top-10
           recall 1.0, no op served degraded; events/s, dispatches and
           events per dispatch, the device idle share of the timed window.
           (12b) the grid families over the wire on a card server (reactor
           on): a session of lists, hashes, sets, sorted sets with the SCAN
           family and the STORE commands, streams with a consumer group,
           geo and WRONGTYPE, byte-equal to a CPU server's replies and to
           Redis's literal replies where known; pub/sub across two
           connections; a BLPOP parked while another connection pipelines
           1000 BF.MEXISTS/GET commands, all answered, the serving-thread
           count unchanged, then woken by an LPUSH.  (12c) ``python -m
           redisson_tpu_torch`` with a snapshot directory: lists, hashes,
           sorted sets, a stream with a consumer group and a geo set over
           the wire, SIGTERM, a reboot that answers every read equal.  K1
           launches in phase 12 are counted and must be 0: the bridge takes
           the vectorized cms_add, not K1
  phase 13 the coordination and services half on fresh card clients:
           (13a) config 1 through ``client.reactive()``: try_init(1,048,576,
           0.01), asyncio.gather of 4 add_all_async awaits of 262,144 keys,
           then of 4 contains_each awaits of 2**20 keys; the row, every
           contains flag and the FPP equal a sync client's run of the same
           keys and the golden model, the sync run's add flags equal the
           sequential golden model and each concurrent await's lie within
           phase 11a's bounds; keys/s beside phase 2's.  (13b) an executor
           service with 4 workers runs 4 tasks, each add_all_seq of 524,288
           zipf(1.2) events into its own CMS(5, 65536): K1 launches, every
           estimate and table equal to golden_seq.  (13c) 8 threads x 250
           rounds of lock, BitSet cardinality() on the card, set that bit,
           unlock: the set bits are exactly 0..1999; a 2-permit semaphore
           around 8 threads' HLL add_all never sees a third holder and the
           registers equal the golden model; a transaction over a map and
           a bucket commits and a conflicting one raises
           TransactionException; lock-hold p50/p99.  (13d) a LocalCachedMap
           of 100,000 entries read twice: the second pass's hit rate and get
           p50/p99, and two handles agree after a put through either.
           (13e) get_nodes() is the card, ping_all(), 100 pings' p50/p99, a
           1 s failure monitor without a down event.  (13f) a profiler trace
           of a 262,144-key Bloom pass holds CUDA kernel events,
           device_memory() reports the card's total memory, ops_total grows
           by exactly the pass's ops, and the scrape endpoint on loopback
           serves every family of the registry.  K1 launches in phase 13
           are counted (13b) and must be more than 0
  phase 14 the op journal, crash recovery and replication on fresh card
           clients (directories under build/, df -T printed once): (14a)
           config 1's 2**19 keys as 512 add_all calls of 1024 keys from 4
           threads in four arms on one client — journal off, appendfsync
           no, everysec, always, each on a fresh filter whose row must
           equal the golden bitmap; keys/s, records, journal bytes per key,
           fsyncs, records per fsync (group commit) and the fsync p50/p99;
           then config 5 (CMS(5, 65536)) add_all_seq of 2**20 zipf(1.2)
           events under always (K1; estimates equal golden_seq, table
           equal golden).  (14b) a child (``--p14-child``) runs the always
           Bloom arm, a snapshot, the CMS stream, an HLL PFADD of 2**21
           keys and a 2**30-bit BitSet's set_many of 2**21 indexes, one ACK
           per resolved call; SIGKILL after the last ack; a fresh card
           client restores, replays and writes back: every row equal to
           the golden state of the acked ops, the live K1 table equal to
           the rebuilt one, and 2**18 more events through K1 on the
           recovered row equal to golden_seq; recovery seconds, records
           and rows.  (14c) ``python -m redisson_tpu_torch.chaos.crashchild
           --device cuda`` for 1 seed x {always, everysec}, plus runs with
           --snapshot-every 50 and --residency-every 25, killed at seeded
           ack counts, recovered on the card and matched to a golden
           prefix (always: covering every ack; everysec: every ack older
           than 2.5 s).  (14d) a primary and a replica RespServer on two
           card clients: FULLRESYNC of config 1 + config 5, then 2**20 keys
           of BF.MADD from 4 connections with WAIT 1 1000 every 64
           commands; replica rows byte-equal, -READONLY, a dropped link
           resyncing partially, FAILOVER, every WAIT-covered write read
           back from the promoted node.  (14e) ``python -m
           redisson_tpu_torch --journal-dir --snapshot-dir`` with CONFIG
           SET appendfsync always, SIGKILLed mid-pipeline and rebooted:
           every acknowledged SET and BF.MADD key reads back.  K1 launches
           in phase 14 (14a, 14b's recovered row, 14d) must be more than 0
  phase 15 the observability tier on fresh card clients: (15a) config 1 at
           trace_sample_rate 1.0 inside client.trace: 4 x 262,144-key
           add_all_async under a torch.profiler capture, then contains_many
           of 2**20 keys; the row and flags equal golden, every span's four
           phases sum to its end-to-end time within 1 us, spans = phase
           histogram samples = coalesced launches, op_stats counts every
           key, the trace holds a launch span per launch, the spans'
           event-timed device time over the kernel + memcpy time the
           capture saw lies in P15_DEVICE_OVER_CARD and each span's is
           below its enqueue + d2h_fetch, and
           rtpu_tenant_device_us equals the spans' device time; config 5
           add_all_seq of 2**20 zipf(1.2) events under a second capture:
           rtpu_dispatches{cms_update_estimate_seq} = K1 launches,
           rtpu_dispatch_ops = 2**20, every K1 kernel launched inside an
           rtpu:cms_update_estimate_seq region, estimates and table equal
           golden_seq.  (15b) phase 2's add pass with the tier off, traced,
           and key-sampled, in turns A B C C B A x 3; keys/s per arm.
           (15c) a card RespServer (reactor, native codec): 256 BF.MADD of
           1024 keys from 4 connections while a fifth is in MONITOR — every
           command seen once in each connection's order with the
           reference's rendering, no fused run, replies equal a sequential
           replay in the monitor's order, SLOWLOG LEN and GET 128 with
           Redis's truncation; an RTPU.TRACE prelude's trace holds the
           command and launch spans; a Bloom breaker trip gives LATENCY
           breaker-open and EVENTS health.breaker.open then close; INFO
           events and telemetry field names; HOTKEYS over config 6's stream
           names every key above N/128.  K1 launches in phase 15 must be
           more than 0
  phase 16 scripting and the per-core front door: (16a) on a card server
           with scripts enabled (reactor on, native codec required), a
           seeded script session byte-equal to a CPU server's; config 1
           through scripts — BF.RESERVE cfg1 0.01 1000000, a SCRIPT LOADed
           body calling redis.call('BF.MADD', KEYS[0], *ARGV), 64 EVALSHA
           of 1024 keys from 4 connections (2**16 keys: scripts run one at
           a time under the grid lock), every flag within 11a's golden
           bounds and the row equal to the golden bitmap; FCALL_RO of a
           no-writes reader over 131,072 outside keys equal to golden and
           FUNCTION LIST equal to the CPU server's; at script_timeout_ms
           200, BUSY on another connection and SCRIPT KILL of a pure loop,
           of a redis.call loop and of a BF.MADD loop after at least 4
           MADDs (its row the golden bitmap of the MADDs that landed), the
           slot free after each; EVALSHA keys/s, script p50/p99 and SCRIPT
           KILL -> reply ms.  (16b) MulticoreNode(4, device="cuda"): every
           worker's INFO over its peer socket names the card, INFO
           frontdoor reports 4 processes with the native tick, each
           worker's device memory grows with its own filter; config 13's
           traffic (8 client processes x 4 closed-loop connections, 128-key
           hot sets pinned to the landing worker, zipf(1.2), 10% SET)
           against the node and a single-process door in turns (median
           cmds/s and p99 per arm, the speedup, host cores, handoffs);
           config 1 over the node (a filter per worker, 2**16 keys each as
           BF.MADD of 1024 keys from 4 connections, about 3/4 through a
           handoff leg: flags within the golden bounds, every loaded key
           present, 131,072 outside keys per filter equal to golden,
           handoffs equal to the sibling-owned commands) beside a pinned
           arm; config 6's replies byte-equal between the node and the
           single door; SIGTERM (a snapshot per worker), a reboot that
           reads every key back, every worker exiting 0 and none left.
           K1 launches in phase 16 must be 0
  phase 17 the slot-sharded cluster on the card (directories under build/):
           (17a) ClusterSupervisor(n_nodes=3, device="cuda"): every node's
           INFO names the card and its own device memory grows when its
           filter is made; config 1 across the fleet — BF.RESERVE 0.01
           1000000 of {n0}cfg1, {n1}cfg1, {n2}cfg1 (one per node), 2**17
           keys each as BF.MADD of 1024 keys through
           connect_cluster().execute_many from 4 threads (three pipelined
           legs per batch), every flag within 11a's golden bounds, every
           loaded key present, 131,072 outside keys per filter equal to
           golden, rtpu_cluster_scatter_fanout = the legs; fleet keys/s.
           (17b) config 9's traffic (9 client processes x 4 routing
           threads, execute_many batches of 192 over 512 keys, zipf(1.2),
           10% SET) against a 1-node and the 3-node fleet in turns: median
           cmds/s and p99 per arm, the speedup, host cores.  (17c) on the
           3-node fleet a writer acks SET {mig}w<i> and BF.ADD {mig}bf
           while migrate_slot moves the slot (with an HLL, a 2**24-bit
           BitSet and a CMS(5, 65536), quiet): every acked SET reads back,
           the moved filter's row equals the golden bitmap of the acked
           keys, the quiet DUMPs are byte-equal, the source counts 0 keys
           in the slot and the target holds the rows on its card; then two
           in-process card nodes move a CMS and the target runs
           add_all_seq of 2**19 zipf events on the moved row (16 K1
           launches), estimates and table equal golden_seq.  (17e)
           SIGTERM: every node exits 0 within 10 s, none left.  (17d)
           three primaries with a replica each (journals under
           appendfsync always): WAIT-fenced SET and BF.MADD in every shard,
           SIGKILL of primary 0, its replica master within 15 s, every
           fenced write back through the client and the filter's row equal
           to golden, the survivors' CLUSTER SHARDS equal with every slot
           owned once, rtpu_failover_elections_total >= 1, new writes to
           the taken-over slots; kill -> master and kill -> first write
           seconds; 17e for that fleet.  K1 launches in phase 17 (17c)
           must be more than 0
  phase 18 the autonomous rebalancer and the fleet doctor on the card:
           three in-process card nodes (LongCodec) splitting the slots in
           thirds, each with a RebalanceAgent (threshold 1.3, 8 moves per
           wave, 50 ms pace, 15 s cooldown, 3 warm-up ticks) and a
           FleetDoctor (0.5 s stuck-slot bound, the WAIT-fenced canary),
           neither thread-started.  (18a) 12 hot hash tags in distinct
           slots of node A and 2 cold ones on each other node, each with a
           config-sized filter (1,000,000 / 1%) and a CMS(5, 65536);
           per tick window through connect_cluster from 4 threads, 64
           BF.MADD of 1024 fresh keys per hot filter and 8 per cold one, 8
           CMS.INCRBY of 256 zipf(1.2) draws over 8 items (as (item,
           count) pairs) per hot CMS and 1 per cold one; after each window CLUSTER REBALANCE NOW and CLUSTER DOCTOR
           NOW on every node (every doctor sweep 0 findings), up to 10
           windows until a wave moves slots.  The imbalance ratio reads
           above 1.3 before the wave and lower after it, every slot that
           changed owner moved once and off node A, every acked key
           answers BF.MEXISTS 1 through the routing client, each moved
           filter's row on its new owner's card equals the golden bitmap
           of its acked keys, the hot objects' DUMPs are byte-equal across
           the wave, the source counts 0 keys in a moved slot and the rows
           sit on the card.  (18b) add_all_seq of 2**19 zipf events on a
           CMS the wave moved, at its new owner: 16 K1 launches,
           estimates and table equal golden_seq from the moved row.
           (18c) CLUSTER SETSLOT <s> MIGRATING B on node A: the doctor's
           next sweep past 0.5 s raises stuck-migration (a doctor.finding
           event, rtpu_doctor_findings{kind="stuck-migration"} 1), SETSLOT
           STABLE clears it (doctor.clear); the canary's round trip per
           primary.  K1 launches in phase 18 (18b) must be more than 0
  phase 19 the port's locks under the armed lock-order witness.  (19a) a
           child (``--p19-child``) with RTPU_LOCK_WITNESS=1 and
           RTPU_LOCK_WITNESS_EXPORT: config 1 (2**20 keys as add_all calls
           of 8192 from 4 threads through the coalescer, every flag within
           11a's bounds, the row and contains from 4 threads equal golden);
           K1 on a CMS(5, 65536), 2**19 zipf(1.2) events in 16 launches,
           estimates and table equal golden_seq; PFADD and BitSet sets
           equal golden; a reactor RespServer under appendfsync always
           with a thread-per-connection replica: 4 connections pipeline
           BF.MADD of 1024 keys and a CMS.INCRBY, WAIT 1 1000 answers 1 on
           each, rows equal across the pair and golden, the replica reads
           every key back; phase 18's three-node fleet cut to one slot
           holding a config-1 filter and a CMS, migrated A -> B (DUMPs
           byte-equal, every key back), one rebalancer tick and one doctor
           sweep (0 findings).  The witness must be active, report no
           cycle or blocking call, and have acquired every name of
           P19_NAMES; no op degraded.  (19b) ``python -m
           redisson_tpu_torch.analysis redisson_tpu_torch/ --runtime-edges``
           with the child's export exits 0; the catalog, static and
           runtime edges and the runtime edges the static pass lacks.
           (19c) config 1's armed add keys/s beside the same shape
           unarmed and phase 2's rate (not gated); with the witness off,
           sampled named sites hold the raw threading lock.  K1 launches
           in phase 19 (19a) must be more than 0

  phase 20 the sharded executor and the mesh: one client at
           use_gpu_sketch(num_shards=8, device_indices=[0]), eight logical
           shards of every pool in one placement on the card; its nodes
           group lists 8 nodes naming the card.
           (20a) config 4: phase 3's plan (1000 tenants x Bloom(10,000,
           1%), 4 threads, add / contains / mixed of 256 keys) through the
           per-op path: every result and tenant row equal golden, every
           shard took ops and rtpu_shard_ops sums to the ops sent; ops/s
           beside phase 3's one-shard rate.  (20b) config 1 (2**20 keys at
           1M / 1%) then set_replicated(): the 8 replica rows, one per
           shard, equal the golden bitmap; contains of every loaded key
           rotating over the replicas, 131,072 outside keys equal golden
           and the FPP within 3 sigma of 1.255%.  (20c) config 3
           m-sharded: two 2**30-bit BitSets split by words over the
           shards, 8 x 2**21 alternating set/get, a set_range and a
           clear_range across shard boundaries, cardinality, length and
           bitpos(0/1), then OR, XOR, AND and NOT between the two rows:
           every result, row and scalar equal golden.  (20d) config 2:
           PFADD of 2**21 keys into each of 4 HLLs on 4 shards, PFMERGE
           across them: registers = golden, merged = the max, count() =
           the Ertl estimate.  (20e) config 5 on 8 CMS(5, 65536) tenants,
           one per shard: 2**20 zipf(1.2) events (**cut**) through
           add_all_seq in 32,768-event calls, which takes the whole-batch
           path while sharded: estimates and tables equal golden,
           CMS.MERGE across shards = the uint32 sum, and no K1 launch in
           20a-20e.  (20f) change_topology(4) while a writer adds: every
           acked key present, the writer's row = golden, every other row
           as before the swap; a 4-shard snapshot restored into a fresh
           1-shard client with every row equal; change_topology(1), then
           add_all_seq of 2**16 events on the carried CMS launches K1,
           estimates and table = golden_seq from the carried table.
           K1 launches in phase 20 (20f) must be more than 0
  phase 21 shards on several placements and in several processes.  (21a)
           one client at 8 shards on 4 placements (cuda:1, 2, 3, 0 on a
           machine with four cards; otherwise four placements on the one
           card, the device enumeration replaced): 20b-20e's streams again,
           every result and row equal golden and every row byte-equal to
           phase 20's one-placement client, rtpu_shard_ops per shard equal
           to its; BITOP between BitSets on different placements; then
           20f (change_topology(8 -> 4) under a writer, a 1-shard restore,
           change_topology(1)) and K1 on the carried CMS on the slice's
           first device, equal to golden_seq.  (21b) two children of this
           script (``--p21-child``) join one torch.distributed group on
           127.0.0.1 (gloo on one card, nccl with a card each), 4 of 8
           global shards each, and run in lockstep config 1 (2**20 keys,
           count()), config 2 (2**21 keys), config 3 (8 x 2**21 sets on a
           2**30-bit BitSet, cardinality()), a PFMERGE, a BITOP and a
           CMS.MERGE between rows of both processes, and a snapshot; a
           one-process client on 21a's placements runs the same stream
           meanwhile and is held to golden.  Both children's answers equal
           each other's and the one-process client's, both snapshots hold
           its pool arrays byte for byte; a child past its deadline kills
           both.  K1 launches in phase 21 (21a) must be more than 0

  phase 22 the pre-hashed Bloom path and the host sketch engine.  (22a)
           config 1 (1,000,000 insertions at 1%: m = 9,585,059, k = 7)
           through the engine's bloom_add / bloom_contains with H1, H2
           the host murmur halves of LongCodec keys 0 .. 2**20 - 1, in
           calls of 2**18, in two arms on fresh clients: exact (coalesced,
           the host-hashed bloom_mixed) and fast (exact_add_semantics
           False, coalesce False: bloom_add_fast_st / bloom_contains_st).
           Every add flag equals golden (sequential flags for the exact
           arm, flags against the state before each call for the fast
           one), every contains of 2**20 keys from [0, 2**21) equals
           golden, the row equals phase 2's encoded-path row byte for
           byte, the FPP over 131,072 outside keys sits within 3 sigma of
           1.255%, no op degraded; add and contains keys/s of both arms
           beside phase 2's.  (22b) the same calls on phase 20's 8-shard
           client at 2**18 keys, both arms: flags sequential, rows equal
           golden.  (22c) the host engine (use_host_sketch) on this
           machine's host in bench.py's measure_host_baseline shape:
           try_init(1_000_000, 0.01), add_all of 2**18 keys, 8 x
           contains_each of 65,536 keys drawn with default_rng(0) from
           [0, 2**19) (drawn before the timed loop); every flag equals the
           card client's on the same sequence; one small HLL, BitSet and
           CMS (add_all_seq: K1 on the card) answer alike on both engines;
           a DUMP of each object from each engine RESTOREs into the other
           and answers alike; host-engine contains keys/s beside the
           card's.  K1 launches in phase 22 (22c) must be more than 0

Every failed check raises, so the script exits non-zero.  Without a CUDA
device it exits with code 2 before printing any result.  The line before
the last is nvidia-smi's name and power limit; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py [--seed N] [--parent-k1 SOURCE]

``--parent-k1`` builds another version of ``csrc/cms_seq.cu`` (one with
the launch interface of the one-warp-per-row kernel) and times it beside
K1 in turns: parent, K1, K1, parent.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3 rate of one H100 SXM (NVIDIA data sheet)


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls queued behind a
    sleep kernel, so that the host's time to enqueue them is hidden (a call
    of K1's wrapper costs the host more than the kernel costs the card)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 4
        check(cycles <= 1 << 34, "the host never got ahead of the card")


def zipf_keys(rng, n: int, n_keys: int = 100_000) -> np.ndarray:
    return (rng.zipf(1.2, size=n) % n_keys).astype(np.uint64)


# -- phase 1: K1 against its plain version -----------------------------------

# Shapes K1 is held at besides the main path's: (name, d, w, B, stream,
# pool words before the table).
K1_EDGES = [
    ("one_op", 5, 1 << 16, 1, "zipf", 0),
    ("33_ops", 5, 1 << 16, 33, "zipf", 0),
    ("ragged_last_tile", 3, 10_007, 5000, "zipf", 0),
    ("one_key", 5, 1 << 16, 1 << 15, "one_key", 0),
    ("uniform", 5, 1 << 16, 1 << 15, "uniform", 0),
    ("weights_wrap", 5, 1 << 16, 1 << 15, "wrap", 0),
    ("pool_view", 5, 1 << 16, 1 << 15, "zipf", 5 * (1 << 16) * 4 + 128),
    ("8_mib", 2, 1 << 20, 1 << 15, "zipf", 0),
]


def k1_inputs(rng, d: int, w: int, B: int, stream: str):
    """Murmur-hashed op columns of a key stream, weights and a table."""
    from redisson_tpu_torch.utils import hashing

    if stream == "one_key":
        keys = np.full(B, 12345, np.uint64)
    elif stream == "uniform":
        keys = rng.integers(0, 1 << 40, B).astype(np.uint64)
    else:
        keys = zipf_keys(rng, B)
    blocks, lengths = hashing.encode_uint64_batch(keys)
    h1w, h2w = hashing.km_reduce_mod(*hashing.hash128_np(blocks, lengths), w)
    wt = (rng.random(B) < 0.9).astype(np.uint32)  # weight 1, some 0 (pure estimates)
    table = rng.integers(0, 1 << 16, d * w).astype(np.uint32)
    if stream == "wrap":  # counters and weights past 2**31: unsigned wrap and min
        wt = rng.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
        table = rng.integers(0, 1 << 32, d * w, dtype=np.uint64).astype(np.uint32)
    return table, h1w, h2w, wt


def k1_check(rng, dev, d, w, B, stream, before_words) -> int:
    """K1 vs its plain version and golden_seq on one shape, the table a view
    into a pool whose other words must not change.  Returns the max abs
    error (0, or the check fails)."""
    from redisson_tpu_torch.ops import cms_seq

    table0, h1w, h2w, wt = k1_inputs(rng, d, w, B, stream)
    pool = rng.integers(0, 1 << 32, before_words + d * w + 96, dtype=np.uint64)
    pool = pool.astype(np.uint32)
    pool[before_words : before_words + d * w] = table0
    view = slice(before_words, before_words + d * w)

    def cols():
        return [torch.from_numpy(a.view(np.int32).copy()).to(dev)
                for a in (pool, h1w, h2w, wt)]

    k_pool, *k_ops = cols()
    k_est = cms_seq.cms_update_estimate_seq(k_pool[view], *k_ops, d=d, w=w)
    p_pool, *p_ops = cols()
    p_est = cms_seq.cms_seq_plain(p_pool[view], *p_ops, d=d, w=w)
    torch.cuda.synchronize()
    err = max(int((k_pool.long() - p_pool.long()).abs().max()),
              int((k_est.long() - p_est.long()).abs().max()))
    check(torch.equal(k_pool, p_pool) and torch.equal(k_est, p_est),
          f"K1 disagrees with its plain version at d={d} w={w} B={B} {stream} "
          f"(max abs err {err})")
    with np.errstate(over="ignore"):  # golden_seq wraps mod 2**32
        g_table, g_est = cms_seq.golden_seq(table0.reshape(d, w), h1w, h2w, wt, d=d, w=w)
    k_pool = k_pool.cpu().numpy().view(np.uint32)
    check(np.array_equal(k_pool[view], g_table.reshape(-1))
          and np.array_equal(k_est.cpu().numpy().view(np.uint32), g_est),
          f"K1 disagrees with golden_seq at d={d} w={w} B={B} {stream}")
    return err


def load_parent_k1(source: str):
    """An earlier K1 with the one-warp-per-row launch interface, built from
    a copy of its source, for timing beside the current kernel.  Returns
    launch(table, h1, h2, wt, d=, w=)."""
    import ctypes
    from pathlib import Path

    from redisson_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "parent_cms_seq.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(Path(source).resolve())], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cms_seq_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.cms_seq_launch.restype = i

    def launch(table, h1, h2, wt, *, d, w):
        est = torch.full((h1.shape[0],), -1, dtype=torch.int32, device=table.device)
        rc = lib.cms_seq_launch(table.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                                wt.data_ptr(), est.data_ptr(), h1.shape[0], d, w,
                                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"parent K1 launch failed: CUDA error {rc}")
        return est

    return launch


def phase_k1(rng, dev, parent_source=None) -> dict:
    from redisson_tpu_torch.ops import cms_seq

    d, w, B = 5, 1 << 16, 1 << 15
    err = k1_check(rng, dev, d, w, B, "zipf", 0)
    for _, *shape in K1_EDGES:
        err = max(err, k1_check(rng, dev, *shape))
    parent = load_parent_k1(parent_source) if parent_source else None

    ms, plain_ms, parent_ms, call_ms = {}, {}, {}, None
    for stream in ("zipf", "uniform", "one_key"):
        cols = [torch.from_numpy(a.view(np.int32).copy()).to(dev)
                for a in k1_inputs(rng, d, w, B, stream)]

        def new():
            return cms_seq.cms_update_estimate_seq(*cols, d=d, w=w)

        if parent is None:
            ms[stream] = device_time_ms(new, 50)
        else:  # in turns: parent, new, new, parent
            t = [device_time_ms(f, 50) for f in (lambda: parent(*cols, d=d, w=w),
                                               new, new,
                                               lambda: parent(*cols, d=d, w=w))]
            ms[stream], parent_ms[stream] = t[1:3], [t[0], t[3]]
            check(torch.equal(parent(*[c.clone() for c in cols], d=d, w=w),
                              cms_seq.cms_update_estimate_seq(
                                  *[c.clone() for c in cols], d=d, w=w)),
                  f"parent K1 and K1 disagree on the {stream} stream")
        plain_ms[stream] = cuda_time_ms(
            lambda: cms_seq.cms_seq_plain(*cols, d=d, w=w), 20)
        if stream == "zipf":  # back-to-back calls, paced by the host
            call_ms = cuda_time_ms(new, 50)
    # Least time for the same work: the table read and written once, the
    # three op columns read once, the estimates written once.
    nbytes = 2 * d * w * 4 + 3 * B * 4 + B * 4
    bound_ms = nbytes / H100_BYTES_PER_S * 1e3
    zipf_ms = ms["zipf"] if parent is None else sum(ms["zipf"]) / 2
    log({"phase": 1, "kernel": "cms_seq", "d": d, "w": w, "B": B,
         "plan": cms_seq._plan(d, w, torch.cuda.get_device_properties(dev)
                               .multi_processor_count)._asdict(),
         "edge_shapes": [e[0] for e in K1_EDGES],
         "bit_identical_to_plain": True, "matches_golden_seq": True,
         "ms_by_stream": ms, "parent_ms_by_stream": parent_ms or None,
         "plain_ms_by_stream": plain_ms, "host_paced_call_ms": call_ms,
         "bound_ms": bound_ms,
         "bytes": nbytes, "compare_launches": cms_seq.LAUNCHES})
    return {"name": "cms_seq", "route": "cuda",
            "source": "redisson_tpu_torch/csrc/cms_seq.cu",
            "replaces": "redisson_tpu/ops/pallas_cms.py:123",
            "max_abs_err": err, "ms": zipf_ms, "ms_by_stream": ms,
            "plain_ms": plain_ms["zipf"], "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


# -- phase 2: config 1, Bloom at 1M keys / 1% FPP -----------------------------


def golden_bloom(bf, keys: np.ndarray):
    from redisson_tpu_torch.ops import golden
    from redisson_tpu_torch.utils import hashing

    m, k = bf.get_size(), bf.get_hash_iterations()
    g = golden.GoldenBloomFilter(m, k)
    h1m, h2m = hashing.km_reduce_mod(*hashing.hash128_np(*hashing.encode_uint64_batch(keys)), m)
    g.bits[g._indexes(h1m, h2m).reshape(-1)] = True  # setting bits is order-free
    return g


def golden_contains(g, keys: np.ndarray) -> np.ndarray:
    from redisson_tpu_torch.utils import hashing

    h1m, h2m = hashing.km_reduce_mod(
        *hashing.hash128_np(*hashing.encode_uint64_batch(keys)), g.size)
    return g.contains_hashed(h1m, h2m)


def tenant_row(client, name: str) -> np.ndarray:
    eng = client._engine
    eng._drain()
    e = eng.registry.lookup(name)
    return eng.executor.read_row(e.pool, e.row)


def phase_bloom(client, rng, card: str):
    bf = client.get_bloom_filter("cfg1")
    check(bf.try_init(1_000_000, 0.01), "try_init refused")
    n_load, chunk = 1 << 20, 1 << 18
    # Warm-up on a filter of the same size class, so the timed adds do not
    # pay the process's first CUDA launches of each op.
    warm = client.get_bloom_filter("cfg1-warmup")
    check(warm.try_init(1_000_000, 0.01), "try_init refused")
    warm.add_all_async(np.arange(chunk, dtype=np.uint64)).result()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adds = [bf.add_all_async(np.arange(i * chunk, (i + 1) * chunk, dtype=np.uint64))
            for i in range(n_load // chunk)]
    n_added = sum(int(np.sum(a.result())) for a in adds)
    add_s = time.perf_counter() - t0
    check(0.97 * n_load <= n_added <= n_load, f"added {n_added} of {n_load}")

    g = golden_bloom(bf, np.arange(n_load, dtype=np.uint64))
    words = tenant_row(client, "cfg1")
    gbits = np.zeros(words.shape[0] * 32, bool)
    gbits[: g.size] = g.bits
    check(np.array_equal(words, np.packbits(gbits, bitorder="little").view(np.uint32)),
          "bloom tenant row differs from the golden bitmap")

    batches = [rng.integers(0, 2 * n_load, 1 << 20).astype(np.uint64) for _ in range(4)]
    bf.contains_many(batches[:1])  # warm-up pass
    t0 = time.perf_counter()
    hits = bf.contains_many(batches)
    contains_s = time.perf_counter() - t0
    for b, h in zip(batches, hits):
        check(np.array_equal(h, golden_contains(g, b)), "contains differs from golden")
    outside = rng.integers(3 * n_load, 8 * n_load, 1 << 17).astype(np.uint64)
    fp = bf.contains_each(outside)
    check(np.array_equal(fp, golden_contains(g, outside)), "contains_each differs from golden")
    fpp = float(fp.mean())
    # The load is 2**20 keys, 4.9% past the design point of 1M, so the
    # expected rate is (1 - e^(-k n / m))^k = 1.26%, not 1%.  The measured
    # rate must sit within 3 binomial sigmas of it (and equals the golden
    # model's exactly, checked above).
    m, k = bf.get_size(), bf.get_hash_iterations()
    p_theory = (1.0 - np.exp(-k * n_load / m)) ** k
    sigma = np.sqrt(p_theory * (1.0 - p_theory) / len(outside))
    check(abs(fpp - p_theory) <= 3 * sigma,
          f"measured FPP {fpp} vs expected {p_theory} +- {3 * sigma}")
    RATES.update(add_ops_per_s=n_load / add_s,
                 contains_ops_per_s=sum(map(len, batches)) / contains_s)
    log({"phase": 2, "config": "bloom 1M keys 1% FPP", "added": n_added,
         "add_ops_per_s": n_load / add_s,
         "contains_ops_per_s": sum(map(len, batches)) / contains_s,
         "fpp": fpp, "fpp_expected": p_theory, "fpp_3sigma": 3 * sigma,
         "row_equals_golden": True, "card": card})
    return g


# -- phase 3: multi-tenant coalesced runs -------------------------------------


def phase_tenants(client, rng, phase=3, runs=True) -> float:
    """Config 4's mixed traffic.  ``runs``: the executor has the
    run-length path, and a spy shows flushes carrying several runs; a
    sharded engine takes the per-op path instead, and every tenant row is
    held against its golden bitmap too."""
    from redisson_tpu_torch.ops import golden

    n_tenants, n_threads, per_op = 1000, 4, 256
    names = [f"t{i}" for i in range(n_tenants)]
    for name in names:
        check(client.get_bloom_filter(name).try_init(10_000, 0.01), "try_init refused")
    plans = {
        name: [(kind, rng.integers(0, 4000, per_op).astype(np.uint64),
                rng.random(per_op) < 0.5)
               for kind in ("add", "contains", "mixed", "add", "contains")]
        for name in names
    }
    ex = client._engine.executor
    runs_per_flush = []
    orig = ex.bloom_mixed_keys_runs

    def spy(pool, k, blocks, lengths, run_rows, *rest):
        runs_per_flush.append(len(run_rows))
        return orig(pool, k, blocks, lengths, run_rows, *rest)

    if runs:
        ex.bloom_mixed_keys_runs = spy
    results: dict = {}

    def worker(t):
        mine = names[t::n_threads]
        futs = {}
        for step in range(5):  # each tenant's ops are issued in order
            for name in mine:
                bf = client.get_bloom_filter(name)
                kind, keys, flags = plans[name][step]
                if kind == "add":
                    f = bf.add_all_async(keys)
                elif kind == "contains":
                    f = bf.contains_all_async(keys)
                else:
                    f = bf.mixed_async(keys, flags)
                futs.setdefault(name, []).append(f)
        for name, fs in futs.items():
            results[name] = [f.result() for f in fs]

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not any(th.is_alive() for th in threads), "tenant workers hung")
    wall_s = time.perf_counter() - t0
    if runs:
        del ex.bloom_mixed_keys_runs
        check(max(runs_per_flush) > 1, "no flush carried more than one run")

    from redisson_tpu_torch.utils import hashing

    bf0 = client.get_bloom_filter(names[0])
    m, k = bf0.get_size(), bf0.get_hash_iterations()
    for name in names:
        g = golden.GoldenBloomFilter(m, k)
        for (kind, keys, flags), got in zip(plans[name], results[name]):
            h1m, h2m = hashing.km_reduce_mod(
                *hashing.hash128_np(*hashing.encode_uint64_batch(keys)), m)
            if kind == "add":
                want = g.add_hashed(h1m, h2m)
            elif kind == "contains":
                want = g.contains_hashed(h1m, h2m)
            else:  # one op at a time, in order
                want = np.array([
                    g.add_hashed(h1m[i:i + 1], h2m[i:i + 1])[0] if f
                    else g.contains_hashed(h1m[i:i + 1], h2m[i:i + 1])[0]
                    for i, f in enumerate(flags)
                ])
            check(np.array_equal(got, want), f"tenant {name} {kind} differs from golden")
        if not runs:
            row = tenant_row(client, name)
            gbits = np.zeros(row.shape[0] * 32, bool)
            gbits[: g.size] = g.bits
            check(np.array_equal(row, np.packbits(gbits, bitorder="little").view(np.uint32)),
                  f"tenant {name}'s row differs from the golden bitmap")
    ops_per_s = n_tenants * 5 * per_op / wall_s
    out = {"phase": phase, "tenants": n_tenants, "threads": n_threads,
           "ops": n_tenants * 5 * per_op, "ops_per_s": ops_per_s,
           "results_equal_golden": True}
    if runs:
        out.update(flushes=len(runs_per_flush), max_runs_per_flush=max(runs_per_flush))
    else:
        out["rows_equal_golden"] = True
    log(out)
    return ops_per_s


# -- phase 4: config 5, CMS streaming top-K -----------------------------------


def phase_cms(client, rng, card: str) -> None:
    from redisson_tpu_torch.ops import cms_seq, golden
    from redisson_tpu_torch.utils import hashing

    d, w, n_events = 5, 1 << 16, 2_000_000
    cms = client.get_count_min_sketch("cms")
    check(cms.try_init(d, w, track_top_k=20), "try_init refused")
    events = zipf_keys(rng, n_events)
    before = cms_seq.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = cms.add_all_seq(events)
    dt = time.perf_counter() - t0
    launches = cms_seq.LAUNCHES - before
    chunk = client._engine._SEQ_CHUNK
    check(launches == -(-n_events // chunk), f"{launches} K1 launches")

    h1w, h2w = hashing.km_reduce_mod(
        *hashing.hash128_np(*hashing.encode_uint64_batch(events)), w)
    g = golden.GoldenCountMinSketch(d, w)
    g.add_hashed(h1w, h2w)
    row = tenant_row(client, "cms")
    check(np.array_equal(row[: d * w].reshape(d, w), g.counts), "CMS table differs from golden")
    _, g_est = cms_seq.golden_seq(np.zeros((d, w), np.uint32), h1w[:chunk], h2w[:chunk],
                                  np.ones(chunk, np.uint32), d=d, w=w)
    check(np.array_equal(est[:chunk], g_est), "first chunk differs from golden_seq")
    true_top = set(np.argsort(-np.bincount(events.astype(np.int64)))[:10].tolist())
    got = {int(key) for key, _ in cms.top_k(10)}
    recall = len(got & true_top) / 10.0
    check(recall == 1.0, f"top-10 recall {recall}")
    check(cms.total_count() == n_events, "total count")
    log({"phase": 4, "config": "cms 5x65536 streaming top-K", "events": n_events,
         "events_per_s": n_events / dt, "k1_launches": launches,
         "table_equals_golden": True, "first_chunk_equals_golden_seq": True,
         "top10_recall": recall, "card": card})


# -- phase 5: config 2, HyperLogLog PFADD at 10M cardinality ------------------


def hll_lanes(keys: np.ndarray):
    """Host murmur lanes (c0, c1, c2) of LongCodec-encoded keys."""
    from redisson_tpu_torch.utils import hashing

    return hashing.murmur3_x86_128(*hashing.encode_uint64_batch(keys))[:3]


def golden_hll_changed(regs: np.ndarray, c0, c1, c2) -> np.ndarray:
    """One op at a time: op j changed iff its rank beat its register.
    Updates ``regs`` in place."""
    from redisson_tpu_torch.ops import golden

    idx, rank = golden.hll_index_rank(c0, c1, c2)
    out = np.zeros(len(c0), bool)
    for j, (i, r) in enumerate(zip(idx.tolist(), rank.tolist())):
        if r > regs[i]:
            out[j] = True
            regs[i] = r
    return out


def phase_hll(client, rng, card: str) -> None:
    from redisson_tpu_torch.ops import golden

    B, iters = 1 << 21, 4
    h = client.get_hyper_log_log("cfg2")
    check(h.add_all_async(np.arange(B, dtype=np.uint64)).result(), "warm-up changed nothing")
    batches = [np.arange((i + 1) * B, (i + 2) * B, dtype=np.uint64) for i in range(iters)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with client.defer_fetch():
        futs = [h.add_all_async(b) for b in batches]
    changed = client.collect(futs)
    add_s = time.perf_counter() - t0
    check(all(changed), f"a PFADD batch of new keys changed nothing: {changed}")
    n = (iters + 1) * B
    t0 = time.perf_counter()
    est = h.count()
    count_ms = (time.perf_counter() - t0) * 1e3

    g = golden.GoldenHyperLogLog()
    for i in range(iters + 1):
        g.add_hashed(*hll_lanes(np.arange(i * B, (i + 1) * B, dtype=np.uint64)))
    regs = tenant_row(client, "cfg2")
    check(np.array_equal(regs, g.regs), "HLL registers differ from the golden model")
    want = int(round(golden.ertl_estimate(np.bincount(regs, minlength=golden.HLL_Q + 2))))
    check(est == want == g.count(), f"count() {est} vs Ertl {want}")
    check(abs(est - n) / n < 0.05, f"count() {est} vs {n} distinct keys")

    # Per-op flags: a chunk with repeats on a tenant already holding keys.
    f = client.get_hyper_log_log("cfg2-flags")
    f.add_all(np.arange(1 << 15, dtype=np.uint64))
    chunk = rng.integers(0, 1 << 17, 1 << 16).astype(np.uint64)
    eng = client._engine
    e = eng.registry.lookup("cfg2-flags")
    g_regs = tenant_row(client, "cfg2-flags")
    c0, c1, c2 = hll_lanes(chunk)
    flags = eng.executor.hll_add_changed(
        e.pool, np.full(len(chunk), e.row, np.int32), c0, c1, c2).result()
    want_flags = golden_hll_changed(g_regs, c0, c1, c2)
    check(np.array_equal(flags, want_flags), "per-op changed flags differ from golden")
    check(np.array_equal(tenant_row(client, "cfg2-flags"), g_regs), "flag chunk registers differ")
    check(0 < want_flags.sum() < len(chunk), "the flag chunk does not exercise both outcomes")
    log({"phase": 5, "config": "hll pfadd 10M cardinality", "keys": n,
         "pfadd_ops_per_s": iters * B / add_s, "count": est,
         "count_rel_err": (est - n) / n, "count_ms": count_ms,
         "registers_equal_golden": True, "flag_chunk_ops": len(chunk),
         "flag_chunk_changed": int(want_flags.sum()), "flags_equal_golden": True,
         "card": card})


# -- phase 6: config 3, a 2**30-bit BitSet -------------------------------------

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def golden_set(bitmap: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """SETBIT of a batch on a uint32 word bitmap, one op at a time: the
    previous bit per op (1 after an earlier set of the same index)."""
    w, b = idx >> 5, (idx & 31).astype(np.uint32)
    prev = ((bitmap[w] >> b) & 1).astype(bool)
    first = np.zeros(len(idx), bool)
    first[np.unique(idx, return_index=True)[1]] = True
    np.bitwise_or.at(bitmap, w, np.uint32(1) << b)
    return prev | ~first


def golden_get(bitmap: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return ((bitmap[idx >> 5] >> (idx & 31).astype(np.uint32)) & 1).astype(bool)


def phase_bitset(client, rng, card: str) -> None:
    nbits, B, iters = 1 << 30, 1 << 21, 8
    bitmap = np.zeros(nbits // 32, np.uint32)
    bs = client.get_bit_set("cfg3")
    check(not bs.set(nbits - 1), "set(2**30 - 1) found the bit set")
    golden_set(bitmap, np.array([nbits - 1]))
    check(bs.size() == nbits, f"size {bs.size()}")
    # Warm-up: the first launches of each op at this batch size.
    warm = rng.integers(0, nbits, B).astype(np.uint32)
    check(np.array_equal(bs.set_many(warm), golden_set(bitmap, warm)), "warm-up set differs")
    warm = rng.integers(0, nbits, B).astype(np.uint32)
    check(np.array_equal(bs.get_many(warm), golden_get(bitmap, warm)), "warm-up get differs")
    idxs = [rng.integers(0, nbits, B).astype(np.uint32) for _ in range(iters)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with client.defer_fetch():
        futs = [bs.set_many_async(idx) if i % 2 == 0 else bs.get_many_async(idx)
                for i, idx in enumerate(idxs)]
    res = client.collect(futs)
    dt = time.perf_counter() - t0
    for i, (idx, got) in enumerate(zip(idxs, res)):
        want = golden_set(bitmap, idx) if i % 2 == 0 else golden_get(bitmap, idx)
        check(np.array_equal(got, want), f"batch {i} differs from the golden bitmap")
    check(np.array_equal(tenant_row(client, "cfg3"), bitmap), "row differs from the golden bitmap")
    card_want = int(_POPCOUNT8[bitmap.view(np.uint8)].sum(dtype=np.int64))
    last = int(np.flatnonzero(bitmap)[-1])
    length_want = last * 32 + int(bitmap[last]).bit_length()
    check(bs.cardinality() == card_want, f"cardinality {bs.cardinality()} vs {card_want}")
    check(bs.length() == length_want == nbits, f"length {bs.length()} vs {length_want}")
    log({"phase": 6, "config": "bitset 2**30 bits", "ops": iters * B,
         "ops_per_s": iters * B / dt, "cardinality": card_want,
         "results_equal_golden": True, "row_equals_golden": True, "card": card})


# -- phase 8: the keyspace lifecycle at full size ----------------------------------

_GETTERS = {"bloom": "get_bloom_filter", "hll": "get_hyper_log_log",
            "bitset": "get_bit_set", "cms": "get_count_min_sketch"}
# Executor methods that launch a coalesced segment: the batch's dispatches.
_DISPATCHES = ("bloom_mixed_keys_runs", "bloom_mixed_keys", "hll_add_changed",
               "cms_update_estimate", "cms_estimate", "bitset_mixed_runs", "bitset_mixed")


def row_view(client, name: str):
    """The tenant row of ``name`` as a view of its pool on the card."""
    from redisson_tpu_torch.ops import bitops

    e = client._engine.registry.lookup(name)
    return bitops.row_slice(e.pool.state, e.row, e.pool.row_units)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lifecycle_dump_restore(client) -> dict:
    """DUMP each config-sized object, RESTORE it under a new name: rows
    equal on the card, the re-dump equal to the dump, BUSYKEY refused."""
    times = {}
    for kind, name in (("bloom", "cfg1"), ("cms", "cms"), ("hll", "cfg2"), ("bitset", "cfg3")):
        get = getattr(client, _GETTERS[kind])
        blob, dump_s = timed(get(name).dump)
        restored = get(name + "-r")
        _, restore_s = timed(lambda: restored.restore(blob))
        check(torch.equal(row_view(client, name), row_view(client, name + "-r")),
              f"restored {kind} row differs from {name}'s on the card")
        check(restored.dump() == blob, f"re-dump of the restored {kind} differs")
        try:
            restored.restore(blob)
        except ValueError as e:
            check("BUSYKEY" in str(e), f"restore onto {name}-r: {e}")
        else:
            fail(f"restore onto the existing {name}-r without replace succeeded")
        times[kind] = {"bytes": len(blob), "dump_s": dump_s, "restore_s": restore_s}
    # The card's share of a dump: one D2H of the row.
    e = client._engine.registry.lookup("cfg3")
    _, times["bitset"]["row_d2h_s"] = timed(lambda: client._engine.executor.read_row(e.pool, e.row))
    return times


def lifecycle_cms(client, rng) -> None:
    """Merge a second zipf-fed CMS and, twice, one with every counter past
    2**31 into the restored copy (the row must equal the numpy uint32 sum,
    which wraps in every cell), then reset it (zero row, top-K
    configuration kept)."""
    from redisson_tpu_torch.interop import load_sketch_rows

    eng = client._engine
    d, w = 5, 1 << 16
    other = client.get_count_min_sketch("cms-b")
    check(other.try_init(d, w), "try_init refused")
    other.add_all(zipf_keys(rng, 1 << 20, n_keys=50_000))
    wrap = rng.integers(1 << 31, 1 << 32, d * w, dtype=np.uint64).astype(np.uint32)
    load_sketch_rows(client, "cms-wrap", "cms", {"depth": d, "width": w}, wrap)
    want = tenant_row(client, "cms-r")
    with np.errstate(over="ignore"):
        want += tenant_row(client, "cms-b")
        want += tenant_row(client, "cms-wrap")
        want += tenant_row(client, "cms-wrap")
    client.get_count_min_sketch("cms-r").merge("cms-b", "cms-wrap", "cms-wrap")
    got = tenant_row(client, "cms-r")
    check(np.array_equal(got, want), "merged CMS row differs from the numpy uint32 sum")
    check((got[: d * w] < wrap).mean() > 0.99, "the merge did not wrap past 2**32")
    k = eng.topk.track("cms-r")
    eng.cms_reset("cms-r")
    check(not row_view(client, "cms-r").any(), "reset left counters")
    check(k == 20 and eng.topk.track("cms-r") == k, "reset lost the top-K configuration")


def lifecycle_rename_ttl(client, n_load: int) -> float:
    """Rename the restored Bloom and expire the restored HLL; returns the
    seconds from expire(0.5) until is_exists() turned False."""
    bf = client.get_bloom_filter("cfg1-r")
    bf.rename("cfg1-renamed")
    check(bf.name == "cfg1-renamed", "rename did not repoint the handle")
    check(not client.get_bloom_filter("cfg1-r").is_exists(), "the old name survived rename")
    check(bf.contains_each(np.arange(n_load, dtype=np.uint64)).all(),
          "the renamed filter lost loaded keys")
    try:
        client.get_bloom_filter("no-such-filter").rename("elsewhere")
    except RuntimeError:
        pass
    else:
        fail("rename of a missing name succeeded")
    h = client.get_hyper_log_log("cfg2-r")
    e = client._engine.registry.lookup("cfg2-r")
    pool, row = e.pool, e.row
    t0 = time.perf_counter()
    check(h.expire(0.5), "expire refused")
    while h.is_exists():
        check(time.perf_counter() - t0 < 5.0, "the expired HLL still exists after 5 s")
        time.sleep(0.01)
    gone_s = time.perf_counter() - t0
    from redisson_tpu_torch.ops import bitops

    # The name is gone once the reaper detaches it; the row is zeroed and
    # then freed after that, under the dispatch lock: wait for the free.
    while row not in pool._free:
        check(time.perf_counter() - t0 < 5.0, "the expired HLL's row was not freed in 5 s")
        time.sleep(0.01)
    check(not bitops.row_slice(pool.state, row, pool.row_units).any(),
          "the expired HLL's row is not zero on the card")
    return gone_s


def cms_disjoint_keys(candidates: np.ndarray, n: int, d: int, w: int, used: set) -> np.ndarray:
    """The first ``n`` candidates whose d cells share no cell with each
    other or with ``used`` (updated in place)."""
    from redisson_tpu_torch.utils import hashing

    h1w, h2w = hashing.km_reduce_mod(
        *hashing.hash128_np(*hashing.encode_uint64_batch(candidates)), w)
    r = np.arange(d, dtype=np.uint64)
    cells = (h1w[:, None].astype(np.uint64) + r * h2w[:, None]) % np.uint64(w) + r * np.uint64(w)
    out = []
    for key, c in zip(candidates, cells.tolist()):
        if used.isdisjoint(c):
            used.update(c)
            out.append(key)
            if len(out) == n:
                return np.array(out, np.uint64)
    fail(f"only {len(out)} of {n} CMS keys with disjoint cells")


def lifecycle_batch(client, rng) -> dict:
    """One batch of sync-named calls over the four kinds against the same
    calls made directly on twin objects (both restored from one dump).
    A coalesced CMS launch returns batch-final estimates, so the batch's
    CMS keys (added once each, or only estimated) share no cell: then
    batch-final and one-call-at-a-time estimates are equal."""
    eng = client._engine
    sources = {"bloom": "cfg1", "hll": "cfg2", "cms": "cms", "bitset": "cfg3"}
    objs = {tag: {kind: f"b8-{kind}-{tag}" for kind in sources} for tag in ("batch", "twin")}
    for kind, src in sources.items():
        get = getattr(client, _GETTERS[kind])
        blob = get(src).dump()
        for tag in objs:
            get(objs[tag][kind]).restore(blob)
    used: set = set()
    cms_keys = cms_disjoint_keys(
        rng.integers(0, 1 << 40, 20_000).astype(np.uint64), 1180, 5, 1 << 16, used)
    cms_add, cms_est = cms_keys[:40], cms_keys[40:80]
    calls = []
    for i in range(40):
        key = int(rng.integers(1 << 40, 1 << 41))
        calls += [("bloom", "add", (key,)), ("bloom", "contains", (key,)),
                  ("bloom", "contains", (key + 1,)), ("hll", "add", (key,)),
                  ("cms", "add", (int(cms_add[i]), 3)), ("cms", "estimate", (int(cms_est[i]),)),
                  ("bitset", "set_many", (rng.integers(0, 1 << 30, 8).astype(np.uint32),)),
                  ("bitset", "get_many", (rng.integers(0, 1 << 30, 8).astype(np.uint32),))]
    keys = rng.integers(1 << 40, 1 << 41, 1000).astype(np.uint64)
    calls += [("bloom", "add_all", (keys[:500],)), ("bloom", "contains_all", (keys,)),
              ("bloom", "contains_each", (keys,)), ("hll", "add_all", (keys,)),
              ("cms", "add_all", (cms_keys[80:180],)),
              ("cms", "estimate_all", (cms_keys[180:],))]
    batch = client.create_batch()
    proxies = {k: getattr(batch, _GETTERS[k])(n) for k, n in objs["batch"].items()}
    for kind, meth, args in calls:
        getattr(proxies[kind], meth)(*args)
    ex = eng.executor
    dispatches = []

    def spy(name):
        orig = getattr(ex, name)

        def counted(*a, **kw):
            dispatches.append(name)
            return orig(*a, **kw)

        return counted

    for name in _DISPATCHES:
        setattr(ex, name, spy(name))
    try:
        res, execute_s = timed(lambda: batch.execute().get_responses())
    finally:
        for name in _DISPATCHES:
            delattr(ex, name)
    twins = {k: getattr(client, _GETTERS[k])(n) for k, n in objs["twin"].items()}
    check(len(res) == len(calls), f"{len(res)} responses for {len(calls)} calls")
    for (kind, meth, args), got in zip(calls, res):
        want = getattr(twins[kind], meth)(*args)
        same = (np.array_equal(got, want) if isinstance(want, np.ndarray)
                else type(got) is type(want) and got == want)
        check(same, f"batch {kind}.{meth} gave {got!r}, the direct call {want!r}")
    for kind in sources:
        check(torch.equal(row_view(client, objs["batch"][kind]),
                          row_view(client, objs["twin"][kind])),
              f"batch and twin {kind} rows differ")
    check(len(dispatches) < len(calls),
          f"{len(dispatches)} dispatches for {len(calls)} queued calls")
    for tag in objs:  # not part of the snapshot that follows
        for name in objs[tag].values():
            check(eng.delete(name), f"delete {name}")
    return {"calls": len(calls), "dispatches": len(dispatches), "execute_s": execute_s}


def lifecycle_snapshot(client, rng, seed: int) -> dict:
    """Snapshot the whole keyspace, restore it on create in a second client,
    hold every pool and the answers equal, then stream the same events
    into both CMSes (K1 runs on the restored one)."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.ops import cms_seq

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    snap_dir = tempfile.mkdtemp(prefix="phase8-snapshot-", dir=build)
    try:
        # The card's share of a snapshot: the D2H capture under the locks.
        _, capture_s = timed(client._engine._snapshot_capture)
        _, snapshot_s = timed(lambda: client.snapshot(snap_dir))
        snap_bytes = sum(os.path.getsize(os.path.join(snap_dir, f))
                         for f in os.listdir(snap_dir))
        cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch()
        cfg.snapshot_dir = snap_dir
        twin, restore_s = timed(lambda: rt.create(cfg))
        try:
            ex1, ex2 = client._engine.executor, twin._engine.executor
            pools1, pools2 = client._engine.registry.pools(), twin._engine.registry.pools()
            check([p.spec.key for p in pools1] == [p.spec.key for p in pools2],
                  "the restored client holds other pools")
            pool_bytes = 0
            for p1, p2 in zip(pools1, pools2):
                a, b = ex1.state_to_host(p1), ex2.state_to_host(p2)
                check(a.dtype == b.dtype and np.array_equal(a, b),
                      f"restored pool {p1.spec.key} differs")
                pool_bytes += a.nbytes
            check(sorted(client._engine.names()) == sorted(twin._engine.names()),
                  "the restored keyspace holds other names")
            probe = np.random.default_rng(seed + 8).integers(
                1 << 22, 1 << 24, 1 << 17).astype(np.uint64)
            for c_name, kind, fn in (
                ("cfg1", "bloom", lambda o: o.contains_each(probe).tolist()),
                ("cfg1-renamed", "bloom", lambda o: o.count()),
                ("cfg2", "hll", lambda o: o.count()),
                ("cfg3", "bitset", lambda o: (o.cardinality(), o.length())),
                ("cms", "cms", lambda o: o.top_k(10)),
            ):
                a = fn(getattr(client, _GETTERS[kind])(c_name))
                b = fn(getattr(twin, _GETTERS[kind])(c_name))
                check(a == b, f"{kind} {c_name} answers differ after restore")
            events = zipf_keys(rng, 1 << 18)
            before = cms_seq.LAUNCHES
            est2 = twin.get_count_min_sketch("cms").add_all_seq(events)
            restored_launches = cms_seq.LAUNCHES - before
            check(restored_launches > 0, "K1 never launched on the restored CMS")
            est1 = client.get_count_min_sketch("cms").add_all_seq(events)
            check(np.array_equal(est1, est2), "streamed estimates differ after restore")
            check(torch.equal(row_view(client, "cms"), row_view(twin, "cms")),
                  "CMS tables differ after the same stream")
        finally:
            # Its config names the directory: shutdown writes the final snapshot.
            _, shutdown_s = timed(twin.shutdown)
        check(os.path.exists(os.path.join(snap_dir, "sketch_meta.json")),
              "no snapshot after shutdown")
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    return {"snapshot_s": snapshot_s, "capture_s": capture_s,
            "snapshot_bytes": snap_bytes, "pool_bytes": pool_bytes,
            "restore_on_create_s": restore_s, "shutdown_snapshot_s": shutdown_s,
            "k1_launches_on_restored": restored_launches}


def phase_lifecycle(client, rng, g, seed: int, card: str) -> None:
    from redisson_tpu_torch.executor.torch_executor import bloom_count_from_bitcount

    n_load = 1 << 20
    count = client.get_bloom_filter("cfg1").count()
    want = bloom_count_from_bitcount(int(g.bits.sum()), g.size, g.hash_iterations)
    check(count == want, f"count() {count} vs {want} from the golden bitmap")
    check(abs(count - n_load) / n_load < 0.05, f"count() {count} vs {n_load} keys")
    dumps = lifecycle_dump_restore(client)
    lifecycle_cms(client, rng)
    ttl_s = lifecycle_rename_ttl(client, n_load)
    batch = lifecycle_batch(client, rng)
    snap = lifecycle_snapshot(client, rng, seed)
    log({"phase": 8, "bloom_count": count, "bloom_count_rel_err": (count - n_load) / n_load,
         "dump_restore": dumps, "bitset_row_dump_s": dumps["bitset"]["dump_s"],
         "bitset_row_restore_s": dumps["bitset"]["restore_s"],
         "bitset_row_d2h_s": dumps["bitset"]["row_d2h_s"], "ttl_gone_s": ttl_s,
         "batch": batch, **snap, "card": card})


# -- phase 7: interleaved opcodes from 4 threads through the coalescer ------------


def phase_interleaved(rng) -> None:
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.ops import golden

    n_threads, per_thread, nbits = 4, 16, 4096
    # A long flush window: a burst queues whole before its first flush, so
    # one launch carries every chunk of the burst as a run.
    client = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        batch_window_us=2_000_000))
    try:
        eng = client._engine
        names = [f"p7-{i}" for i in range(n_threads * per_thread)]
        for name in names:
            eng.bitset_ensure(name, nbits)
        ex = eng.executor
        runs = {"runs": [], "per_op": []}
        orig_runs, orig_ops = ex.bitset_mixed_runs, ex.bitset_mixed

        def spy_runs(pool, idx, run_rows, *rest):
            runs["runs"].append(len(run_rows))
            return orig_runs(pool, idx, run_rows, *rest)

        def spy_ops(pool, rows, *rest):
            runs["per_op"].append(len(rows))
            return orig_ops(pool, rows, *rest)

        ex.bitset_mixed_runs, ex.bitset_mixed = spy_runs, spy_ops
        plans = {}  # name -> [(kind, idx or keys)] per burst
        for burst_rounds in (24, 4):
            for name in names:
                plans.setdefault(name, []).append([
                    (int(rng.integers(0, 5)),
                     rng.integers(0, nbits, int(rng.integers(1, 48))).astype(np.uint32))
                    for _ in range(burst_rounds)])
        results: dict = {}
        barrier = threading.Barrier(n_threads)

        def worker(t):
            mine = names[t * per_thread : (t + 1) * per_thread]
            for burst in range(2):
                futs = {name: [] for name in mine}
                for step in range(len(plans[mine[0]][burst])):
                    for name in mine:
                        kind, idx = plans[name][burst][step]
                        if kind == 0:
                            f = eng.bitset_set(name, idx, True)
                        elif kind == 1:
                            f = eng.bitset_set(name, idx, False)
                        elif kind == 2:
                            f = eng.bitset_flip(name, idx)
                        elif kind == 3:
                            f = eng.bitset_get(name, idx)
                        else:
                            f = client.get_hyper_log_log("h" + name).add_all_async(
                                idx.astype(np.uint64))
                        futs[name].append(f)
                barrier.wait(timeout=600)  # the burst is queued whole
                for name in mine:
                    results.setdefault(name, []).extend(f.result() for f in futs[name])

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        check(not any(th.is_alive() for th in threads), "phase 7 workers hung")
        wall_s = time.perf_counter() - t0
        del ex.bitset_mixed_runs, ex.bitset_mixed
        n_ops = 0
        for name in names:
            bits = np.zeros(nbits, bool)
            regs = golden.GoldenHyperLogLog()
            ops = [op for burst in plans[name] for op in burst]
            for (kind, idx), got in zip(ops, results[name]):
                n_ops += len(idx)
                if kind == 4:
                    before = regs.regs.copy()
                    regs.add_hashed(*hll_lanes(idx.astype(np.uint64)))
                    check(got == bool(np.any(regs.regs != before)), f"{name} PFADD differs")
                    continue
                want = np.empty(len(idx), bool)
                for j, i in enumerate(idx):
                    want[j] = bits[i]
                    if kind < 3:
                        bits[i] = (kind == 0) if kind < 2 else not bits[i]
                check(np.array_equal(got, want), f"{name} opcode {kind} differs from golden")
            check(np.array_equal(tenant_row(client, name),
                                 np.packbits(bits, bitorder="little").view(np.uint32)),
                  f"{name} row differs from golden")
        check_healthy(client, 7)
        check(max(runs["per_op"], default=0) > 1024, f"no flush of more than 1024 runs: {runs}")
        check(max(runs["runs"], default=0) > 1, f"no multi-run flush: {runs}")
        log({"phase": 7, "threads": n_threads, "bitsets": len(names), "ops": n_ops,
             "ops_per_s": n_ops / wall_s, "runs_flushes": runs["runs"],
             "per_op_flush_ops": runs["per_op"], "results_equal_golden": True})
    finally:
        client.shutdown()


# -- phase 9: failure and overload on the card ----------------------------------

# Knobs of phase 9's clients: a breaker opens on the second consecutive
# failure, retries and backoffs take milliseconds.  The open window must
# outlast seeding the 2**30-bit mirror (a 128 MiB D2H and a decode to 1 GiB
# of bools, half a second or more): the recovery probe is a row read, so
# under a fault that hits only the kind's methods it succeeds, and a
# breaker that closes in the middle of a seed discards it.
P9_KNOBS = {"breaker_failure_threshold": 2, "breaker_open_ms": 2000,
            "retry_max_backoff_ms": 20}
P9_RETRY = {"retry_attempts": 2, "retry_interval_ms": 2}
# The dispatch methods of each kind's coalesced path (chaos points
# dispatch.<method>), and K1's for the CMS.
KIND_POINTS = {
    "bloom": ("dispatch.bloom_mixed_keys_runs", "dispatch.bloom_mixed_keys"),
    "hll": ("dispatch.hll_add_changed",),
    "bitset": ("dispatch.bitset_mixed_runs", "dispatch.bitset_mixed"),
    "cms": ("dispatch.cms_update_estimate", "dispatch.cms_update_estimate_seq"),
}


def p9_client(**kw):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(**P9_KNOBS, **kw)
    cfg.retry_attempts = P9_RETRY["retry_attempts"]
    cfg.retry_interval_ms = P9_RETRY["retry_interval_ms"]
    return rt.create(cfg)


def typed_errors():
    from redisson_tpu_torch import chaos
    from redisson_tpu_torch.executor.failures import RedissonTpuError

    return (RedissonTpuError, chaos.FaultInjected, chaos.CorruptionDetected)


def until(cond, what: str, timeout: float = 30.0) -> float:
    """Poll ``cond`` with a deadline; the seconds it took."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout, f"{what} within {timeout} s")
        time.sleep(0.002)
    return time.perf_counter() - t0


def check_healthy(client, phase) -> None:
    """Phases 2-8 run on a healthy card: no op served degraded, every
    breaker closed, no mirror."""
    from redisson_tpu_torch.obs import total

    eng = client._engine
    check(total(eng.obs.degraded_ops) == 0, f"phase {phase}: ops were served degraded")
    check(eng.health.board.open_count() == 0 and not eng._mirrors
          and not eng.health.any_degraded, f"phase {phase}: a breaker is not closed")


def trip(client, kind: str, name: str, op):
    """Fail the kind's dispatch methods until its breaker opens and ``op``
    is answered by the host mirror (seeded from the device row: its D2H
    and decode are inside the failover time).  Then hold the breaker open
    through the degraded window: the recovery probe's row read fails too.
    Returns (the first mirror answer, failover seconds)."""
    from redisson_tpu_torch import chaos

    eng = client._engine
    served = eng.obs.degraded_ops
    for p in KIND_POINTS[kind]:
        chaos.inject(p, "error", 1.0)
    t0 = time.perf_counter()
    while True:
        before = served.get((kind,))
        try:
            res = op()
        except typed_errors():
            check(time.perf_counter() - t0 < 60, f"{kind} never failed over")
            continue
        check(served.get((kind,)) > before, f"{kind}: an op reached the failing device")
        break
    failover_s = time.perf_counter() - t0
    check(eng.health.degraded_kind(kind) and eng.health.state() != "healthy",
          f"{kind}: health does not show the degraded kind")
    chaos.inject("dispatch.read_row", "error", 1.0)
    return res, failover_s


def heal(client, kind: str) -> float:
    """Clear the schedule and poll until the breaker closed and the mirrors
    reconciled; the reconcile's own seconds (encode + H2D)."""
    from redisson_tpu_torch import chaos

    eng = client._engine
    eng.reconcile_seconds.pop(kind, None)
    chaos.clear()
    # The reconcile records its time after it releases the mirror lock.
    until(lambda: not eng._mirrors and not eng.health.any_degraded
          and eng.health.board.open_count() == 0 and kind in eng.reconcile_seconds,
          f"{kind} reconcile")
    return eng.reconcile_seconds[kind]


def words_on_card(bits: np.ndarray, row_units: int, dev) -> torch.Tensor:
    """A bool bitmap as the int32 bit-view row the card holds."""
    padded = np.zeros(row_units * 32, bool)
    padded[: bits.size] = bits
    words = np.packbits(padded, bitorder="little").view(np.uint32)
    return torch.from_numpy(words.view(np.int32).copy()).to(dev)


def p9_bloom(client, rng, dev) -> dict:
    from redisson_tpu_torch.utils import hashing

    bf = client.get_bloom_filter("p9-cfg1")
    check(bf.try_init(1_000_000, 0.01), "try_init refused")
    load = np.arange(1 << 20, dtype=np.uint64)
    for i in range(4):
        bf.add_all_async(load[i << 18 : (i + 1) << 18]).result()
    g = golden_bloom(bf, load)

    def reduce(keys):
        return hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(keys)), g.size)

    first, failover_s = trip(client, "bloom", "p9-cfg1", lambda: bf.add(1 << 40))
    check(first == bool(g.add_hashed(*reduce(np.array([1 << 40], np.uint64)))[0]),
          "bloom: the first mirror answer differs from golden")
    adds = rng.integers(0, 1 << 21, 1 << 17).astype(np.uint64)
    probes = rng.integers(0, 1 << 22, 1 << 17).astype(np.uint64)
    t0 = time.perf_counter()
    got_add = bf.add_all_async(adds).result()
    got_has = bf.contains_each(probes)
    window_s = time.perf_counter() - t0
    check(np.array_equal(got_add, g.add_hashed(*reduce(adds))), "bloom: degraded adds differ")
    check(np.array_equal(got_has, g.contains_hashed(*reduce(probes))),
          "bloom: degraded contains differ")
    reconcile_s = heal(client, "bloom")
    e = client._engine.registry.lookup("p9-cfg1")
    check(torch.equal(row_view(client, "p9-cfg1"), words_on_card(g.bits, e.pool.row_units, dev)),
          "bloom: the reconciled row differs from golden")
    return {"failover_s": failover_s, "degraded_ops": 2 << 17,
            "degraded_ops_per_s": (2 << 17) / window_s, "reconcile_s": reconcile_s}


def p9_hll(client) -> dict:
    from redisson_tpu_torch.ops import golden

    h = client.get_hyper_log_log("p9-cfg2")
    base = np.arange(1 << 21, dtype=np.uint64)
    h.add_all_async(base).result()
    g = golden.GoldenHyperLogLog()
    g.add_hashed(*hll_lanes(base))

    def golden_add(keys) -> bool:
        before = g.regs.copy()
        g.add_hashed(*hll_lanes(keys))
        return bool(np.any(g.regs != before))

    first, failover_s = trip(client, "hll", "p9-cfg2", lambda: h.add(1 << 40))
    check(first == golden_add(np.array([1 << 40], np.uint64)), "hll: first mirror answer")
    calls = np.arange(1 << 21, (1 << 21) + (1 << 19), dtype=np.uint64).reshape(64, -1)
    t0 = time.perf_counter()
    got = [h.add_all(keys) for keys in calls]
    count = h.count()
    window_s = time.perf_counter() - t0
    check(got == [golden_add(keys) for keys in calls], "hll: degraded PFADD results differ")
    check(count == g.count(), f"hll: degraded count {count} vs golden {g.count()}")
    reconcile_s = heal(client, "hll")
    check(torch.equal(row_view(client, "p9-cfg2"), torch.from_numpy(g.regs).to(row_view(
        client, "p9-cfg2").device)), "hll: the reconciled registers differ from golden")
    check(h.count() == count, "hll: count after reconcile")
    return {"failover_s": failover_s, "degraded_ops": 1 << 19,
            "degraded_ops_per_s": (1 << 19) / window_s, "reconcile_s": reconcile_s}


def golden_ops(bits: np.ndarray, idx: np.ndarray, op: str) -> np.ndarray:
    """Previous bit per op, one op at a time, on a bool bitmap."""
    prev = np.empty(len(idx), bool)
    for j, i in enumerate(idx.tolist()):
        prev[j] = bits[i]
        if op == "set":
            bits[i] = True
        elif op == "clear":
            bits[i] = False
        elif op == "flip":
            bits[i] = not prev[j]
    return prev


def p9_bitset(client, rng, dev) -> dict:
    nbits = 1 << 30
    eng = client._engine
    bs = client.get_bit_set("p9-cfg3")
    bits = np.zeros(nbits, bool)
    warm = rng.integers(0, nbits, 1 << 21).astype(np.uint32)
    warm[0] = nbits - 1
    bs.set_many(warm)
    bits[warm] = True
    first, failover_s = trip(client, "bitset", "p9-cfg3", lambda: bs.set(12345))
    check(first == golden_ops(bits, np.array([12345]), "set")[0], "bitset: first mirror answer")
    mirror_bytes = eng._mirrors["p9-cfg3"].bits.nbytes
    parts = [(op, rng.integers(0, nbits, 1 << 16).astype(np.uint32))
             for op in ("set", "clear", "flip", "get")]
    parts[2][1][:4096] = parts[0][1][:4096]  # flips that meet this window's sets
    t0 = time.perf_counter()
    got = []
    for op, idx in parts:
        if op == "set":
            got.append(bs.set_many(idx))
        elif op == "clear":
            got.append(eng.bitset_set("p9-cfg3", idx, False).result())
        elif op == "flip":
            got.append(eng.bitset_flip("p9-cfg3", idx).result())
        else:
            got.append(bs.get_many(idx))
    window_s = time.perf_counter() - t0
    for (op, idx), res in zip(parts, got):
        check(np.array_equal(res, golden_ops(bits, idx, op)), f"bitset: degraded {op} differs")
    check(bs.cardinality() == int(bits.sum()), "bitset: degraded cardinality")
    reconcile_s = heal(client, "bitset")
    e = eng.registry.lookup("p9-cfg3")
    check(torch.equal(row_view(client, "p9-cfg3"), words_on_card(bits, e.pool.row_units, dev)),
          "bitset: the reconciled row differs from golden")
    return {"failover_s": failover_s, "degraded_ops": 1 << 18,
            "degraded_ops_per_s": (1 << 18) / window_s, "reconcile_s": reconcile_s,
            "mirror_host_bytes": int(mirror_bytes)}


def p9_cms(client, rng) -> dict:
    """K1 through a trip: 2**20 events on K1, 2**18 on the host mirror,
    2**20 on K1 again."""
    from redisson_tpu_torch.ops import cms_seq, golden
    from redisson_tpu_torch.utils import hashing

    d, w = 5, 1 << 16
    cms = client.get_count_min_sketch("p9-cms")
    check(cms.try_init(d, w), "try_init refused")

    def reduce(keys):
        return hashing.km_reduce_mod(*hashing.hash128_np(*hashing.encode_uint64_batch(keys)), w)

    table = np.zeros((d, w), np.uint32)
    cells = []  # every event's d cells, for the plain uint32 sum

    def k1_window(events):
        nonlocal table
        h1w, h2w = reduce(events)
        before = cms_seq.LAUNCHES
        est = cms.add_all_seq(events)
        launched = cms_seq.LAUNCHES - before
        check(launched == -(-len(events) // client._engine._SEQ_CHUNK),
              f"cms: {launched} K1 launches")
        table, want = cms_seq.golden_seq(table, h1w, h2w, np.ones(len(events), np.uint32),
                                         d=d, w=w)
        check(np.array_equal(est, want), "cms: K1 estimates differ from golden_seq")
        cells.append((h1w, h2w))
        return launched

    def mirror_call(events, fn):
        nonlocal table
        h1w, h2w = reduce(events)
        g = golden.GoldenCountMinSketch(d, w)
        g.counts = table.copy()
        g.add_hashed(h1w, h2w)
        want = g.estimate_hashed(h1w, h2w)
        got = fn()
        table = g.counts
        cells.append((h1w, h2w))
        check(np.array_equal(np.asarray(got), want),
              "cms: degraded estimates differ from the whole-call golden model")

    k1_window(zipf_keys(rng, 1 << 20))
    key = np.array([1 << 40], np.uint64)
    first, failover_s = trip(client, "cms", "p9-cms", lambda: cms.add_all(key))
    mirror_call(key, lambda: first)
    events = zipf_keys(rng, 1 << 18)
    t0 = time.perf_counter()
    mirror_call(events, lambda: cms.add_all_seq(events))
    window_s = time.perf_counter() - t0
    reconcile_s = heal(client, "cms")
    k1_after = k1_window(zipf_keys(rng, 1 << 20))
    plain = np.zeros(d * w, np.uint64)
    for h1w, h2w in cells:
        idx = h1w.astype(np.uint64)
        for r in range(d):
            np.add.at(plain, r * w + idx, 1)
            idx = (idx + h2w) % w
    check(np.array_equal(tenant_row(client, "p9-cms")[: d * w],
                         (plain % (1 << 32)).astype(np.uint32)),
          "cms: the table differs from the uint32 sum of every event")
    return {"failover_s": failover_s, "degraded_ops": 1 << 18,
            "degraded_ops_per_s": (1 << 18) / window_s, "reconcile_s": reconcile_s,
            "k1_launches_after_reconcile": k1_after}


def p9_soak(client, seed: int) -> dict:
    """4 threads of mixed multi-tenant ops under a seeded 5% schedule over
    every dispatch, fetch and staged H2D: every call resolves (a value or a
    typed error), and after clearing no breaker is open, no mirror is left,
    and every acknowledged write reads back."""
    from redisson_tpu_torch import chaos

    eng = client._engine
    n_threads, n_calls = 4, 400
    for t in range(n_threads):
        check(client.get_bloom_filter(f"soak-bf{t}").try_init(100_000, 0.01), "try_init")
        eng.bitset_ensure(f"soak-bs{t}", 1 << 16)
        check(client.get_count_min_sketch(f"soak-cms{t}").try_init(4, 4096), "try_init")
    acked = [{"bloom": [], "bits": [], "cms": 0, "hll": 0} for _ in range(n_threads)]
    failed, untyped = [0] * n_threads, []
    typed = typed_errors()

    def worker(t):
        rng = np.random.default_rng(seed * 100 + t)
        bf = client.get_bloom_filter(f"soak-bf{t}")
        bs = client.get_bit_set(f"soak-bs{t}")
        cms = client.get_count_min_sketch(f"soak-cms{t}")
        hll = client.get_hyper_log_log(f"soak-h{t}")
        for i in range(n_calls):
            keys = rng.integers(0, 1 << 20, 32).astype(np.uint64)
            try:
                if i % 5 == 0:
                    bf.add_all_async(keys).result()
                    acked[t]["bloom"].append(keys)
                elif i % 5 == 1:
                    idx = (keys % (1 << 16)).astype(np.uint32)
                    bs.set_many_async(idx).result()
                    acked[t]["bits"].append(idx)
                elif i % 5 == 2:
                    cms.add_all(keys)
                    acked[t]["cms"] += len(keys)
                elif i % 5 == 3:
                    hll.add_all(keys)
                    acked[t]["hll"] += 1
                else:
                    bf.contains_each(keys)
                    bs.get_many((keys % (1 << 16)).astype(np.uint32))
            except typed:
                failed[t] += 1
            except Exception as e:  # noqa: BLE001 - the check below reports it
                untyped.append(repr(e))

    chaos.install(chaos.ChaosSchedule(seed=seed, rate=0.05,
                                      points=("dispatch", "fetch", "h2d.staging")))
    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    soak_s = time.perf_counter() - t0
    injected = sum(chaos.counts().values())
    chaos.clear()
    check(not any(th.is_alive() for th in threads), "soak workers hung")
    check(not untyped, f"untyped failures in the soak: {untyped[:3]}")
    recover_s = until(lambda: eng.health.board.open_count() == 0 and not eng._mirrors
                      and not eng.health.any_degraded, "soak recovery", 60)
    for t in range(n_threads):
        bf = client.get_bloom_filter(f"soak-bf{t}")
        for keys in acked[t]["bloom"]:
            check(bf.contains_all(keys) == len(keys), "soak: an acked bloom add was lost")
        bs = client.get_bit_set(f"soak-bs{t}")
        for idx in acked[t]["bits"]:
            check(bs.get_many(idx).all(), "soak: an acked bitset set was lost")
        total = client.get_count_min_sketch(f"soak-cms{t}").total_count()
        check(total >= acked[t]["cms"], f"soak: CMS total {total} < acked {acked[t]['cms']}")
    return {"calls": n_threads * n_calls, "failed_calls": sum(failed),
            "faults_injected": injected, "soak_s": soak_s,
            "degrade_events": eng.health.degrade_events,
            "recoveries": eng.health.recoveries, "recover_s": recover_s}


def p9_stall(dev) -> dict:
    """A real stall: a sleep kernel ahead of one launch on the executor's
    stream outlasts fetch_timeout_ms, so the waiter gets
    DispatchTimeoutError, the fetch timeout and a breaker failure are
    recorded, and the op still lands (applied but reported failed)."""
    from redisson_tpu_torch.executor.failures import DispatchTimeoutError
    from redisson_tpu_torch.obs import total

    client = p9_client(fetch_timeout_ms=50)
    try:
        eng = client._engine
        bf = client.get_bloom_filter("stall")
        check(bf.try_init(100_000, 0.01), "try_init refused")
        warm = np.arange(4096, dtype=np.uint64)
        bf.add_all_async(warm).result()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(1 << 20)
        end.record()
        torch.cuda.synchronize()
        cycles = int((1 << 20) * 1000.0 / start.elapsed_time(end))  # ~1 s
        keys = np.arange(1 << 20, (1 << 20) + 4096, dtype=np.uint64)
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        fut = bf.add_all_async(keys)
        try:
            fut.result()
            fail("the stalled launch came home within fetch_timeout_ms")
        except DispatchTimeoutError:
            waited_s = time.perf_counter() - t0
        failures = max(b.failures for b in eng.health.board._breakers.values())
        timeouts = total(eng.obs.fetch_timeouts)
        check(timeouts == 1 and failures >= 1,
              f"fetch timeouts {timeouts}, breaker failures {failures}")
        torch.cuda.synchronize()
        until(fut.done, "the stalled launch")
        check(bf.contains_all(keys) == len(keys), "the stalled op did not land")
        return {"fetch_timeout_ms": 50, "stall_cycles": cycles, "waited_s": waited_s,
                "fetch_timeouts": timeouts, "breaker_failures": failures}
    finally:
        client.shutdown()


def count_dispatches(ex):
    """Counting spies on every executor method that launches work;
    ``counts["restore"]()`` removes them."""
    names = (*_DISPATCHES, "cms_update_estimate_seq", "bloom_contains_keys_st",
             "bloom_add_keys_st")
    counts = {"n": 0}
    for name in names:
        orig = getattr(ex, name)

        def spy(*a, _orig=orig, **k):
            counts["n"] += 1
            return _orig(*a, **k)

        setattr(ex, name, spy)

    def restore():
        for name in names:
            delattr(ex, name)

    counts["restore"] = restore
    return counts


def p9_overload(client) -> dict:
    from redisson_tpu_torch import chaos
    from redisson_tpu_torch.executor.failures import (
        DeadlineExceededError,
        TenantThrottledError,
    )

    eng = client._engine
    bf = client.get_bloom_filter("p9-over")
    check(bf.try_init(1_000_000, 0.01), "try_init refused")
    bf.add_all_async(np.arange(1024, dtype=np.uint64)).result()
    launches = count_dispatches(eng.executor)
    chaos.inject("overload.pressure", "pressure", 1.0, latency_s=30.0)
    shed_us = []
    for i in range(1000):
        t0 = time.perf_counter()
        try:
            with client.op_deadline(50):
                if i % 2:
                    bf.add(i)
                else:
                    bf.contains(i)
            fail("a deadline call under pressure was not shed")
        except DeadlineExceededError as e:
            check(e.stage == "admission", f"shed at {e.stage}")
        shed_us.append((time.perf_counter() - t0) * 1e6)
    check(launches["n"] == 0, f"{launches['n']} launches for shed calls")
    for i in range(10):
        check(bf.add(1 << 30 | i) and bf.contains(1 << 30 | i), "a no-deadline call")
    check(launches["n"] > 0, "no-deadline calls did not launch")
    chaos.clear()
    launches["restore"]()

    victim = client.get_bloom_filter("p9-victim")
    check(victim.try_init(1_000_000, 0.01), "try_init refused")
    burster = client.get_bloom_filter("p9-burster")
    check(burster.try_init(1_000_000, 0.01), "try_init refused")
    eng.governor.set_limits(rate_limit=4_000_000, burst=1_000_000)

    def victim_run(duration_s, tag):
        acked, failures, ops = [], [], [0]
        stop = time.perf_counter() + duration_s

        def vt(t):
            rng = np.random.default_rng(t)
            while time.perf_counter() < stop:
                keys = rng.integers(0, 1 << 40, 128).astype(np.uint64)
                try:
                    victim.add_all_async(keys).result()
                    acked.append(keys)
                    check(victim.contains_all_async(keys).result().all(), "victim read")
                    ops[0] += 256
                except Exception as e:  # noqa: BLE001 - the check below reports it
                    failures.append(repr(e))

        threads = [threading.Thread(target=vt, args=(t,)) for t in range(3)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        check(not any(th.is_alive() for th in threads), "victim threads hung")
        check(not failures, f"victim ops failed ({tag}): {failures[:3]}")
        return ops[0] / (time.perf_counter() - t0), acked

    alone, acked = victim_run(1.5, "alone")
    stop = threading.Event()
    burst = {"ok": [], "throttled": 0}

    def burster_run():
        i = 0
        while not stop.is_set():
            keys = np.arange(i << 20, (i + 1) << 20, dtype=np.uint64)
            try:
                burster.add_all_async(keys).result()
                burst["ok"].append(keys)
            except TenantThrottledError:
                burst["throttled"] += 1
                time.sleep(0.001)
            i += 1

    bt = threading.Thread(target=burster_run)
    bt.start()
    try:
        contested, acked2 = victim_run(1.5, "burst")
    finally:
        stop.set()
        bt.join(timeout=60)
    eng.governor.set_limits(rate_limit=0, burst=0)
    check(burst["throttled"] > 0, "the burster was never throttled")
    for keys in acked + acked2:
        check(victim.contains_all(keys) == len(keys), "an acked victim write was lost")
    for keys in burst["ok"]:
        check(burster.contains_all(keys) == len(keys), "an acked burster write was lost")
    return {"shed_calls": 1000, "shed_p50_us": float(np.percentile(shed_us, 50)),
            "shed_p99_us": float(np.percentile(shed_us, 99)),
            "victim_ops_per_s_alone": alone, "victim_ops_per_s_with_burster": contested,
            "burster_throttled_calls": burst["throttled"],
            "burster_acked_calls": len(burst["ok"])}


def phase_failover(rng, seed: int, card: str) -> None:
    from redisson_tpu_torch.obs import total

    dev = torch.device("cuda")
    log({"phase": 9, "knobs": {**P9_KNOBS, **P9_RETRY}, "card": card})
    client = p9_client()
    try:
        kinds = {"bloom": p9_bloom(client, rng, dev), "hll": p9_hll(client),
                 "bitset": p9_bitset(client, rng, dev), "cms": p9_cms(client, rng)}
        served = {k: client._engine.obs.degraded_ops.get((k,)) for k in kinds}
        soak = p9_soak(client, seed)
        overload = p9_overload(client)
        degraded_total = total(client._engine.obs.degraded_ops)
    finally:
        client.shutdown()
    stall = p9_stall(dev)
    log({"phase": 9, "kinds": kinds, "degraded_ops_served": served,
         "degraded_ops_total": degraded_total, "soak": soak, "stall": stall,
         "overload": overload, "card": card})


# -- phase 10: the residency ladder, the near cache and pre-warm ----------------

# Phase 10a: bench.py config 11's shape at a population a multi-tenant
# deployment holds — 100x the device-row budget in Bloom tenants of
# 10,000 keys / 1% FPP, a zipf(1.1) tenant stream of 128-key ops with an
# add every third op, the cold tail past a 32 MiB host cap spilling to
# disk, and config 11's 30 s heat half-life.  The hot set is the stream's
# actual head; the tenant ids are a seeded permutation of the zipf ranks,
# so the hot set is mostly born cold and has to be promoted by heat.
# The stream is cut from 65,536 ops to 5,120 for the script's time
# limit (the tiered stream ran at 162-316 ops/s on an NVIDIA H100 80GB
# HBM3 at 700 W, and the later phases need the room).  A touched tenant's host copy is 16 KB:
# the 40,960-op stream touched ~17,300 tenants, past the 16,384 a
# 256 MiB cap holds, and the cap is halved with each halving of the
# stream (the 10,240-op stream touched ~5,300, past the 4,096 of
# 64 MiB; the 5,120-op stream's head is past the 2,048 of 32 MiB), so
# the cold tail still spills to disk.  The population and
# the device budget are not cut.
P10 = {"pop": 102_400, "budget": 1024, "ops": 5_120, "keys": 128, "hot": 256,
       "hot_keys": 1 << 14, "hot_passes": 4, "host_bytes": 32 << 20,
       "cms": (4, 5, 1 << 16), "cms_events": 1 << 18, "seq_events": 1 << 15,
       "hlls": 2, "hll_keys": 1 << 20, "bitsets": 2, "bitset_bits": 1 << 24,
       "sample": 256, "nc_keys": 100_000, "nc_reads": 1024}
P10_DEVICE = "cuda"


def p10_client(**kw):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    return rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        device=P10_DEVICE, **kw))


def p10_truth(client, name: str) -> np.ndarray:
    """The object's state in device-row layout, whatever its tier (a DISK
    tenant loads)."""
    eng = client._engine
    return np.asarray(eng._host_row(eng.registry.lookup(name))).copy()


def p10_stream(client, names, stream, keys):
    """The op stream, issued pipelined (config 11's loop): per-op results
    packed 8 per byte, the errors, and the seconds it took."""
    from collections import deque

    out = np.zeros((len(stream), keys.shape[1] // 8), np.uint8)
    errors = 0
    futs = deque()

    def collect(j, f):
        nonlocal errors
        try:
            out[j] = np.packbits(np.asarray(f.result(), bool))
        except Exception:
            errors += 1

    t0 = time.perf_counter()
    for j, t in enumerate(stream):
        bf = client.get_bloom_filter(names[t])
        futs.append((j, bf.add_all_async(keys[j]) if j % 3 == 0
                     else bf.contains_all_async(keys[j])))
        while futs and futs[0][1].done():
            collect(*futs.popleft())
    while futs:
        collect(*futs.popleft())
    return out, errors, time.perf_counter() - t0


def p10_hot_pass(client, names, hot, rng) -> float:
    """Config 11's hot pass: contains over the hot set, 2**14 keys per op,
    all issued before any is collected; key-ops/s."""
    keys = [rng.integers(0, 1 << 40, P10["hot_keys"], dtype=np.uint64)
            for _ in range(P10["hot_passes"])]
    filters = [client.get_bloom_filter(names[t]) for t in hot]
    for f in filters:  # warm-up outside the clock
        f.contains_all_async(keys[0]).result()
    if P10_DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for kp in keys:
        futs = [f.contains_all_async(kp) for f in filters]
        for fu in futs:
            fu.result()
    return P10["hot_passes"] * len(filters) * P10["hot_keys"] / (time.perf_counter() - t0)


def p10_other_kinds(client, rng) -> list:
    """The four CMSes, two HLLs and two BitSets the ladder moves whole;
    created before the Bloom population, so they hold device rows."""
    n_cms, d, w = P10["cms"]
    names = []
    for i in range(n_cms):
        cms = client.get_count_min_sketch(f"p10-cms{i}")
        check(cms.try_init(d, w), "try_init refused")
        cms.add_all(zipf_keys(rng, P10["cms_events"]))  # the multi-tenant path
        names.append(f"p10-cms{i}")
    for i in range(P10["hlls"]):
        client.get_hyper_log_log(f"p10-hll{i}").add_all(
            rng.integers(0, 1 << 40, P10["hll_keys"], dtype=np.uint64))
        names.append(f"p10-hll{i}")
    for i in range(P10["bitsets"]):
        bs = client.get_bit_set(f"p10-bs{i}")
        bs.set(P10["bitset_bits"] - 1)
        bs.set_many(rng.integers(0, P10["bitset_bits"], 1 << 20), True)
        names.append(f"p10-bs{i}")
    return names


def p10_force_ladder(client, names, rng) -> dict:
    """Each object through demote -> spill -> load -> promote, its bytes
    equal to the pre-demotion bytes at every tier; then K1 on each promoted
    CMS row, its estimates equal to golden_seq on the host."""
    from redisson_tpu_torch.ops import cms_seq
    from redisson_tpu_torch.utils import hashing

    rm = client._engine.residency
    for n in names:
        if client._engine.registry.lookup(n).row < 0:
            # The ladder may have demoted it (or spilled it) while the
            # stream ran: back to the card first.
            rm.load(n)
            check(rm.promote(n), f"promotion of {n} refused")
        before = p10_truth(client, n)
        for step in (rm.demote, rm.spill, rm.load, rm.promote):
            check(step(n), f"{step.__name__} of {n} refused")
            check(np.array_equal(p10_truth(client, n), before),
                  f"{n} changed on {step.__name__}")
        e = client._engine.registry.lookup(n)
        check(e.row >= 0 and e.residency == "device", f"{n} not back on the card")
    _, d, w = P10["cms"]
    launches = 0
    for n in names:
        if not n.startswith("p10-cms"):
            continue
        table = p10_truth(client, n)[: d * w].reshape(d, w)
        events = zipf_keys(rng, P10["seq_events"])
        before = cms_seq.LAUNCHES
        est = client.get_count_min_sketch(n).add_all_seq(events)
        launched = cms_seq.LAUNCHES - before
        check(launched >= 1, f"K1 never launched on the promoted row of {n}")
        launches += launched
        h1w, h2w = hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(events)), w)
        want_table, want = cms_seq.golden_seq(
            table, h1w, h2w, np.ones(len(events), np.uint32), d=d, w=w)
        check(np.array_equal(np.asarray(est, np.uint32), want),
              f"K1 on the promoted row of {n} differs from golden_seq")
        check(np.array_equal(p10_truth(client, n)[: d * w].reshape(d, w), want_table),
              f"{n} table after K1 differs from golden_seq")
    return {"objects": len(names), "k1_launches_on_promoted_rows": launches,
            "bytes_equal_on_every_tier": True, "k1_equals_golden_seq": True}


def p10_sample(rm_client, names, hot, rng) -> np.ndarray:
    """256 tenants: the hot set's head and tenants on each tier at the end."""
    eng = rm_client._engine
    by_tier = {"device": [], "host": [], "disk": []}
    for i, n in enumerate(names):
        e = eng.registry.lookup(n)
        tier = "device" if e.row >= 0 else ("host" if n in eng._mirrors else
                                             "disk" if e.residency == "disk" else None)
        if tier is not None and len(by_tier[tier]) < 64:
            by_tier[tier].append(i)
    picked = list(hot[:64])
    for ids in by_tier.values():
        picked += ids
    rest = rng.choice(len(names), P10["sample"], replace=False)
    picked = list(dict.fromkeys(int(i) for i in picked + list(rest)))[: P10["sample"]]
    return np.asarray(picked), {k: len(v) for k, v in by_tier.items()}


def phase_tiered(rng, card: str) -> None:
    from redisson_tpu_torch.obs import total

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    blob_dir = tempfile.mkdtemp(prefix="phase10-blobs-", dir=build)
    pop, budget = P10["pop"], P10["budget"]
    names = [f"p10-{i}" for i in range(pop)]
    perm = rng.permutation(pop)
    stream = perm[rng.zipf(1.1, P10["ops"]) % pop]
    keys = rng.integers(0, 1 << 40, (P10["ops"], P10["keys"]), dtype=np.uint64)
    counts = np.bincount(stream, minlength=pop)
    hot = np.argsort(-counts, kind="stable")[: P10["hot"]]
    tiered = p10_client(residency_device_rows=budget,
                        residency_max_host_bytes=P10["host_bytes"],
                        residency_dir=blob_dir, residency_heat_half_life_s=30.0)
    resident = None
    try:
        eng, rm = tiered._engine, tiered._engine.residency
        others = p10_other_kinds(tiered, rng)
        t0 = time.perf_counter()
        for n in names:
            tiered.get_bloom_filter(n).try_init(10_000, 0.01)
        create_s = time.perf_counter() - t0
        born_cold = sum(1 for n in names if eng.registry.lookup(n).row < 0)
        check(rm.device_rows_used() <= budget, "creation grew past the device budget")
        check(born_cold == pop - (budget - len(others)), f"{born_cold} born cold")
        res_t, err_t, mixed_t = p10_stream(tiered, names, stream, keys)
        st_stream = rm.stats()
        # The thread stops here: the forced ladder and the convergence
        # below drive maintain() by hand, as config 11 does.
        rm.shutdown()
        check(rm.errors == 0, f"{rm.errors} maintenance cycles failed")
        ladder = p10_force_ladder(tiered, others, rng)
        for t in hot:  # heat for the hot set (config 11 warms it too)
            for _ in range(4):
                tiered.get_bloom_filter(names[t]).contains_all_async(keys[0, :8]).result()
        for _ in range(8):
            rm.maintain()
        hot_resident = sum(1 for t in hot if eng.registry.lookup(names[t]).row >= 0)
        hot_tiered = p10_hot_pass(tiered, names, hot, rng)
        rm.maintain()
        rm.maintain()  # the second reclaims what the first quarantined
        used = rm.device_rows_used()
        check(used <= budget, f"{used} device rows in use past the budget {budget}")
        check(rm.errors == 0, "maintenance failed")

        resident = p10_client()
        for n in names:
            resident.get_bloom_filter(n).try_init(10_000, 0.01)
        res_r, err_r, mixed_r = p10_stream(resident, names, stream, keys)
        check(err_t == 0 and err_r == 0, f"stream errors: tiered {err_t}, resident {err_r}")
        check(np.array_equal(res_t, res_r),
              f"{int(np.sum(np.any(res_t != res_r, axis=1)))} ops differ tiered vs all-resident")
        hot_res = p10_hot_pass(resident, names, hot, rng)
        sample, sample_tiers = p10_sample(tiered, names, hot, rng)
        check(all(sample_tiers.values()), f"a tier is empty at the end: {sample_tiers}")
        for i in sample:
            e = resident._engine.registry.lookup(names[i])
            check(np.array_equal(p10_truth(tiered, names[i]),
                                 resident._engine.executor.read_row(e.pool, e.row)),
                  f"{names[i]} differs tiered vs all-resident")
        check(total(eng.obs.degraded_ops) == 0, "phase 10a: ops were served degraded")
        st = rm.stats()
        resident_rows = sum(p.used_rows() for p in resident._engine.registry.pools())
        log({"phase": "10a", "population": pop, "device_rows_budget": budget,
             "born_cold": born_cold, "create_s": create_s,
             "ops": P10["ops"], "keys_per_op": P10["keys"],
             "tiered_mixed_ops_per_s": P10["ops"] / mixed_t,
             "tiered_mixed_keys_per_s": P10["ops"] * P10["keys"] / mixed_t,
             "resident_mixed_ops_per_s": P10["ops"] / mixed_r,
             "resident_mixed_keys_per_s": P10["ops"] * P10["keys"] / mixed_r,
             "hot_set": len(hot), "hot_device_resident": hot_resident,
             "tiered_hot_keys_per_s": hot_tiered, "resident_hot_keys_per_s": hot_res,
             "hot_ratio": hot_res / hot_tiered, "hot_ratio_bar": 1.25,
             "errors": err_t + err_r + rm.errors, "per_op_results_equal": True,
             "sample": len(sample), "sample_tiers": sample_tiers,
             "sample_bytes_equal": True, "device_rows_used": used,
             "resident_device_rows": resident_rows,
             "tiers_after_stream": st_stream, "tiers": st,
             "transition_ms": rm.latency_ms((50, 99)), "ladder": ladder,
             "card": card})
    finally:
        tiered.shutdown()
        if resident is not None:
            resident.shutdown()
        shutil.rmtree(blob_dir, ignore_errors=True)


def phase_nearcache(rng, card: str) -> None:
    """10b: bench.py bench_nearcache_hotkeys' shape at config 1's filter."""
    client = p10_client()
    try:
        bf = client.get_bloom_filter("p10-nc")
        check(bf.try_init(1_000_000, 0.01), "try_init refused")
        loaded = np.arange(P10["nc_keys"], dtype=np.uint64)
        bf.add_all(loaded)
        g = golden_bloom(bf, loaded)
        nc = client._engine.nearcache
        n = P10["nc_reads"]
        reads = (rng.zipf(1.3, 2 * n) % (2 * P10["nc_keys"])).astype(np.uint64)

        def run():
            answers = [bf.contains(k) for k in reads[:n]]  # warm
            h0, m0 = nc.hits, nc.misses
            lat = np.empty(n)
            t0 = time.perf_counter()
            for i, k in enumerate(reads[n:]):
                s = time.perf_counter()
                answers.append(bf.contains(k))
                lat[i] = time.perf_counter() - s
            dt = time.perf_counter() - t0
            hits, misses = nc.hits - h0, nc.misses - m0
            return answers, {"ops_per_s": n / dt, "p50_us": float(np.percentile(lat, 50)) * 1e6,
                             "p99_us": float(np.percentile(lat, 99)) * 1e6,
                             "hit_rate": hits / max(1, hits + misses)}

        on, on_stats = run()
        nc.set_enabled(False)
        off, off_stats = run()
        nc.set_enabled(True)
        check(on == off, "answers differ with the near cache on and off")
        check(np.array_equal(np.asarray(on), golden_contains(g, reads)),
              "near-cache answers differ from golden")
        ghost = np.uint64(1 << 41)
        check(bf.contains(ghost) is False and bf.contains(ghost) is False, "ghost present")
        h0 = nc.hits
        check(bf.contains(ghost) is False and nc.hits == h0 + 1, "the negative was not cached")
        check(bf.add(ghost) is True, "ghost add")
        check(bf.contains(ghost) is True, "a cached negative outlived the add")
        log({"phase": "10b", "config": "bloom 1M keys 1% FPP, 100,000 added",
             "reads": n, "zipf": 1.3, "cache_on": on_stats, "cache_off": off_stats,
             "answers_equal": True, "negative_retired_by_add": True, "card": card})
    finally:
        client.shutdown()


def p10c_child(mode: str) -> int:
    """10c in a fresh process: first-batch latency per bucket with pre-warm
    (``warm``) or without (``cold``); prints one JSON line."""
    from redisson_tpu_torch.executor import prewarm

    rng = np.random.default_rng(100)
    client = p10_client(prewarm=mode == "warm")
    try:
        bf = client.get_bloom_filter("p10c-bf")
        bf.try_init(1_000_000, 0.01)
        bf.add(np.uint64(0))  # the first submit reveals the codec's ladder
        bs = client.get_bit_set("p10c-bs")
        bs.set(1 << 20)
        hll = client.get_hyper_log_log("p10c-hll")
        hll.add(np.uint64(0))
        cms = client.get_count_min_sketch("p10c-cms")
        cms.try_init(5, 1 << 16)
        t0 = time.perf_counter()
        drained = client.prewarm_wait(600)
        wait_s = time.perf_counter() - t0
        cfg = client.config.gpu_sketch
        ladder, b = [], cfg.min_bucket
        while b <= cfg.max_batch:
            ladder.append(b)
            b *= 2
        before = prewarm.first_launch_count()
        first_ms = {"bloom": {}, "bitset": {}, "hll": {}, "cms": {}}
        for b in ladder:
            keys = rng.integers(0, 1 << 40, b, dtype=np.uint64)
            idx = rng.integers(0, 1 << 20, b)
            for kind, op in (("bloom", lambda: bf.add_all_async(keys)),
                             ("bitset", lambda: bs.set_many_async(idx, True)),
                             ("hll", lambda: hll.add_all_async(keys)),
                             ("cms", lambda: cms.add_all_async(keys))):
                torch.cuda.synchronize()
                s = time.perf_counter()
                op().result()
                torch.cuda.synchronize()
                first_ms[kind][b] = (time.perf_counter() - s) * 1e3
        after = prewarm.first_launch_count()
        pw = client._engine.prewarmer
        print(json.dumps({"mode": mode, "drained": drained, "prewarm_wait_s": wait_s,
                          "warmed": 0 if pw is None else pw.warmed,
                          "first_launches_before": before, "first_launches_after": after,
                          "first_batch_ms": first_ms}), flush=True)
    finally:
        client.shutdown()
    return 0


def phase_prewarm(card: str) -> None:
    """10c: each arm in its own process, so the cold one is really cold."""
    out = {}
    for mode in ("warm", "cold"):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--p10c-child", mode], capture_output=True, text=True,
                              timeout=600)
        check(proc.returncode == 0, f"10c {mode} arm failed:\n{proc.stderr[-4000:]}")
        out[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
    warm = out["warm"]
    check(warm["drained"] is True, "prewarm_wait did not drain")
    check(warm["first_launches_after"] == warm["first_launches_before"],
          f"{warm['first_launches_after'] - warm['first_launches_before']} first "
          f"launches after prewarm_wait")
    log({"phase": "10c", "warm": warm, "cold": out["cold"], "card": card})


def phase_bitset_past_2_31(card: str) -> None:
    """The BitSet contract past 2**31 bits (int64 end to end) on fresh
    2**32-bit BitSets, 512 MiB each on the card."""
    client = p10_client()
    try:
        got = {}
        bs = client.get_bit_set("p10-big")
        bs.set(2**31)
        got["length_after_set_2_31"] = bs.length()
        bs.set(2**32 - 1)
        got["length_after_set_2_32_minus_1"] = bs.length()
        bs2 = client.get_bit_set("p10-big2")
        bs2.set(3 * 2**30)
        got["first_set_bit_after_set_3_2_30"] = bs2.first_set_bit()
        bs3 = client.get_bit_set("p10-big3")
        bs3.set_range(2**31 - 64, 2**31 + 64)
        got["cardinality_after_set_range"] = bs3.cardinality()
        want = {"length_after_set_2_31": 2147483649,
                "length_after_set_2_32_minus_1": 4294967296,
                "first_set_bit_after_set_3_2_30": 3221225472,
                "cardinality_after_set_range": 128}
        check(got == want, f"BitSet past 2**31: {got}")
        log({"phase": "10-bitset", **got, "card": card})
    finally:
        client.shutdown()


def phase_nearcache_tenants(card: str) -> None:
    """10d: phase 3's 1000-tenant run (reads of 256 keys, under the near
    cache's 1024-key cutoff) on fresh clients with the near cache on and
    off, in turns: what the default costs reads the cache rarely hits."""
    rates = {"on": [], "off": []}
    for arm in ("on", "off", "off", "on"):
        client = p10_client(nearcache=arm == "on")
        try:
            rates[arm].append(phase_tenants(client, np.random.default_rng(3),
                                            phase=f"10d-{arm}"))
        finally:
            client.shutdown()
    log({"phase": "10d", "ops_per_s": rates, "card": card})


def timed_parts(phase, parts) -> None:
    """Run ``(name, fn)`` parts in order; log each one's seconds."""
    secs = {}
    for name, fn in parts:
        t0 = time.perf_counter()
        fn()
        secs[name] = time.perf_counter() - t0
    log({"phase": phase, "parts_s": secs})


def phase_tiers(rng, card: str) -> None:
    log({"phase": 10, "sizes": P10, "card": card})
    timed_parts("10-parts", [
        ("10a", lambda: phase_tiered(rng, card)),
        ("10b-10d", lambda: phase_nearcache(rng, card)),
        ("10-tenants", lambda: phase_nearcache_tenants(card)),
        ("10c", lambda: phase_prewarm(card)),
        ("10-bitset", lambda: phase_bitset_past_2_31(card)),
    ])


# -- phase 11: the RESP front door ---------------------------------------------

P11 = {"keys": 1 << 20, "madd": 1024, "conns": 4, "window": 16,
       "read": 131_072, "mexists": 1024, "fpp": 0.01, "capacity": 1_000_000,
       "c6_conns": 4, "c6_depth": 256, "c6_batches": 2, "c6_items": 512,
       "c6_filter": 100_000,
       "c8_idle": 1000, "c8_active": 32, "c8_procs": 8, "c8_pass_s": 1.5,
       "c8_items": 512}
P11_DEVICE = "cuda"


def wire(cmds) -> bytes:
    from redisson_tpu_torch.serve.wireutil import wire_command

    return b"".join(wire_command(c) for c in cmds)


def read_frames(sock, n: int, timeout: float = 300.0) -> list:
    """Exactly ``n`` complete reply frames from ``sock``, as bytes."""
    from redisson_tpu_torch.serve.wireutil import skip_reply_frame

    sock.settimeout(timeout)
    buf, out, pos = b"", [], 0
    while True:
        try:
            while len(out) < n:
                end = skip_reply_frame(buf, pos)
                out.append(buf[pos:end])
                pos = end
        except (IndexError, ValueError):
            pass
        if len(out) >= n:
            check(pos == len(buf), "extra reply bytes after the expected frames")
            return out
        chunk = sock.recv(1 << 20)
        check(bool(chunk), f"connection closed after {len(out)} of {n} replies")
        buf += chunk


def roundtrip(server, cmds) -> list:
    import socket

    s = socket.create_connection((server.host, server.port))
    try:
        s.sendall(wire(cmds))
        return read_frames(s, len(cmds))
    finally:
        s.close()


def int_array(frame: bytes) -> np.ndarray:
    """The integers of a RESP array reply of integers."""
    parts = frame.split(b"\r\n")
    check(parts[0][:1] == b"*", f"not an array reply: {frame[:40]!r}")
    n = int(parts[0][1:])
    check(all(p[:1] == b":" for p in parts[1:1 + n]), "not an integer array")
    return np.array([int(p[1:]) for p in parts[1:1 + n]], np.int64)


def p11_client(**kw):
    import redisson_tpu_torch as rt

    return rt.create(rt.Config().use_gpu_sketch(device=P11_DEVICE, **kw))


def p11_server(client):
    from redisson_tpu_torch.serve.resp import RespServer

    return RespServer(client, max_connections=4096)


def wire_hashes(client, items, m: int):
    """(h1 mod m, h2 mod m) of wire items as the server hashes them: the
    client codec's bytes, murmur3 x86-128."""
    from redisson_tpu_torch import codecs
    from redisson_tpu_torch.utils import hashing

    return hashing.km_reduce_mod(
        *hashing.hash128_np(*codecs.encode_batch(client.config.codec, items)), m)


def c11_keys(lo: int, hi: int) -> list:
    return [b"%d" % i for i in range(lo, hi)]


def madd_model(h1, h2, m: int, k: int, per: int, conns: int):
    """The golden model of a BF.MADD load where connection c sends commands
    c, c + conns, ... of ``per`` keys each (command j holds keys
    [j * per, (j + 1) * per) of the hashed ``h1, h2``): the golden filter
    of every key, per key whether its bits are all set by OTHER keys, and
    per connection its keys and the flags a sequential golden filter of
    that connection alone gives them.  Loads of the same keys in the same
    order into several filters share one model."""
    from redisson_tpu_torch.ops import golden

    n = len(h1)
    g = golden.GoldenBloomFilter(m, k)
    idx = g._indexes(h1, h2)
    hits = np.bincount(idx.reshape(-1).astype(np.int64), minlength=m)
    own = np.zeros((n, k), np.int64)  # a key's own hits on each of its bits
    for j in range(k):
        same = idx == idx[:, j:j + 1]
        own[:, j] = same.sum(axis=1)
    covered_by_others = np.all(hits[idx.astype(np.int64)] - own > 0, axis=1)
    streams = []
    for c in range(conns):
        keys = np.concatenate([np.arange(j * per, (j + 1) * per)
                               for j in range(c, n // per, conns)])
        seq = golden.GoldenBloomFilter(m, k)
        streams.append((keys, seq.add_hashed(h1[keys], h2[keys])))
    g.bits[idx.reshape(-1)] = True
    return g, covered_by_others, streams


def madd_check(model, replies, tag: str) -> int:
    """Holds each connection's BF.MADD flags (``replies[c]``, its reply
    frames) to ``madd_model``'s bounds and returns the keys added.  The
    flags of one connection depend on the others' adds only through the
    interleaving, so a reply is right when it lies between the two orders
    the golden model bounds it by: 1 only if the key's bits were not all
    set by the earlier keys of its own connection, and 0 only if every one
    of its bits is set by some OTHER key of the whole load."""
    _g, covered_by_others, streams = model
    n_added = 0
    for (keys, upper), frames in zip(streams, replies):
        # Raw reply frames, or replies a routing client already decoded.
        flags = np.concatenate([int_array(f) if isinstance(f, bytes)
                                else np.asarray(f, np.int64) for f in frames])
        check(flags.shape == keys.shape and np.isin(flags, (0, 1)).all(),
              f"{tag}: BF.MADD replies malformed")
        check(np.all(flags <= upper), f"{tag}: BF.MADD reported a key new whose "
              "bits its own connection had already set")
        check(np.all(flags >= ~covered_by_others[keys]), f"{tag}: BF.MADD reported "
              "a key present whose bits no other key sets")
        n_added += int(flags.sum())
    return n_added


def golden_words(g, row_words: int) -> np.ndarray:
    """A golden filter's bitmap as the uint32 words of a pool row."""
    gbits = np.zeros(row_words * 32, bool)
    gbits[:g.bits.shape[0]] = g.bits
    return np.packbits(gbits, bitorder="little").view(np.uint32)


def phase_wire_bloom(rng, card: str) -> None:
    """11a: config 1 over the wire at full size."""
    import socket

    n, per, conns = P11["keys"], P11["madd"], P11["conns"]
    client = p11_client()
    server = p11_server(client)
    try:
        check(roundtrip(server, [[b"BF.RESERVE", b"cfg1", b"%g" % P11["fpp"],
                                  b"%d" % P11["capacity"]]]) == [b"+OK\r\n"],
              "BF.RESERVE refused")
        bf = client.get_bloom_filter("cfg1")
        m, k = bf.get_size(), bf.get_hash_iterations()
        # Warm-up on a filter of the same size class (first launches of
        # each op, the reactor's first ticks) outside the timed window.
        roundtrip(server, [[b"BF.RESERVE", b"warm", b"%g" % P11["fpp"],
                            b"%d" % P11["capacity"]]]
                  + [[b"BF.MADD", b"warm"] + c11_keys(i * per, (i + 1) * per)
                     for i in range(8)]
                  + [[b"BF.MEXISTS", b"warm"] + c11_keys(i * per, (i + 1) * per)
                     for i in range(8)])
        n_cmds = n // per
        # Connection c sends commands c, c + conns, ... in pipelined windows.
        streams = [[[b"BF.MADD", b"cfg1"] + c11_keys(j * per, (j + 1) * per)
                    for j in range(c, n_cmds, conns)] for c in range(conns)]
        payloads = [[wire(s[i:i + P11["window"]]) for i in range(0, len(s), P11["window"])]
                    for s in streams]
        replies = [None] * conns
        errors = []

        def load(c):
            try:
                sock = socket.create_connection((server.host, server.port))
                out = []
                for i, p in enumerate(payloads[c]):
                    sock.sendall(p)
                    out += read_frames(sock, min(P11["window"], len(streams[c]) - i * P11["window"]))
                sock.close()
                replies[c] = out
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=load, args=(c,)) for c in range(conns)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        add_s = time.perf_counter() - t0
        check(not errors, f"wire load failed: {errors[:1]}")
        h1, h2 = wire_hashes(client, c11_keys(0, n), m)
        model = madd_model(h1, h2, m, k, per, conns)
        g, n_added = model[0], madd_check(model, replies, "11a")
        check(0.97 * n <= n_added <= n, f"added {n_added} of {n}")
        words = tenant_row(client, "cfg1")
        check(np.array_equal(words, golden_words(g, words.shape[0])),
              "11a: filter row differs from the golden bitmap")
        # Read: keys outside the loaded set, BF.MEXISTS over 4 connections.
        outside = rng.integers(3 * n, 8 * n, P11["read"])
        items = [b"%d" % v for v in outside]
        per_r = P11["mexists"]
        cmds = [[b"BF.MEXISTS", b"cfg1"] + items[i:i + per_r]
                for i in range(0, len(items), per_r)]
        rstreams = [cmds[c::conns] for c in range(conns)]
        rreplies = [None] * conns

        def read(c):
            try:
                sock = socket.create_connection((server.host, server.port))
                out = []
                for i in range(0, len(rstreams[c]), P11["window"]):
                    part = rstreams[c][i:i + P11["window"]]
                    sock.sendall(wire(part))
                    out += read_frames(sock, len(part))
                sock.close()
                rreplies[c] = out
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=read, args=(c,)) for c in range(conns)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        read_s = time.perf_counter() - t0
        check(not errors, f"wire read failed: {errors[:1]}")
        o1, o2 = wire_hashes(client, items, m)
        want = g.contains_hashed(o1, o2)
        got = np.zeros(len(items), bool)
        for c in range(conns):
            for j, f in enumerate(rreplies[c]):
                lo = (c + j * conns) * per_r
                got[lo:lo + per_r] = int_array(f).astype(bool)
        check(np.array_equal(got, want), "11a: BF.MEXISTS differs from golden")
        fpp = float(got.mean())
        p_theory = (1.0 - np.exp(-k * n / m)) ** k
        sigma = np.sqrt(p_theory * (1.0 - p_theory) / len(items))
        check(abs(fpp - p_theory) <= 3 * sigma,
              f"11a: FPP {fpp} vs expected {p_theory} +- {3 * sigma}")
        check_healthy(client, "11a")
        log({"phase": "11a", "config": "bloom 1M keys 1% FPP over RESP",
             "connections": conns, "madd_keys_per_cmd": per,
             "wire_add_ops_per_s": n / add_s, "wire_contains_ops_per_s": len(items) / read_s,
             "added": n_added, "fpp": fpp, "fpp_expected": p_theory,
             "fpp_3sigma": 3 * sigma, "row_equals_golden": True,
             "native_parser": bool(server.reactor and server.reactor.native_tick),
             "card": card})
    finally:
        server.close()
        client.shutdown()


def config6_seed_cmds() -> list:
    """Config 6's keyspace: the 100,000-key / 1% filter holding the even
    hot items, four strings, a bitmap with its even offsets set."""
    n_items = P11["c6_items"]
    cmds = [[b"BF.RESERVE", b"fd-bf", b"0.01", b"%d" % P11["c6_filter"]]]
    cmds += [[b"BF.MADD", b"fd-bf"] + [b"%d" % i for i in range(j, min(j + 64, n_items), 2)]
             for j in range(0, n_items, 64)]
    cmds += [[b"SET", b"fd-s%d" % i, b"value-%d" % i] for i in range(4)]
    cmds += [[b"SETBIT", b"fd-bs", b"%d" % i, b"1"] for i in range(0, 64, 2)]
    return cmds


def config6_batches(seed: int, n_batches: int, depth: int) -> list:
    """Config 6's pipelined traffic (``bench.py::bench_config6_frontdoor``):
    spans of 16-48 commands on one family — Bloom 0.5 (15% BF.ADD among
    BF.EXISTS), strings 0.3 (4% SET among GET), bitmap 0.2 (20% SETBIT
    among GETBIT) — over zipf(1.3) keys on 512 hot items.  A SET writes
    its key's seed value, so what a GET returns does not depend on how
    the connections interleave."""
    rng = np.random.default_rng(seed)
    n_items = P11["c6_items"]
    out = []
    for _ in range(n_batches):
        cmds = []
        while len(cmds) < depth:
            burst = min(int(rng.integers(16, 49)), depth - len(cmds))
            hot = (rng.zipf(1.3, burst) - 1) % n_items
            fam = rng.random()
            for i in range(burst):
                w = rng.random()
                if fam < 0.5:
                    op = b"BF.ADD" if w < 0.15 else b"BF.EXISTS"
                    cmds.append([op, b"fd-bf", b"%d" % hot[i]])
                elif fam < 0.8:
                    key = int(hot[i]) % 4
                    cmds.append([b"SET", b"fd-s%d" % key, b"value-%d" % key] if w < 0.04
                                else [b"GET", b"fd-s%d" % key])
                else:
                    off = b"%d" % (hot[i] % 64)
                    cmds.append([b"SETBIT", b"fd-bs", off, b"1"] if w < 0.2
                                else [b"GETBIT", b"fd-bs", off])
        out.append(cmds)
    return out


def config6_pass(server, batches_per_conn) -> tuple:
    """One pass: connection c streams its batches, one pipelined batch in
    flight at a time.  Returns (reply bytes per connection, seconds)."""
    import socket

    conns = len(batches_per_conn)
    payloads = [[wire(b) for b in bs] for bs in batches_per_conn]
    out = [None] * conns
    errors = []

    def worker(c):
        try:
            sock = socket.create_connection((server.host, server.port))
            got = []
            for b, p in zip(batches_per_conn[c], payloads[c]):
                sock.sendall(p)
                got += read_frames(sock, len(b))
            sock.close()
            out[c] = b"".join(got)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(c,)) for c in range(conns)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    check(not errors, f"config 6 pass failed: {errors[:1]}")
    return out, dt


def frontdoor_totals(server) -> dict:
    from redisson_tpu_torch.obs import total

    o = server.obs
    return {"fused": total(o.resp_fused_cmds), "cmds": total(o.resp_commands),
            "hits": total(o.resp_cache_hits), "misses": total(o.resp_cache_misses)}


def device_idle_share(fn, name: str = "frontdoor") -> dict:
    """Wall, device busy (the union of the kernel and memcpy intervals the
    profiler saw) and idle share of one call of ``fn``; None where the
    profiler saw no device activity."""
    import profile_port

    if P11_DEVICE != "cuda":
        return {"wall_ms": None, "device_busy_ms": None, "idle_share": None}
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    row = profile_port.profile_pass(name, fn, out_dir, warm=False)
    return {k: row[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                "top_device_ms")}


def phase_config6(card: str, seed: int) -> None:
    """11b: config 6's stream on a vectorizing and a sequential server."""
    P, depth, nb = P11["c6_conns"], P11["c6_depth"], P11["c6_batches"]
    batches = config6_batches(seed, P * nb, depth)
    per_conn = [batches[c * nb:(c + 1) * nb] for c in range(P)]
    arms = {}
    for vec in (True, False):
        client = p11_client(batch_window_us=200)
        client.config.resp_vectorize = vec
        server = p11_server(client)
        try:
            roundtrip(server, config6_seed_cmds())
            config6_pass(server, per_conn)  # warm: every write of the stream lands once
            before = frontdoor_totals(server)
            replies, dt = config6_pass(server, per_conn)
            after = frontdoor_totals(server)
            d = {k: after[k] - before[k] for k in after}
            prof = device_idle_share(lambda: config6_pass(server, per_conn)) if vec else None
            check_healthy(client, "11b")
            arms[vec] = {"replies": replies, "dt": dt, "d": d, "prof": prof,
                         "rows": (tenant_row(client, "fd-bf"), tenant_row(client, "fd-bs"))}
        finally:
            server.close()
            client.shutdown()
    for c in range(P):
        check(arms[True]["replies"][c] == arms[False]["replies"][c],
              f"11b: connection {c}'s replies differ between the arms")
    for a, b in zip(arms[True]["rows"], arms[False]["rows"]):
        check(np.array_equal(a, b), "11b: rows differ between the arms")
    n_cmds = P * nb * depth
    d = arms[True]["d"]
    log({"phase": "11b", "config": "config 6 front door", "connections": P,
         "depth": depth, "batches_per_conn": nb, "cmds": n_cmds,
         "cmds_per_s": n_cmds / arms[True]["dt"],
         "unfused_cmds_per_s": n_cmds / arms[False]["dt"],
         "fusion_ratio": d["fused"] / d["cmds"] if d["cmds"] else 0.0,
         "response_cache_hit_rate": d["hits"] / (d["hits"] + d["misses"])
         if d["hits"] + d["misses"] else 0.0,
         "replies_equal": True, "rows_equal": True,
         "profile_one_pass": arms[True]["prof"], "card": card})


def config8_seed_cmds() -> list:
    n_items = P11["c8_items"]
    cmds = [[b"BF.RESERVE", b"rx-bf", b"0.01", b"100000"]]
    cmds += [[b"BF.MADD", b"rx-bf"] + [b"%d" % i for i in range(j, j + 64)]
             for j in range(0, n_items, 64)]
    cmds += [[b"SET", b"rx-s%d" % i, b"value-%d" % i] for i in range(4)]
    cmds += [[b"SETBIT", b"rx-bs", b"%d" % i, b"1"] for i in range(0, 64, 2)]
    for _ in range(3):  # the fused paths' first launches, outside the passes
        cmds += [[b"BF.EXISTS", b"rx-bf", b"%d" % i] for i in range(32)]
        cmds += [[b"BF.ADD", b"rx-bf", b"%d" % i] if i % 4 == 0 else
                 [b"BF.EXISTS", b"rx-bf", b"%d" % i] for i in range(32)]
        cmds += [[b"GETBIT", b"rx-bs", b"%d" % (i % 64)] for i in range(32)]
        cmds += [[b"GET", b"rx-s%d" % (i % 4)] for i in range(16)]
    return cmds


def config8_command(rng) -> list:
    """One command of config 8's closed-loop clients
    (``bench.py::bench_config8_reactor``): 3% BF.ADD, 35% BF.EXISTS, 50%
    GET, the rest GETBIT, over zipf(1.3) on 512 hot items."""
    hot = int((rng.zipf(1.3) - 1) % P11["c8_items"])
    r = rng.random()
    if r < 0.03:
        return [b"BF.ADD", b"rx-bf", b"%d" % hot]
    if r < 0.38:
        return [b"BF.EXISTS", b"rx-bf", b"%d" % hot]
    if r < 0.88:
        return [b"GET", b"rx-s%d" % (hot % 4)]
    return [b"GETBIT", b"rx-bs", b"%d" % (hot % 64)]


def config8_client_proc(host, port, conns, seconds, seed, q):
    """Closed-loop single-command clients in a child process (so the
    clients do not share the server's interpreter): one thread per
    connection, one command in flight.  Puts (count, seconds, latencies,
    the distinct (command, reply) pairs seen)."""
    import socket

    counts = [0] * conns
    lats = [[] for _ in range(conns)]
    seen = [dict() for _ in range(conns)]

    def worker(t):
        rng = np.random.default_rng(seed * 100 + t)
        sock = socket.create_connection((host, port))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        stop = time.perf_counter() + seconds
        try:
            while time.perf_counter() < stop:
                cmd = config8_command(rng)
                t0 = time.perf_counter()
                sock.sendall(wire([cmd]))
                rep = read_frames(sock, 1, timeout=60.0)[0]
                lats[t].append(time.perf_counter() - t0)
                counts[t] += 1
                seen[t].setdefault(tuple(cmd), set()).add(rep)
        finally:
            sock.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(conns)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    pairs = {}
    for s in seen:
        for k, v in s.items():
            pairs.setdefault(k, set()).update(v)
    q.put((sum(counts), time.perf_counter() - t0, [x for la in lats for x in la],
           {k: sorted(v) for k, v in pairs.items()}))


def serving_threads() -> int:
    return sum(1 for t in threading.enumerate() if t.name.startswith("rtpu-resp"))


def open_fds() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def phase_config8(card: str, seed: int) -> None:
    """11c: config 8's traffic, reactor against thread-per-connection."""
    import multiprocessing as mp
    import resource
    import socket

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    # Both ends of an idle connection live in this process: 2 fds each.
    idle_n = min(P11["c8_idle"], max(0, (soft - 512) // 2))
    ctx = mp.get_context("spawn")
    out = {}
    for arm in (True, False):
        client = p11_client(batch_window_us=200)
        client.config.resp_reactor = arm
        server = p11_server(client)
        idle = []
        try:
            roundtrip(server, config8_seed_cmds())
            threads_base = serving_threads()  # before any idle connection
            for _ in range(idle_n):
                idle.append(socket.create_connection((server.host, server.port), timeout=10))
            threads_idle = serving_threads()

            def measure(seconds):
                q = ctx.Queue()
                per = P11["c8_active"] // P11["c8_procs"]
                procs = [ctx.Process(target=config8_client_proc,
                                     args=(server.host, server.port, per, seconds, seed + i, q))
                         for i in range(P11["c8_procs"])]
                for p in procs:
                    p.start()
                res = [q.get(timeout=seconds + 120) for _ in procs]
                for p in procs:
                    p.join(timeout=30)
                return res

            measure(1.0)  # warm
            threads_loaded = serving_threads()
            res = measure(P11["c8_pass_s"])
            total = sum(r[0] for r in res)
            dt = float(np.median([r[1] for r in res]))
            lat = np.sort(np.concatenate([np.asarray(r[2]) for r in res]))
            pairs = {}
            for r in res:
                for k, v in r[3].items():
                    pairs.setdefault(k, set()).update(v)
            # Every distinct command got one reply only, equal to a
            # sequential replay on one connection.
            cmds = sorted(pairs)
            check(all(len(v) == 1 for v in pairs.values()),
                  "11c: one command got different replies")
            replay = roundtrip(server, [list(c) for c in cmds])
            check(all(pairs[c] == {r} for c, r in zip(cmds, replay)),
                  "11c: replies differ from a sequential replay")
            nthreads = server.reactor.nthreads if server.reactor is not None else 0
            if arm:
                # Fixed: the same serving threads (the reactor's and the
                # accept thread) however many connections are open.
                check(threads_idle == threads_base and threads_loaded <= threads_base + 1,
                      f"11c: serving threads {threads_base} -> {threads_idle} idle, "
                      f"{threads_loaded} loaded, with a reactor of {nthreads}")
            check_healthy(client, "11c")
            out["reactor" if arm else "reactor_off"] = {
                "cmds_per_s": total / dt, "p50_ms": float(lat[len(lat) // 2] * 1e3),
                "p99_ms": float(lat[int(len(lat) * 0.99)] * 1e3),
                "serving_threads_before_conns": threads_base,
                "serving_threads_idle": threads_idle,
                "serving_threads_loaded": threads_loaded,
                "process_fds": open_fds(), "distinct_cmds": len(cmds)}
        finally:
            for s in idle:
                s.close()
            server.close()
            client.shutdown()
    log({"phase": "11c", "config": "config 8 reactor", "idle_conns": idle_n,
         "idle_target": P11["c8_idle"], "active_conns": P11["c8_active"],
         "fd_soft_limit": soft, **out, "card": card})


def c11d_boot(port: int, sdir: str):
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    return subprocess.Popen(
        [sys.executable, "-m", "redisson_tpu_torch", "--port", str(port),
         "--device", P11_DEVICE, "--snapshot-dir", sdir],
        cwd=str(Path(__file__).resolve().parent), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def c11d_connect(port: int, proc, timeout: float = 180.0):
    import socket

    t0 = time.perf_counter()
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=120)
            if sock.getsockname() != sock.getpeername():
                return sock
            # A TCP self-connect to the port the server has yet to bind:
            # drop it at once, or the server's bind fails.
            sock.close()
        except OSError:
            if proc.poll() is not None:
                fail(f"server exited: {proc.communicate()[0][-2000:]}")
            check(time.perf_counter() - t0 < timeout, "server did not start")
            time.sleep(0.2)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def held_ports(n: int):
    """``n`` free ports kept bound (SO_REUSEADDR, not listening) until the
    block ends, so that no outgoing connection takes one as its source
    port before its server binds it (the servers bind with SO_REUSEADDR,
    which such a holder admits)."""
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            socks.append(s)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
        yield [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


C11D_WRITES = [
    [b"PING"], [b"SET", b"cli-k", b"v"], [b"INCR", b"cli-n"], [b"INCR", b"cli-n"],
    [b"BF.RESERVE", b"cli-bf", b"0.01", b"1000"], [b"BF.ADD", b"cli-bf", b"alpha"],
    [b"BF.EXISTS", b"cli-bf", b"alpha"], [b"PFADD", b"cli-h", b"a", b"b", b"c"],
    [b"PFCOUNT", b"cli-h"], [b"SETBIT", b"cli-bs", b"77", b"1"],
    [b"GETBIT", b"cli-bs", b"77"], [b"CMS.INITBYDIM", b"cli-cms", b"1024", b"4"],
    [b"CMS.INCRBY", b"cli-cms", b"x", b"5", b"y", b"2"], [b"CMS.QUERY", b"cli-cms", b"x", b"y"],
    [b"TOPK.RESERVE", b"cli-tk", b"2"], [b"TOPK.ADD", b"cli-tk", b"a", b"b", b"a", b"c", b"a"],
    [b"TOPK.LIST", b"cli-tk", b"WITHCOUNT"],
]
C11D_READS = [
    [b"GET", b"cli-k"], [b"GET", b"cli-n"], [b"BF.EXISTS", b"cli-bf", b"alpha"],
    [b"BF.EXISTS", b"cli-bf", b"nope"], [b"PFCOUNT", b"cli-h"], [b"GETBIT", b"cli-bs", b"77"],
    [b"GETBIT", b"cli-bs", b"78"], [b"CMS.QUERY", b"cli-cms", b"x", b"y", b"z"],
    [b"TOPK.LIST", b"cli-tk", b"WITHCOUNT"], [b"DBSIZE"], [b"TYPE", b"cli-bf"],
]


def phase_entry_point(card: str) -> None:
    """11d: ``python -m redisson_tpu_torch`` boots, serves, drains and
    snapshots on SIGTERM, and a reboot on the same directory answers every
    read as before."""
    import signal

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    sdir = tempfile.mkdtemp(prefix="phase11d-", dir=str(build))
    try:
        answers = []
        for boot in range(2):
            port = free_port()
            t0 = time.perf_counter()
            proc = c11d_boot(port, sdir)
            try:
                sock = c11d_connect(port, proc)
                boot_s = time.perf_counter() - t0
                if boot == 0:
                    sock.sendall(wire(C11D_WRITES))
                    w = read_frames(sock, len(C11D_WRITES))
                    check(not any(f.startswith(b"-") for f in w), f"11d: write failed: {w}")
                sock.sendall(wire(C11D_READS + [[b"INFO", b"server"]]))
                r = read_frames(sock, len(C11D_READS) + 1)
                sock.close()
                info = r[-1].decode()
                check(f"rtpu_device:{P11_DEVICE}" in info, f"11d: INFO server: {info}")
                if P11_DEVICE == "cuda":
                    check(torch.cuda.get_device_name(0) in info, "11d: INFO lacks the card")
                answers.append(r[:-1])
                proc.send_signal(signal.SIGTERM)
                out, _ = proc.communicate(timeout=180)
                check(proc.returncode == 0, f"11d: exit {proc.returncode}: {out[-2000:]}")
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate(timeout=30)
            if boot == 0:
                check(os.path.exists(os.path.join(sdir, "grid_store.bin")),
                      "11d: no grid_store.bin after SIGTERM")
                first_boot_s = boot_s
        check(answers[0] == answers[1], f"11d: reboot answers differ: {answers}")
        check(answers[0][0] == b"$1\r\nv\r\n" and answers[0][1] == b"$1\r\n2\r\n"
              and answers[0][2] == b":1\r\n", f"11d: wrong answers {answers[0]}")
        log({"phase": "11d", "entry_point": "python -m redisson_tpu_torch",
             "boot_s": first_boot_s, "reboot_s": boot_s, "reads": len(C11D_READS),
             "reads_equal_after_restart": True, "info_server_card": True, "card": card})
    finally:
        shutil.rmtree(sdir, ignore_errors=True)


def phase_frontdoor(rng, seed: int, card: str) -> None:
    os.environ["RTPU_REQUIRE_NATIVE_RESP"] = "1"
    from redisson_tpu_torch.serve import native_codec

    check(native_codec.get_parser() is not None and native_codec.get_ticker() is not None,
          "the native RESP codec did not build")
    timed_parts("11-parts", [
        ("11a", lambda: phase_wire_bloom(rng, card)),
        ("11b", lambda: phase_config6(card, seed)),
        ("11c", lambda: phase_config8(card, seed)),
        ("11d", lambda: phase_entry_point(card)),
    ])


# -- phase 12: the data grid, the RTopic -> CMS pipe, pub/sub, blocking pops ---

P12 = {"events": 16_000_000, "msg": 1 << 15, "keys": 100_000, "d": 5, "w": 1 << 16,
       "top_k": 20, "batch_size": 1 << 15, "flush_s": 0.05, "pipeline": 1000}
P12_DEVICE = "cuda"

# The grid session of 12b: lists, hashes, sets, sorted sets (SCAN family,
# STORE commands), streams with a consumer group, geo, WRONGTYPE between a
# Bloom key and a list key.  bytes = the literal Redis reply (the pairs of
# tests/test_resp_wire_fixtures.py and Redis's documented GEO replies);
# None = equal to the CPU server's bytes only; ("prefix", p) / ("shape", p)
# = both replies start with p (error codes; random picks and idle times).
P12_GRID = [
    # the literal pairs of tests/test_resp_wire_fixtures.py
    ([b"RPUSH", b"l", b"a", b"b"], b":2\r\n"),
    ([b"LPUSH", b"l", b"z"], b":3\r\n"),
    ([b"LRANGE", b"l", b"0", b"-1"], b"*3\r\n$1\r\nz\r\n$1\r\na\r\n$1\r\nb\r\n"),
    ([b"LPOP", b"l"], b"$1\r\nz\r\n"),
    ([b"LLEN", b"l"], b":2\r\n"),
    ([b"HSET", b"h", b"f1", b"v1"], b":1\r\n"),
    ([b"HGET", b"h", b"f1"], b"$2\r\nv1\r\n"),
    ([b"HEXISTS", b"h", b"f1"], b":1\r\n"),
    ([b"HLEN", b"h"], b":1\r\n"),
    ([b"SADD", b"s", b"a", b"b"], b":2\r\n"),
    ([b"SISMEMBER", b"s", b"a"], b":1\r\n"),
    ([b"SISMEMBER", b"s", b"q"], b":0\r\n"),
    ([b"SCARD", b"s"], b":2\r\n"),
    ([b"ZADD", b"z", b"1.5", b"m"], b":1\r\n"),
    ([b"ZSCORE", b"z", b"m"], b"$3\r\n1.5\r\n"),
    ([b"ZCARD", b"z"], b":1\r\n"),
    ([b"HSET", b"s", b"f"], ("prefix", b"-ERR")),
    ([b"LPOP", b"h"], ("prefix", b"-WRONGTYPE")),
    # lists
    ([b"RPUSH", b"l", b"c", b"a", b"d"], b":5\r\n"),
    ([b"LINDEX", b"l", b"-1"], b"$1\r\nd\r\n"),
    ([b"LINDEX", b"l", b"99"], b"$-1\r\n"),
    ([b"LSET", b"l", b"1", b"B"], b"+OK\r\n"),
    ([b"LSET", b"l", b"99", b"B"], ("prefix", b"-ERR")),
    ([b"LPOS", b"l", b"a"], b":0\r\n"),
    ([b"LPOS", b"l", b"a", b"RANK", b"2"], b":3\r\n"),
    ([b"LPOS", b"l", b"a", b"COUNT", b"0"], b"*2\r\n:0\r\n:3\r\n"),
    ([b"LREM", b"l", b"1", b"a"], b":1\r\n"),
    ([b"LRANGE", b"l", b"0", b"-1"], None),
    ([b"LTRIM", b"l", b"0", b"2"], b"+OK\r\n"),
    ([b"LPUSHX", b"l", b"x"], b":4\r\n"),
    ([b"RPUSHX", b"nolist", b"x"], b":0\r\n"),
    ([b"RPOPLPUSH", b"l", b"l2"], None),
    ([b"LMOVE", b"l", b"l2", b"LEFT", b"RIGHT"], None),
    ([b"LRANGE", b"l2", b"0", b"-1"], None),
    ([b"RPOP", b"l"], None),
    ([b"RPOP", b"ghostlist"], b"$-1\r\n"),
    ([b"BLPOP", b"l2", b"1"], b"*2\r\n$2\r\nl2\r\n$1\r\na\r\n"),
    ([b"BRPOP", b"emptyl", b"l2", b"1"], b"*2\r\n$2\r\nl2\r\n$1\r\nx\r\n"),
    ([b"TYPE", b"l"], b"+list\r\n"),
    # hashes
    ([b"HSET", b"h", b"f2", b"v2", b"f3", b"v3"], b":2\r\n"),
    ([b"HMGET", b"h", b"f1", b"nope", b"f3"], b"*3\r\n$2\r\nv1\r\n$-1\r\n$2\r\nv3\r\n"),
    ([b"HGETALL", b"h"], None),
    ([b"HKEYS", b"h"], None),
    ([b"HVALS", b"h"], None),
    ([b"HSETNX", b"h", b"f1", b"x"], b":0\r\n"),
    ([b"HSETNX", b"h", b"f4", b"x"], b":1\r\n"),
    ([b"HINCRBY", b"h", b"n", b"5"], b":5\r\n"),
    ([b"HINCRBY", b"h", b"n", b"-2"], b":3\r\n"),
    ([b"HINCRBY", b"h", b"f1", b"1"], ("prefix", b"-ERR")),
    ([b"HDEL", b"h", b"f4", b"nope"], b":1\r\n"),
    ([b"HSCAN", b"h", b"0", b"COUNT", b"100"], None),
    ([b"HSCAN", b"h", b"0", b"MATCH", b"f*", b"COUNT", b"1"], None),
    ([b"HSCAN", b"h", b"0", b"NOVALUES"], None),
    ([b"HRANDFIELD", b"h", b"-3"], ("shape", b"*3\r\n")),
    ([b"TYPE", b"h"], b"+hash\r\n"),
    # sets
    ([b"SADD", b"s2", b"b", b"c"], b":2\r\n"),
    ([b"SMISMEMBER", b"s", b"a", b"c"], b"*2\r\n:1\r\n:0\r\n"),
    ([b"SINTER", b"s", b"s2"], b"*1\r\n$1\r\nb\r\n"),
    ([b"SUNION", b"s", b"s2"], None),
    ([b"SDIFF", b"s", b"s2"], b"*1\r\n$1\r\na\r\n"),
    ([b"SINTERCARD", b"2", b"s", b"s2"], b":1\r\n"),
    ([b"SUNIONSTORE", b"su", b"s", b"s2"], b":3\r\n"),
    ([b"SDIFFSTORE", b"sd", b"s", b"s2"], b":1\r\n"),
    ([b"SINTERSTORE", b"si", b"s", b"s2"], b":1\r\n"),
    ([b"SMEMBERS", b"sd"], b"*1\r\n$1\r\na\r\n"),
    ([b"SMOVE", b"s", b"s2", b"a"], b":1\r\n"),
    ([b"SREM", b"s2", b"a", b"zz"], b":1\r\n"),
    ([b"SSCAN", b"su", b"0", b"COUNT", b"100"], None),
    ([b"SSCAN", b"su", b"0", b"MATCH", b"[ab]"], None),
    ([b"SRANDMEMBER", b"su", b"-2"], ("shape", b"*2\r\n")),
    ([b"SPOP", b"si"], b"$1\r\nb\r\n"),
    ([b"TYPE", b"su"], b"+set\r\n"),
    # sorted sets
    ([b"ZADD", b"z", b"2", b"n", b"3", b"o", b"0.25", b"p"], b":3\r\n"),
    ([b"ZRANGE", b"z", b"0", b"-1", b"WITHSCORES"], None),
    ([b"ZREVRANGE", b"z", b"0", b"1", b"WITHSCORES"], None),
    ([b"ZRANK", b"z", b"o"], b":3\r\n"),
    ([b"ZREVRANK", b"z", b"o"], b":0\r\n"),
    ([b"ZCOUNT", b"z", b"1", b"(3"], b":2\r\n"),
    ([b"ZRANGEBYSCORE", b"z", b"-inf", b"+inf", b"WITHSCORES", b"LIMIT", b"1", b"2"], None),
    ([b"ZINCRBY", b"z", b"0.5", b"m"], b"$1\r\n2\r\n"),
    ([b"ZADD", b"z2", b"10", b"m", b"20", b"q"], b":2\r\n"),
    ([b"ZUNIONSTORE", b"zu", b"2", b"z", b"z2", b"WEIGHTS", b"1", b"2"], b":5\r\n"),
    ([b"ZINTERSTORE", b"zi", b"2", b"z", b"z2", b"AGGREGATE", b"MAX"], b":1\r\n"),
    ([b"ZRANGE", b"zu", b"0", b"-1", b"WITHSCORES"], None),
    ([b"ZSCORE", b"zi", b"m"], b"$2\r\n10\r\n"),
    ([b"ZSCAN", b"zu", b"0", b"COUNT", b"100"], None),
    ([b"ZSCAN", b"zu", b"0", b"MATCH", b"m*"], None),
    ([b"ZADD", b"lex", b"0", b"a", b"0", b"b", b"0", b"c", b"0", b"d"], b":4\r\n"),
    ([b"ZRANGEBYLEX", b"lex", b"[b", b"(d"], b"*2\r\n$1\r\nb\r\n$1\r\nc\r\n"),
    ([b"ZRANGEBYLEX", b"lex", b"-", b"+", b"LIMIT", b"1", b"2"], None),
    ([b"ZRANDMEMBER", b"z", b"-2"], ("shape", b"*2\r\n")),
    ([b"ZPOPMIN", b"z"], b"*2\r\n$1\r\np\r\n$4\r\n0.25\r\n"),
    ([b"ZPOPMAX", b"z", b"2"], None),
    ([b"ZREMRANGEBYSCORE", b"zu", b"-inf", b"(20"], b":3\r\n"),
    ([b"ZREM", b"zu", b"q", b"zz"], b":1\r\n"),
    ([b"TYPE", b"z"], b"+zset\r\n"),
    # streams with a consumer group
    ([b"XADD", b"st", b"1-1", b"f", b"v1"], b"$3\r\n1-1\r\n"),
    ([b"XADD", b"st", b"2-0", b"f", b"v2", b"g", b"w"], b"$3\r\n2-0\r\n"),
    ([b"XADD", b"st", b"3-0", b"f", b"v3"], b"$3\r\n3-0\r\n"),
    ([b"XADD", b"st", b"1-0", b"f", b"bad"], ("prefix", b"-ERR")),
    ([b"XLEN", b"st"], b":3\r\n"),
    ([b"XRANGE", b"st", b"-", b"+"], None),
    ([b"XRANGE", b"st", b"-", b"+", b"COUNT", b"1"], None),
    ([b"XREVRANGE", b"st", b"+", b"-"], None),
    ([b"XGROUP", b"CREATE", b"st", b"g1", b"0"], b"+OK\r\n"),
    ([b"XGROUP", b"CREATE", b"st", b"g1", b"0"], ("prefix", b"-BUSYGROUP")),
    ([b"XREADGROUP", b"GROUP", b"g1", b"c1", b"COUNT", b"2", b"STREAMS", b"st", b">"], None),
    ([b"XPENDING", b"st", b"g1"], None),
    ([b"XPENDING", b"st", b"g1", b"-", b"+", b"10"],
     ("shape", b"*2\r\n*4\r\n$3\r\n1-1\r\n$2\r\nc1\r\n:")),
    ([b"XACK", b"st", b"g1", b"1-1"], b":1\r\n"),
    ([b"XACK", b"st", b"g1", b"1-1"], b":0\r\n"),
    ([b"XAUTOCLAIM", b"st", b"g1", b"c2", b"0", b"0"], None),
    ([b"XCLAIM", b"st", b"g1", b"c3", b"0", b"2-0"], None),
    ([b"XREAD", b"COUNT", b"10", b"STREAMS", b"st", b"1-1"], None),
    ([b"XINFO", b"STREAM", b"st"], None),
    ([b"XDEL", b"st", b"3-0"], b":1\r\n"),
    ([b"XTRIM", b"st", b"MAXLEN", b"1"], b":1\r\n"),
    ([b"XLEN", b"st"], b":1\r\n"),
    ([b"XREADGROUP", b"GROUP", b"nog", b"c1", b"STREAMS", b"st", b">"], ("prefix", b"-NOGROUP")),
    ([b"TYPE", b"st"], b"+stream\r\n"),
    # geo
    ([b"GEOADD", b"Sicily", b"13.361389", b"38.115556", b"Palermo",
      b"15.087269", b"37.502669", b"Catania"], b":2\r\n"),
    ([b"GEODIST", b"Sicily", b"Palermo", b"Catania"], b"$11\r\n166274.1516\r\n"),
    ([b"GEODIST", b"Sicily", b"Palermo", b"Catania", b"km"], b"$8\r\n166.2742\r\n"),
    ([b"GEODIST", b"Sicily", b"Palermo", b"Nowhere"], b"$-1\r\n"),
    ([b"GEOPOS", b"Sicily", b"Palermo", b"Nowhere"], None),
    ([b"GEOHASH", b"Sicily", b"Palermo", b"Catania"], b"*2\r\n$11\r\nsqc8b49rnyw\r\n$11\r\nsqdtr74hyu4\r\n"),
    ([b"GEOSEARCH", b"Sicily", b"FROMLONLAT", b"15", b"37", b"BYRADIUS",
      b"200", b"km", b"ASC", b"WITHCOORD", b"WITHDIST"], None),
    ([b"GEOSEARCH", b"Sicily", b"FROMMEMBER", b"Palermo", b"BYBOX",
      b"400", b"400", b"km", b"DESC", b"COUNT", b"1"], None),
    ([b"GEOSEARCHSTORE", b"near", b"Sicily", b"FROMLONLAT", b"15", b"37",
      b"BYRADIUS", b"100", b"km", b"STOREDIST"], b":1\r\n"),
    ([b"ZRANGE", b"near", b"0", b"-1", b"WITHSCORES"], None),
    ([b"GEOADD", b"Sicily", b"XX", b"CH", b"13.5", b"38.0", b"Palermo"], b":1\r\n"),
    ([b"GEOADD", b"Sicily", b"200", b"100", b"bad"], ("prefix", b"-ERR")),
    # one keyspace: WRONGTYPE between a Bloom key and a list key
    ([b"BF.RESERVE", b"bfk", b"0.01", b"100"], b"+OK\r\n"),
    ([b"LPUSH", b"bfk", b"x"], ("prefix", b"-WRONGTYPE")),
    ([b"SADD", b"bfk", b"x"], ("prefix", b"-WRONGTYPE")),
    ([b"BF.ADD", b"l2", b"x"], ("prefix", b"-ERR")),
    ([b"BF.RESERVE", b"l", b"0.01", b"100"], ("prefix", b"-WRONGTYPE")),
    ([b"HSET", b"s", b"f", b"v"], ("prefix", b"-WRONGTYPE")),
    ([b"XADD", b"h", b"*", b"f", b"v"], ("prefix", b"-WRONGTYPE")),
    ([b"GEOADD", b"l", b"1", b"1", b"m"], ("prefix", b"-WRONGTYPE")),
    ([b"SCAN", b"0", b"COUNT", b"1000"], None),
    ([b"DBSIZE"], b":17\r\n"),
    # transactions over the grid
    ([b"MULTI"], b"+OK\r\n"),
    ([b"RPUSH", b"tl", b"1", b"2"], b"+QUEUED\r\n"),
    ([b"HSET", b"th", b"f", b"v"], b"+QUEUED\r\n"),
    ([b"BLPOP", b"tl", b"0"], b"+QUEUED\r\n"),
    ([b"BLPOP", b"tnone", b"0"], b"+QUEUED\r\n"),
    ([b"EXEC"], b"*4\r\n:2\r\n:1\r\n*2\r\n$2\r\ntl\r\n$1\r\n1\r\n*-1\r\n"),
    ([b"MULTI"], b"+OK\r\n"),
    ([b"SUBSCRIBE", b"ch"], ("prefix", b"-ERR")),
    ([b"EXEC"], ("prefix", b"-EXECABORT")),
]


def p12_dispatch_counter(client):
    """Wrap the executor's ``cms_update_estimate`` (the dispatch the bridge's
    ``cms_add`` reaches through the coalescer): counts calls and ops."""
    ex = client._engine.executor
    orig = ex.cms_update_estimate
    seen = {"calls": 0, "ops": 0}

    def counted(pool, rows, *a, **kw):
        seen["calls"] += 1
        seen["ops"] += len(rows)
        return orig(pool, rows, *a, **kw)

    ex.cms_update_estimate = counted
    return seen


def phase_config5_pipe(card: str) -> dict:
    """12a: config 5 through its real pipe at bench_config5_stream_topk's
    shape: publish -> delivery pool -> TopicCmsBridge -> add_all_async ->
    cms_add -> coalescer -> cms_update_estimate on the card."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.ops import golden
    from redisson_tpu_torch.serve import TopicCmsBridge
    from redisson_tpu_torch.utils import hashing

    d, w, n, chunk = P12["d"], P12["w"], P12["events"], P12["msg"]
    client = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(device=P12_DEVICE))
    try:
        cms = client.get_count_min_sketch("c5")
        check(cms.try_init(d, w, track_top_k=P12["top_k"]), "12a: try_init refused")
        bridge = TopicCmsBridge(client, "c5-events", "c5", batch_size=P12["batch_size"],
                                flush_interval_s=P12["flush_s"])
        topic = client.get_topic("c5-events")
        stream = (np.random.default_rng(3).zipf(1.2, size=n) % P12["keys"]).astype(np.uint64)
        topic.publish(stream[:chunk])  # one warm message first
        check(client._topic_bus.drain(timeout=300), "12a: warm delivery stuck")
        bridge.flush()
        seen = p12_dispatch_counter(client)
        timed = {}

        def window():
            t0 = time.perf_counter()
            for i in range(chunk, n, chunk):
                topic.publish(stream[i:i + chunk])
            check(client._topic_bus.drain(timeout=600), "12a: delivery stuck")
            bridge.close()
            timed["s"] = time.perf_counter() - t0

        if P12_DEVICE == "cuda":
            idle = device_idle_share(window, name="config5_pipe")
        else:  # a CPU rehearsal: no device to profile
            window()
            idle = {"wall_ms": None, "device_busy_ms": None, "idle_share": None}
        seen = dict(seen)  # the window's dispatches (top_k's reads come later)
        timed_events = n - chunk
        check(bridge.events_ingested == n, f"12a: bridge ingested {bridge.events_ingested}")
        check(cms.total_count() == n, f"12a: total_count {cms.total_count()} != {n}")
        g = golden.GoldenCountMinSketch(d, w)
        for i in range(0, n, 1 << 21):
            part = stream[i:i + (1 << 21)]
            g.add_hashed(*hashing.km_reduce_mod(
                *hashing.hash128_np(*hashing.encode_uint64_batch(part)), w))
        row = tenant_row(client, "c5")
        check(np.array_equal(row[:d * w].reshape(d, w), g.counts),
              "12a: CMS table differs from golden")
        true_top = set(np.argsort(-np.bincount(stream.astype(np.int64)))[:10].tolist())
        recall = len({int(k) for k, _ in cms.top_k(10)} & true_top) / 10.0
        check(recall == 1.0, f"12a: top-10 recall {recall}")
        check(seen["ops"] == timed_events, f"12a: dispatched {seen['ops']} of {timed_events}")
        check_healthy(client, "12a")
        out = {"phase": "12a", "config": f"config 5: RTopic -> TopicCmsBridge -> CMS({d}, {w})",
               "events": n, "timed_events": timed_events, "msg_events": chunk,
               "events_per_s": timed_events / timed["s"], "window_s": timed["s"],
               "cms_update_estimate_dispatches": seen["calls"],
               "events_per_dispatch": seen["ops"] / max(1, seen["calls"]),
               "table_equals_golden": True, "lost_events": 0, "top10_recall": recall,
               "device_wall_ms": idle["wall_ms"], "device_busy_ms": idle["device_busy_ms"],
               "device_idle_share": idle["idle_share"], "card": card}
        log(out)
        return out
    finally:
        client.shutdown()


def p12_server(device: str, reactor: bool = True):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.serve.resp import RespServer

    client = rt.create(rt.Config().use_gpu_sketch(device=device))
    client.config.resp_reactor = reactor
    return client, RespServer(client)


def p12_session(server, cmds) -> list:
    import socket

    s = socket.create_connection((server.host, server.port))
    try:
        out = []
        for c in cmds:
            s.sendall(wire([c]))
            out += read_frames(s, 1)
        return out
    finally:
        s.close()


def p12_serving_threads() -> list:
    import threading

    return sorted(t.name for t in threading.enumerate() if t.name.startswith("rtpu-resp"))


def phase_grid_wire(card: str) -> dict:
    """12b: the grid families over the wire on a card server (reactor on)
    against a ``device="cpu"`` port server in this process; pub/sub across
    two connections; a parked BLPOP while another connection pipelines."""
    import socket

    cc, cs = p12_server(P12_DEVICE)
    hc, hs = p12_server("cpu")
    out = {"phase": "12b"}
    try:
        check(cs.reactor is not None, "12b: the card server runs no reactor")
        cmds = [c for c, _ in P12_GRID]
        t0 = time.perf_counter()
        got = p12_session(cs, cmds)
        out["session_s"] = time.perf_counter() - t0
        ref = p12_session(hs, cmds)
        literal = 0
        for (cmd, want), a, b in zip(P12_GRID, got, ref):
            if isinstance(want, tuple):
                check(a.startswith(want[1]) and b.startswith(want[1]),
                      f"12b: {cmd}: {a!r} / {b!r}")
                if want[0] == "shape":
                    continue
            check(a == b, f"12b: {cmd}: card {a!r} != cpu {b!r}")
            if isinstance(want, bytes):
                check(a == want, f"12b: {cmd}: {a!r} != Redis's {want!r}")
                literal += 1
        out.update(commands=len(cmds), equal_to_cpu_server=True, literal_replies=literal)
        # pub/sub across two connections
        sub = socket.create_connection((cs.host, cs.port))
        pub = socket.create_connection((cs.host, cs.port))
        try:
            sub.sendall(wire([[b"SUBSCRIBE", b"p12-ch"]]))
            ack = read_frames(sub, 1)[0]
            check(ack == b"*3\r\n$9\r\nsubscribe\r\n$6\r\np12-ch\r\n:1\r\n", f"12b: ack {ack!r}")
            pub.sendall(wire([[b"PUBLISH", b"p12-ch", b"hello"], [b"PUBLISH", b"nobody", b"x"]]))
            counts = read_frames(pub, 2)
            check(counts == [b":1\r\n", b":0\r\n"], f"12b: PUBLISH counts {counts}")
            push = read_frames(sub, 1)[0]
            check(push == b"*3\r\n$7\r\nmessage\r\n$6\r\np12-ch\r\n$5\r\nhello\r\n",
                  f"12b: push {push!r}")
        finally:
            sub.close()
            pub.close()
        out["pubsub_frames_checked"] = True
        # a parked BLPOP while another connection pipelines
        n = P12["pipeline"]
        pre = [[b"BF.RESERVE", b"p12-bf", b"0.01", b"10000"],
               [b"BF.MADD", b"p12-bf"] + [b"k%d" % i for i in range(64)],
               [b"SET", b"p12-s", b"val"]]
        check(not any(f.startswith(b"-") for f in roundtrip(cs, pre)), "12b: setup failed")
        blocker = socket.create_connection((cs.host, cs.port))
        other = socket.create_connection((cs.host, cs.port))
        waker = socket.create_connection((cs.host, cs.port))
        try:
            base = p12_serving_threads()
            blocker.sendall(wire([[b"BLPOP", b"p12-q", b"0"]]))
            deadline = time.monotonic() + 30
            while not cc._grid.cond._waiters:
                check(time.monotonic() < deadline, "12b: BLPOP never parked")
                time.sleep(0.005)
            threads = p12_serving_threads()
            batch = [[b"BF.MEXISTS", b"p12-bf", b"k%d" % (i % 64), b"k%d" % ((i + 7) % 64)]
                     if i % 2 == 0 else [b"GET", b"p12-s"] for i in range(n)]
            t0 = time.perf_counter()
            other.sendall(wire(batch))
            frames = read_frames(other, n)
            pipe_s = time.perf_counter() - t0
            want = [b"*2\r\n:1\r\n:1\r\n" if i % 2 == 0 else b"$3\r\nval\r\n"
                    for i in range(n)]
            check(frames == want, "12b: pipelined replies wrong while BLPOP parked")
            check(p12_serving_threads() == threads,
                  f"12b: serving threads {threads} -> {p12_serving_threads()}")
            blocker.setblocking(False)
            try:
                early = blocker.recv(1 << 10)
            except BlockingIOError:
                early = b""
            blocker.setblocking(True)
            check(early == b"", f"12b: BLPOP answered early: {early!r}")
            waker.sendall(wire([[b"LPUSH", b"p12-q", b"wake"]]))
            check(read_frames(waker, 1) == [b":1\r\n"], "12b: LPUSH failed")
            popped = read_frames(blocker, 1)[0]
            check(popped == b"*2\r\n$5\r\np12-q\r\n$4\r\nwake\r\n", f"12b: BLPOP {popped!r}")
            deadline = time.monotonic() + 30  # the pop's worker exits
            while p12_serving_threads() != base:
                check(time.monotonic() < deadline,
                      f"12b: serving threads {base} -> {p12_serving_threads()}")
                time.sleep(0.01)
        finally:
            for s in (blocker, other, waker):
                s.close()
        out.update(blpop_parked_pipelined=n, pipelined_cmds_per_s=n / pipe_s,
                   serving_threads=len(base), serving_threads_while_parked=len(threads),
                   serving_threads_unchanged=True)
        check_healthy(cc, "12b")
        out["card"] = card
        log(out)
        return out
    finally:
        cs.close()
        cc.shutdown()
        hs.close()
        hc.shutdown()


C12C_WRITES = [
    [b"RPUSH", b"r-l", b"a", b"b", b"c"], [b"LPUSH", b"r-l", b"z"],
    [b"HSET", b"r-h", b"f1", b"v1", b"f2", b"v2"], [b"HINCRBY", b"r-h", b"n", b"7"],
    [b"ZADD", b"r-z", b"1.5", b"a", b"2", b"b", b"0.25", b"c"],
    [b"XADD", b"r-st", b"1-1", b"f", b"v1"], [b"XADD", b"r-st", b"2-0", b"f", b"v2"],
    [b"XGROUP", b"CREATE", b"r-st", b"g", b"0"],
    [b"XREADGROUP", b"GROUP", b"g", b"c1", b"COUNT", b"1", b"STREAMS", b"r-st", b">"],
    [b"GEOADD", b"r-g", b"13.361389", b"38.115556", b"Palermo",
     b"15.087269", b"37.502669", b"Catania"],
    [b"SADD", b"r-s", b"x", b"y"],
]
C12C_READS = [
    [b"LRANGE", b"r-l", b"0", b"-1"], [b"HGETALL", b"r-h"],
    [b"ZRANGE", b"r-z", b"0", b"-1", b"WITHSCORES"], [b"XRANGE", b"r-st", b"-", b"+"],
    [b"XPENDING", b"r-st", b"g"], [b"XINFO", b"STREAM", b"r-st"],
    [b"GEODIST", b"r-g", b"Palermo", b"Catania", b"km"], [b"GEOPOS", b"r-g", b"Palermo"],
    [b"SMEMBERS", b"r-s"], [b"TYPE", b"r-st"], [b"DBSIZE"],
]


def phase_grid_restart(card: str) -> dict:
    """12c: ``python -m redisson_tpu_torch`` with a snapshot directory: grid
    writes over the wire, SIGTERM, a reboot that answers every read equal."""
    import signal

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    sdir = tempfile.mkdtemp(prefix="phase12c-", dir=str(build))
    try:
        answers = []
        for boot in range(2):
            port = free_port()
            proc = c11d_boot(port, sdir)
            try:
                sock = c11d_connect(port, proc)
                if boot == 0:
                    sock.sendall(wire(C12C_WRITES))
                    w = read_frames(sock, len(C12C_WRITES))
                    check(not any(f.startswith(b"-") for f in w), f"12c: write failed: {w}")
                sock.sendall(wire(C12C_READS))
                answers.append(read_frames(sock, len(C12C_READS)))
                sock.close()
                proc.send_signal(signal.SIGTERM)
                out, _ = proc.communicate(timeout=180)
                check(proc.returncode == 0, f"12c: exit {proc.returncode}: {out[-2000:]}")
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate(timeout=30)
        check(answers[0] == answers[1], f"12c: reboot answers differ: {answers}")
        check(answers[0][0] == b"*4\r\n$1\r\nz\r\n$1\r\na\r\n$1\r\nb\r\n$1\r\nc\r\n"
              and answers[0][6] == b"$8\r\n166.2742\r\n", f"12c: wrong answers {answers[0]}")
        out = {"phase": "12c", "entry_point": "python -m redisson_tpu_torch",
               "writes": len(C12C_WRITES), "reads": len(C12C_READS),
               "reads_equal_after_restart": True, "card": card}
        log(out)
        return out
    finally:
        shutil.rmtree(sdir, ignore_errors=True)


def phase_grid(card: str) -> None:
    phase_config5_pipe(card)
    phase_grid_wire(card)
    phase_grid_restart(card)


# -- phase 13: the coordination and services half ------------------------------

P13 = {"keys": 1 << 20, "add_chunk": 1 << 18, "contains": 1 << 20, "fpp": 0.01,
       "capacity": 1_048_576, "cms_tasks": 4, "cms_events": 524_288, "d": 5,
       "w": 1 << 16, "lock_threads": 8, "lock_rounds": 250, "sem_threads": 8,
       "sem_keys": 1 << 16, "lcm_entries": 100_000, "pings": 100,
       "monitor_s": 1.0, "prof_keys": 262_144}
P13_DEVICE = "cuda"
# Phase 2's rates, printed beside phase 13a's.
RATES: dict = {}


def p13_client(**kw):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    return rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        device=P13_DEVICE, **kw))


def pctl_us(samples) -> dict:
    s = np.asarray(samples, np.float64) * 1e6
    return {"p50_us": float(np.percentile(s, 50)), "p99_us": float(np.percentile(s, 99))}


def bloom_seq_flags(idx: np.ndarray, m: int) -> np.ndarray:
    """GoldenBloomFilter.add_hashed's per-key flags from an empty filter,
    vectorized: a key is new exactly when it is the first key to set one
    of its bits."""
    n = idx.shape[0]
    first = np.full(m, n, np.int64)
    np.minimum.at(first, idx.reshape(-1).astype(np.int64),
                  np.repeat(np.arange(n, dtype=np.int64), idx.shape[1]))
    return np.any(first[idx.astype(np.int64)] == np.arange(n)[:, None], axis=1)


def cms_seq_unit(h1w, h2w, d: int, w: int):
    """cms_seq.golden_seq for unit weights from an empty table, vectorized:
    an event's estimate is the least, over its d cells, of the events so
    far (itself included) that hit the cell."""
    n = len(h1w)
    idx = np.asarray(h1w, np.int64).copy()
    step = np.asarray(h2w, np.int64)
    est = np.full(n, np.iinfo(np.int64).max)
    table = np.zeros((d, w), np.uint32)
    pos = np.arange(n)
    for r in range(d):
        if r:
            idx += step
            idx[idx >= w] -= w
        order = np.argsort(idx, kind="stable")
        s = idx[order]
        start = np.maximum.accumulate(np.where(np.r_[True, s[1:] != s[:-1]], pos, 0))
        seen = np.empty(n, np.int64)
        seen[order] = pos - start + 1
        est = np.minimum(est, seen)
        table[r] = np.bincount(idx, minlength=w)
    return table, est.astype(np.uint32)


def p13a_reactive_bloom(card: str) -> dict:
    """13a: config 1 through the reactive facade, against a sync client's
    run of the same keys and the golden model."""
    import asyncio

    from redisson_tpu_torch.ops import golden
    from redisson_tpu_torch.utils import hashing

    n, chunk = P13["keys"], P13["add_chunk"]
    chunks = [np.arange(i * chunk, (i + 1) * chunk, dtype=np.uint64) for i in range(n // chunk)]
    rng = np.random.default_rng(13)
    batches = [rng.integers(0, 2 * n, P13["contains"]).astype(np.uint64) for _ in range(4)]
    client, sync = p13_client(), p13_client()
    try:
        rc = client.reactive()
        warm = client.get_bloom_filter("p13-warm")  # first launches, untimed
        check(warm.try_init(P13["capacity"], P13["fpp"]), "try_init refused")
        warm.add_all_async(chunks[0]).result()
        warm.contains_each(batches[0])

        async def run():
            bf = rc.get_bloom_filter("p13-cfg1")
            check(await bf.try_init(P13["capacity"], P13["fpp"]), "reactive try_init refused")
            t0 = time.perf_counter()
            added = await asyncio.gather(*[bf.add_all_async(c) for c in chunks])
            add_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            hits = await asyncio.gather(*[bf.contains_each(b) for b in batches])
            return added, add_s, hits, time.perf_counter() - t0

        added, add_s, hits, contains_s = asyncio.run(run())
        sbf = sync.get_bloom_filter("p13-cfg1")
        check(sbf.try_init(P13["capacity"], P13["fpp"]), "sync try_init refused")
        s_added = [np.asarray(sbf.add_all_async(c).result()) for c in chunks]
        s_hits = [np.asarray(sbf.contains_each(b)) for b in batches]

        bf = client.get_bloom_filter("p13-cfg1")
        m, k = bf.get_size(), bf.get_hash_iterations()
        g = golden.GoldenBloomFilter(m, k)
        allk = np.concatenate(chunks)
        h1, h2 = hashing.km_reduce_mod(*hashing.hash128_np(*hashing.encode_uint64_batch(allk)), m)
        idx = g._indexes(h1, h2)
        small = golden.GoldenBloomFilter(m, k)
        check(np.array_equal(bloom_seq_flags(idx[:4096], m), small.add_hashed(h1[:4096], h2[:4096])),
              "13a: the vectorized sequential flags differ from GoldenBloomFilter")
        # The sync run is one stream in chunk order: its flags are the
        # sequential golden model's, exactly.
        check(np.array_equal(np.concatenate(s_added), bloom_seq_flags(idx, m)),
              "13a: the sync client's add flags differ from the golden model")
        # The 4 reactive awaits run concurrently, so a flag depends on how
        # the other awaits' keys interleaved: it must lie between the
        # bounds of phase 11a (1 only if the key's bits were not all set by
        # earlier keys of its own await; 0 only if other keys set every
        # one of its bits).
        hitc = np.bincount(idx.reshape(-1).astype(np.int64), minlength=m)
        own = np.zeros(idx.shape, np.int64)
        for j in range(k):
            own[:, j] = (idx == idx[:, j:j + 1]).sum(axis=1)
        covered = np.all(hitc[idx.astype(np.int64)] - own > 0, axis=1)
        for i, a in enumerate(added):
            a = np.asarray(a)
            sl = slice(i * chunk, (i + 1) * chunk)
            check(a.shape == (chunk,), "13a: add flags malformed")
            check(np.all(a <= bloom_seq_flags(idx[sl], m)),
                  "13a: a key reported new whose bits its own await had set")
            check(np.all(a >= ~covered[sl]), "13a: a key reported present that no other key covers")
        n_added = int(sum(np.sum(a) for a in added))
        check(0.97 * n <= n_added <= n, f"13a: added {n_added} of {n}")
        g.bits[idx.reshape(-1)] = True
        row, srow = tenant_row(client, "p13-cfg1"), tenant_row(sync, "p13-cfg1")
        gbits = np.zeros(row.shape[0] * 32, bool)
        gbits[:m] = g.bits
        check(np.array_equal(row, np.packbits(gbits, bitorder="little").view(np.uint32))
              and np.array_equal(row, srow), "13a: the row differs from the golden bitmap")
        for b, h, sh in zip(batches, hits, s_hits):
            check(np.array_equal(np.asarray(h), sh) and np.array_equal(sh, golden_contains(g, b)),
                  "13a: contains differs from the sync client or the golden model")
        fpp = float(np.mean([np.asarray(h)[b >= n].mean() for b, h in zip(batches, hits)]))
        s_fpp = float(np.mean([h[b >= n].mean() for b, h in zip(batches, s_hits)]))
        check(fpp == s_fpp, "13a: the FPP differs from the sync client's")
        check_healthy(client, "13a")
        check_healthy(sync, "13a")
        out = {"phase": "13a", "config": "bloom 1M keys 1% FPP through reactive()",
               "add_ops_per_s": n / add_s, "contains_ops_per_s": 4 * P13["contains"] / contains_s,
               "phase2_add_ops_per_s": RATES.get("add_ops_per_s"),
               "phase2_contains_ops_per_s": RATES.get("contains_ops_per_s"),
               "added": n_added, "fpp_outside_keys": fpp, "row_equals_golden_and_sync": True,
               "card": card}
        log(out)
        return out
    finally:
        client.shutdown()
        sync.shutdown()


def p13b_executor_k1(client, rng, card: str) -> dict:
    """13b: an executor service whose tasks drive K1 (add_all_seq)."""
    from redisson_tpu_torch.ops import cms_seq
    from redisson_tpu_torch.utils import hashing

    d, w, n, tasks = P13["d"], P13["w"], P13["cms_events"], P13["cms_tasks"]
    ex = client.get_executor_service("p13")
    ex.register_workers(tasks)
    streams = [zipf_keys(rng, n) for _ in range(tasks)]

    def task(i):
        cms = client.get_count_min_sketch(f"p13-cms-{i}")
        check(cms.try_init(d, w), "try_init refused")
        return np.asarray(cms.add_all_seq(streams[i]))

    before = cms_seq.LAUNCHES
    t0 = time.perf_counter()
    futs = [ex.submit(task, i) for i in range(tasks)]
    ests = [f.result(600) for f in futs]
    dt = time.perf_counter() - t0
    launches = cms_seq.LAUNCHES - before
    ex.shutdown()
    chunk = client._engine._SEQ_CHUNK
    check(launches == tasks * -(-n // chunk), f"13b: {launches} K1 launches")
    for i, est in enumerate(ests):
        h1w, h2w = hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(streams[i])), w)
        if i == 0:  # the vectorized twin against golden_seq itself
            t_ref, e_ref = cms_seq.golden_seq(np.zeros((d, w), np.uint32), h1w[:8192],
                                              h2w[:8192], np.ones(8192, np.uint32), d=d, w=w)
            t_vec, e_vec = cms_seq_unit(h1w[:8192], h2w[:8192], d, w)
            check(np.array_equal(t_ref, t_vec) and np.array_equal(e_ref, e_vec),
                  "13b: the vectorized golden_seq differs from golden_seq")
        table, want = cms_seq_unit(h1w, h2w, d, w)
        check(np.array_equal(est, want), f"13b: task {i}'s estimates differ from golden_seq")
        row = tenant_row(client, f"p13-cms-{i}")
        check(np.array_equal(row[: d * w].reshape(d, w), table),
              f"13b: task {i}'s table differs from golden_seq")
    out = {"phase": "13b", "config": "executor service, 4 tasks of CMS(5, 65536) add_all_seq",
           "events": tasks * n, "events_per_s": tasks * n / dt, "k1_launches": launches,
           "estimates_and_tables_equal_golden_seq": True, "card": card}
    log(out)
    return out


def p13c_locks(client, card: str) -> dict:
    """13c: a lock around card state, a semaphore around HLL adds, and a
    transaction over a map and a bucket."""
    from redisson_tpu_torch.grid import TransactionException
    from redisson_tpu_torch.ops import golden

    threads, rounds = P13["lock_threads"], P13["lock_rounds"]
    bs = client.get_bit_set("p13-bs")
    holds, errors = [], []

    def locked_rounds():
        lk = client.get_lock("p13-lk")
        mine = []
        try:
            for _ in range(rounds):
                lk.lock()
                t0 = time.perf_counter()
                try:
                    bs.set(bs.cardinality())
                finally:
                    mine.append(time.perf_counter() - t0)
                    lk.unlock()
        except Exception as e:  # surfaced below
            errors.append(e)
        holds.extend(mine)

    ts = [threading.Thread(target=locked_rounds) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    lock_s = time.perf_counter() - t0
    check(not errors, f"13c: lock rounds failed: {errors[:1]}")
    total = threads * rounds
    got = np.asarray(bs.get_many(np.arange(total + 64)))
    check(got[:total].all() and not got[total:].any() and bs.cardinality() == total
          and bs.length() == total, "13c: the set bits are not exactly 0..%d" % (total - 1))

    sem = client.get_semaphore("p13-sem")
    check(sem.try_set_permits(2), "13c: try_set_permits refused")
    hll = client.get_hyper_log_log("p13-hll")
    state = {"holders": 0, "peak": 0}
    guard = threading.Lock()
    keys = [np.arange(i * P13["sem_keys"], (i + 1) * P13["sem_keys"], dtype=np.uint64)
            for i in range(P13["sem_threads"])]

    def permitted(i):
        try:
            sem.acquire()
            try:
                with guard:
                    state["holders"] += 1
                    state["peak"] = max(state["peak"], state["holders"])
                hll.add_all(keys[i])
                with guard:
                    state["holders"] -= 1
            finally:
                sem.release()
        except Exception as e:
            errors.append(e)

    ts = [threading.Thread(target=permitted, args=(i,)) for i in range(P13["sem_threads"])]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    check(not errors, f"13c: semaphore rounds failed: {errors[:1]}")
    check(1 <= state["peak"] <= 2, f"13c: {state['peak']} semaphore holders at once")
    check(sem.available_permits() == 2, "13c: permits leaked")
    g = golden.GoldenHyperLogLog()
    for kk in keys:
        g.add_hashed(*hll_lanes(kk))
    check(np.array_equal(tenant_row(client, "p13-hll"), g.regs),
          "13c: HLL registers differ from the golden model")

    tx = client.create_transaction()
    tx.get_map("p13-m").put(1, 1)
    tx.get_bucket("p13-b").set(7)
    check(client.get_bucket("p13-b").get() is None, "13c: a write was visible before commit")
    tx.commit()
    check(client.get_map("p13-m").get(1) == 1 and client.get_bucket("p13-b").get() == 7,
          "13c: the commit did not apply")
    tx2 = client.create_transaction()
    tx2.get_bucket("p13-b").get()
    client.get_bucket("p13-b").set(8)
    tx2.get_bucket("p13-b").set(9)
    tx2.get_map("p13-m").put(1, 2)
    try:
        tx2.commit()
        fail("13c: a conflicting transaction committed")
    except TransactionException:
        pass
    check(client.get_bucket("p13-b").get() == 8 and client.get_map("p13-m").get(1) == 1,
          "13c: the conflicting transaction applied a write")
    out = {"phase": "13c", "config": "8 threads x 500 lock rounds around a BitSet on the card",
           "rounds": total, "rounds_per_s": total / lock_s,
           "lock_hold": pctl_us(holds), "semaphore_peak_holders": state["peak"],
           "bits_exact": True, "transaction_conflict_raised": True, "card": card}
    log(out)
    return out


def p13d_local_cached_map(client, card: str) -> dict:
    """13d: a LocalCachedMap of 100,000 entries read twice."""
    n = P13["lcm_entries"]
    m = client.get_local_cached_map("p13-lcm", cache_size=1 << 17, cache_max_bytes=256 << 20)
    m.put_all({i: i * 3 for i in range(n)})
    client._topic_bus.drain(timeout=60)
    got = [m.get(i) for i in range(n)]
    check(got == [i * 3 for i in range(n)], "13d: first pass read wrong values")
    h0 = m.cache_stats()["hits"]
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        v = m.get(i)
        lat.append(time.perf_counter() - t0)
        check(v == i * 3, "13d: second pass read a wrong value")
    hit_rate = (m.cache_stats()["hits"] - h0) / n
    other = client.get_local_cached_map("p13-lcm", cache_size=1 << 17, cache_max_bytes=256 << 20)
    m.put(n, 1)
    client._topic_bus.drain(timeout=10)
    check(other.get(n) == 1, "13d: a second handle missed a put through the first")
    other.put(n, 2)
    client._topic_bus.drain(timeout=10)
    check(m.get(n) == 2 and other.get(7) == 21, "13d: the handles disagree")
    out = {"phase": "13d", "config": "LocalCachedMap 100,000 entries, two read passes",
           "second_pass_hit_rate": hit_rate, "get": pctl_us(lat), "card": card}
    log(out)
    return out


def p13e_nodes(client, card: str) -> dict:
    """13e: the node is the card; pings and a failure monitor."""
    ng = client.get_nodes_group()
    nodes = ng.get_nodes()
    check(len(nodes) == 1, f"13e: {len(nodes)} nodes")
    kind = torch.cuda.get_device_name(0) if P13_DEVICE == "cuda" else "cpu"
    info = nodes[0].info()
    check(info["device_kind"] == kind, f"13e: device_kind {info['device_kind']!r}")
    check(ng.ping_all(), "13e: ping_all failed")
    lat = []
    for _ in range(P13["pings"]):
        t0 = time.perf_counter()
        check(nodes[0].ping(), "13e: a ping failed")
        lat.append(time.perf_counter() - t0)
    mon = client.get_failure_monitor(interval_s=0.1)
    events = []
    mon.add_listener(events.append)
    mon.start()
    time.sleep(P13["monitor_s"])
    mon.stop()
    check(not events and not mon.down_shards(), f"13e: the monitor saw {events}")
    out = {"phase": "13e", "node": info, "ping": pctl_us(lat), "monitor_events": 0, "card": card}
    log(out)
    return out


def p13f_profiler_metrics(client, card: str) -> dict:
    """13f: a profiler trace of a Bloom pass, device memory, the metrics'
    op count and the scrape endpoint."""
    import urllib.request

    n = P13["prof_keys"]
    bf = client.get_bloom_filter("p13-prof")
    check(bf.try_init(P13["capacity"], P13["fpp"]), "try_init refused")
    bf.add_all_async(np.arange(1024, dtype=np.uint64)).result()  # first launches
    ops0 = client.get_metrics()["ops_total"]
    prof = client.get_profiler()
    tmp = tempfile.mkdtemp(prefix="p13-trace-")
    try:
        with prof.trace(tmp):
            with prof.annotate("p13f-bloom-pass"):
                bf.add_all_async(np.arange(1024, 1024 + n, dtype=np.uint64)).result()
        with open(prof.last_trace) as f:
            events = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(prof.last_trace)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if P13_DEVICE == "cuda":
        check(kernels, "13f: the trace holds no CUDA kernel event")
    ops = client.get_metrics()["ops_total"] - ops0
    check(ops == n, f"13f: ops_total grew by {ops}, the pass submitted {n}")
    mem = prof.device_memory()
    if P13_DEVICE == "cuda":
        total = torch.cuda.get_device_properties(0).total_memory
        check(mem["gpu:0"]["bytes_limit"] == total,
              f"13f: device_memory {mem['gpu:0']} vs total_memory {total}")
    srv = client.start_metrics_endpoint("127.0.0.1", 0)
    body = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=30).read().decode()
    fams = [ln.split()[2] for ln in client.obs.registry.render_prometheus().splitlines()
            if ln.startswith("# TYPE ")]
    check(fams and all(f"# TYPE {f} " in body for f in fams)
          and "redisson_tpu_ops_total" in body, "13f: the endpoint misses a family")
    out = {"phase": "13f", "trace_events": len(events), "trace_kernel_events": len(kernels),
           "trace_bytes": trace_bytes, "ops_total_delta": ops, "device_memory": mem,
           "endpoint_families": len(fams), "card": card}
    log(out)
    return out


def phase_services(rng, card: str) -> None:
    """Phase 13: the coordination and services half on fresh card clients."""
    p13a_reactive_bloom(card)
    client = p13_client()
    try:
        p13b_executor_k1(client, rng, card)
        check_healthy(client, "13b")
        p13c_locks(client, card)
        check_healthy(client, "13c")
        p13d_local_cached_map(client, card)
        p13e_nodes(client, card)
        p13f_profiler_metrics(client, card)
        check_healthy(client, "13")
    finally:
        client.shutdown()


# -- phase 14: the op journal, crash recovery and replication ----------------

P14 = {"keys": 1 << 19, "chunk": 1024, "threads": 4, "capacity": 1_048_576,
       "fpp": 0.01, "cms_events": 1 << 20, "d": 5, "w": 1 << 16,
       "hll_keys": 1 << 21, "bs_bits": 1 << 30, "bs_idx": 1 << 21,
       "big_chunk": 1 << 18, "k1_after": 1 << 18, "soak_seeds": (0,),
       "soak_ops": 300, "repl_keys": 1 << 20, "repl_conns": 4, "repl_madd": 1024,
       "wait_every": 64, "e_batches": 40, "e_batch": 50, "e_kill_after": 20}
P14_DEVICE = "cuda"


def p14_sync() -> None:
    if P14_DEVICE == "cuda":
        torch.cuda.synchronize()


def p14_client(base=None, fsync="always", journal=True, snap=True, **kw):
    """A fresh client on the card with LongCodec; ``base`` holds its
    journal/ and snap/ directories."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device=P14_DEVICE, **kw)
    if base is not None and journal:
        cfg.journal_dir = os.path.join(base, "journal")
        cfg.journal_fsync = fsync
    if base is not None and snap:
        cfg.snapshot_dir = os.path.join(base, "snap")
    return rt.create(cfg)


def p14_abandon(client) -> None:
    """Shut a client down without its final snapshot and with the journal
    closed first (the next boot on the directory recovers its tail)."""
    eng = client._engine
    j, eng.journal = eng.journal, None
    if j is not None:
        j.close()
    eng.config.snapshot_dir = client.config.snapshot_dir = None
    client.shutdown()


def p14_streams(seed: int) -> dict:
    """The phase's inputs, a pure function of the seed (the crash child
    and the parent regenerate the same arrays)."""
    rng = np.random.default_rng(seed + 14)
    return {
        "bloom": rng.integers(0, 1 << 62, P14["keys"], dtype=np.uint64),
        "cms": zipf_keys(rng, P14["cms_events"]),
        "hll": rng.integers(0, 1 << 62, P14["hll_keys"], dtype=np.uint64),
        "bs": rng.integers(0, P14["bs_bits"], P14["bs_idx"], dtype=np.uint64).astype(np.uint32),
    }


def p14_bloom_load(client, name: str, keys: np.ndarray, ack=None) -> float:
    """Config 1: try_init(capacity, fpp), then the keys as add_all calls of
    ``chunk`` keys from ``threads`` threads; the wall seconds."""
    bf = client.get_bloom_filter(name)
    check(bf.try_init(P14["capacity"], P14["fpp"]), "try_init refused")
    chunk, nthreads = P14["chunk"], P14["threads"]
    n = len(keys) // chunk
    errors = []

    def worker(t):
        try:
            for i in range(t, n, nthreads):
                bf.add_all(keys[i * chunk:(i + 1) * chunk])
                if ack is not None:
                    ack("bloom", i)
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(nthreads)]
    p14_sync()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    check(not errors, f"bloom load failed: {errors[:1]}")
    return dt


def p14_bloom_words(client, name: str, keys: np.ndarray) -> np.ndarray:
    """The golden bitmap of ``keys`` in ``name``'s row layout."""
    bf = client.get_bloom_filter(name)
    g = golden_bloom(bf, keys)
    units = client._engine.registry.lookup(name).pool.row_units
    gbits = np.zeros(units * 32, bool)
    gbits[: g.size] = g.bits
    return np.packbits(gbits, bitorder="little").view(np.uint32)


def p14_golden_hll(keys: np.ndarray) -> np.ndarray:
    from redisson_tpu_torch.ops import golden

    idx, rank = golden.hll_index_rank(*hll_lanes(keys))
    regs = np.zeros(golden.HLL_M, np.uint8)
    np.maximum.at(regs, np.asarray(idx, np.int64), np.asarray(rank, np.uint8))
    return regs


def p14_golden_bits(idx: np.ndarray, nbits: int) -> np.ndarray:
    words = np.zeros(nbits // 32, np.uint32)
    np.bitwise_or.at(words, idx >> 5, np.uint32(1) << (idx & 31).astype(np.uint32))
    return words


def p14_golden_cms(events: np.ndarray):
    from redisson_tpu_torch.utils import hashing

    h1w, h2w = hashing.km_reduce_mod(
        *hashing.hash128_np(*hashing.encode_uint64_batch(events)), P14["w"])
    return h1w, h2w


def p14_df(path: str) -> str:
    out = subprocess.run(["df", "-T", path], capture_output=True, text=True, timeout=60)
    return " ".join(out.stdout.strip().splitlines()[-1].split())


def p14_fsync_pctl(obs) -> dict:
    p50, p99 = obs.journal_fsync_us.percentiles((), [50, 99])
    return {"fsync_p50_us": p50 * 1e6, "fsync_p99_us": p99 * 1e6}


def p14a_appendfsync(streams, base: str, card: str) -> None:
    """14a: the cost of appendfsync on the main path — config 1's load in
    four arms on one client (journal off, no, everysec, always), each on
    a fresh filter; then config 5's K1 stream under always."""
    from redisson_tpu_torch.ops import cms_seq

    client = p14_client(base, fsync="everysec", snap=False)
    eng, obs = client._engine, client._engine.obs
    keys = streams["bloom"]
    want = None
    arms = {}
    try:
        # Warm-up on a filter of the same size class, so no arm pays the
        # process's first launches.
        eng.journal_set_enabled(False)
        p14_bloom_load(client, "p14a-warm", keys[: 64 * P14["chunk"]])
        for arm in ("off", "no", "everysec", "always"):
            if arm == "off":
                eng.journal_set_enabled(False)
            else:
                eng.journal_set_enabled(True)
                eng.journal_set_policy(arm)
            check((eng.journal is None) == (arm == "off"), f"14a: journal state in arm {arm}")
            obs.journal_fsync_us.reset()
            st0 = eng.journal.stats() if eng.journal is not None else None
            dt = p14_bloom_load(client, f"p14a-{arm}", keys)
            out = {"keys_per_s": len(keys) / dt, "seconds": dt}
            if st0 is not None:
                check(eng.journal_fence(timeout=60), "14a: fence timed out")
                st = eng.journal.stats()
                recs = st["records_written"] - st0["records_written"]
                fs = st["fsyncs"] - st0["fsyncs"]
                out.update(records=recs, journal_bytes_per_key=(
                    st["bytes_written"] - st0["bytes_written"]) / len(keys),
                    fsyncs=fs, records_per_fsync=recs / max(1, fs),
                    **p14_fsync_pctl(obs))
                check(recs == len(keys) // P14["chunk"] + 1, f"14a: {recs} records in arm {arm}")
            if want is None:
                want = p14_bloom_words(client, f"p14a-{arm}", keys)
            check(np.array_equal(tenant_row(client, f"p14a-{arm}"), want),
                  f"14a: arm {arm}'s row differs from the golden bitmap")
            arms[arm] = out
        # Config 5 under always: K1 on the journaled path.
        d, w = P14["d"], P14["w"]
        cms = client.get_count_min_sketch("p14a-cms")
        check(cms.try_init(d, w), "try_init refused")
        events = streams["cms"]
        before = cms_seq.LAUNCHES
        p14_sync()
        t0 = time.perf_counter()
        est = cms.add_all_seq(events)
        dt = time.perf_counter() - t0
        launches = cms_seq.LAUNCHES - before
        check(launches == -(-len(events) // eng._SEQ_CHUNK), f"14a: {launches} K1 launches")
        h1w, h2w = p14_golden_cms(events)
        table, g_est = cms_seq_unit(h1w, h2w, d, w)
        check(np.array_equal(np.asarray(est, np.uint32), g_est), "14a: estimates != golden_seq")
        check(np.array_equal(tenant_row(client, "p14a-cms")[: d * w].reshape(d, w), table),
              "14a: CMS table != golden")
        check_healthy(client, "14a")
        log({"phase": "14a", "config": "config 1 bloom 1M / 1% from 4 threads; config 5 cms",
             "keys": len(keys), "calls_per_arm": len(keys) // P14["chunk"], "arms": arms,
             "always_vs_off_keys_per_s": arms["always"]["keys_per_s"] / arms["off"]["keys_per_s"],
             "cms_events": len(events), "cms_events_per_s_always": len(events) / dt,
             "cms_k1_launches": launches, "rows_equal_golden": True,
             "cms_equals_golden_seq": True, "filesystem": p14_df(base), "card": card})
    finally:
        p14_abandon(client)


def p14_child(base: str, seed: int) -> int:
    """14b's crash child: the always Bloom arm, a snapshot, then the CMS
    stream (K1), an HLL PFADD and a 2**30-bit BitSet's set_many, journaled
    under always; one ``ACK`` line per resolved call, the live rows saved,
    ``LAST``, and then it waits for its SIGKILL."""
    streams = p14_streams(seed)
    lock = threading.Lock()

    def ack(kind, i):
        with lock:
            sys.stdout.write(f"ACK {kind} {i}\n")
            sys.stdout.flush()

    client = p14_client(base, fsync="always")
    eng = client._engine
    times = {"bloom_s": p14_bloom_load(client, "p14b-bloom", streams["bloom"], ack)}
    segs = eng.journal.stats()["segments"]
    t0 = time.perf_counter()
    eng.snapshot(client.config.snapshot_dir)
    times["snapshot_s"] = time.perf_counter() - t0
    retired = segs + 1 - eng.journal.stats()["segments"]  # mark_snapshot rotates one in
    cms = client.get_count_min_sketch("p14b-cms")
    cms.try_init(P14["d"], P14["w"])
    big = P14["big_chunk"]
    t0 = time.perf_counter()
    for i in range(0, len(streams["cms"]), big):
        cms.add_all_seq(streams["cms"][i:i + big])
        ack("cms", i // big)
    times["cms_s"] = time.perf_counter() - t0
    hll = client.get_hyper_log_log("p14b-hll")
    t0 = time.perf_counter()
    for i in range(0, len(streams["hll"]), big):
        hll.add_all(streams["hll"][i:i + big])
        ack("hll", i // big)
    times["hll_s"] = time.perf_counter() - t0
    bs = client.get_bit_set("p14b-bs")
    bs.set(P14["bs_bits"] - 1, False)  # size the row to 2**30 bits
    t0 = time.perf_counter()
    for i in range(0, len(streams["bs"]), big):
        bs.set_many(streams["bs"][i:i + big], True)
        ack("bs", i // big)
    times["bs_s"] = time.perf_counter() - t0
    eng._drain()
    np.savez(os.path.join(base, "live_rows.npz"), **{
        n: np.asarray(eng.executor.read_row(e.pool, e.row))
        for n, e in ((e.name, e) for e in eng.registry.entries())})
    print(json.dumps({"child": "14b", "segments_retired_by_snapshot": retired,
                      "journal": eng.journal.stats(), **times}), flush=True)
    print("LAST", flush=True)
    time.sleep(3600)  # the parent's SIGKILL lands here, before any shutdown
    return 0


def p14b_kill9(streams, base: str, seed: int, card: str) -> None:
    """14b: SIGKILL a child after its last ack, boot a fresh card client
    on its directories and hold every recovered row to the acked golden
    state; then K1 on the recovered CMS row."""
    import signal

    from redisson_tpu_torch.ops import cms_seq

    cfg = json.dumps({"P14": P14, "device": P14_DEVICE})
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--p14-child",
                             base, "--seed", str(seed), "--p14-config", cfg],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    acks, child = 0, None
    try:
        for line in proc.stdout:
            if line.startswith("ACK "):
                acks += 1
            elif line.startswith("{"):
                child = json.loads(line)
            elif line.strip() == "LAST":
                break
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        err = proc.stderr.read()
        proc.stdout.close()
        proc.stderr.close()
    check(child is not None, f"14b: the child never finished its stream:\n{err[-4000:]}")
    big = P14["big_chunk"]
    want_acks = (len(streams["bloom"]) // P14["chunk"]
                 + sum(-(-len(streams[k]) // big) for k in ("cms", "hll", "bs")))
    check(acks == want_acks, f"14b: {acks} acks, expected {want_acks}")
    live = dict(np.load(os.path.join(base, "live_rows.npz")))
    p14_sync()
    t0 = time.perf_counter()
    client = p14_client(base, fsync="always")
    p14_sync()
    boot_s = time.perf_counter() - t0
    try:
        eng = client._engine
        rs = eng.recovery_stats or {}
        check(all(p.state.device.type == P14_DEVICE for p in eng.registry.pools()),
              "14b: a recovered pool is not on the card")
        d, w = P14["d"], P14["w"]
        h1w, h2w = p14_golden_cms(streams["cms"])
        gcms, _ = cms_seq_unit(h1w, h2w, d, w)
        golden_rows = {
            "p14b-bloom": p14_bloom_words(client, "p14b-bloom", streams["bloom"]),
            "p14b-hll": p14_golden_hll(streams["hll"]),
            "p14b-bs": p14_golden_bits(np.r_[streams["bs"]], P14["bs_bits"]),
        }
        rows = {e.name: np.asarray(eng.executor.read_row(e.pool, e.row))
                for e in eng.registry.entries()}
        check(set(rows) == set(live) == {"p14b-bloom", "p14b-cms", "p14b-hll", "p14b-bs"},
              f"14b: recovered names {sorted(rows)}")
        for n, g in golden_rows.items():
            check(np.array_equal(rows[n], g), f"14b: recovered {n} != golden")
            check(np.array_equal(live[n], g), f"14b: live {n} != golden")
        check(np.array_equal(rows["p14b-cms"][: d * w].reshape(d, w), gcms),
              "14b: recovered CMS table != golden")
        check(np.array_equal(live["p14b-cms"], rows["p14b-cms"]),
              "14b: the table K1 wrote live != the table recovery rebuilt")
        # K1 on the recovered row.
        more = zipf_keys(np.random.default_rng(seed + 141), P14["k1_after"])
        m1, m2 = p14_golden_cms(more)
        g_table, g_est = cms_seq.golden_seq(gcms, m1, m2, np.ones(len(more), np.uint32),
                                            d=d, w=w)
        before = cms_seq.LAUNCHES
        est = client.get_count_min_sketch("p14b-cms").add_all_seq(more)
        k1 = cms_seq.LAUNCHES - before
        check(k1 > 0, "14b: K1 did not launch on the recovered row")
        check(np.array_equal(np.asarray(est, np.uint32), g_est), "14b: K1 estimates != golden_seq")
        check(np.array_equal(tenant_row(client, "p14b-cms")[: d * w].reshape(d, w), g_table),
              "14b: K1 table on the recovered row != golden_seq")
        check_healthy(client, "14b")
        log({"phase": "14b", "acked_calls": acks, "child": child, "boot_s": boot_s,
             "recovery_s": rs.get("seconds"), "records_replayed": rs.get("records"),
             "replayed_records_per_s": rs.get("records", 0) / max(1e-9, rs.get("seconds", 0)),
             "rows_written": rs.get("rows_written"),
             "segments_retired_by_snapshot": child["segments_retired_by_snapshot"],
             "rows_equal_acked_golden": True, "live_k1_table_equals_recovered": True,
             "k1_on_recovered_row_launches": k1, "card": card})
    finally:
        p14_abandon(client)


def p14c_soak(base: str, card: str) -> None:
    """14c: the JAX package's kill -9 soak with the port's crash child on
    the card: seeds x {always, everysec}, one run with mid-stream
    snapshots and one with forced residency transitions, all children at
    once; each killed at an ack count drawn from random.Random(seed);
    recovery on the card; rows matched against a golden prefix."""
    import random
    import signal

    import redisson_tpu_torch as rt
    from redisson_tpu_torch.chaos import crashchild
    from redisson_tpu_torch.codecs import LongCodec

    ops = P14["soak_ops"]
    runs = [(s, f, ()) for s in P14["soak_seeds"] for f in ("always", "everysec")]
    runs += [(3, "always", ("--snapshot-every", "50")),
             (4, "always", ("--residency-every", "25"))]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    procs = []
    for i, (seed, fsync, extra) in enumerate(runs):
        d = os.path.join(base, f"run{i}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "redisson_tpu_torch.chaos.crashchild", "--dir", d,
             "--fsync", fsync, "--seed", str(seed), "--ops", str(ops), "--device", P14_DEVICE,
             *extra], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
            cwd=str(Path(__file__).resolve().parent)))
    results = [None] * len(runs)

    def drive(i):
        seed, fsync, _ = runs[i]
        proc = procs[i]
        kill_at = random.Random(seed).randrange(40, ops - 20)
        acked = {}
        for line in proc.stdout:
            parts = line.split()
            if len(parts) == 3 and parts[0] == "ACK":
                acked[int(parts[1])] = float(parts[2])
                if int(parts[1]) >= kill_at:
                    break
        kill_time = time.time()
        proc.send_signal(signal.SIGKILL)
        for line in proc.stdout:
            parts = line.split()
            if len(parts) == 3 and parts[0] == "ACK":
                acked[int(parts[1])] = float(parts[2])
        proc.wait(timeout=60)
        results[i] = (acked, kill_time, kill_at)

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(len(runs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    children_s = time.perf_counter() - t0
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.stdout.close()
    out = []
    for i, (seed, fsync, extra) in enumerate(runs):
        check(results[i] is not None, f"14c: run {i} never finished")
        acked, kill_time, kill_at = results[i]
        check(acked and max(acked) >= kill_at, f"14c: run {i} stopped at {max(acked or [0])}")
        d = os.path.join(base, f"run{i}")
        client = crashchild.build_client(d, fsync, residency=bool(extra and "resid" in extra[0]),
                                         device=P14_DEVICE)
        eng = client._engine
        try:
            check(all(p.state.device.type == P14_DEVICE for p in eng.registry.pools()),
                  "14c: a recovered pool is not on the card")
            eng._drain()
            rows = {e.name: np.asarray(eng._host_row(e)).copy() for e in eng.registry.entries()}
            rs = eng.recovery_stats or {}
        finally:
            p14_abandon(client)
        if fsync == "always":
            lower = max(acked) + 1
        else:
            covered = [j for j, ts in acked.items() if ts <= kill_time - 2.5]
            lower = (max(covered) + 1) if covered else 0
        golden = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
            device="cpu", min_bucket=64))
        matched = [None]

        def same():
            golden._engine._drain()
            got = {e.name: np.asarray(golden._engine._host_row(e))
                   for e in golden._engine.registry.entries()}
            return set(got) == set(rows) and all(np.array_equal(got[n], rows[n]) for n in got)

        class _Hit(Exception):
            pass

        def on_ack(j):
            if j + 1 >= lower and same():
                matched[0] = j + 1
                raise _Hit()

        try:
            if lower <= 0 and same():
                matched[0] = 0
            else:
                crashchild.apply_ops(golden, seed, ops, ack=on_ack)
        except _Hit:
            pass
        finally:
            golden.shutdown()
        check(matched[0] is not None,
              f"14c: run {i} ({fsync} {extra}) matches no golden prefix >= {lower}")
        out.append({"seed": seed, "fsync": fsync, "extra": " ".join(extra),
                    "max_acked": max(acked), "golden_prefix": matched[0], "lower": lower,
                    "records_replayed": rs.get("records"), "recovery_s": rs.get("seconds")})
    log({"phase": "14c", "runs": out, "children_wall_s": children_s,
         "every_acked_write_recovered": True, "card": card})


def p14_cmds(server, cmds):
    from redisson_tpu_torch.serve.wireutil import exchange

    s = socket.create_connection((server.host, server.port), timeout=120)
    try:
        return exchange(s, cmds)
    finally:
        s.close()


def p14d_replication(streams, base: str, card: str) -> None:
    """14d: a primary and a replica RespServer, each on its own card
    client in this process: FULLRESYNC of config 1 and config 5, then 4
    connections of BF.MADD with WAIT 1 every 64 commands, a dropped link
    that resyncs partially, -READONLY, and FAILOVER."""
    from redisson_tpu_torch.serve.resp import RespServer
    from redisson_tpu_torch.serve.wireutil import ReplyError, exchange

    pc = p14_client(os.path.join(base, "primary"), fsync="everysec")
    ps = RespServer(pc)
    rc = rs = None
    try:
        t_load = p14_bloom_load(pc, "p14d", streams["bloom"])
        cms = pc.get_count_min_sketch("p14d-cms")
        cms.try_init(P14["d"], P14["w"])
        cms.add_all_seq(streams["cms"])
        rc = p14_client(os.path.join(base, "replica"), journal=False)
        rs = RespServer(rc)
        t0 = time.perf_counter()
        link = rs.start_replication_from(ps.host, ps.port)
        head = pc._engine.journal.last_seq()
        until(lambda: link.applied >= head, "14d: replica bootstrap", timeout=600)
        fullresync_s = time.perf_counter() - t0
        check(link.full_resyncs == 1, "14d: expected one FULLRESYNC")
        # The live stream: BF.MADD from 4 connections, WAIT 1 every 64.
        extra = np.random.default_rng(1414).integers(0, 1 << 62, P14["repl_keys"],
                                                     dtype=np.uint64)
        conns, madd = P14["repl_conns"], P14["repl_madd"]
        per = len(extra) // conns
        waits, lag_max, errors = [], [0], []
        stop = threading.Event()

        def monitor():
            while not stop.is_set():
                lag_max[0] = max(lag_max[0], link.lag_ops())
                time.sleep(0.005)

        def sender(c):
            try:
                s = socket.create_connection((ps.host, ps.port), timeout=120)
                mine = extra[c * per:(c + 1) * per]
                cmds = [("BF.MADD", "p14d", *map(str, mine[i:i + madd].tolist()))
                        for i in range(0, len(mine), madd)]
                for i in range(0, len(cmds), P14["wait_every"]):
                    replies = exchange(s, cmds[i:i + P14["wait_every"]])
                    check(not any(isinstance(r, ReplyError) for r in replies), "14d: MADD error")
                    w0 = time.perf_counter()
                    (n,) = exchange(s, [("WAIT", "1", "1000")])
                    waits.append(time.perf_counter() - w0)
                    check(n == 1, f"14d: WAIT 1 answered {n}")
                s.close()
            except BaseException as e:
                errors.append(e)

        rec0 = link.applied
        mon = threading.Thread(target=monitor)
        mon.start()
        t0 = time.perf_counter()
        senders = [threading.Thread(target=sender, args=(c,)) for c in range(conns)]
        for t in senders:
            t.start()
        for t in senders:
            t.join()
        head = pc._engine.journal.last_seq()
        until(lambda: link.applied >= head, "14d: replica catch-up", timeout=600)
        stream_s = time.perf_counter() - t0
        stop.set()
        mon.join()
        check(not errors, f"14d: sender failed: {errors[:1]}")
        applied = link.applied - rec0
        prow = {n: tenant_row(pc, n) for n in ("p14d", "p14d-cms")}
        check(all(np.array_equal(tenant_row(rc, n), r) for n, r in prow.items()),
              "14d: replica rows != primary rows")
        all_keys = np.concatenate([streams["bloom"], extra])
        check(np.array_equal(prow["p14d"], p14_bloom_words(pc, "p14d", all_keys)),
              "14d: primary row != golden")
        # -READONLY on the replica.
        (r,) = p14_cmds(rs, [("BF.MADD", "p14d", "1")])
        check(isinstance(r, ReplyError) and r.code == "READONLY", f"14d: replica write got {r}")
        # A dropped link resyncs partially.
        hub = ps._repl_hub()
        fr0, pr0 = hub.fullresyncs, pc.obs.repl_partial_resyncs.get(())
        link._sock.close()
        p14_cmds(ps, [("BF.MADD", "p14d", "7", "8", "9")])
        head = pc._engine.journal.last_seq()
        until(lambda: link.applied >= head and link.link_up, "14d: partial resync", timeout=120)
        check(pc.obs.repl_partial_resyncs.get(()) == pr0 + 1 and hub.fullresyncs == fr0,
              "14d: the dropped link did not resync partially")
        # FAILOVER promotes the replica; every WAIT-covered write reads back.
        check(p14_cmds(rs, [("FAILOVER",)]) == [b"OK"], "14d: FAILOVER refused")
        check(rs.replica_link is None, "14d: still a replica after FAILOVER")
        check(p14_cmds(rs, [("BF.MADD", "p14d", "424242")]) == [[1]], "14d: promoted write")
        probe = all_keys[:: max(1, len(all_keys) // 65536)]
        got = rc.get_bloom_filter("p14d").contains_each(probe)
        check(bool(np.all(got)), "14d: a WAIT-covered write is missing on the promoted node")
        check_healthy(pc, "14d")
        check_healthy(rc, "14d")
        w_us = np.asarray(waits) * 1e6
        log({"phase": "14d", "primary_load_s": t_load, "fullresync_s": fullresync_s,
             "fullresync_tar_bytes": link.last_resync_bytes, "stream_keys": len(extra),
             "stream_s": stream_s, "replica_applied_records": applied,
             "replica_applied_records_per_s": applied / stream_s,
             "replica_max_lag_ops": lag_max[0], "waits": len(waits),
             "wait_p50_us": float(np.percentile(w_us, 50)),
             "wait_p99_us": float(np.percentile(w_us, 99)),
             "rows_equal": True, "readonly": True, "partial_resync": True,
             "failover": True, "card": card})
    finally:
        if rs is not None:
            rs.close()
        ps.close()
        for c in (rc, pc):
            if c is not None:
                p14_abandon(c)


def p14e_entry_point(base: str, card: str) -> None:
    """14e: ``python -m redisson_tpu_torch --journal-dir --snapshot-dir``
    under appendfsync always, SIGKILLed in the middle of a pipelined
    SET/BF.MADD stream, then rebooted: every acknowledged write reads
    back."""
    import signal

    from redisson_tpu_torch.serve.wireutil import exchange

    sdir, jdir = os.path.join(base, "snap"), os.path.join(base, "journal")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))

    def boot():
        port = free_port()
        proc = subprocess.Popen(
            [sys.executable, "-m", "redisson_tpu_torch", "--port", str(port), "--device",
             P14_DEVICE, "--snapshot-dir", sdir, "--journal-dir", jdir],
            cwd=str(Path(__file__).resolve().parent), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, c11d_connect(port, proc)

    proc, sock = boot()
    acked_sets, acked_keys = [], []
    try:
        check(exchange(sock, [("CONFIG", "SET", "appendfsync", "always"),
                              ("BF.RESERVE", "p14e", "0.01", "100000")]) == [b"OK", b"OK"],
              "14e: setup")
        nb, bsz = P14["e_batches"], P14["e_batch"]
        for b in range(nb):
            cmds = []
            for j in range(bsz):
                k = b * bsz + j
                cmds.append(("SET", f"p14e-{k}", str(k * 7)) if j % 2 else
                            ("BF.MADD", "p14e", *(str(k * 1000 + x) for x in range(16))))
            sock.sendall(wire([[str(a).encode() for a in c] for c in cmds]))
            frames = read_frames(sock, len(cmds))
            for c, f in zip(cmds, frames):
                check(not f.startswith(b"-"), f"14e: {c[0]} failed: {f[:200]}")
                if c[0] == "SET":
                    acked_sets.append((c[1], c[2]))
                else:
                    acked_keys.extend(c[2:])
            if b == P14["e_kill_after"]:
                # Mid-stream: the next batch is on the wire, unanswered.
                sock.sendall(wire([[b"SET", b"p14e-inflight", b"x"]] * bsz))
                proc.send_signal(signal.SIGKILL)
                break
        proc.wait(timeout=60)
        check(proc.returncode == -signal.SIGKILL, f"14e: exit {proc.returncode}")
        sock.close()
        t0 = time.perf_counter()
        proc, sock = boot()
        reboot_s = time.perf_counter() - t0
        gets = exchange(sock, [("GET", k) for k, _ in acked_sets])
        check(gets == [v.encode() for _, v in acked_sets], "14e: an acked SET was lost")
        hits = exchange(sock, [("BF.MEXISTS", "p14e", *acked_keys)])[0]
        check(all(int(h) == 1 for h in hits), "14e: an acked BF.MADD key was lost")
        info = exchange(sock, [("INFO", "persistence")])[0].decode()
        check("aof_enabled:1" in info, "14e: the rebooted server has no journal")
        log({"phase": "14e", "acked_sets": len(acked_sets), "acked_bloom_keys": len(acked_keys),
             "reboot_s": reboot_s, "all_acked_writes_read_back": True,
             "aof": [ln for ln in info.split("\r\n") if ln.startswith("aof_replayed")],
             "card": card})
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate(timeout=30)
        sock.close()


def phase_durability(seed: int, card: str) -> None:
    """Phase 14: the op journal, kill -9 recovery and the replication
    stream on fresh card clients."""
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    base = tempfile.mkdtemp(prefix="phase14-", dir=str(build))
    try:
        t0 = time.perf_counter()
        streams = p14_streams(seed)
        p14a_appendfsync(streams, os.path.join(base, "a"), card)
        p14b_kill9(streams, os.path.join(base, "b"), seed, card)
        p14c_soak(os.path.join(base, "c"), card)
        p14d_replication(streams, os.path.join(base, "d"), card)
        p14e_entry_point(os.path.join(base, "e"), card)
        log({"phase": 14, "seconds": time.perf_counter() - t0, "card": card})
    finally:
        shutil.rmtree(base, ignore_errors=True)


# -- phase 15: the observability tier on the card ----------------------------

P15 = {"keys": 1 << 20, "chunk": 1 << 18, "capacity": 1_048_576, "fpp": 0.01,
       "contains": 1 << 20, "cms_events": 1 << 20, "d": 5, "w": 1 << 16,
       "rounds": 3, "madd": 1024, "madd_cmds": 256, "conns": 4, "window": 16,
       "c6_batches": 8, "c6_depth": 256}
P15_DEVICE = "cuda"
# The fields of INFO telemetry and INFO events, as the JAX server names them.
P15_TELEMETRY = ("trace_sample_rate", "trace_spans", "trace_traces", "trace_max_spans",
                 "trace_sampled_total", "trace_evicted_total", "latency_monitor_threshold",
                 "latency_events", "latency_samples", "monitors")
P15_EVENTS = ("events_enabled", "events_len", "events_seq", "events_evicted", "events_max")
PHASES = ("coalesce_wait", "host_stage", "slot_wait", "enqueue", "d2h_fetch")
# The band of the add pass's event-timed device time (the spans'
# device_s) over the kernel, memcpy and memset time its capture saw.  A
# launch's events bracket its kernels and the gaps between them, which the
# host's kernel issue leaves: readings 4.88-7.53 at P15's size, 8.36-15.54
# at the card test's smaller one (NVIDIA H100 80GB HBM3, 700 W); the top is
# about twice the largest.  Below 1 the events would miss device work.  The
# band alone cannot tell event time from the host's dispatch and fetch
# phases, which read 7.6-15.9 there: 15a also holds each span's device
# time below its enqueue + d2h_fetch, the host interval that contains the
# launch's work.
P15_DEVICE_OVER_CARD = (1.0, 32.0)


def p15_sync() -> None:
    if P15_DEVICE == "cuda":
        torch.cuda.synchronize()


def p15_config(long_codec: bool = True, **kw):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    cfg = rt.Config().use_gpu_sketch(device=P15_DEVICE, **kw)
    if long_codec:
        cfg.set_codec(LongCodec())
    return cfg


def p15_capture(fn):
    """``fn()`` under a torch.profiler capture (CPU activity, and CUDA on
    the card); returns its result and the Chrome trace's events."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if P15_DEVICE == "cuda":
        acts.append(ProfilerActivity.CUDA)
    p15_sync()
    tmp = tempfile.mkdtemp(prefix="p15-trace-")
    try:
        with profile(activities=acts) as prof:
            out = fn()
            p15_sync()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, events


def device_us(events) -> float:
    """Microseconds of CUDA kernel, memcpy and memset activity in a trace."""
    return float(sum(e.get("dur", 0) for e in events
                     if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")))


def tenant_device_us(obs, tenant: str) -> float:
    fam = obs.registry.family("rtpu_tenant_device_us_total")
    return float(sum(c.value for (t, _op), c in fam.items() if t == tenant))


def family_value(obs, family: str, labels: tuple) -> float:
    c = dict(obs.registry.family(family).items()).get(labels)
    return 0.0 if c is None else float(c.value)


def k1_in_regions(events, n_launches: int) -> dict:
    """Every K1 kernel of the trace was launched inside an
    ``rtpu:cms_update_estimate_seq`` region, shown by either of the
    trace's two links: the kernel's launch call (the runtime event of the
    same correlation id) lies within such a region on the same thread, or
    the kernel's external id (the innermost host op open at its launch)
    is such a region's."""
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "cms_seq_kernel" in e.get("name", "")]
    regions = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "rtpu:cms_update_estimate_seq"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    region_ids = {r.get("args", {}).get("External id") for r in regions} - {None}
    # A long process's later captures can miss device records (a whole
    # smoke run's capture held 23 of 32 K1 kernels), so the kernels seen
    # are bounded by the launches, and each one seen must sit in a region.
    check(0 < len(kernels) <= n_launches,
          f"15a: {len(kernels)} K1 kernels in the trace, {n_launches} launches")
    check(len(regions) == n_launches,
          f"15a: {len(regions)} rtpu:cms_update_estimate_seq regions, {n_launches} launches")
    by_launch = by_external = 0
    for k in kernels:
        args = k.get("args", {})
        rt_ev = launches.get(args.get("correlation"))
        inside = rt_ev is not None and any(
            r["tid"] == rt_ev["tid"] and r["pid"] == rt_ev["pid"]
            and r["ts"] <= rt_ev["ts"] <= r["ts"] + r["dur"] for r in regions)
        by_launch += inside
        ext = args.get("External id") in region_ids
        by_external += ext
        check(inside or ext, f"15a: K1 kernel {args} was launched outside an "
              "rtpu:cms_update_estimate_seq region")
    return {"k1_kernels": len(kernels), "regions": len(regions),
            "k1_in_region_by_launch_event": by_launch,
            "k1_in_region_by_external_id": by_external,
            "k1_kernel_us": float(sum(k.get("dur", 0) for k in kernels))}


def p15a_spans(rng, card: str) -> dict:
    """15a: spans, dispatch records, traces and load attribution see the
    card's launches, K1's among them."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.ops import cms_seq

    cfg = p15_config()
    cfg.trace_sample_rate = 1.0
    client = rt.create(cfg)
    try:
        obs = client.obs
        n, chunk = P15["keys"], P15["chunk"]
        bf = client.get_bloom_filter("p15-cfg1")
        check(bf.try_init(P15["capacity"], P15["fpp"]), "try_init refused")
        warm = client.get_bloom_filter("p15-warm")
        check(warm.try_init(P15["capacity"], P15["fpp"]), "try_init refused")
        warm.add_all_async(np.arange(chunk, dtype=np.uint64)).result()
        warm.contains_many([np.arange(chunk, dtype=np.uint64)])
        p15_sync()
        obs.reset_op_stats()  # the spans, their families and the trace ring
        batches0 = client.get_metrics()["batches_total"]

        def add_pass():
            futs = [bf.add_all_async(np.arange(i * chunk, (i + 1) * chunk, dtype=np.uint64))
                    for i in range(n // chunk)]
            return [f.result() for f in futs]

        probes = rng.integers(0, 2 * n, P15["contains"]).astype(np.uint64)
        with client.trace("p15") as root:
            check(root is not None, "15a: client.trace minted no span at rate 1.0")
            flags, add_events = p15_capture(add_pass)
            add_spans = obs.spans.recent()
            add_dev_tenant_us = tenant_device_us(obs, "p15-cfg1")
            hits = bf.contains_many([probes])[0]
        spans = obs.spans.recent()
        check(len(spans) < 256, "15a: the span ring wrapped")
        # Results: the row and every flag equal the golden model.
        n_added = sum(int(np.sum(f)) for f in flags)
        check(0.97 * n <= n_added <= n, f"15a: added {n_added} of {n}")
        g = golden_bloom(bf, np.arange(n, dtype=np.uint64))
        words = tenant_row(client, "p15-cfg1")
        gbits = np.zeros(words.shape[0] * 32, bool)
        gbits[: g.size] = g.bits
        check(np.array_equal(words, np.packbits(gbits, bitorder="little").view(np.uint32)),
              "15a: the row differs from the golden bitmap")
        check(np.array_equal(hits, golden_contains(g, probes)), "15a: a flag differs from golden")
        # Every span's phases partition its end-to-end time.
        worst = 0.0
        for s in spans:
            ph = s.phases()
            check(set(ph) == set(PHASES), f"15a: span phases {sorted(ph)}")
            worst = max(worst, abs(sum(ph.values()) - s.end_to_end()))
        check(worst <= 1e-6, f"15a: phases miss end_to_end by {worst * 1e6:.3f} us")
        # Spans = phase-histogram samples = coalesced launches.
        hist = obs.registry.family("rtpu_op_phase_seconds")
        n_hist = sum(c.count for (_op, ph), c in hist.items() if ph == "enqueue")
        launches = client.get_metrics()["batches_total"] - batches0
        check(n_hist == len(spans) == launches,
              f"15a: {n_hist} phase samples, {len(spans)} spans, {launches} launches")
        ops = sum(st["ops"] for st in obs.op_stats().values())
        check(ops == n + len(probes), f"15a: op_stats counts {ops} ops, {n + len(probes)} submitted")
        # The trace holds one launch span per launch, each with its phases.
        tspans = obs.trace.traces(root.trace_id)[root.trace_id]
        lspans = [s for s in tspans if s["name"].startswith("launch:")]
        check(len(lspans) == len(spans), f"15a: {len(lspans)} launch spans, {len(spans)} launches")
        check(all(s["parent_id"] == root.span_id
                  and all(p + "_us" in s["attrs"] for p in PHASES) for s in lspans),
              "15a: a launch span lacks its parent or a phase")
        # The spans' event-timed device time against the card's own.
        check(all(s.device_s is not None for s in add_spans), "15a: a span lacks its device time")
        over = [s for s in add_spans
                if s.device_s >= s.phases()["enqueue"] + s.phases()["d2h_fetch"]]
        check(not over, f"15a: {len(over)} spans' device time is not below their "
              "enqueue + d2h_fetch")
        span_dev_us = sum(s.device_s * 1e6 for s in add_spans)
        card_us = device_us(add_events)
        ratio = span_dev_us / card_us if card_us else None
        print(f"15a: span device time {span_dev_us:.1f} us, card {card_us:.1f} us, "
              f"ratio {ratio}", flush=True)
        if P15_DEVICE == "cuda":
            check(card_us > 0, "15a: the add pass's capture holds no device activity")
            lo, hi = P15_DEVICE_OVER_CARD
            check(lo <= ratio <= hi, f"15a: span device time over card time {ratio:.3f} "
                  f"outside [{lo}, {hi}]")
        check(abs(add_dev_tenant_us - span_dev_us) <= 0.1 * len(add_spans) + 0.05,
              f"15a: rtpu_tenant_device_us {add_dev_tenant_us:.1f} != spans' {span_dev_us:.1f} us")

        # Config 5: K1's dispatch records and regions under a second capture.
        d, w = P15["d"], P15["w"]
        cms = client.get_count_min_sketch("p15-cms")
        check(cms.try_init(d, w), "try_init refused")
        wcms = client.get_count_min_sketch("p15-cms-warm")
        check(wcms.try_init(d, w), "try_init refused")
        wcms.add_all_seq(np.arange(1024, dtype=np.uint64))
        events = (rng.zipf(1.2, P15["cms_events"]) % 100_000).astype(np.uint64)
        key = ("cms_update_estimate_seq",)
        d0 = family_value(obs, "rtpu_dispatches_total", key)
        o0 = family_value(obs, "rtpu_dispatch_ops_total", key)
        l0 = cms_seq.LAUNCHES
        est, k1_events = p15_capture(lambda: cms.add_all_seq(events))
        n_disp = family_value(obs, "rtpu_dispatches_total", key) - d0
        n_ops = family_value(obs, "rtpu_dispatch_ops_total", key) - o0
        n_k1 = cms_seq.LAUNCHES - l0
        chunks = -(-len(events) // client._engine._SEQ_CHUNK)
        check(n_disp == chunks, f"15a: {n_disp} K1 dispatch records for {chunks} chunks")
        if P15_DEVICE == "cuda":
            check(n_disp == n_k1, f"15a: {n_disp} dispatch records, {n_k1} K1 launches")
            regions = k1_in_regions(k1_events, n_k1)
        else:
            regions = {"regions": sum(1 for e in k1_events if e.get("cat") == "user_annotation"
                                      and e.get("name") == "rtpu:cms_update_estimate_seq")}
            check(regions["regions"] == chunks, f"15a: {regions['regions']} K1 regions")
        check(n_ops == len(events), f"15a: rtpu_dispatch_ops {n_ops}, {len(events)} events")
        from redisson_tpu_torch.utils import hashing

        h1w, h2w = hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(events)), w)
        table, g_est = cms_seq_unit(h1w, h2w, d, w)
        check(np.array_equal(np.asarray(est, np.uint32), g_est), "15a: estimates != golden_seq")
        check(np.array_equal(tenant_row(client, "p15-cms")[: d * w].reshape(d, w), table),
              "15a: the CMS table != golden")
        check_healthy(client, "15a")
        out = {"phase": "15a", "config": "config 1 spans; config 5 K1 records",
               "launches": launches, "spans": len(spans), "launch_spans_in_trace": len(lspans),
               "phase_sum_worst_us": worst * 1e6, "ops": ops,
               "add_pass_span_device_us": span_dev_us, "add_pass_card_us": card_us,
               "add_pass_tenant_device_us": add_dev_tenant_us,
               "span_over_card": ratio,
               "k1_dispatch_records": n_disp, "k1_launches": n_k1,
               "k1_dispatch_ops": n_ops, **regions,
               "phase_stats": obs.phase_stats(), "card": card}
        log(out)
        return out
    finally:
        client.obs.trace.set_sample_rate(0.0)
        client.shutdown()


def p15b_overhead(card: str) -> dict:
    """15b: phase 2's add pass with the tier off (A), inside a trace scope
    at rate 1.0 (B), and with the loadmap's key sampling at 1.0 (C), in
    turns A B C C B A, three rounds."""
    import redisson_tpu_torch as rt

    client = rt.create(p15_config())
    try:
        obs = client.obs
        n, chunk = P15["keys"], P15["chunk"]
        keys = [np.arange(i * chunk, (i + 1) * chunk, dtype=np.uint64) for i in range(n // chunk)]
        warm = client.get_bloom_filter("p15b-warm")
        check(warm.try_init(P15["capacity"], P15["fpp"]), "try_init refused")
        warm.add_all_async(keys[0]).result()
        want = None
        rates = {"A": [], "B": [], "C": []}
        for i, arm in enumerate("ABCCBA" * P15["rounds"]):
            obs.trace.set_sample_rate(1.0 if arm == "B" else 0.0)
            obs.loadmap.sample_rate = 1.0 if arm == "C" else 0.0
            name = f"p15b-{i}"
            bf = client.get_bloom_filter(name)
            check(bf.try_init(P15["capacity"], P15["fpp"]), "try_init refused")
            if want is None:
                g = golden_bloom(bf, np.arange(n, dtype=np.uint64))
                words = tenant_row(client, name)
                gbits = np.zeros(words.shape[0] * 32, bool)
                gbits[: g.size] = g.bits
                want = np.packbits(gbits, bitorder="little").view(np.uint32)
            p15_sync()
            t0 = time.perf_counter()
            if arm == "B":
                with client.trace("p15b") as span:
                    check(span is not None, "15b: no span at rate 1.0")
                    for f in [bf.add_all_async(k) for k in keys]:
                        f.result()
            else:
                for f in [bf.add_all_async(k) for k in keys]:
                    f.result()
            rates[arm].append(n / (time.perf_counter() - t0))
            check(np.array_equal(tenant_row(client, name), want),
                  f"15b: arm {arm}'s row differs from the golden bitmap")
            bf.delete()
        obs.trace.set_sample_rate(0.0)
        check_healthy(client, "15b")
        med = {a: float(np.median(v)) for a, v in rates.items()}
        out = {"phase": "15b", "config": "phase 2's add pass, tier off / traced / key-sampled",
               "keys_per_s": {a: {"min": min(v), "median": med[a], "max": max(v)}
                              for a, v in rates.items()},
               "B_over_A": med["B"] / med["A"], "C_over_A": med["C"] / med["A"],
               "rounds": P15["rounds"], "card": card}
        log(out)
        return out
    finally:
        client.obs.trace.set_sample_rate(0.0)
        client.shutdown()


def monitor_line(cmd) -> bytes:
    """The reference's MONITOR rendering of one command (after the
    timestamp and the client address)."""
    return b" ".join(
        b'"%s"' % a.replace(b"\\", b"\\\\").replace(b'"', b'\\"') for a in cmd)


def slowlog_args(cmd) -> list:
    """Redis's slowlog argument truncation: at most 32 arguments (the last
    replaced by a count of the rest), at most 128 bytes each."""
    shown = cmd[:31] if len(cmd) > 32 else cmd
    out = [a if len(a) <= 128 else a[:128] + b"... (%d more bytes)" % (len(a) - 128)
           for a in shown]
    if len(cmd) > 32:
        out.append(b"... (%d more arguments)" % (len(cmd) - 31))
    return out


def read_monitor(sock, want: int, timeout: float = 120.0) -> list:
    """(address, rendered command) of MONITOR lines until ``want`` BF.MADD
    lines arrived."""
    import re

    pat = re.compile(rb"^\+\d+\.\d{6} \[0 ([^\]]+)\] (.*)$")
    sock.settimeout(timeout)
    buf, out, seen = b"", [], 0
    while seen < want:
        chunk = sock.recv(1 << 20)
        check(bool(chunk), f"15c: the monitor closed after {seen} BF.MADD lines")
        buf += chunk
        *lines, buf = buf.split(b"\r\n")
        for ln in lines:
            m = pat.match(ln)
            check(m is not None, f"15c: malformed monitor line {ln[:80]!r}")
            out.append((m.group(1).decode(), m.group(2)))
            seen += m.group(2).startswith(b'"BF.MADD"')
    check(buf == b"", "15c: a partial monitor line after the last BF.MADD")
    return out


def p15c_wire(rng, card: str, seed: int) -> dict:
    """15c: MONITOR, SLOWLOG, LATENCY, EVENTS, TRACE and HOTKEYS over the
    wire on a card server (reactor on, native codec required)."""
    import json as _json

    import redisson_tpu_torch as rt
    from redisson_tpu_torch.obs import total
    from redisson_tpu_torch.serve.resp import RespServer
    from redisson_tpu_torch.serve.wireutil import exchange

    os.environ["RTPU_REQUIRE_NATIVE_RESP"] = "1"

    def p15_server(**kw):
        cfg = p15_config(long_codec=False, **P9_KNOBS, **kw)
        cfg.retry_attempts = P9_RETRY["retry_attempts"]
        cfg.retry_interval_ms = P9_RETRY["retry_interval_ms"]
        client = rt.create(cfg)
        return client, RespServer(client, max_connections=4096)

    per, n_cmds, conns, win = P15["madd"], P15["madd_cmds"], P15["conns"], P15["window"]
    cmds = [[b"BF.MADD", b"cfg1"] + c11_keys(j * per, (j + 1) * per) for j in range(n_cmds)]
    client, server = p15_server()
    out = {"phase": "15c", "card": card}
    try:
        check(server.reactor is not None, "15c: the reactor is off")
        ctl = socket.create_connection((server.host, server.port))
        r = exchange(ctl, [("CONFIG", "SET", "slowlog-log-slower-than", "0"),
                           ("BF.RESERVE", "cfg1", "%g" % P15["fpp"], "%d" % P15["capacity"])])
        check(r == [b"OK", b"OK"], f"15c: setup replies {r}")
        mon = socket.create_connection((server.host, server.port))
        mon.sendall(wire([[b"MONITOR"]]))
        check(read_frames(mon, 1) == [b"+OK\r\n"], "15c: MONITOR refused")
        check(len(server._monitors) == 1, "15c: the server holds no monitor")
        fused0 = total(server.obs.resp_fused_runs)
        # The load: connection c sends commands c, c + conns, ... in
        # pipelined windows, while the monitor is attached.
        streams = [cmds[c::conns] for c in range(conns)]
        socks = [socket.create_connection((server.host, server.port)) for _ in range(conns)]
        addrs = ["%s:%d" % s.getsockname()[:2] for s in socks]
        replies = [None] * conns
        errors = []

        def load(c):
            try:
                got = []
                for i in range(0, len(streams[c]), win):
                    part = streams[c][i:i + win]
                    socks[c].sendall(wire(part))
                    got += read_frames(socks[c], len(part))
                replies[c] = got
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=load, args=(c,)) for c in range(conns)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        load_s = time.perf_counter() - t0
        check(not errors, f"15c: the load failed: {errors[:1]}")
        lines = read_monitor(mon, n_cmds)
        fused = total(server.obs.resp_fused_runs) - fused0
        check(fused == 0, f"15c: {fused} runs fused while a monitor was attached")
        # Every command exactly once, in each connection's send order, with
        # the reference's rendering.
        order = []
        for c in range(conns):
            mine = [body for addr, body in lines if addr == addrs[c]]
            check(mine == [monitor_line(x) for x in streams[c]],
                  f"15c: the monitor's lines of connection {c} differ from its commands")
        by_line = {monitor_line(x): x for x in cmds}
        order = [by_line[body] for _addr, body in lines if body.startswith(b'"BF.MADD"')]
        check(len(order) == n_cmds and len({id(x) for x in order}) == n_cmds,
              "15c: the monitor saw a command twice or missed one")
        # SLOWLOG: the newest 128 commands, truncated as Redis truncates.
        # Logged since the threshold went to 0: that CONFIG SET, BF.RESERVE,
        # MONITOR, the load, and (for LEN) the SLOWLOG GET.
        (entries,) = exchange(ctl, [("SLOWLOG", "GET", "128")])
        (sl_len,) = exchange(ctl, [("SLOWLOG", "LEN")])
        check(sl_len == min(n_cmds + 4, 128), f"15c: SLOWLOG LEN {sl_len}")
        check(len(entries) == min(n_cmds + 3, 128), f"15c: SLOWLOG GET gave {len(entries)}")
        newest = order[::-1][:128]
        addr_of = {id(x): addrs[c] for c in range(conns) for x in streams[c]}
        check(all(e[3] == slowlog_args(x) and e[4] == addr_of[id(x)].encode()
                  for e, x in zip(entries, newest)),
              "15c: SLOWLOG GET is not the newest commands with Redis's truncation")
        ids = [e[0] for e in entries]
        check(ids == sorted(ids, reverse=True), "15c: slowlog ids not newest first")
        mon.close()
        until(lambda: not server._monitors, "15c: the monitor's slot reclaimed", 30)
        # Replies equal a sequential replay in the monitor's order.
        rclient, rserver = p15_server()
        try:
            rserver.vectorize = False
            roundtrip(rserver, [[b"BF.RESERVE", b"cfg1", b"%g" % P15["fpp"],
                                 b"%d" % P15["capacity"]]])
            replay = []
            rs = socket.create_connection((rserver.host, rserver.port))
            for i in range(0, len(order), win):
                rs.sendall(wire(order[i:i + win]))
                replay += read_frames(rs, len(order[i:i + win]))
            rs.close()
        finally:
            rserver.close()
            rclient.shutdown()
        want = {id(x): f for x, f in zip(order, replay)}
        check(all(replies[c][j] == want[id(x)] for c in range(conns)
                  for j, x in enumerate(streams[c])),
              "15c: a reply differs from the sequential replay")
        out.update(monitor_cmds=n_cmds, monitor_lines=len(lines), fused_runs_attached=fused,
                   load_cmds_per_s=n_cmds / load_s, slowlog_len=sl_len,
                   replies_equal_replay=True)
        for s in socks:
            s.close()

        # TRACE: the prelude gives a trace id; the command and launch spans.
        tid, sid = "15" * 16, "ab" * 8
        r = exchange(ctl, [("RTPU.TRACE", tid, sid), cmds[0]])
        check(r[0] == b"OK" and len(r[1]) == per, f"15c: traced BF.MADD replied {r[0]}")
        (docs,) = exchange(ctl, [("TRACE", "GET", tid)])
        check(len(docs) == 1, f"15c: TRACE GET gave {len(docs)} documents")
        spans = _json.loads(docs[0])["spans"]
        cmd_span = [s for s in spans if s["name"] == "resp:BF.MADD"]
        launch = [s for s in spans if s["name"].startswith("launch:")]
        check(len(cmd_span) == 1 and cmd_span[0]["parent_id"] == sid,
              "15c: the traced command's span is missing")
        check(launch and all(s["parent_id"] == cmd_span[0]["span_id"]
                             and all(p + "_us" in s["attrs"] for p in PHASES) for s in launch),
              "15c: the launch span with its four phases is missing")
        out.update(trace_spans=len(spans), trace_launch_spans=len(launch))

        check_healthy(client, "15c")
        # LATENCY and EVENTS: trip the Bloom breaker and clear it.
        r = exchange(ctl, [("CONFIG", "SET", "latency-monitor-threshold", "1")])
        check(r == [b"OK"], f"15c: CONFIG SET latency-monitor-threshold: {r}")
        bf = client.get_bloom_filter("p15c-trip")
        check(bf.try_init(10_000, 0.01), "try_init refused")
        bf.add_all(["a", "b"])
        trip(client, "bloom", "p15c-trip", lambda: bf.add("p15c-probe"))
        heal(client, "bloom")

        def events_of(kind=None):
            cmd = ("EVENTS", "GET") if kind is None else ("EVENTS", "GET", "0", kind)
            (doc,) = exchange(ctl, [cmd])
            return _json.loads(doc)["events"]

        until(lambda: events_of("health.breaker.close"), "15c: health.breaker.close", 30)
        evs = events_of("health.")
        kinds = [e["kind"] for e in evs]
        check("health.breaker.open" in kinds and "health.breaker.close" in kinds
              and kinds.index("health.breaker.open") < kinds.index("health.breaker.close"),
              f"15c: EVENTS GET health. gave {kinds}")
        seqs = [e["seq"] for e in events_of()]
        check(seqs == sorted(set(seqs)), "15c: event seq not monotone")
        (latest,) = exchange(ctl, [("LATENCY", "LATEST")])
        check(any(row[0] == b"breaker-open" for row in latest),
              f"15c: LATENCY LATEST names {[row[0] for row in latest]}")
        info = {}
        for sec in ("events", "telemetry"):
            (txt,) = exchange(ctl, [("INFO", sec)])
            info[sec] = [ln.split(":", 1)[0] for ln in txt.decode().split("\r\n")
                         if ln and not ln.startswith("#")]
        check(tuple(info["events"]) == P15_EVENTS, f"15c: INFO events fields {info['events']}")
        check(tuple(info["telemetry"]) == P15_TELEMETRY,
              f"15c: INFO telemetry fields {info['telemetry']}")
        eng = client._engine
        check(eng.health.board.open_count() == 0 and not eng._mirrors
              and not eng.health.any_degraded, "15c: the breaker did not close")
        out.update(events=kinds, latency_latest=[row[0].decode() for row in latest])
        ctl.close()
    finally:
        server.close()
        client.shutdown()

    # HOTKEYS on config 6's stream with every key sampled.
    P, depth, nb = P15["conns"], P15["c6_depth"], P15["c6_batches"]
    batches = config6_batches(seed, P * nb, depth)
    per_conn = [batches[c * nb:(c + 1) * nb] for c in range(P)]
    client, server = p15_server(batch_window_us=200)
    try:
        roundtrip(server, [[b"CONFIG", b"SET", b"loadmap-key-sample-rate", b"1"]])
        roundtrip(server, config6_seed_cmds())
        lm = server.loadmap
        ops0, hits0 = lm.totals()["ops"], total(server.obs.resp_cache_hits)
        config6_pass(server, per_conn)
        sent = sum(len(b) for b in batches)
        counted = lm.totals()["ops"] - ops0
        hits = total(server.obs.resp_cache_hits) - hits0
        check(counted + hits == sent,
              f"15c: loadmap ops {counted} + cache hits {hits} != {sent} commands sent")
        counts: dict = {}
        for b in batches:
            for c in b:
                counts[c[1]] = counts.get(c[1], 0) + 1
        hs = socket.create_connection((server.host, server.port))
        (flat,) = exchange(hs, [("HOTKEYS", "16")])
        hs.close()
        shown = set(flat[0::2])
        heavy = {k for k, v in counts.items() if v > sent / 128}
        check(heavy <= shown, f"15c: HOTKEYS {sorted(shown)} misses {sorted(heavy - shown)}")
        (txt,) = roundtrip(server, [[b"INFO", b"loadstats"]])
        check(b"loadmap_ops:" in txt and b"loadmap_hot_keys:" in txt, "15c: INFO loadstats")
        check_healthy(client, "15c")
        out.update(c6_cmds=sent, c6_cache_hits=hits, hot_keys=sorted(k.decode() for k in heavy))
    finally:
        server.close()
        client.shutdown()
    log(out)
    return out


def phase_telemetry(rng, seed: int, card: str) -> None:
    """Phase 15: the observability tier on the card."""
    p15a_spans(rng, card)
    p15b_overhead(card)
    p15c_wire(rng, card, seed)


# -- phase 16: scripting and the per-core front door -------------------------

P16 = {"keys": 1 << 16, "madd": 1024, "conns": 4, "window": 16, "read": 131_072,
       "fpp": 0.01, "capacity": 1_000_000, "lat_cmds": 32, "timeout_ms": 200,
       "kill_iters": 4, "workers": 4, "c13_procs": 8, "c13_conns": 4, "c13_hot": 128,
       "c13_pass_s": 1.5, "c13_passes": 1, "c13_warm_s": 1.0, "c6_batches": 1,
       "node_keys": 1 << 16, "node_read": 131_072}
P16_DEVICE = "cuda"

# The reader library of 16a: FCALL_RO look 1 <filter> <items...>.
P16_LIB = (b"#!python name=cfg1lib\n"
           b"def look(keys, args):\n"
           b"    return redis.call('BF.MEXISTS', keys[0], *args)\n"
           b"register_function('look', look, flags=('no-writes',))\n")
P16_MADD = b"redis.call('BF.MADD', KEYS[0], *ARGV)"


def p16_session() -> list:
    """A seeded script session: EVAL in both forms and every reply type,
    EVALSHA and NOSCRIPT, SCRIPT LOAD|EXISTS|FLUSH, FUNCTION LOAD|REPLACE|
    LIST|DELETE|FLUSH, FCALL and FCALL_RO, and redis.call / redis.pcall of
    the Bloom, CMS and string commands."""
    import hashlib

    rng = np.random.default_rng(16)
    keys = [b"%d" % v for v in rng.integers(0, 1 << 40, 64)]
    items = [b"i%d" % v for v in rng.integers(0, 50, 12)]
    body = b"int(ARGV[0]) + 1"
    sha = hashlib.sha1(body).hexdigest().encode()
    lib = (b"#!python name=slib\ndef add(keys, args):\n"
           b"    return redis.call('BF.MADD', keys[0], *args)\n"
           b"def look(keys, args):\n    return redis.call('BF.MEXISTS', keys[0], *args)\n"
           b"register_function('add', add)\n"
           b"register_function('look', look, flags=('no-writes',))\n")
    return [
        [b"BF.RESERVE", b"sbf", b"0.01", b"5000"], [b"CMS.INITBYDIM", b"scms", b"2048", b"4"],
        [b"EVAL", b"None", b"0"], [b"EVAL", b"True", b"0"], [b"EVAL", b"-42", b"0"],
        [b"EVAL", b"2.5", b"0"], [b"EVAL", b"'text'", b"0"],
        [b"EVAL", b"[1, b'x', [None, False], (2, 'y')]", b"0"],
        [b"EVAL", b"{'a': 1, 'b': [2.25]}", b"0"], [b"EVAL", b"redis.pcall('NOPE')", b"0"],
        [b"EVAL", b"x = int(ARGV[0])\nresult = [x, x * 2]", b"0", b"21"],
        [b"EVAL", b"1 / 0", b"0"],
        [b"EVAL", body, b"0", b"1"], [b"EVALSHA", sha, b"0", b"5"],
        [b"EVALSHA", b"f" * 40, b"0"], [b"SCRIPT", b"LOAD", b"len(KEYS)"],
        [b"SCRIPT", b"EXISTS", sha, b"0" * 40], [b"SCRIPT", b"FLUSH"],
        [b"SCRIPT", b"EXISTS", sha],
        [b"FUNCTION", b"LOAD", lib], [b"FUNCTION", b"LOAD", lib],
        [b"FUNCTION", b"LOAD", b"REPLACE", lib],
        [b"FUNCTION", b"LOAD", b"#!lua name=x\nreturn 1"],
        [b"FUNCTION", b"LIST", b"LIBRARYNAME", b"s*"],
        [b"FCALL", b"add", b"1", b"sbf"] + keys[48:],
        [b"FCALL_RO", b"look", b"1", b"sbf"] + keys[40:],
        [b"FCALL_RO", b"add", b"1", b"sbf", b"x"],
        [b"FUNCTION", b"DELETE", b"slib"], [b"FCALL", b"add", b"1", b"sbf", b"x"],
        [b"FUNCTION", b"FLUSH"], [b"FUNCTION", b"LIST"],
        [b"EVAL", P16_MADD, b"1", b"sbf"] + keys[:32],
        [b"EVAL", b"redis.pcall('BF.MEXISTS', KEYS[0], *ARGV)", b"1", b"sbf"] + keys[16:48],
        [b"EVAL", b"redis.call('SET', KEYS[0], ARGV[0])\nresult = redis.call('GET', KEYS[0])",
         b"1", b"skey", b"sval"],
        [b"EVAL", b"redis.call('CMS.INCRBY', KEYS[0], *ARGV)", b"1", b"scms"]
        + [x for it in items for x in (it, b"3")],
        [b"EVAL", b"redis.pcall('CMS.QUERY', KEYS[0], *ARGV)", b"1", b"scms"] + items,
        [b"BF.MEXISTS", b"sbf"] + keys, [b"CMS.QUERY", b"scms"] + items,
    ]


def p16_server(client, **kw):
    from redisson_tpu_torch.serve.resp import RespServer

    return RespServer(client, max_connections=4096, enable_python_scripts=True, **kw)


def p16_running(server, cmd):
    """Send ``cmd`` on a fresh connection; (socket, thread, reply box)."""
    box = []
    sock = socket.create_connection((server.host, server.port))
    sock.sendall(wire([cmd]))

    def wait():
        box.append(read_frames(sock, 1, timeout=120.0)[0])
        box.append(time.perf_counter())

    t = threading.Thread(target=wait)
    t.start()
    return sock, t, box


def p16_kill(server, ctl, cmd, tag: str, before_kill=None) -> float:
    """Run ``cmd`` until another connection answers BUSY (and
    ``before_kill()`` holds), SCRIPT KILL it, check the killed reply and
    a free slot; the ms from the KILL's send to the killed reply."""
    sock, t, box = p16_running(server, cmd)
    got = []

    def busy():
        ctl.sendall(wire([[b"PING"]]))
        got.append(read_frames(ctl, 1)[0])
        return got[-1].startswith(b"-BUSY")

    until(busy, f"{tag}: BUSY on another connection", 60)
    if before_kill is not None:
        until(before_kill, f"{tag}: the script's progress", 120)
    t0 = time.perf_counter()
    ctl.sendall(wire([[b"SCRIPT", b"KILL"]]))
    check(read_frames(ctl, 1) == [b"+OK\r\n"], f"{tag}: SCRIPT KILL refused")
    t.join(60)
    check(not t.is_alive(), f"{tag}: the killed script never replied")
    sock.close()
    check(box[0] == b"-ERR Script killed by user with SCRIPT KILL...\r\n",
          f"{tag}: the killed script replied {box[0][:80]!r}")
    check(server._script_run is None and server._script_kill is None,
          f"{tag}: the watchdog slot is still held")
    ctl.sendall(wire([[b"EVAL", b"6 * 7", b"0"]]))
    check(read_frames(ctl, 1) == [b":42\r\n"], f"{tag}: the next EVAL did not run")
    return (box[1] - t0) * 1e3


def p16a_scripting(rng, card: str) -> dict:
    """16a: config 1 through scripts on a card server, the seeded script
    session against a CPU server, and the watchdog."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.ops import golden

    os.environ["RTPU_REQUIRE_NATIVE_RESP"] = "1"
    n, per, conns, win = P16["keys"], P16["madd"], P16["conns"], P16["window"]
    out = {"phase": "16a", "card": card}
    client = p11_client()
    server = p16_server(client)
    cpu = rt.create(rt.Config().use_gpu_sketch(device="cpu"))
    cpu_server = p16_server(cpu)
    try:
        check(server.reactor is not None and server.reactor.native_tick,
              "16a: the reactor or its native tick is off")
        session = p16_session()
        got, want = roundtrip(server, session), roundtrip(cpu_server, session)
        for c, a, b in zip(session, got, want):
            check(a == b, f"16a: {c[:2]} replied {a[:60]!r} on the card, {b[:60]!r} on the CPU")
        check(sum(f.startswith(b"-") for f in got) < len(got) // 3,
              "16a: the session is mostly errors")
        check(np.array_equal(tenant_row(client, "sbf"), tenant_row(cpu, "sbf"))
              and np.array_equal(tenant_row(client, "scms"), tenant_row(cpu, "scms")),
              "16a: the session's rows differ from the CPU server's")
        # Config 1 through scripts: 256 EVALSHA of 1024 keys, 4 connections.
        r = roundtrip(server, [[b"BF.RESERVE", b"cfg1", b"%g" % P16["fpp"],
                                b"%d" % P16["capacity"]],
                               [b"SCRIPT", b"LOAD", P16_MADD]])
        check(r[0] == b"+OK\r\n" and r[1].startswith(b"$40\r\n"), f"16a: setup replied {r}")
        sha = r[1].split(b"\r\n")[1]
        bf = client.get_bloom_filter("cfg1")
        m, k = bf.get_size(), bf.get_hash_iterations()
        roundtrip(server, [[b"BF.RESERVE", b"warm", b"%g" % P16["fpp"], b"%d" % P16["capacity"]]]
                  + [[b"EVALSHA", sha, b"1", b"warm"] + c11_keys(i * per, (i + 1) * per)
                     for i in range(8)])
        n_cmds = n // per
        streams = [[[b"EVALSHA", sha, b"1", b"cfg1"] + c11_keys(j * per, (j + 1) * per)
                    for j in range(c, n_cmds, conns)] for c in range(conns)]
        replies = [None] * conns
        errors = []

        def load(c):
            try:
                sock = socket.create_connection((server.host, server.port))
                got = []
                for i in range(0, len(streams[c]), win):
                    part = streams[c][i:i + win]
                    sock.sendall(wire(part))
                    got += read_frames(sock, len(part))
                sock.close()
                replies[c] = got
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=load, args=(c,)) for c in range(conns)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        load_s = time.perf_counter() - t0
        check(not errors, f"16a: the EVALSHA load failed: {errors[:1]}")
        h1, h2 = wire_hashes(client, c11_keys(0, n), m)
        model = madd_model(h1, h2, m, k, per, conns)
        g, n_added = model[0], madd_check(model, replies, "16a")
        check(0.97 * n <= n_added <= n, f"16a: added {n_added} of {n}")
        words = tenant_row(client, "cfg1")
        check(np.array_equal(words, golden_words(g, words.shape[0])),
              "16a: the row differs from the golden bitmap")
        # Script latency: unpipelined EVALSHA of fresh keys on one connection.
        lat = []
        sock = socket.create_connection((server.host, server.port))
        for i in range(P16["lat_cmds"]):
            lo = n + i * per
            t1 = time.perf_counter()
            sock.sendall(wire([[b"EVALSHA", sha, b"1", b"warm"] + c11_keys(lo, lo + per)]))
            read_frames(sock, 1)
            lat.append(time.perf_counter() - t1)
        sock.close()
        lat = np.sort(np.array(lat)) * 1e3
        # The reader: FCALL_RO over outside keys equals the golden flags.
        outside = rng.integers(3 * n, 8 * n, P16["read"])
        items = [b"%d" % v for v in outside]
        cmds = [[b"FCALL_RO", b"look", b"1", b"cfg1"] + items[i:i + per]
                for i in range(0, len(items), per)]
        r = roundtrip(server, [[b"FUNCTION", b"LOAD", P16_LIB], [b"FUNCTION", b"LIST"]])
        (cpu_list,) = roundtrip(cpu_server, [[b"FUNCTION", b"FLUSH"],
                                             [b"FUNCTION", b"LOAD", P16_LIB],
                                             [b"FUNCTION", b"LIST"]])[2:]
        check(r[0] == b"$7\r\ncfg1lib\r\n" and r[1] == cpu_list,
              f"16a: FUNCTION LIST {r[1][:80]!r} differs from the CPU server's")
        t1 = time.perf_counter()
        flags = np.concatenate([int_array(f) for f in roundtrip(server, cmds)])
        read_s = time.perf_counter() - t1
        o1, o2 = wire_hashes(client, items, m)
        check(np.array_equal(flags.astype(bool), g.contains_hashed(o1, o2)),
              "16a: FCALL_RO flags differ from the golden model")
        check_healthy(client, "16a")
        out.update(evalsha_cmds=n_cmds, evalsha_keys=n, connections=conns,
                   evalsha_keys_per_s=n / load_s, added=n_added, row_equals_golden=True,
                   script_p50_ms=float(lat[len(lat) // 2]),
                   script_p99_ms=float(lat[int(len(lat) * 0.99)]),
                   fcall_ro_keys_per_s=len(items) / read_s, session_cmds=len(session),
                   session_equal_cpu=True)
    finally:
        server.close()
        cpu_server.close()
        cpu.shutdown()

    # The watchdog at script_timeout_ms 200 on a second server of the client.
    client.config.script_timeout_ms = P16["timeout_ms"]
    server = p16_server(client)
    madds = []
    orig = server._cmd_BF_MADD

    def counted(args):
        frame = orig(args)
        madds.append(len(args) - 1)
        return frame

    server._cmd_BF_MADD = counted
    try:
        ctl = socket.create_connection((server.host, server.port))
        ctl.sendall(wire([[b"SCRIPT", b"KILL"], [b"BF.RESERVE", b"kbf", b"%g" % P16["fpp"],
                                                  b"%d" % P16["capacity"]]]))
        r = read_frames(ctl, 2)
        check(r[0].startswith(b"-NOTBUSY") and r[1] == b"+OK\r\n", f"16a: {r}")
        kill_ms = {
            "pure_loop": p16_kill(server, ctl, [b"EVAL", b"while True: pass", b"0"],
                                  "16a pure loop"),
            "redis_call_loop": p16_kill(
                server, ctl, [b"EVAL", b"while True:\n    redis.call('BF.EXISTS', KEYS[0], 'x')",
                              b"1", b"kbf"], "16a redis.call loop"),
        }
        body = (b"i = 0\nwhile True:\n    redis.call('BF.MADD', KEYS[0], "
                b"*[b'%d' % (i * " + b"%d" % per + b" + j) for j in range(" + b"%d" % per
                + b")])\n    i += 1\n    redis.call('SET', KEYS[1], str(i))\n")
        kill_ms["madd_loop"] = p16_kill(server, ctl, [b"EVAL", body, b"2", b"kbf", b"kdone"],
                                        "16a BF.MADD loop",
                                        lambda: len(madds) >= P16["kill_iters"])
        ctl.sendall(wire([[b"GET", b"kdone"]]))
        done = int(read_frames(ctl, 1)[0].split(b"\r\n")[1])
        check(done >= P16["kill_iters"] and len(madds) in (done, done + 1)
              and all(x == per for x in madds),
              f"16a: {len(madds)} MADDs ran, the script counted {done}")
        kbf = client.get_bloom_filter("kbf")
        words = tenant_row(client, "kbf")
        fits = []
        for d in (done, done + 1):
            h1, h2 = wire_hashes(client, c11_keys(0, d * per), kbf.get_size())
            g = golden.GoldenBloomFilter(kbf.get_size(), kbf.get_hash_iterations())
            g.bits[g._indexes(h1, h2).reshape(-1)] = True
            fits.append(np.array_equal(words, golden_words(g, words.shape[0])))
        check(fits[len(madds) - done],
              "16a: the killed BF.MADD loop's row is not the golden bitmap of its MADDs")
        ctl.close()
        check_healthy(client, "16a")
        out.update(kill_to_reply_ms=kill_ms, killed_madd_iterations=done,
                   madds_landed=len(madds), killed_row_equals_golden=True)
    finally:
        server.close()
        client.shutdown()
    log(out)
    return out


def p16_info(sock) -> dict:
    """INFO's fields on ``sock`` as a dict."""
    sock.sendall(wire([[b"INFO", b"everything"]]))
    txt = read_frames(sock, 1)[0].decode()
    return dict(ln.split(":", 1) for ln in txt.split("\r\n")
                if ln and not ln.startswith("#") and ":" in ln)


def p16_peer(node, w: int):
    """A connection to worker ``w`` alone, over its unix peer socket."""
    from redisson_tpu_torch.serve.multicore import peer_sock_path

    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(peer_sock_path(node.rundir, w))
    return s


def p16_handoffs(node) -> int:
    """The node's handoffs so far, summed over its workers."""
    total = 0
    for w in range(node.nworkers):
        s = p16_peer(node, w)
        info = p16_info(s)
        s.close()
        total += sum(int(info[f"frontdoor_handoffs_{k}"]) for k in ("forward", "split", "fanout"))
    return total


def p16_landed(sock) -> int:
    return int(p16_info(sock)["frontdoor_worker_index"])


def p16_env() -> dict:
    return {"RTPU_REQUIRE_NATIVE_RESP": "1",
            "PYTHONPATH": str(Path(__file__).resolve().parent)}


def p16_node(sdir: str):
    from redisson_tpu_torch.serve.multicore import MulticoreNode

    return MulticoreNode(P16["workers"], device=P16_DEVICE, env_extra=p16_env(),
                         extra_args=["--snapshot-dir", sdir, "--max-connections", "4096"])


def p16_single(port: int):
    env = dict(os.environ, **p16_env())
    return subprocess.Popen(
        [sys.executable, "-m", "redisson_tpu_torch", "--port", str(port),
         "--device", P16_DEVICE, "--max-connections", "4096"],
        cwd=str(Path(__file__).resolve().parent), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def c13_client_proc(conns: int, seed: int, inq, outq):
    """Config 13's closed-loop clients in a child process, for as many
    passes as the parent asks ((host, port, seconds); None ends): each of
    ``conns`` connections reads the worker it landed on from INFO
    frontdoor, pins a 128-key hot set to it by hash tag, seeds it, then
    sends unpipelined zipf(1.2) GET (90%) / SET (10%) until the clock
    runs out.  Every reply is checked."""
    from redisson_tpu_torch.serve.multicore import worker_tag

    npass = 0
    while True:
        req = inq.get()
        if req is None:
            return
        host, port, seconds = req
        npass += 1
        counts = [0] * conns
        lats = [[] for _ in range(conns)]
        errors = []

        def worker(t):
            rng = np.random.default_rng((seed * 100 + t) * 1000 + npass)
            sock = socket.create_connection((host, port))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                info = p16_info(sock)
                tag = worker_tag(int(info["frontdoor_worker_index"]),
                                 int(info["frontdoor_processes"]))
                keys = [b"{%s}c13-%d-%d-%d" % (tag.encode(), seed, t, i)
                        for i in range(P16["c13_hot"])]
                vals = [b"v%d" % i for i in range(len(keys))]
                sock.sendall(wire([[b"SET", k, v] for k, v in zip(keys, vals)]))
                read_frames(sock, len(keys))
                stop = time.perf_counter() + seconds
                while time.perf_counter() < stop:
                    hot = int((rng.zipf(1.2) - 1) % len(keys))
                    is_set = rng.random() < 0.1
                    cmd = [b"SET", keys[hot], vals[hot]] if is_set else [b"GET", keys[hot]]
                    t0 = time.perf_counter()
                    sock.sendall(wire([cmd]))
                    rep = read_frames(sock, 1, timeout=60.0)[0]
                    lats[t].append(time.perf_counter() - t0)
                    want = b"+OK\r\n" if is_set else b"$%d\r\n%s\r\n" % (len(vals[hot]), vals[hot])
                    if rep != want:
                        errors.append(f"{cmd[0]!r} replied {rep[:60]!r}")
                        return
                    counts[t] += 1
            except Exception as e:  # reported to the parent
                errors.append(repr(e))
            finally:
                sock.close()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(conns)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        outq.put((sum(counts), time.perf_counter() - t0,
                  [x for la in lats for x in la], errors))


def c13_measure(pool, port: int, seconds: float) -> tuple:
    """One pass of every client process against ``port``: (cmds/s, p99 ms)."""
    inqs, outq = pool
    for q in inqs:
        q.put(("127.0.0.1", port, seconds))
    res = [outq.get(timeout=seconds + 120) for _ in inqs]
    errs = [e for r in res for e in r[3]]
    check(not errs, f"16b: config 13 client errors: {errs[:3]}")
    lat = np.sort(np.concatenate([np.asarray(r[2]) for r in res]))
    dt = float(np.median([r[1] for r in res]))
    return sum(r[0] for r in res) / dt, float(lat[int(len(lat) * 0.99)] * 1e3)


def p16_config13(node, single_port: int) -> dict:
    """Config 13's traffic against the K=4 node and the single door, in
    turns: one warm pass each, then the passes of P16 per arm."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    inqs = [ctx.Queue() for _ in range(P16["c13_procs"])]
    outq = ctx.Queue()
    procs = [ctx.Process(target=c13_client_proc, args=(P16["c13_conns"], i, inqs[i], outq))
             for i in range(P16["c13_procs"])]
    for p in procs:
        p.start()
    arms = {"multicore": node.port, "single": single_port}
    try:
        for port in arms.values():
            c13_measure((inqs, outq), port, P16["c13_warm_s"])
        h0 = p16_handoffs(node)
        passes = {a: [] for a in arms}
        for _ in range(P16["c13_passes"]):
            for a, port in arms.items():
                passes[a].append(c13_measure((inqs, outq), port, P16["c13_pass_s"]))
        handoffs = p16_handoffs(node) - h0
    finally:
        for q in inqs:
            q.put(None)
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    med = {a: float(np.median([x[0] for x in v])) for a, v in passes.items()}
    return {"c13_clients": P16["c13_procs"] * P16["c13_conns"],
            "c13_multicore_cmds_per_s": med["multicore"], "c13_single_cmds_per_s": med["single"],
            "c13_multicore_p99_ms": float(np.median([x[1] for x in passes["multicore"]])),
            "c13_single_p99_ms": float(np.median([x[1] for x in passes["single"]])),
            "c13_speedup": med["multicore"] / med["single"],
            "c13_passes": {a: [x[0] for x in v] for a, v in passes.items()},
            "c13_multicore_handoffs": handoffs,
            "host_cores": len(os.sched_getaffinity(0))}


def p16_load(socks, streams) -> tuple:
    """Connection c sends ``streams[c]`` in pipelined windows; (replies
    per connection, seconds)."""
    replies = [None] * len(socks)
    errors = []

    def load(c):
        try:
            got = []
            for i in range(0, len(streams[c]), P16["window"]):
                part = streams[c][i:i + P16["window"]]
                socks[c].sendall(wire(part))
                got += read_frames(socks[c], len(part))
            replies[c] = got
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=load, args=(c,)) for c in range(len(socks))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    check(not errors, f"16b: a BF.MADD load failed: {errors[:1]}")
    return replies, dt


def p16_config1(node, rng) -> dict:
    """Config 1 over the node: a filter per worker pinned by hash tag,
    2**18 keys each as BF.MADD of 1024 keys from 4 connections landed
    where the kernel puts them; then a pinned arm where each connection
    writes only its landing worker's filter."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.serve.multicore import worker_tag

    K, n, per, conns = P16["workers"], P16["node_keys"], P16["madd"], P16["conns"]
    names = [b"{%s}cfg1" % worker_tag(w, K).encode() for w in range(K)]
    # m, k and the hashing of a worker's filter, from a CPU client.
    ref = rt.create(rt.Config().use_gpu_sketch(device="cpu"))
    try:
        rbf = ref.get_bloom_filter("m-k")
        rbf.try_init(P16["capacity"], P16["fpp"])
        m, k = rbf.get_size(), rbf.get_hash_iterations()
        h1, h2 = wire_hashes(ref, c11_keys(0, n), m)
        outside = [b"%d" % v for v in rng.integers(3 * n, 8 * n, P16["node_read"])]
        o1, o2 = wire_hashes(ref, outside, m)
    finally:
        ref.shutdown()
    used = []
    for w in range(K):
        s = p16_peer(node, w)
        before = int(p16_info(s)["used_memory"])
        s.sendall(wire([[b"BF.RESERVE", names[w], b"%g" % P16["fpp"],
                         b"%d" % P16["capacity"]]]))
        check(read_frames(s, 1) == [b"+OK\r\n"], f"16b: BF.RESERVE on worker {w}")
        after = int(p16_info(s)["used_memory"])
        s.close()
        check(after > before, f"16b: worker {w}'s device memory did not grow ({before} -> {after})")
        used.append(after)
    n_cmds = n // per
    # Connection c sends, for j = c, c + conns, ...: command j of every filter.
    socks = [socket.create_connection((node.host, node.port)) for _ in range(conns)]
    landed = [p16_landed(s) for s in socks]
    streams = [[[b"BF.MADD", names[w]] + c11_keys(j * per, (j + 1) * per)
                for j in range(c, n_cmds, conns) for w in range(K)] for c in range(conns)]
    foreign = sum(1 for c in range(conns) for cmd in streams[c]
                  if names.index(cmd[1]) != landed[c])
    h0 = p16_handoffs(node)
    replies, load_s = p16_load(socks, streams)
    handoffs = p16_handoffs(node) - h0
    check(handoffs == foreign, f"16b: {handoffs} handoffs for {foreign} sibling-owned commands")
    # Every filter got the same keys in the same per-connection order.
    model = madd_model(h1, h2, m, k, per, conns)
    for w in range(K):
        rep_w = [[f for f, cmd in zip(replies[c], streams[c]) if cmd[1] == names[w]]
                 for c in range(conns)]
        n_added = madd_check(model, rep_w, f"16b worker {w}")
        check(0.97 * n <= n_added <= n, f"16b: worker {w} added {n_added} of {n}")
    t0 = time.perf_counter()
    reads = p16_reads(node, names, n, per, outside)
    reads_s = time.perf_counter() - t0
    want_outside = model[0].contains_hashed(o1, o2)
    for w in range(K):
        check(reads["loaded"][w].all(), f"16b: worker {w}'s filter lost a loaded key")
        check(np.array_equal(reads["outside"][w], want_outside),
              f"16b: worker {w}'s outside keys differ from the golden model")
    for s in socks:
        s.close()
    # The pinned arm: one connection landed on each worker writes only there.
    pinned = [None] * K
    tries = 0
    while any(s is None for s in pinned):
        tries += 1
        check(tries < 400, "16b: no connection landed on some worker")
        s = socket.create_connection((node.host, node.port))
        w = p16_landed(s)
        if pinned[w] is None:
            pinned[w] = s
        else:
            s.close()
    pnames = [b"{%s}pin" % worker_tag(w, K).encode() for w in range(K)]
    for w in range(K):
        pinned[w].sendall(wire([[b"BF.RESERVE", pnames[w], b"%g" % P16["fpp"],
                                 b"%d" % P16["capacity"]]]))
        check(read_frames(pinned[w], 1) == [b"+OK\r\n"], "16b: pinned BF.RESERVE")
    pstreams = [[[b"BF.MADD", pnames[w]] + c11_keys(j * per, (j + 1) * per)
                 for j in range(n_cmds)] for w in range(K)]
    h0 = p16_handoffs(node)
    replies, pinned_s = p16_load(pinned, pstreams)
    check(p16_handoffs(node) == h0, "16b: the pinned arm took a handoff")
    model = madd_model(h1, h2, m, k, per, 1)
    for w in range(K):
        n_added = madd_check(model, [replies[w]], f"16b pinned {w}")
        check(0.97 * n <= n_added <= n, f"16b: pinned worker {w} added {n_added} of {n}")
    for s in pinned:
        s.close()
    return {"node_filters": K, "node_keys_per_filter": n,
            "node_wire_keys_per_s": K * n / load_s, "node_handoffs": handoffs,
            "node_sibling_cmds": foreign, "node_cmds": K * n_cmds,
            "pinned_wire_keys_per_s": K * n / pinned_s, "worker_used_memory": used,
            "peer_read_keys_per_s": K * (n + len(outside)) / reads_s,
            "_names": names, "_outside": outside, "_reads": reads}


def p16_reads(node, names, n: int, per: int, outside: list) -> dict:
    """BF.MEXISTS of every loaded key and of the outside keys, per filter,
    on its owner's peer socket (a worker reads its own filter in
    pipelined windows that fuse; the TCP port's handoffs are 16b's load)."""
    res = {"loaded": [None] * len(names), "outside": [None] * len(names)}
    errors = []

    def read(w):
        try:
            s = p16_peer(node, w)
            for kind, items in (("loaded", c11_keys(0, n)), ("outside", outside)):
                cmds = [[b"BF.MEXISTS", names[w]] + items[i:i + per]
                        for i in range(0, len(items) // per * per, per)]
                flags = []
                for i in range(0, len(cmds), P16["window"]):
                    part = cmds[i:i + P16["window"]]
                    s.sendall(wire(part))
                    flags += [int_array(f) for f in read_frames(s, len(part))]
                res[kind][w] = np.concatenate(flags)
            s.close()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=read, args=(w,)) for w in range(len(names))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"16b: reads failed: {errors[:1]}")
    res["outside"] = [f.astype(bool) for f in res["outside"]]
    return res


def p16_config6(port: int, seed: int) -> list:
    """Config 6's pipelined stream against ``port``: the seed, a warm pass
    (every write lands once), then the measured pass's replies per
    connection."""
    import types

    P, depth, nb = P11["c6_conns"], P11["c6_depth"], P16["c6_batches"]
    batches = config6_batches(seed, P * nb, depth)
    per_conn = [batches[c * nb:(c + 1) * nb] for c in range(P)]
    at = types.SimpleNamespace(host="127.0.0.1", port=port)
    seed_replies = roundtrip(at, config6_seed_cmds())
    check(all(not f.startswith(b"-") for f in seed_replies), "16b: config 6 seed refused")
    config6_pass(at, per_conn)
    replies, _dt = config6_pass(at, per_conn)
    return replies


def p16_orphans(rundir: str) -> list:
    """Live processes started as workers of the node at ``rundir``."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"--frontdoor-index" in argv and rundir.encode() in argv:
            out.append(int(pid))
    return out


def p16b_frontdoor(rng, card: str, seed: int) -> dict:
    """16b: 4 front-door workers on the one card behind one port."""
    import signal

    K = P16["workers"]
    out = {"phase": "16b", "card": card, "workers": K}
    base = Path(__file__).resolve().parent / "build" / f"phase16-{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    sdir = str(base / "snap")
    single_port = free_port()
    single = p16_single(single_port)
    node = None
    try:
        t0 = time.perf_counter()
        node = p16_node(sdir)
        out["node_start_s"] = time.perf_counter() - t0
        for w in range(K):
            s = p16_peer(node, w)
            info = p16_info(s)
            s.close()
            check(info["rtpu_device"] == P16_DEVICE.split(":")[0]
                  and int(info["frontdoor_processes"]) == K
                  and int(info["frontdoor_worker_index"]) == w,
                  f"16b: worker {w} reports {info.get('rtpu_device')}, "
                  f"{info.get('frontdoor_processes')} processes")
            if P16_DEVICE.startswith("cuda"):
                check(info["rtpu_device_name"] == torch.cuda.get_device_name(0),
                      f"16b: worker {w} names {info.get('rtpu_device_name')}")
        s = socket.create_connection((node.host, node.port))
        info = p16_info(s)
        s.close()
        check(int(info["frontdoor_processes"]) == K and info["frontdoor_native_tick"] == "1",
              f"16b: INFO frontdoor reports {info.get('frontdoor_processes')} processes, "
              f"native tick {info.get('frontdoor_native_tick')}")
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60) if P16_DEVICE.startswith("cuda") else None
        out["compute_apps"] = smi.stdout.strip().splitlines() if smi is not None else []
        out["worker_pids"] = [p.pid for p in node.procs]
        c11d_connect(single_port, single).close()
        secs = out["seconds"] = {}
        t0 = time.perf_counter()
        out.update(p16_config13(node, single_port))
        secs["config13"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        c1 = p16_config1(node, rng)
        secs["config1"] = time.perf_counter() - t0
        names, outside, before = c1.pop("_names"), c1.pop("_outside"), c1.pop("_reads")
        out.update(c1)
        t0 = time.perf_counter()
        node_c6 = p16_config6(node.port, seed)
        single_c6 = p16_config6(single_port, seed)
        secs["config6"] = time.perf_counter() - t0
        for c in range(len(node_c6)):
            check(node_c6[c] == single_c6[c],
                  f"16b: config 6 connection {c}'s replies differ between the node and the door")
        s = socket.create_connection((node.host, node.port))
        s.sendall(wire([[b"GET", b"fd-s%d" % i] for i in range(4)]))
        strings = read_frames(s, 4)
        s.close()
        # Restart: SIGTERM writes one snapshot per worker; the reboot reads
        # every key back.
        rundir = node.rundir
        t0 = time.perf_counter()
        check(node.shutdown(timeout_s=10.0), "16b: a worker needed SIGKILL")
        secs["shutdown_snapshot"] = time.perf_counter() - t0
        check(all(p.returncode == 0 for p in node.procs),
              f"16b: worker exit codes {[p.returncode for p in node.procs]}")
        check(not p16_orphans(rundir), "16b: a worker outlived the node")
        for w in range(K):
            check(any((base / "snap" / f"worker{w}").iterdir()),
                  f"16b: worker {w} wrote no snapshot")
        t0 = time.perf_counter()
        node = p16_node(sdir)
        out["restart_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        after = p16_reads(node, names, P16["node_keys"], P16["madd"], outside)
        secs["reads_after_restart"] = time.perf_counter() - t0
        for w in range(K):
            check(after["loaded"][w].all()
                  and np.array_equal(after["outside"][w], before["outside"][w]),
                  f"16b: worker {w}'s filter changed across the restart")
        s = socket.create_connection((node.host, node.port))
        s.sendall(wire([[b"GET", b"fd-s%d" % i] for i in range(4)]))
        check(read_frames(s, 4) == strings, "16b: config 6's strings changed across the restart")
        s.close()
        rundir = node.rundir
        check(node.shutdown(timeout_s=10.0), "16b: a worker needed SIGKILL after the restart")
        check(all(p.returncode == 0 for p in node.procs),
              f"16b: worker exit codes {[p.returncode for p in node.procs]}")
        node = None
        check(not p16_orphans(rundir), "16b: a worker outlived the node")
        out.update(config6_equal=True, restart_equal=True, orphans=0)
    finally:
        if node is not None:
            node.shutdown(timeout_s=10.0)
        if single.poll() is None:
            single.send_signal(signal.SIGTERM)
            try:
                single.wait(timeout=30)
            except subprocess.TimeoutExpired:
                single.kill()
        shutil.rmtree(base, ignore_errors=True)
    check(single.returncode == 0, f"16b: the single door exited {single.returncode}")
    log(out)
    return out


def phase_scripting_frontdoor(rng, seed: int, card: str) -> None:
    """Phase 16: scripting and the per-core front door on the card."""
    t0 = time.perf_counter()
    p16a_scripting(rng, card)
    t1 = time.perf_counter()
    p16b_frontdoor(rng, card, seed)
    log({"phase": 16, "seconds": time.perf_counter() - t0, "16a_seconds": t1 - t0,
         "card": card})


# -- phase 17: the slot-sharded cluster ----------------------------------------

P17 = {"nodes": 3, "keys": 1 << 17, "madd": 1024, "threads": 4, "window": 16,
       "read": 131_072, "capacity": 1_000_000, "fpp": 0.01,
       "c9_procs": 9, "c9_conns": 4, "c9_batch": 192, "c9_keys": 512,
       "c9_warm_s": 1.0, "c9_pass_s": 1.5, "c9_passes": 1,
       "mig_bits": 1 << 24, "mig_hll": 1 << 16, "mig_events": 1 << 16,
       "mig_write_s": 1.0, "cms_d": 5, "cms_w": 1 << 16, "k1_events": 1 << 19,
       "fo_keys": 512, "fo_madd": 8, "fo_timeout_ms": 1000, "fo_promote_s": 15.0}
P17_DEVICE = "cuda"


def p17_supervisor(n: int, **kw):
    from redisson_tpu_torch.cluster.supervisor import ClusterSupervisor

    return ClusterSupervisor(n_nodes=n, device=P17_DEVICE, env_extra=p16_env(),
                             startup_timeout_s=240.0, **kw)


def p17_req(addr, cmds, timeout: float = 120.0) -> list:
    from redisson_tpu_torch.serve.wireutil import exchange

    s = socket.create_connection(tuple(addr), timeout=timeout)
    try:
        return exchange(s, cmds)
    finally:
        s.close()


def p17_info(addr) -> dict:
    s = socket.create_connection(tuple(addr), timeout=120)
    try:
        return p16_info(s)
    finally:
        s.close()


def p17_check_card(addrs, tag: str, device=None) -> None:
    """Every node's INFO names the card (or the CPU when rehearsed)."""
    device = device or P17_DEVICE
    for i, addr in enumerate(addrs):
        info = p17_info(addr)
        check(info["rtpu_device"] == device.split(":")[0],
              f"{tag}: node {i} reports {info.get('rtpu_device')}")
        if device.startswith("cuda"):
            check(info["rtpu_device_name"] == torch.cuda.get_device_name(0),
                  f"{tag}: node {i} names {info.get('rtpu_device_name')}")


def p17_memory(addr) -> int:
    """A node's own device allocations (its CUDA context's; the pool bytes
    when rehearsed on the CPU)."""
    info = p17_info(addr)
    return int(info.get("rtpu_device_memory_allocated", info["used_memory"]))


def p17_tags(sup) -> list:
    """One hash tag per node, each landing in that node's slot range."""
    from redisson_tpu_torch.cluster.slots import key_slot

    owner = {}
    for start, end, nid, _h, _p in sup.slots_table():
        owner[(start, end)] = sup.node_ids.index(nid)
    tags = []
    for i in range(len(sup.addrs)):
        j = 0
        while True:
            t = "n%d" % i if j == 0 else "n%d-%d" % (i, j)
            slot = key_slot("{%s}" % t)
            if any(a <= slot <= b and o == i for (a, b), o in owner.items()):
                tags.append(t)
                break
            j += 1
    return tags


def dump_row(blob: bytes) -> np.ndarray:
    """The row words of a sketch DUMP payload (RTPU | u32 | json | npy)."""
    import io
    import struct

    check(blob[:4] == b"RTPU", "not a sketch DUMP")
    (hlen,) = struct.unpack("<I", blob[4:8])
    return np.load(io.BytesIO(blob[8 + hlen:]), allow_pickle=False).view(np.uint32)


def p17_bloom_model(n: int, outside: list):
    """m, k and the wire hashes of config 1's filter for keys 0..n-1 and the
    outside keys, from a CPU client (the nodes' default codec)."""
    import redisson_tpu_torch as rt

    ref = rt.create(rt.Config().use_gpu_sketch(device="cpu"))
    try:
        rbf = ref.get_bloom_filter("m-k")
        rbf.try_init(P17["capacity"], P17["fpp"])
        m, k = rbf.get_size(), rbf.get_hash_iterations()
        h1, h2 = wire_hashes(ref, c11_keys(0, n), m) if n else (None, None)
        o1, o2 = wire_hashes(ref, outside, m) if outside else (None, None)
    finally:
        ref.shutdown()
    return m, k, h1, h2, o1, o2


def p17a_config1(sup, rng) -> dict:
    """17a: config 1 across the fleet — a filter per node, 2**18 keys each
    as BF.MADD of 1024 keys through connect_cluster().execute_many from 4
    threads (thread c sends commands c, c + 4, ... of every filter, 16 per
    filter per batch: three pipelined legs)."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.obs import Observability

    n, per, T = P17["keys"], P17["madd"], P17["threads"]
    names = [b"{%s}cfg1" % t.encode() for t in p17_tags(sup)]
    outside = [b"%d" % v for v in rng.integers(3 * n, 8 * n, P17["read"])]
    m, k, h1, h2, o1, o2 = p17_bloom_model(n, outside)
    before = [p17_memory(a) for a in sup.addrs]
    cc = rt.connect_cluster(sup.addrs, timeout_s=120.0)
    try:
        rep = cc.execute_many([[b"BF.RESERVE", nm, b"%g" % P17["fpp"],
                                b"%d" % P17["capacity"]] for nm in names])
        check(rep == [b"OK"] * len(names), f"17a: BF.RESERVE replied {rep}")
    finally:
        cc.close()
    after = [p17_memory(a) for a in sup.addrs]
    for i, (b, a) in enumerate(zip(before, after)):
        check(a > b, f"17a: node {i}'s device memory did not grow ({b} -> {a})")
    n_cmds = n // per
    obs = Observability()
    replies = [[[] for _ in names] for _ in range(T)]
    errors = []

    def load(c):
        cl = rt.connect_cluster(sup.addrs, timeout_s=300.0, obs=obs)
        try:
            js = list(range(c, n_cmds, T))
            for i in range(0, len(js), P17["window"]):
                part = js[i:i + P17["window"]]
                cmds = [[b"BF.MADD", nm] + c11_keys(j * per, (j + 1) * per)
                        for nm in names for j in part]
                got = cl.execute_many(cmds)
                for f in range(len(names)):
                    replies[c][f] += got[f * len(part):(f + 1) * len(part)]
        except Exception as e:  # surfaced below
            errors.append(repr(e))
        finally:
            cl.close()

    threads = [threading.Thread(target=load, args=(c,)) for c in range(T)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    load_s = time.perf_counter() - t0
    check(not errors, f"17a: a BF.MADD load failed: {errors[:1]}")
    legs = sum(int(c.value) for lv, c in obs.cluster_scatter_fanout.items() if lv == ("legs",))
    batches = sum(int(c.value) for lv, c in obs.cluster_scatter_fanout.items()
                  if lv == ("batches",))
    want_batches = T * -(-(n_cmds // T) // P17["window"])
    check(batches == want_batches and legs == len(names) * batches,
          f"17a: rtpu_cluster_scatter_fanout counted {batches} batches / {legs} legs, "
          f"want {want_batches} / {len(names) * want_batches}")
    model = madd_model(h1, h2, m, k, per, T)
    for f in range(len(names)):
        n_added = madd_check(model, [replies[c][f] for c in range(T)], f"17a filter {f}")
        check(0.97 * n <= n_added <= n, f"17a: filter {f} added {n_added} of {n}")
    want_outside = model[0].contains_hashed(o1, o2)
    cc = rt.connect_cluster(sup.addrs, timeout_s=300.0)
    try:
        t0 = time.perf_counter()
        for f, nm in enumerate(names):
            loaded = cc.execute_many([[b"BF.MEXISTS", nm] + c11_keys(i, i + per)
                                      for i in range(0, n, per)])
            check(all(all(x == 1 for x in r) for r in loaded),
                  f"17a: filter {f} lost a loaded key")
            out = cc.execute_many([[b"BF.MEXISTS", nm] + outside[i:i + per]
                                   for i in range(0, len(outside), per)])
            flags = np.concatenate([np.asarray(r, np.int64) for r in out]).astype(bool)
            check(np.array_equal(flags, want_outside),
                  f"17a: filter {f}'s outside keys differ from the golden model")
        reads_s = time.perf_counter() - t0
    finally:
        cc.close()
    return {"fleet_nodes": len(names), "fleet_keys_per_filter": n,
            "fleet_wire_keys_per_s": len(names) * n / load_s, "fleet_load_s": load_s,
            "fleet_read_keys_per_s": len(names) * (n + len(outside)) / reads_s,
            "scatter_batches": batches, "scatter_legs": legs,
            "node_memory_before": before, "node_memory_after": after,
            "fpp": float(want_outside.mean())}


def c9_client_proc(conns: int, seed: int, inq, outq):
    """Config 9's closed-loop slot-routing clients in a child process, for
    as many passes as the parent asks ((seeds, seconds); None ends): each
    of ``conns`` threads ships execute_many batches of P17["c9_batch"]
    zipf(1.2) GET (90%) / SET (10%) over P17["c9_keys"] keys.  Every reply
    is checked."""
    from redisson_tpu_torch.cluster.client import ClusterClient

    npass = 0
    nk, batch = P17["c9_keys"], P17["c9_batch"]
    while True:
        req = inq.get()
        if req is None:
            return
        seeds, seconds = req
        npass += 1
        counts = [0] * conns
        lats = [[] for _ in range(conns)]
        errors = []

        def worker(t):
            rng = np.random.default_rng((seed * 100 + t) * 1000 + npass)
            cc = ClusterClient([tuple(a) for a in seeds], timeout_s=60.0)
            try:
                stop = time.perf_counter() + seconds
                while time.perf_counter() < stop:
                    hot = ((rng.zipf(1.2, batch) - 1) % nk).astype(np.int64)
                    sets = rng.random(batch) < 0.1
                    cmds = [(b"SET", b"ck%d" % h, b"v%d" % h) if s else (b"GET", b"ck%d" % h)
                            for h, s in zip(hot, sets)]
                    t0 = time.perf_counter()
                    got = cc.execute_many(cmds)
                    lats[t].append(time.perf_counter() - t0)
                    for (h, s), r in zip(zip(hot, sets), got):
                        if r != (b"OK" if s else b"v%d" % h):
                            errors.append(f"ck{h} replied {r!r}")
                            return
                    counts[t] += batch
            except Exception as e:  # reported to the parent
                errors.append(repr(e))
            finally:
                cc.close()

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(conns)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        outq.put((sum(counts), time.perf_counter() - t0,
                  [x for la in lats for x in la], errors))


def c9_measure(pool, seeds, seconds: float) -> tuple:
    """One pass of every client process against ``seeds``: (cmds/s, p99
    batch ms)."""
    inqs, outq = pool
    for q in inqs:
        q.put((seeds, seconds))
    res = [outq.get(timeout=seconds + 120) for _ in inqs]
    errs = [e for r in res for e in r[3]]
    check(not errs, f"17b: config 9 client errors: {errs[:3]}")
    lat = np.sort(np.concatenate([np.asarray(r[2]) for r in res]))
    dt = float(np.median([r[1] for r in res]))
    return sum(r[0] for r in res) / dt, float(lat[int(len(lat) * 0.99)] * 1e3)


def p17b_config9(sups) -> dict:
    """17b: config 9's traffic against a 1-node and a 3-node fleet, both
    live, in turns: one warm pass each, then P17["c9_passes"] per arm."""
    import multiprocessing as mp

    import redisson_tpu_torch as rt

    for sup in sups.values():
        cc = rt.connect_cluster(sup.addrs, timeout_s=120.0)
        try:
            acks = cc.execute_many([(b"SET", b"ck%d" % i, b"v%d" % i)
                                    for i in range(P17["c9_keys"])])
            check(acks == [b"OK"] * P17["c9_keys"], "17b: config 9 seed refused")
        finally:
            cc.close()
    ctx = mp.get_context("spawn")
    inqs = [ctx.Queue() for _ in range(P17["c9_procs"])]
    outq = ctx.Queue()
    procs = [ctx.Process(target=c9_client_proc, args=(P17["c9_conns"], i, inqs[i], outq))
             for i in range(P17["c9_procs"])]
    for p in procs:
        p.start()
    arms = {n: [list(a) for a in sup.addrs] for n, sup in sups.items()}
    try:
        for seeds in arms.values():
            c9_measure((inqs, outq), seeds, P17["c9_warm_s"])
        passes = {n: [] for n in arms}
        for _ in range(P17["c9_passes"]):
            for n in (3, 1):
                passes[n].append(c9_measure((inqs, outq), arms[n], P17["c9_pass_s"]))
    finally:
        for q in inqs:
            q.put(None)
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    med = {n: float(np.median([x[0] for x in v])) for n, v in passes.items()}
    return {"c9_clients": P17["c9_procs"] * P17["c9_conns"], "c9_batch": P17["c9_batch"],
            "c9_1node_cmds_per_s": med[1], "c9_3node_cmds_per_s": med[3],
            "c9_1node_p99_ms": float(np.median([x[1] for x in passes[1]])),
            "c9_3node_p99_ms": float(np.median([x[1] for x in passes[3]])),
            "c9_speedup": med[3] / med[1],
            "c9_passes": {n: [x[0] for x in v] for n, v in passes.items()},
            "host_cores": len(os.sched_getaffinity(0))}


def p17c_migration(sup, rng) -> dict:
    """17c: a writer acks SET {mig}w<i> and BF.ADD {mig}bf <key> while
    migrate_slot moves {mig}'s slot; the slot's HLL, 2**24-bit BitSet and
    CMS stay quiet."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.cluster.slots import key_slot
    from redisson_tpu_torch.ops import golden

    tag = b"{mig}"
    slot = key_slot(tag)
    src_addr = sup.slot_owner_addr(slot)
    src = sup.addrs.index(src_addr)
    dst = (src + 1) % len(sup.addrs)
    quiet = [tag + b"hll", tag + b"bits", tag + b"cms"]
    hll = [b"h%d" % v for v in rng.integers(0, 1 << 40, P17["mig_hll"])]
    bits = rng.integers(0, P17["mig_bits"], 512)
    # CMS.INCRBY adds item by item (a blocking call each): the zipf
    # stream goes in as (item, count) pairs over 256 distinct items.
    items, counts = np.unique(rng.zipf(1.2, P17["mig_events"]) % 256, return_counts=True)
    events = [x for v, c in zip(items, counts) for x in (b"e%d" % v, b"%d" % c)]
    seed = [[b"BF.RESERVE", tag + b"bf", b"%g" % P17["fpp"], b"%d" % P17["capacity"]],
            [b"SETBIT", tag + b"bits", b"%d" % (P17["mig_bits"] - 1), b"1"],
            [b"CMS.INITBYDIM", tag + b"cms", b"%d" % P17["cms_w"], b"%d" % P17["cms_d"]]]
    seed += [[b"PFADD", tag + b"hll"] + hll[i:i + 4096] for i in range(0, len(hll), 4096)]
    seed += [[b"SETBIT", tag + b"bits", b"%d" % b, b"1"] for b in bits]
    seed += [[b"CMS.INCRBY", tag + b"cms"] + events]
    rep = p17_req(src_addr, seed)
    check(not [r for r in rep if isinstance(r, Exception)], "17c: seeding the slot failed")
    before = p17_req(src_addr, [[b"DUMP", q] for q in quiet])
    acked_set, acked_bf, failures = {}, [], []
    stop = threading.Event()

    def writer():
        w = rt.connect_cluster(sup.addrs, timeout_s=120.0)
        i = 0
        try:
            while not stop.is_set():
                k = tag + b"w%d" % i
                if w.execute(b"SET", k, b"v%d" % i) == b"OK":
                    acked_set[k] = b"v%d" % i
                item = b"a%d" % i
                if w.execute(b"BF.ADD", tag + b"bf", item) in (0, 1):
                    acked_bf.append(item)
                i += 1
        except Exception as e:  # surfaced below: a writer must never die
            failures.append(repr(e))
        finally:
            w.close()

    th = threading.Thread(target=writer)
    th.start()
    time.sleep(P17["mig_write_s"])
    n_before = len(acked_set)
    t0 = time.perf_counter()
    moved = sup.migrate_slot(slot, dst)
    mig_s = time.perf_counter() - t0
    n_during = len(acked_set) - n_before
    time.sleep(P17["mig_write_s"])
    stop.set()
    th.join()
    check(not failures, f"17c: the writer died: {failures[:1]}")
    check(moved >= 4 and n_before > 0, f"17c: moved {moved} keys, {n_before} writes before")
    dst_addr = sup.addrs[dst]
    cc = rt.connect_cluster(sup.addrs, timeout_s=120.0)
    try:
        check(cc.slot_addr(slot) == tuple(dst_addr), "17c: the slot did not move")
        got = cc.execute_many([(b"GET", k) for k in acked_set])
        lost = [k for k, g in zip(acked_set, got) if g != acked_set[k]]
        check(not lost, f"17c: {len(lost)} acked SETs lost, e.g. {lost[:3]}")
    finally:
        cc.close()
    after = p17_req(dst_addr, [[b"DUMP", q] for q in quiet] + [[b"DUMP", tag + b"bf"]])
    check(after[:3] == before, "17c: a quiet object's DUMP changed across the move")
    m, k, _h1, _h2, _o1, _o2 = p17_bloom_model(0, [])
    ref = rt.create(rt.Config().use_gpu_sketch(device="cpu"))
    try:
        h1, h2 = wire_hashes(ref, acked_bf, m)
    finally:
        ref.shutdown()
    g = golden.GoldenBloomFilter(m, k)
    g.bits[g._indexes(h1, h2).reshape(-1)] = True
    row = dump_row(after[3])
    check(np.array_equal(row, golden_words(g, row.shape[0])),
          "17c: the moved filter's row differs from the golden bitmap of the acked keys")
    (count,) = p17_req(src_addr, [[b"CLUSTER", b"COUNTKEYSINSLOT", b"%d" % slot]])
    check(count == 0, f"17c: the source kept {count} keys in the slot")
    enc = p17_req(dst_addr, [[b"OBJECT", b"ENCODING", tag + x] for x in
                             (b"bf", b"hll", b"bits", b"cms")])
    check(enc == [b"device"] * 4, f"17c: the moved rows are not on the card: {enc}")
    info = p17_info(dst_addr)
    check(info["rtpu_device"] == P17_DEVICE.split(":")[0], "17c: the target is not on the card")
    return {"mig_keys_moved": moved, "mig_seconds": mig_s, "mig_acked_sets": len(acked_set),
            "mig_acked_bf_adds": len(acked_bf), "mig_writes_during_move": n_during,
            "mig_target_used_memory": int(info["used_memory"]),
            "mig_quiet_dumps_equal": True, "mig_row_equals_golden": True}


def p17c_k1_on_moved_cms(rng) -> dict:
    """17c: in this process, two nodes on the card; a CMS(5, 65536) seeded
    over the wire on A moves to B, then B's client runs add_all_seq of
    2**19 zipf events on the moved row through K1."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.cluster.slots import NSLOTS, key_slot
    from redisson_tpu_torch.cluster.supervisor import migrate_slot
    from redisson_tpu_torch.ops import cms_seq
    from redisson_tpu_torch.serve.resp import RespServer
    from redisson_tpu_torch.utils import hashing

    d, w, n = P17["cms_d"], P17["cms_w"], P17["k1_events"]
    name = "{k1mv}cms"
    slot = key_slot(name)
    nodes = []
    try:
        with held_ports(2) as ports:
            topo = {"nodes": [
                {"id": "A", "host": "127.0.0.1", "port": ports[0],
                 "slots": [[slot, slot]]},
                {"id": "B", "host": "127.0.0.1", "port": ports[1],
                 "slots": [[s0, s1] for s0, s1 in ((0, slot - 1), (slot + 1, NSLOTS - 1))
                           if s0 <= s1]},
            ]}
            for nid, port in zip("AB", ports):
                cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device=P17_DEVICE)
                cfg.cluster_enabled = True
                cfg.cluster_topology = topo
                cfg.cluster_node_id = nid
                cl = rt.create(cfg)
                nodes.append((cl, RespServer(cl, port=port)))
        a, b = [("127.0.0.1", p) for p in ports]
        # Integer items (the nodes' LongCodec reads wire items as ints),
        # as (item, count) pairs: CMS.INCRBY adds item by item.
        items, counts = np.unique(rng.zipf(1.2, 1 << 14) % 256, return_counts=True)
        rep = p17_req(a, [[b"CMS.INITBYDIM", name.encode(), b"%d" % w, b"%d" % d],
                          [b"CMS.INCRBY", name.encode()]
                          + [x for v, c in zip(items, counts) for x in (b"%d" % v, b"%d" % c)]])
        check(not [r for r in rep if isinstance(r, Exception)],
              f"17c K1: seeding failed: {[r for r in rep if isinstance(r, Exception)][:2]}")
        (blob,) = p17_req(a, [[b"DUMP", name.encode()]])
        check(migrate_slot(slot, a, b, notify=[a, b]) == 1, "17c K1: the CMS did not move")
        client = nodes[1][0]
        check(tenant_row(client, name)[: d * w].tobytes() == dump_row(blob)[: d * w].tobytes(),
              "17c K1: the moved row differs from the source's")
        table = tenant_row(client, name)[: d * w].reshape(d, w).copy()
        events = zipf_keys(rng, n)
        h1w, h2w = hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(events)), w)
        want_table, want_est = cms_seq.golden_seq(table, h1w, h2w, np.ones(n, np.uint32),
                                                  d=d, w=w)
        before = cms_seq.LAUNCHES
        t0 = time.perf_counter()
        est = client.get_count_min_sketch(name).add_all_seq(events)
        dt = time.perf_counter() - t0
        launches = cms_seq.LAUNCHES - before
        chunk = client._engine._SEQ_CHUNK
        check(launches == -(-n // chunk), f"17c K1: {launches} K1 launches")
        check(np.array_equal(np.asarray(est, np.uint32), np.asarray(want_est, np.uint32)),
              "17c K1: estimates differ from golden_seq")
        got = tenant_row(client, name)[: d * w]
        check(np.array_equal(got, want_table.reshape(-1)), "17c K1: table differs from golden_seq")
    finally:
        for cl, srv in nodes:
            srv.close()
            cl.shutdown()
    return {"k1_moved_cms_launches": launches, "k1_moved_cms_events_per_s": n / dt,
            "k1_moved_cms_equals_golden_seq": True}


def p17d_failover(rng, base: Path) -> dict:
    """17d: three primaries with one replica each (an election needs a
    majority of ALL primaries: with two, the dead one's vote is missing),
    journals under appendfsync always; WAIT-fenced SET and BF.MADD into
    every shard, SIGKILL primary 0, then its replica's election, the
    takeover and the fleet's agreement; 17e's teardown of this fleet."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.cluster.slots import NSLOTS
    from redisson_tpu_torch.ops import golden

    cfg_path = base / "p17d.json"
    cfg_path.write_text(json.dumps({"journal_fsync": "always"}))
    sup = p17_supervisor(3, replicas_per_shard=1, node_timeout_ms=P17["fo_timeout_ms"],
                         metrics=True, node_args=["--config", str(cfg_path)])
    out = {}
    procs = []
    try:
        t0 = time.perf_counter()
        sup.start()
        out["fo_start_s"] = time.perf_counter() - t0
        with sup._lock:
            procs = list(sup._procs)
        p17_check_card(list(sup.addrs) + list(sup.replica_addrs), "17d")
        tags = p17_tags(sup)
        per = P17["madd"]
        keys = {f"{{{tags[i % 3]}}}fo{i}": "v%d" % i for i in range(P17["fo_keys"])}
        filters = [b"{%s}fobf" % t.encode() for t in tags]
        items = c11_keys(0, P17["fo_madd"] * per)
        cc = rt.connect_cluster(sup.addrs, timeout_s=120.0)
        try:
            check(cc.execute_many([(b"SET", k, v) for k, v in keys.items()])
                  == [b"OK"] * len(keys), "17d: SET refused")
            check(cc.execute_many([(b"BF.RESERVE", f, b"%g" % P17["fpp"],
                                    b"%d" % P17["capacity"]) for f in filters])
                  == [b"OK"] * len(filters), "17d: BF.RESERVE refused")
            got = cc.execute_many([[b"BF.MADD", f] + items[i:i + per]
                                   for f in filters for i in range(0, len(items), per)])
            check(all(isinstance(r, list) for r in got), "17d: BF.MADD refused")
            for i, addr in enumerate(sup.addrs):
                (acked,) = p17_req(addr, [(b"WAIT", b"1", b"8000")])
                check(acked == 1, f"17d: primary {i} never got its replica's ack")
            ring = sup.replica_addrs[0]
            t_kill = time.perf_counter()
            sup.kill_node(0)
            promoted = None
            while promoted is None:
                try:
                    (info,) = p17_req(ring, [(b"INFO", b"replication")], timeout=5.0)
                    if b"role:master" in info:
                        promoted = time.perf_counter() - t_kill
                except OSError:
                    pass
                if promoted is None:
                    check(time.perf_counter() - t_kill < P17["fo_promote_s"],
                          f"17d: the replica was not master {P17['fo_promote_s']} s after the kill")
                    time.sleep(0.05)
            out["fo_kill_to_master_s"] = promoted
            post = f"{{{tags[0]}}}post"
            first_ack = None
            while first_ack is None:
                try:
                    if cc.execute(b"SET", post.encode(), b"new") == b"OK":
                        first_ack = time.perf_counter() - t_kill
                except Exception:
                    check(time.perf_counter() - t_kill < 60, "17d: no new write acked in 60 s")
                    time.sleep(0.05)
            out["fo_kill_to_first_write_s"] = first_ack
            lost = [k for k, v in keys.items() if cc.execute(b"GET", k) != v.encode()]
            check(not lost, f"17d: WAIT-fenced writes lost across the failover: {lost[:5]}")
            flags = cc.execute_many([[b"BF.MEXISTS", f] + items[i:i + per]
                                     for f in filters for i in range(0, len(items), per)])
            check(all(all(x == 1 for x in r) for r in flags), "17d: a fenced BF.MADD key is gone")
            for i in range(8):
                k = f"{{{tags[0]}}}post{i}".encode()
                check(cc.execute(b"SET", k, b"n") == b"OK" and cc.execute(b"GET", k) == b"n",
                      "17d: a new write to the taken-over slots failed")
        finally:
            cc.close()
        m, k, h1, h2, _o1, _o2 = p17_bloom_model(len(items), [])
        g = golden.GoldenBloomFilter(m, k)
        g.bits[g._indexes(h1, h2).reshape(-1)] = True
        (blob,) = p17_req(ring, [(b"DUMP", filters[0])])
        row = dump_row(blob)
        check(np.array_equal(row, golden_words(g, row.shape[0])),
              "17d: the promoted node's filter row differs from the golden bitmap")
        survivors = list(sup.addrs[1:]) + list(sup.replica_addrs)
        shards = [p17_req(a, [(b"CLUSTER", b"SHARDS")])[0] for a in survivors]
        check(all(sh == shards[0] for sh in shards), "17d: the survivors' CLUSTER SHARDS differ")
        owned = np.zeros(NSLOTS, np.int64)
        for sh in shards[0]:
            flat = sh[1]
            for a, b in zip(flat[::2], flat[1::2]):
                owned[a:b + 1] += 1
        check(owned.max() == 1 and owned.min() == 1, "17d: a slot owned twice or not at all")
        import urllib.request

        with urllib.request.urlopen(
                "http://%s:%d/metrics" % sup.replica_metrics_addrs[0], timeout=30) as r:
            page = r.read().decode()
        elections = sum(float(ln.split()[-1]) for ln in page.splitlines()
                        if ln.startswith("rtpu_failover_elections_total"))
        check(elections >= 1, f"17d: rtpu_failover_elections_total = {elections}")
        out["fo_elections"] = elections
        out.update(p17e_teardown(sup, procs, skip={0}))
        sup = None
    finally:
        if sup is not None:
            sup.shutdown(timeout_s=10.0)
    return out


def p17_orphans(tmpdir: str) -> list:
    """Live processes started with --cluster for the fleet at ``tmpdir``."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"--cluster" in argv and any(tmpdir.encode() in a for a in argv):
            out.append(int(pid))
    return out


def p17e_teardown(sup, procs, skip=()) -> dict:
    """17e: SIGTERM; every node (but the ones in ``skip``, killed before)
    exits 0 within 10 s and no --cluster process of the fleet is left."""
    tmpdir = sup._tmpdir
    t0 = time.perf_counter()
    clean = sup.shutdown(timeout_s=10.0)
    dt = time.perf_counter() - t0
    check(clean, "17e: a node needed SIGKILL")
    rcs = [p.returncode for i, p in enumerate(procs) if i not in skip]
    check(all(rc == 0 for rc in rcs), f"17e: node exit codes {rcs}")
    check(not p17_orphans(tmpdir), "17e: a --cluster process outlived the fleet")
    return {"teardown_s": dt, "exit_codes": rcs}


def phase_cluster(rng, seed: int, card: str) -> None:
    """Phase 17: the slot-sharded cluster on the card."""
    t0 = time.perf_counter()
    out = {"phase": 17, "card": card}
    base = Path(__file__).resolve().parent / "build" / f"phase17-{os.getpid()}"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    secs = out["seconds"] = {}
    sups = {}
    try:
        t = time.perf_counter()
        sups[3] = p17_supervisor(P17["nodes"])
        sups[1] = p17_supervisor(1)
        for sup in sups.values():
            sup.start()
        secs["start"] = time.perf_counter() - t
        p17_check_card(list(sups[3].addrs) + list(sups[1].addrs), "17a")
        t = time.perf_counter()
        out.update(p17a_config1(sups[3], rng))
        secs["17a"] = time.perf_counter() - t
        t = time.perf_counter()
        out.update(p17b_config9(sups))
        secs["17b"] = time.perf_counter() - t
        t = time.perf_counter()
        out.update(p17c_migration(sups[3], rng))
        out.update(p17c_k1_on_moved_cms(rng))
        secs["17c"] = time.perf_counter() - t
        t = time.perf_counter()
        for n in (3, 1):
            with sups[n]._lock:
                procs = list(sups[n]._procs)
            out[f"teardown_{n}node"] = p17e_teardown(sups.pop(n), procs)
        secs["17e"] = time.perf_counter() - t
        t = time.perf_counter()
        out.update(p17d_failover(rng, base))
        secs["17d"] = time.perf_counter() - t
    finally:
        for sup in sups.values():
            sup.shutdown(timeout_s=10.0)
        shutil.rmtree(base, ignore_errors=True)
    out["phase_seconds"] = time.perf_counter() - t0
    log(out)


P18 = {"nodes": 3, "hot": 12, "cold": 2, "capacity": 1_000_000, "fpp": 0.01,
       "cms_d": 5, "cms_w": 1 << 16, "madd": 1024, "hot_madd": 64, "cold_madd": 8,
       "hot_incr": 8, "cold_incr": 1, "incr_draws": 256, "incr_items": 8,
       "threads": 4, "window": 16, "max_windows": 10, "threshold": 1.3,
       "max_moves": 8, "pace_s": 0.05, "cooldown_s": 15.0, "stuck_slot_s": 0.5,
       "k1_events": 1 << 19}
P18_DEVICE = "cuda"


def p18_fleet():
    """P18["nodes"] in-process card nodes splitting the slots evenly, each
    with a RespServer, a rebalance agent and a fleet doctor (neither
    thread-started: CLUSTER REBALANCE NOW and CLUSTER DOCTOR NOW tick
    them)."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.cluster.rebalancer import RebalanceAgent
    from redisson_tpu_torch.cluster.slots import NSLOTS
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.obs.doctor import FleetDoctor
    from redisson_tpu_torch.serve.resp import RespServer

    n = P18["nodes"]
    cuts = [i * NSLOTS // n for i in range(n + 1)]
    ids = [chr(ord("A") + i) for i in range(n)]
    nodes = []
    try:
        with held_ports(n) as ports:
            topo = {"nodes": [{"id": ids[i], "host": "127.0.0.1", "port": ports[i],
                               "slots": [[cuts[i], cuts[i + 1] - 1]]} for i in range(n)]}
            for nid, port in zip(ids, ports):
                cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device=P18_DEVICE)
                cfg.cluster_enabled = True
                cfg.cluster_topology = topo
                cfg.cluster_node_id = nid
                cl = rt.create(cfg)
                srv = RespServer(cl, port=port)
                nodes.append((cl, srv))
                RebalanceAgent(srv, interval_s=3600.0, threshold=P18["threshold"],
                               max_moves=P18["max_moves"], pace_s=P18["pace_s"],
                               cooldown_s=P18["cooldown_s"])
                FleetDoctor(srv, interval_s=3600.0, stuck_slot_s=P18["stuck_slot_s"],
                            canary=True)
    except BaseException:
        p18_close(nodes)
        raise
    # One process, three nodes: each server's telemetry is its own.
    for part in ("obs", "loadmap", "rebalancer", "doctor"):
        check(len({id(getattr(srv, part)) for _cl, srv in nodes}) == n,
              f"18: the nodes share one {part}")
    check(len({id(srv.obs.events) for _cl, srv in nodes}) == n,
          "18: the nodes share one event ring")
    return nodes, ids, [("127.0.0.1", p) for p in ports], cuts


def p18_close(nodes) -> None:
    for cl, srv in nodes:
        srv.close()
        cl.shutdown()


def p18_tags(cuts, node: int, n: int, taken: set) -> list:
    """``n`` hash tags in distinct slots of node ``node``'s range."""
    from redisson_tpu_torch.cluster.slots import key_slot

    tags, j = [], 0
    while len(tags) < n:
        t = b"{r%d-%d}" % (node, j)
        j += 1
        s = key_slot(t)
        if cuts[node] <= s < cuts[node + 1] and s not in taken:
            taken.add(s)
            tags.append(t)
    return tags


def p18_load(addrs, batches, tag: str) -> list:
    """One thread per list of execute_many batches, each with its own
    routing client, all at once; every reply, per thread."""
    import redisson_tpu_torch as rt

    replies = [[] for _ in batches]
    errors = []

    def load(c):
        cl = rt.connect_cluster(addrs, timeout_s=300.0)
        try:
            for batch in batches[c]:
                replies[c].append(cl.execute_many(batch))
        except Exception as e:  # surfaced below
            errors.append(repr(e))
        finally:
            cl.close()

    threads = [threading.Thread(target=load, args=(c,)) for c in range(len(batches))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(not errors, f"{tag}: a load thread failed: {errors[:1]}")
    return replies


def p18_window(addrs, tags, hot: set, window: int, rng, acked: dict) -> tuple:
    """One tick window of traffic through connect_cluster from
    P18["threads"] threads: per hot tag P18["hot_madd"] BF.MADD of
    P18["madd"] fresh keys, then P18["hot_incr"] CMS.INCRBY; per cold tag
    P18["cold_madd"] and P18["cold_incr"].  Thread c sends commands c,
    c + T, ... of every object, P18["window"] per object per batch (a
    filter's run fuses on its node).  A CMS.INCRBY carries
    P18["incr_draws"] zipf(1.2) draws over P18["incr_items"] items as
    (item, count) pairs (it adds item by item, a blocking call each).
    Acked BF.MADD key ranges go into ``acked``; returns the seconds of
    the BF.MADD half and of the CMS.INCRBY half."""
    per, T, W = P18["madd"], P18["threads"], P18["window"]
    madd = [[] for _ in range(T)]
    meta = [[] for _ in range(T)]
    incr = [[] for _ in range(T)]
    for c in range(T):
        runs = []
        for ti, t in enumerate(tags):
            n_madd = P18["hot_madd"] if t in hot else P18["cold_madd"]
            los = [(ti << 32) | ((window * P18["hot_madd"] + j) * per)
                   for j in range(c, n_madd, T)]
            runs.append([([b"BF.MADD", t + b"bf"] + c11_keys(lo, lo + per), (t, lo))
                         for lo in los])
            for _ in range(c, P18["hot_incr"] if t in hot else P18["cold_incr"], T):
                items, counts = np.unique(
                    rng.zipf(1.2, P18["incr_draws"]) % P18["incr_items"], return_counts=True)
                incr[c].append([b"CMS.INCRBY", t + b"cms"]
                               + [x for v, n in zip(items, counts)
                                  for x in (b"%d" % v, b"%d" % n)])
        for i in range(0, max(len(r) for r in runs), W):
            part = [cm for r in runs for cm in r[i:i + W]]
            madd[c].append([cm for cm, _m in part])
            meta[c].append([m for _cm, m in part])
    incr = [[cmds] if cmds else [] for cmds in incr]
    t0 = time.perf_counter()
    replies = p18_load(addrs, madd, f"18a window {window}")
    madd_s = time.perf_counter() - t0
    for c in range(T):
        for got, ms in zip(replies[c], meta[c]):
            for r, m in zip(got, ms):
                check(isinstance(r, list) and len(r) == per,
                      f"18a: BF.MADD replied {r!r}"[:200])
                acked.setdefault(m[0], []).append(m[1])
    t0 = time.perf_counter()
    replies = p18_load(addrs, incr, f"18a window {window}")
    incr_s = time.perf_counter() - t0
    check(all(isinstance(r, list) for rc in replies for b in rc for r in b),
          "18a: a CMS.INCRBY failed")
    return madd_s, incr_s


def p18_now(addrs, what: bytes) -> list:
    return [p17_req(a, [[b"CLUSTER", what, b"NOW"]])[0] for a in addrs]


def p18_owner_map(nodes, ids) -> dict:
    """Every node's view of every slot's owner must agree; returns it."""
    views = [srv.cluster.slotmap for _cl, srv in nodes]
    owners = {}
    for nid in ids:
        for a, b in views[0].ranges(nid):
            for s in range(a, b + 1):
                owners[s] = nid
    for v in views[1:]:
        for nid in ids:
            check([tuple(r) for r in v.ranges(nid)] == [tuple(r) for r in views[0].ranges(nid)],
                  "18a: the nodes' slot maps disagree")
    return owners


def p18_rebalancer_metrics(obs) -> dict:
    dec = {lv[0]: int(c.value) for lv, c in obs.rebalancer_decisions.items()}
    keys = sum(int(c.value) for _lv, c in obs.rebalancer_keys_moved.items())
    mig = [(c.sum, c.count) for _lv, c in obs.rebalancer_migration_seconds.items()]
    s, n = (mig[0] if mig else (0.0, 0))
    return {"decisions": dec, "keys_moved": keys, "migration_seconds_sum": s,
            "migration_seconds_count": n,
            "imbalance_ratio": float(obs.rebalancer_imbalance_source())}


def p18a_wave(nodes, ids, addrs, cuts, rng) -> tuple:
    """18a: heat from the card's launches drives a wave off node A."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.cluster.slots import key_slot
    from redisson_tpu_torch.ops import golden

    taken: set = set()
    hot = p18_tags(cuts, 0, P18["hot"], taken)
    cold = [t for i in range(1, len(ids)) for t in p18_tags(cuts, i, P18["cold"], taken)]
    tags = hot + cold
    cc = rt.connect_cluster(addrs, timeout_s=300.0)
    try:
        rep = cc.execute_many(
            [[b"BF.RESERVE", t + b"bf", b"%g" % P18["fpp"], b"%d" % P18["capacity"]]
             for t in tags]
            + [[b"CMS.INITBYDIM", t + b"cms", b"%d" % P18["cms_w"], b"%d" % P18["cms_d"]]
               for t in tags])
        check(rep == [b"OK"] * (2 * len(tags)), f"18a: creating the objects replied {rep[:4]}")
    finally:
        cc.close()
    owners0 = p18_owner_map(nodes, ids)
    acked: dict = {}
    window_s, tick_s, doctor_now, moved = [], [], [], 0
    dumps_before = None
    names = [t + x for t in hot for x in (b"bf", b"cms")]
    agent_a = nodes[0][1].rebalancer
    for window in range(P18["max_windows"]):
        window_s.append(p18_window(addrs, tags, set(hot), window, rng, acked))
        t_tick = time.perf_counter()
        if agent_a.planner.ticks + 1 >= agent_a.planner.warmup_ticks:
            # This tick may plan a wave: the hot objects' DUMPs before it.
            dumps_before = p17_req(addrs[0], [[b"DUMP", nm] for nm in names])
        t0 = time.perf_counter()
        moved = sum(p18_now(addrs, b"REBALANCE"))
        wave_s = time.perf_counter() - t0
        doctor_now += p18_now(addrs, b"DOCTOR")
        tick_s.append(time.perf_counter() - t_tick)
        if moved:
            break
    check(moved > 0, f"18a: no wave in {P18['max_windows']} windows")
    windows = len(window_s)
    ratio_before = agent_a.planner.last_ratio
    check(ratio_before > P18["threshold"],
          f"18a: the ratio before the wave read {ratio_before}")
    # One more tick on every node without traffic: the planners' ratio
    # over the new owners (every slot's heat decays alike).
    moved_after = sum(p18_now(addrs, b"REBALANCE"))
    doctor_now += p18_now(addrs, b"DOCTOR")
    ratio_after = agent_a.planner.last_ratio
    check(ratio_after < ratio_before,
          f"18a: the ratio did not fall ({ratio_before} -> {ratio_after})")
    check(all(x == 0 for x in doctor_now),
          f"18a: the doctor raised findings on a clean fleet: {doctor_now}")
    owners1 = p18_owner_map(nodes, ids)
    changed = {s for s in owners0 if owners0[s] != owners1[s]}
    statuses = [srv.rebalancer.status() for _cl, srv in nodes]
    slots_moved = sum(st["slots_moved"] for st in statuses)
    check(slots_moved == len(changed),
          f"18a: {slots_moved} moves for {len(changed)} slots that changed owner "
          "(a slot moved twice)")
    check(all(st["failures"] == 0 for st in statuses), f"18a: failed moves: {statuses}")
    moved_hot = [t for t in hot if key_slot(t) in changed]
    check(moved_hot, "18a: no hot slot moved")
    check(all(owners0[s] == ids[0] for s in changed), "18a: a slot moved off a cold node")
    # Every acked key through the routing client, from P18["threads"]
    # threads (P18["window"] commands of one filter per batch).
    per, T, W = P18["madd"], P18["threads"], P18["window"]
    batches = [[] for _ in range(T)]
    for t, los in acked.items():
        for c in range(T):
            mine = los[c::T]
            batches[c] += [[[b"BF.MEXISTS", t + b"bf"] + c11_keys(lo, lo + per)
                            for lo in mine[i:i + W]] for i in range(0, len(mine), W)]
    t0 = time.perf_counter()
    replies = p18_load(addrs, batches, "18a read-back")
    reads_s = time.perf_counter() - t0
    n_keys = 0
    for got in (r for rc in replies for batch in rc for r in batch):
        check(isinstance(got, list) and all(x == 1 for x in got),
              "18a: an acked key reads 0 after the wave")
        n_keys += len(got)
    check(n_keys == per * sum(len(v) for v in acked.values()), "18a: keys went unread")
    t_golden = time.perf_counter()
    # The moved rows: on the target's card, equal to the golden filter of
    # the acked keys; quiet objects' DUMPs byte-equal; the source empty.
    ref = rt.create(rt.Config().set_codec(nodes[0][0].config.codec).use_gpu_sketch(device="cpu"))
    try:
        rbf = ref.get_bloom_filter("m-k")
        rbf.try_init(P18["capacity"], P18["fpp"])
        m, k = rbf.get_size(), rbf.get_hash_iterations()
        for t in moved_hot:
            dst = ids.index(owners1[key_slot(t)])
            cl = nodes[dst][0]
            items = [x for lo in acked[t] for x in c11_keys(lo, lo + per)]
            h1, h2 = wire_hashes(ref, items, m)
            g = golden.GoldenBloomFilter(m, k)
            g.bits[g._indexes(h1, h2).reshape(-1)] = True
            row = tenant_row(cl, (t + b"bf").decode())
            check(np.array_equal(row, golden_words(g, row.shape[0])),
                  f"18a: the moved filter {t!r}'s row differs from the golden bitmap")
            e = cl._engine.registry.lookup((t + b"bf").decode())
            check(e.pool.state.device.type == P18_DEVICE.split(":")[0],
                  f"18a: the moved filter {t!r} is not on the card")
    finally:
        ref.shutdown()
    golden_s = time.perf_counter() - t_golden
    after = []
    for nm in names:
        dst = ids.index(owners1[key_slot(nm)])
        after += p17_req(addrs[dst], [[b"DUMP", nm]])
    check(dumps_before is not None and after == dumps_before,
          "18a: a hot object's DUMP changed across the wave")
    for t in moved_hot:
        s = b"%d" % key_slot(t)
        got = p17_req(addrs[0], [[b"CLUSTER", b"COUNTKEYSINSLOT", s],
                                 [b"DEBUG", b"COUNTKEYSINSLOT", s], [b"EXISTS", t + b"bf"]])
        check(got[:2] == [0, 0] and getattr(got[2], "code", "") == "MOVED",
              f"18a: the source still holds {t!r}: {got}")
        dst = addrs[ids.index(owners1[key_slot(t)])]
        enc = p17_req(dst, [[b"OBJECT", b"ENCODING", t + x] for x in (b"bf", b"cms")])
        check(enc == [b"device"] * 2, f"18a: {t!r}'s rows are not on the card: {enc}")
    metrics = p18_rebalancer_metrics(nodes[0][1].obs)
    # How much of the hot slots' heat came from the dispatch records'
    # device time (the planner weighs 100 us as one op).
    lm = nodes[0][1].loadmap
    ops = sum(lm.ops[key_slot(t)] for t in hot)
    dev = sum(lm.device_us[key_slot(t)] for t in hot) / 100.0
    out = {"ratio_before": ratio_before, "ratio_after": ratio_after,
           "windows_to_first_wave": windows,
           "window_madd_incr_s": window_s, "tick_s": tick_s, "wave_s": wave_s,
           "read_s": reads_s, "golden_s": golden_s,
           "moves_after_wave": moved_after, "slots_moved": len(changed),
           "hot_slots_moved": len(moved_hot),
           "other_slots_moved": sorted(changed - {key_slot(t) for t in hot}),
           "keys_moved": sum(st["keys_moved"] for st in statuses),
           "seconds_per_slot": (metrics["migration_seconds_sum"]
                                / max(1, metrics["migration_seconds_count"])),
           "acked_keys_read": n_keys, "read_keys_per_s": n_keys / reads_s,
           "moved_rows_equal_golden": True, "quiet_dumps_equal": True,
           "rebalancer_metrics_A": metrics,
           "hot_ops_A": ops, "hot_device_us_A": 100.0 * dev,
           "hot_heat_device_share": dev / (ops + dev),
           "doctor_now_replies": len(doctor_now)}
    return out, owners1, moved_hot, hot


def p18b_k1_on_moved_cms(nodes, ids, owners, moved_hot, rng) -> dict:
    """18b: K1 on a CMS the wave moved, at its new owner's client:
    add_all_seq of P18["k1_events"] zipf events, estimates and table
    equal golden_seq seeded from the moved row."""
    from redisson_tpu_torch.cluster.slots import key_slot
    from redisson_tpu_torch.ops import cms_seq
    from redisson_tpu_torch.utils import hashing

    d, w, n = P18["cms_d"], P18["cms_w"], P18["k1_events"]
    t = moved_hot[0]
    name = (t + b"cms").decode()
    client = nodes[ids.index(owners[key_slot(t)])][0]
    table = tenant_row(client, name)[: d * w].reshape(d, w).copy()
    check(table.sum() > 0, "18b: the moved CMS is empty")
    events = zipf_keys(rng, n)
    h1w, h2w = hashing.km_reduce_mod(*hashing.hash128_np(*hashing.encode_uint64_batch(events)), w)
    want_table, want_est = cms_seq.golden_seq(table, h1w, h2w, np.ones(n, np.uint32), d=d, w=w)
    before = cms_seq.LAUNCHES
    t0 = time.perf_counter()
    est = client.get_count_min_sketch(name).add_all_seq(events)
    dt = time.perf_counter() - t0
    launches = cms_seq.LAUNCHES - before
    chunk = client._engine._SEQ_CHUNK
    check(launches == -(-n // chunk), f"18b: {launches} K1 launches on the moved CMS")
    check(np.array_equal(np.asarray(est, np.uint32), np.asarray(want_est, np.uint32)),
          "18b: estimates differ from golden_seq")
    got = tenant_row(client, name)[: d * w]
    check(np.array_equal(got, want_table.reshape(-1)), "18b: table differs from golden_seq")
    return {"k1_moved_cms": name, "k1_moved_cms_owner": owners[key_slot(t)],
            "k1_moved_cms_launches": launches, "k1_moved_cms_events_per_s": n / dt,
            "k1_moved_cms_equals_golden_seq": True}


def p18c_doctor(nodes, ids, addrs, owners, hot) -> dict:
    """18c: a stuck migration is raised and cleared; the canary's round
    trip per primary."""
    from redisson_tpu_torch.cluster.slots import key_slot
    from redisson_tpu_torch.obs.doctor import canary_key

    a, doc = addrs[0], nodes[0][1].doctor
    canary_slots = {key_slot(canary_key(nid, doc.slotmap).encode()) for nid in ids}
    stay = [t for t in hot if owners[key_slot(t)] == ids[0]
            and key_slot(t) not in canary_slots]
    check(stay, "18c: no slot left on node A")
    s = b"%d" % key_slot(stay[0])
    ev0 = nodes[0][1].obs.events.stats()["seq"]
    check(p17_req(a, [[b"CLUSTER", b"SETSLOT", s, b"MIGRATING", ids[1].encode()]]) == [b"OK"],
          "18c: SETSLOT MIGRATING refused")
    first = p17_req(a, [[b"CLUSTER", b"DOCTOR", b"NOW"]])[0]
    time.sleep(P18["stuck_slot_s"] + 0.1)
    raised = p17_req(a, [[b"CLUSTER", b"DOCTOR", b"NOW"]])[0]
    st = doc.status()
    kinds = [f["kind"] for f in st["active_findings"]]
    check(first == 0 and raised == 1 and kinds == ["stuck-migration"],
          f"18c: stuck migration: NOW replied {first}, then {raised}: {kinds}")
    fam = nodes[0][1].obs.doctor_findings.get(("stuck-migration",))
    check(fam == 1, f"18c: rtpu_doctor_findings{{kind=stuck-migration}} = {fam}")
    check(p17_req(a, [[b"CLUSTER", b"SETSLOT", s, b"STABLE"]]) == [b"OK"],
          "18c: SETSLOT STABLE refused")
    cleared = p17_req(a, [[b"CLUSTER", b"DOCTOR", b"NOW"]])[0]
    check(cleared == 0 and not doc.active, f"18c: the finding did not clear ({cleared})")
    evs = [e for e in nodes[0][1].obs.events.snapshot(count=64) if e["seq"] > ev0]
    got = [(e["kind"], e["fields"].get("kind")) for e in evs if e["kind"].startswith("doctor.")]
    check(("doctor.finding", "stuck-migration") in got and ("doctor.clear", "stuck-migration") in got,
          f"18c: the doctor's events were {got}")
    rtt = {}
    for nid in ids:
        t0 = time.perf_counter()
        err = doc._canary_probe(nid)
        rtt[nid] = (time.perf_counter() - t0) * 1e3
        check(err is None, f"18c: the canary failed on {nid}: {err}")
    return {"stuck_slot": int(s), "stuck_raised": True, "stuck_cleared": True,
            "canary_rtt_ms": rtt, "doctor_sweeps_A": st["sweeps"]}


def phase_rebalance(rng, card: str) -> None:
    """Phase 18: the autonomous rebalancer and the fleet doctor on the card."""
    t0 = time.perf_counter()
    out = {"phase": 18, "card": card}
    secs = out["seconds"] = {}
    t = time.perf_counter()
    nodes, ids, addrs, cuts = p18_fleet()
    try:
        p17_check_card(addrs, "18", P18_DEVICE)
        secs["start"] = time.perf_counter() - t
        t = time.perf_counter()
        a, owners, moved_hot, hot = p18a_wave(nodes, ids, addrs, cuts, rng)
        out.update(a)
        secs["18a"] = time.perf_counter() - t
        t = time.perf_counter()
        out.update(p18b_k1_on_moved_cms(nodes, ids, owners, moved_hot, rng))
        secs["18b"] = time.perf_counter() - t
        t = time.perf_counter()
        out.update(p18c_doctor(nodes, ids, addrs, owners, hot))
        secs["18c"] = time.perf_counter() - t
        for cl, _srv in nodes:
            check_healthy(cl, 18)
    finally:
        p18_close(nodes)
    out["phase_seconds"] = time.perf_counter() - t0
    log(out)


# -- phase 19: the port's locks under the armed lock-order witness ------------

P19 = {"keys": 1 << 20, "capacity": 1_000_000, "fpp": 0.01, "per": 8192, "threads": 4,
       "outside": 1 << 18, "d": 5, "w": 1 << 16, "k1_events": 1 << 19,
       "hll_keys": 1 << 16, "bs_bits": 1 << 20, "bs_idx": 1 << 16,
       "wire_keys": 1 << 16, "madd": 1024, "conns": 4, "incr_draws": 256,
       "incr_items": 64, "fleet_keys": 1 << 14, "child_timeout": 600}
P19_DEVICE = "cuda"
# A run that never took one of these went around the witness: the phase
# fails rather than pass on an unarmed or bypassed path.
P19_NAMES = ("coalescer.queue", "coalescer.inflight", "engine.mirror", "tenancy.registry",
             "journal.queue", "repl.hub", "repl.link", "resp.conn.send", "cluster.move",
             "cluster.slotmap", "rebalance.tick", "doctor.tick")
# Named sites whose lock the parent, with the witness off, must hold raw:
# (what, how to reach it from a client and its server, the raw type).
P19_RAW = (
    ("engine.mirror", lambda cl, srv: cl._engine._mirror_lock, "RLock"),
    ("tenancy.registry", lambda cl, srv: cl._engine.registry._lock, "RLock"),
    ("coalescer.queue", lambda cl, srv: cl._engine.coalescer._lock, "Lock"),
    ("health.state", lambda cl, srv: cl._engine.health._lock, "Lock"),
    ("grid.store", lambda cl, srv: cl._grid.lock, "RLock"),
    ("resp.conns", lambda cl, srv: srv._conn_lock, "Lock"),
    ("resp.write_epoch", lambda cl, srv: srv._epoch_lock, "Lock"),
)


def p19_client(base=None, **kw):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    cfg = rt.Config().set_codec(LongCodec()).use_gpu_sketch(device=P19_DEVICE)
    if base is not None:  # a primary: journaled under always, snapshots for FULLRESYNC
        cfg.journal_dir = os.path.join(base, "journal")
        cfg.journal_fsync = "always"
        cfg.snapshot_dir = os.path.join(base, "snap")
    for k, v in kw.items():
        setattr(cfg, k, v)
    return rt.create(cfg)


def p19_threads(n: int, fn) -> None:
    """``fn(t)`` on ``n`` threads at once; a failure in any is raised."""
    errors = []

    def run(t):
        try:
            fn(t)
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]


def p19_cfg1_add(client, name: str) -> tuple:
    """Config 1's 2**20 keys into a fresh filter as add_all calls of
    P19["per"] keys, thread t sending calls t, t + T, ...: (the filter,
    the keys, each thread's per-key flags, the wall seconds)."""
    n, per, T = P19["keys"], P19["per"], P19["threads"]
    bf = client.get_bloom_filter(name)
    check(bf.try_init(P19["capacity"], P19["fpp"]), "19: try_init refused")
    keys = np.arange(n, dtype=np.uint64)
    flags = [[] for _ in range(T)]

    def add(t):
        for j in range(t, n // per, T):
            flags[t].append(np.asarray(bf.add_all_async(keys[j * per:(j + 1) * per]).result()))

    if P19_DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    p19_threads(T, add)
    return bf, keys, flags, time.perf_counter() - t0


def p19a_engine(client, rng) -> dict:
    """Config 1 from 4 threads through the coalescer (flags within 11a's
    bounds, the row equal to golden, contains equal to golden); K1 on a
    CMS(5, 65536); PFADD and BitSet sets on a small keyspace."""
    from redisson_tpu_torch.ops import cms_seq
    from redisson_tpu_torch.utils import hashing

    n, per, T = P19["keys"], P19["per"], P19["threads"]
    p19_cfg1_add(client, "p19-warm")  # first launches outside the timed pass, as 19c
    bf, keys, flags, add_s = p19_cfg1_add(client, "p19-cfg1")
    m, k = bf.get_size(), bf.get_hash_iterations()
    h1, h2 = hashing.km_reduce_mod(*hashing.hash128_np(*hashing.encode_uint64_batch(keys)), m)
    model = madd_model(h1, h2, m, k, per, T)
    g, n_added = model[0], madd_check(model, flags, "19a")
    check(0.97 * n <= n_added <= n, f"19a: added {n_added} of {n}")
    words = tenant_row(client, "p19-cfg1")
    check(np.array_equal(words, golden_words(g, words.shape[0])),
          "19a: the filter row differs from the golden bitmap")
    probe = np.concatenate([keys[:: max(1, n // P19["outside"])],
                            rng.integers(3 * n, 8 * n, P19["outside"]).astype(np.uint64)])
    parts = np.array_split(probe, T)
    got = [None] * T

    def contains(t):
        got[t] = np.asarray(bf.contains_each(parts[t]))

    p19_threads(T, contains)
    for part, hit in zip(parts, got):
        check(np.array_equal(hit, golden_contains(g, part)), "19a: contains differs from golden")
    # K1: 2**19 zipf events, 16 launches of 32768.
    d, w, n_ev = P19["d"], P19["w"], P19["k1_events"]
    cms = client.get_count_min_sketch("p19-cms")
    check(cms.try_init(d, w), "19a: CMS try_init refused")
    events = zipf_keys(rng, n_ev)
    h1w, h2w = hashing.km_reduce_mod(*hashing.hash128_np(*hashing.encode_uint64_batch(events)), w)
    want_table, want_est = cms_seq.golden_seq(np.zeros((d, w), np.uint32), h1w, h2w,
                                              np.ones(n_ev, np.uint32), d=d, w=w)
    before = cms_seq.LAUNCHES
    est = cms.add_all_seq(events)
    launches = cms_seq.LAUNCHES - before
    if P19_DEVICE == "cuda":
        check(launches == -(-n_ev // client._engine._SEQ_CHUNK), f"19a: {launches} K1 launches")
    check(np.array_equal(np.asarray(est, np.uint32), np.asarray(want_est, np.uint32)),
          "19a: K1 estimates differ from golden_seq")
    check(np.array_equal(tenant_row(client, "p19-cms")[: d * w], want_table.reshape(-1)),
          "19a: K1 table differs from golden_seq")
    # PFADD and BitSet sets.
    hkeys = rng.integers(0, 1 << 62, P19["hll_keys"], dtype=np.uint64)
    hll = client.get_hyper_log_log("p19-hll")
    for i in range(0, len(hkeys), len(hkeys) // 4):
        hll.add_all(hkeys[i:i + len(hkeys) // 4])
    check(np.array_equal(tenant_row(client, "p19-hll"), p14_golden_hll(hkeys)),
          "19a: HLL registers differ from golden")
    idx = rng.integers(0, P19["bs_bits"], P19["bs_idx"], dtype=np.uint64).astype(np.uint32)
    bs = client.get_bit_set("p19-bs")
    bs.set(P19["bs_bits"] - 1, False)  # size the row
    for part in np.array_split(idx, 4):
        bs.set_many(part, True)
    check(np.array_equal(tenant_row(client, "p19-bs"), p14_golden_bits(idx, P19["bs_bits"])),
          "19a: BitSet row differs from golden")
    check_healthy(client, "19a")
    return {"cfg1_added": n_added, "cfg1_add_keys_per_s_armed": n / add_s,
            "cfg1_row_equals_golden": True, "k1_launches_engine": launches,
            "k1_equals_golden_seq": True, "hll_equals_golden": True,
            "bitset_equals_golden": True}


def p19a_wire(base: str, rng) -> dict:
    """A RespServer over the reactor under appendfsync always with a
    replica: 4 connections pipeline BF.MADD of 1024 keys and CMS.INCRBY,
    then WAIT 1 1000 on each must answer 1; rows equal on both sides."""
    from redisson_tpu_torch.serve.resp import RespServer
    from redisson_tpu_torch.serve.wireutil import ReplyError, exchange

    pc = p19_client(os.path.join(base, "primary"))
    ps = RespServer(pc)
    rc = rs = None
    try:
        check(ps.reactor is not None, "19a: the server runs without its reactor")
        seed = p17_req((ps.host, ps.port), [
            [b"BF.RESERVE", b"p19w", b"%g" % P19["fpp"], b"%d" % P19["capacity"]],
            [b"CMS.INITBYDIM", b"p19w-cms", b"%d" % P19["w"], b"%d" % P19["d"]]])
        check(seed == [b"OK", b"OK"], f"19a: seeding refused: {seed}")
        # The replica serves thread-per-connection: its read-back below
        # writes through the connection's send lock (resp.conn.send),
        # which the reactor's connections never take.
        rc = p19_client(resp_reactor=False)
        rs = RespServer(rc)
        check(rs.reactor is None, "19a: the replica runs a reactor")
        link = rs.start_replication_from(ps.host, ps.port)
        until(lambda: link.applied >= pc._engine.journal.last_seq() and link.link_up,
              "19a: replica bootstrap", timeout=120)
        n, per, C = P19["wire_keys"], P19["madd"], P19["conns"]
        items = [b"%d" % v for v in rng.integers(0, 1 << 62, n, dtype=np.uint64)]
        streams = []
        for c in range(C):
            mine = items[c::C]
            cmds = [[b"BF.MADD", b"p19w"] + mine[i:i + per] for i in range(0, len(mine), per)]
            # CMS.INCRBY adds item by item: zipf draws as (item, count) pairs.
            ev, cnt = np.unique(rng.zipf(1.2, P19["incr_draws"]) % P19["incr_items"],
                                return_counts=True)
            cmds.append([b"CMS.INCRBY", b"p19w-cms"]
                        + [x for v, q in zip(ev, cnt) for x in (b"%d" % v, b"%d" % q)])
            streams.append(cmds)
        waits = []

        def conn(c):
            s = socket.create_connection((ps.host, ps.port), timeout=120)
            try:
                cmds = streams[c]
                replies = exchange(s, cmds)
                check(not any(isinstance(r, ReplyError) for r in replies), "19a: a wire write failed")
                check(all(isinstance(r, list) and len(r) == len(cm) - 2
                          for r, cm in zip(replies[:-1], cmds[:-1])), "19a: BF.MADD replies malformed")
                (acks,) = exchange(s, [[b"WAIT", b"1", b"1000"]])
                waits.append(acks)
            finally:
                s.close()

        t0 = time.perf_counter()
        p19_threads(C, conn)
        wire_s = time.perf_counter() - t0
        check(waits == [1] * C, f"19a: WAIT 1 1000 answered {waits}")
        until(lambda: link.applied >= pc._engine.journal.last_seq(), "19a: replica catch-up",
              timeout=120)
        for name in ("p19w", "p19w-cms"):
            check(np.array_equal(tenant_row(rc, name), tenant_row(pc, name)),
                  f"19a: the replica's {name} row differs from the primary's")
        back = p17_req((rs.host, rs.port), [[b"BF.MEXISTS", b"p19w"] + items[i:i + per]
                                            for i in range(0, n, per)])
        check(all(r == [1] * len(items[i * per:(i + 1) * per]) for i, r in enumerate(back)),
              "19a: a WAIT-acked key reads 0 on the replica")
        from redisson_tpu_torch.ops import golden

        bf = pc.get_bloom_filter("p19w")
        m, k = bf.get_size(), bf.get_hash_iterations()
        h1, h2 = wire_hashes(pc, items, m)
        g = golden.GoldenBloomFilter(m, k)
        g.bits[g._indexes(h1, h2).reshape(-1)] = True
        words = tenant_row(pc, "p19w")
        check(np.array_equal(words, golden_words(g, words.shape[0])),
              "19a: the wire filter's row differs from the golden bitmap")
        check(pc._engine.journal.stats()["fsyncs"] > 0, "19a: the journal never fsynced")
        check_healthy(pc, "19a primary")
        check_healthy(rc, "19a replica")
        return {"wire_keys": n, "wire_keys_per_s_armed": n / wire_s, "wait_acks": waits,
                "replica_rows_equal": True, "replica_reads_back": True,
                "wire_row_equals_golden": True}
    finally:
        if rs is not None:
            rs.close()
        ps.close()
        for cl in (rc, pc):
            if cl is not None:
                cl.shutdown()


def p19a_fleet() -> dict:
    """Phase 18's in-process three-node fleet cut to one slot holding a
    config-1 filter and a CMS: migrate it from A to B, then one
    rebalancer tick and one doctor sweep on A."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.cluster.slots import key_slot
    from redisson_tpu_torch.cluster.supervisor import migrate_slot

    global P18_DEVICE
    P18_DEVICE = P19_DEVICE
    nodes, ids, addrs, cuts = p18_fleet()
    try:
        (tag,) = p18_tags(cuts, 0, 1, set())
        slot = key_slot(tag)
        n, per = P19["fleet_keys"], P19["madd"]
        cmds = [[b"BF.RESERVE", tag + b"bf", b"%g" % P19["fpp"], b"%d" % P19["capacity"]],
                [b"CMS.INITBYDIM", tag + b"cms", b"%d" % P19["w"], b"%d" % P19["d"]]]
        cmds += [[b"BF.MADD", tag + b"bf"] + c11_keys(i, i + per) for i in range(0, n, per)]
        cmds.append([b"CMS.INCRBY", tag + b"cms"] + [b"%d" % (i % 16) if j % 2 == 0 else b"1"
                                                     for i in range(64) for j in range(2)])
        cc = rt.connect_cluster(addrs, timeout_s=120.0)
        try:
            rep = cc.execute_many(cmds)
            check(not [r for r in rep if isinstance(r, Exception)], "19a: seeding the slot failed")
            before = cc.execute_many([[b"DUMP", tag + b"bf"], [b"DUMP", tag + b"cms"]])
            t0 = time.perf_counter()
            moved = migrate_slot(slot, addrs[0], addrs[1], notify=[addrs[2]])
            mig_s = time.perf_counter() - t0
            check(moved == 2, f"19a: the migration moved {moved} keys")
            after = p17_req(addrs[1], [[b"DUMP", tag + b"bf"], [b"DUMP", tag + b"cms"]])
            check(after == before, "19a: a moved object's DUMP changed across the move")
            hits = cc.execute_many([[b"BF.MEXISTS", tag + b"bf"] + c11_keys(i, i + per)
                                    for i in range(0, n, per)])
            check(all(h == [1] * per for h in hits), "19a: an acked key is missing after the move")
            check(cc.slot_addr(slot) == tuple(addrs[1]), "19a: the slot did not move to B")
        finally:
            cc.close()
        (count,) = p17_req(addrs[0], [[b"CLUSTER", b"COUNTKEYSINSLOT", b"%d" % slot]])
        check(count == 0, f"19a: the source kept {count} keys in the slot")
        (waves,) = p17_req(addrs[0], [[b"CLUSTER", b"REBALANCE", b"NOW"]])
        (findings,) = p17_req(addrs[0], [[b"CLUSTER", b"DOCTOR", b"NOW"]])
        check(findings == 0, f"19a: the doctor's sweep found {findings}")
        for cl, _srv in nodes:
            check_healthy(cl, "19a fleet")
        return {"fleet_keys_moved": moved, "fleet_migration_s": mig_s,
                "fleet_rebalance_moved": waves, "fleet_doctor_findings": findings,
                "fleet_dumps_equal": True}
    finally:
        p18_close(nodes)


def p19_child(base: str, seed: int) -> int:
    """Phase 19a, in a child started with RTPU_LOCK_WITNESS=1 and
    RTPU_LOCK_WITNESS_EXPORT set: the serving paths on the card under the
    armed witness; fails on any violation and on any of P19_NAMES never
    acquired.  Prints one JSON line."""
    from redisson_tpu_torch.analysis import witness
    from redisson_tpu_torch.ops import cms_seq

    check(witness.enabled(), "19a: the child runs without RTPU_LOCK_WITNESS")
    rng = np.random.default_rng(seed + 19)
    out = {"phase": "19a"}
    cms_seq.LAUNCHES = 0
    client = p19_client()
    try:
        check(witness.active(), "19a: no lock was wrapped by the witness")
        out.update(p19a_engine(client, rng))
    finally:
        client.shutdown()
    out.update(p19a_wire(base, rng))
    out.update(p19a_fleet())
    out["k1_launches"] = cms_seq.LAUNCHES
    vs = witness.violations()
    for v in vs:
        print(v.format(), file=sys.stderr, flush=True)
    check(not vs, f"19a: the witness reports {len(vs)} violation(s): "
          + "; ".join(f"[{v.kind}] {v.message}" for v in vs)[:2000])
    names = witness.acquired_names()
    missing = [x for x in P19_NAMES if x not in names]
    check(not missing, f"19a: never acquired under the witness: {missing}")
    out.update(witness_active=True, violations=0, acquired=sorted(names),
               runtime_edges=len(witness.export_edges()))
    log(out)
    return 0


def phase_witness(seed: int, card: str) -> dict:
    """Phase 19: 19a in a child under the armed witness; 19b the port's
    analyser over the tree with the child's runtime edges; 19c the cost
    beside phase 2's unarmed rate and the raw lock types with the witness
    off.  Returns the child's line."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.analysis import lockgraph, witness
    from redisson_tpu_torch.serve.resp import RespServer

    t0 = time.perf_counter()
    repo = Path(__file__).resolve().parent
    base = tempfile.mkdtemp(prefix="p19-")
    edges = os.path.join(base, "edges.json")
    env = dict(os.environ, PYTHONPATH=str(repo), RTPU_LOCK_WITNESS="1",
               RTPU_LOCK_WITNESS_EXPORT=edges)
    cfg = json.dumps({"P19": P19, "device": P19_DEVICE})
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--p19-child", base,
                             "--seed", str(seed), "--p19-config", cfg],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=str(repo))
    try:
        # 19b's static half while the child runs.
        graph = lockgraph.build_graph([str(repo / "redisson_tpu_torch")])
        try:
            out, err = proc.communicate(timeout=P19["child_timeout"])
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            fail(f"19a: the child ran past {P19['child_timeout']} s:\n{err[-4000:]}")
        lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
        child = next((x for x in lines if x.get("phase") == "19a"), None)
        check(proc.returncode == 0 and child is not None,
              f"19a: the child exited {proc.returncode}:\n{err[-6000:]}")
        log(child)
        # 19b: the analyser with the card's runtime edges.
        check(os.path.exists(edges), "19b: the child exported no witness edges")
        runtime = lockgraph.load_runtime_edges(edges)
        check(runtime, "19b: the witness export holds no edge")
        cli = subprocess.run([sys.executable, "-m", "redisson_tpu_torch.analysis",
                              "redisson_tpu_torch/", "--runtime-edges", edges, "--jobs", "8"],
                             cwd=str(repo), capture_output=True, text=True, timeout=600)
        said = (cli.stdout + cli.stderr).strip()
        check(cli.returncode == 0 and "rtpulint: 0 violation(s)" in cli.stderr,
              f"19b: the analyser with the card's edges exited {cli.returncode}:\n{said[-4000:]}")
        blind = sorted(set(runtime) - set(graph.edges))
        log({"phase": "19b", "catalog": len(graph.catalog), "static_edges": len(graph.edges),
             "runtime_edges": len(runtime), "blind_spots": len(blind),
             "blind_spot_edges": [f"{a} -> {b}" for a, b in blind],
             "analyser": said.splitlines()[-1]})
    finally:
        if proc.poll() is None:
            proc.kill()
        shutil.rmtree(base, ignore_errors=True)
    # 19c: the cost beside phase 2's unarmed rate, and the raw locks.
    check(not witness.enabled(), "19c: the witness is armed in the parent")
    client = p19_client()
    server = RespServer(client)
    try:
        kinds = {"Lock": type(threading.Lock()), "RLock": type(threading.RLock())}
        for what, get, kind in P19_RAW:
            check(type(get(client, server)) is kinds[kind],
                  f"19c: {what} is {type(get(client, server))!r} with the witness off")
        # The armed run's add shape again, unarmed, on a warmed client.
        p19_cfg1_add(client, "p19-warm")
        _bf, _keys, _flags, add_s = p19_cfg1_add(client, "p19-cfg1")
    finally:
        server.close()
        client.shutdown()
    armed, unarmed = child["cfg1_add_keys_per_s_armed"], P19["keys"] / add_s
    log({"phase": "19c", "cfg1_add_keys_per_s_armed": armed,
         "cfg1_add_keys_per_s_unarmed": unarmed, "armed_over_unarmed": armed / unarmed,
         "cfg1_add_keys_per_s_unarmed_phase_2": RATES.get("add_ops_per_s"),
         "raw_locks_with_witness_off": [w for w, _g, _k in P19_RAW],
         "phase_seconds": time.perf_counter() - t0, "card": card})
    return child


# -- phase 20: the sharded executor and the mesh ------------------------------------

P20 = {"shards": 8, "nbits": 1 << 30, "bs_ops": 1 << 21, "bs_iters": 8,
       "bloom_keys": 1 << 20, "bloom_chunk": 1 << 18, "outside": 1 << 17,
       "hll_keys": 1 << 21, "hlls": 4, "cms": (5, 1 << 16), "cms_events": 1 << 20,
       "cms_chunk": 1 << 15, "writer_chunk": 4096, "mbit_threshold_words": 1 << 22}
P20_DEVICE = "cuda"


def p20_shard_ops(client) -> np.ndarray:
    """rtpu_shard_ops per shard, as counted so far."""
    out = np.zeros(P20["shards"], np.int64)
    for labels, c in client._engine.obs.registry.family("rtpu_shard_ops_total").items():
        out[int(labels[0])] += int(c.value)
    return out


def p20_rows(client) -> dict:
    """Every tenant's row, read through the executor (layout-free)."""
    eng = client._engine
    eng._drain()
    return {e.name: eng.executor.read_row(e.pool, e.row) for e in eng.registry.entries()}


def p20_bloom_words(g, row_words: int) -> np.ndarray:
    gbits = np.zeros(row_words * 32, bool)
    gbits[: g.size] = g.bits
    return np.packbits(gbits, bitorder="little").view(np.uint32)


def p20a_tenants(client, rng) -> dict:
    """20a: config 4 at 8 shards — phase 3's plan through the per-op
    path; every result and row equal golden, every shard took ops and the
    shard counters sum to the ops sent."""
    before = p20_shard_ops(client)
    rate = phase_tenants(client, rng, phase="20a", runs=False)
    per_shard = p20_shard_ops(client) - before
    sent = 1000 * 5 * 256
    check(int(per_shard.sum()) == sent, f"20a: shard ops {per_shard.tolist()} vs {sent} sent")
    check(bool((per_shard > 0).all()), f"20a: a shard took no ops: {per_shard.tolist()}")
    out = {"phase": "20a", "ops_per_s": rate, "phase3_ops_per_s": RATES.get("tenants_ops_per_s"),
           "shard_ops": per_shard.tolist()}
    log(out)
    return out


def p20b_replicated(client, rng) -> dict:
    """20b: config 1 (1M keys at 1%), then set_replicated(): every replica
    row equals the golden bitmap, every loaded key is present and the FPP
    sits within 3 sigma of the expected 1.255%."""
    n, chunk = P20["bloom_keys"], P20["bloom_chunk"]
    bf = client.get_bloom_filter("p20-cfg1")
    check(bf.try_init(1_000_000, 0.01), "20b: try_init refused")
    t0 = time.perf_counter()
    adds = [bf.add_all_async(np.arange(i, i + chunk, dtype=np.uint64)) for i in range(0, n, chunk)]
    added = sum(int(np.sum(a.result())) for a in adds)
    add_s = time.perf_counter() - t0
    check(0.97 * n <= added <= n, f"20b: added {added} of {n}")
    t0 = time.perf_counter()
    check(bf.set_replicated() and bf.is_replicated(), "20b: set_replicated refused")
    rep_s = time.perf_counter() - t0
    g = golden_bloom(bf, np.arange(n, dtype=np.uint64))
    eng = client._engine
    e = eng.registry.lookup("p20-cfg1")
    S = P20["shards"]
    check(sorted(r % S for r in e.replica_rows) == list(range(S)), "20b: a shard lacks a replica")
    want = p20_bloom_words(g, e.pool.row_units)
    for r in e.replica_rows:
        check(np.array_equal(eng.executor.read_row(e.pool, r), want),
              f"20b: replica row {r} differs from the golden bitmap")
    t0 = time.perf_counter()
    present = bf.contains_each(np.arange(n, dtype=np.uint64))
    contains_s = time.perf_counter() - t0
    check(bool(present.all()), f"20b: {int((~present).sum())} loaded keys missing")
    outside = rng.integers(3 * n, 8 * n, P20["outside"]).astype(np.uint64)
    fp = bf.contains_each(outside)
    check(np.array_equal(fp, golden_contains(g, outside)), "20b: outside keys differ from golden")
    m, k = bf.get_size(), bf.get_hash_iterations()
    p = (1.0 - np.exp(-k * n / m)) ** k
    sigma = np.sqrt(p * (1.0 - p) / len(outside))
    fpp = float(fp.mean())
    check(abs(fpp - p) <= 3 * sigma, f"20b: FPP {fpp} vs {p} +- {3 * sigma}")
    out = {"phase": "20b", "add_ops_per_s": n / add_s, "contains_ops_per_s": n / contains_s,
           "replicate_s": rep_s, "replica_rows": list(e.replica_rows), "fpp": fpp,
           "fpp_expected": p, "replicas_equal_golden": True}
    log(out)
    return out


def p20_range(bitmap: np.ndarray, lo: int, hi: int, value: bool) -> None:
    """Set or clear bits [lo, hi) of a packed uint32 bitmap."""
    fw, lw = lo >> 5, (hi - 1) >> 5
    head = np.uint32((0xFFFFFFFF << (lo & 31)) & 0xFFFFFFFF)
    tail = np.uint32(0xFFFFFFFF >> (31 - ((hi - 1) & 31)))
    masks = [(fw, head & tail)] if fw == lw else [(fw, head), (lw, tail)]
    if lw > fw + 1:
        bitmap[fw + 1 : lw] = 0xFFFFFFFF if value else 0
    for wd, mk in masks:
        bitmap[wd] = (bitmap[wd] | mk) if value else (bitmap[wd] & ~mk)


def p20_bits_stats(bitmap: np.ndarray) -> tuple:
    nz = np.flatnonzero(bitmap)
    card = int(_POPCOUNT8[bitmap.view(np.uint8)].sum(dtype=np.int64))
    length = int(nz[-1]) * 32 + int(bitmap[nz[-1]]).bit_length() if len(nz) else 0
    first1 = int(nz[0]) * 32 + (int(bitmap[nz[0]]) & -int(bitmap[nz[0]])).bit_length() - 1 \
        if len(nz) else -1
    free = np.flatnonzero(bitmap != 0xFFFFFFFF)
    if len(free):
        wv = int(bitmap[free[0]]) ^ 0xFFFFFFFF
        first0 = int(free[0]) * 32 + (wv & -wv).bit_length() - 1
    else:
        first0 = len(bitmap) * 32
    return card, length, first1, first0


def p20c_mbit(client, rng) -> dict:
    """20c: config 3 m-sharded — two 2**30-bit BitSets split over the
    shards by words: 8 x 2**21 set/get ops, a set_range across shard
    boundaries, the scalars and AND/OR/XOR/NOT between the two rows."""
    nbits, B, iters = P20["nbits"], P20["bs_ops"], P20["bs_iters"]
    eng = client._engine
    maps = {}
    for name in ("p20-x", "p20-y"):
        bs = client.get_bit_set(name)
        bitmap = np.zeros(nbits // 32, np.uint32)
        check(not bs.set(nbits - 1), f"20c: set(2**30 - 1) found the bit set in {name}")
        golden_set(bitmap, np.array([nbits - 1]))
        maps[name] = bitmap
        check(eng.executor._is_mbit(eng.registry.lookup(name).pool), f"20c: {name} not m-sharded")
    x, y = client.get_bit_set("p20-x"), client.get_bit_set("p20-y")
    idxs = [rng.integers(0, nbits, B).astype(np.uint32) for _ in range(iters)]
    if P20_DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with client.defer_fetch():
        futs = [x.set_many_async(idx) if i % 2 == 0 else x.get_many_async(idx)
                for i, idx in enumerate(idxs)]
    res = client.collect(futs)
    dt = time.perf_counter() - t0
    for i, (idx, got) in enumerate(zip(idxs, res)):
        want = golden_set(maps["p20-x"], idx) if i % 2 == 0 else golden_get(maps["p20-x"], idx)
        check(np.array_equal(got, want), f"20c: batch {i} differs from the golden bitmap")
    yi = rng.integers(0, nbits, B).astype(np.uint32)
    check(np.array_equal(y.set_many(yi), golden_set(maps["p20-y"], yi)), "20c: y's sets differ")
    win = nbits // P20["shards"]
    lo, hi = 2 * win - 1000, 5 * win + 77  # spans shards 1..5
    x.set_range(lo, hi)
    p20_range(maps["p20-x"], lo, hi, True)
    x.clear_range(lo + 4096, 3 * win + 5)
    p20_range(maps["p20-x"], lo + 4096, 3 * win + 5, False)

    def same(name, what):
        check(np.array_equal(tenant_row(client, name), maps[name]),
              f"20c: {name}'s row differs from the golden bitmap after {what}")
        card, length, first1, first0 = p20_bits_stats(maps[name])
        bs = client.get_bit_set(name)
        got = (bs.cardinality(), bs.length(), bs.first_set_bit(), bs.first_clear_bit())
        check(got == (card, length, first1, first0), f"20c: {name} scalars {got} after {what}")

    same("p20-x", "set/get and the ranges")
    same("p20-y", "set_many")
    for op in ("or", "xor", "and"):
        getattr(x, op + "_op")("p20-y")
        gx, gy = maps["p20-x"], maps["p20-y"]
        maps["p20-x"] = gx | gy if op == "or" else gx ^ gy if op == "xor" else gx & gy
        same("p20-x", op.upper())
    y.not_op()
    maps["p20-y"] = ~maps["p20-y"]
    same("p20-y", "NOT")
    out = {"phase": "20c", "ops": iters * B, "ops_per_s": iters * B / dt,
           "rows_equal_golden": True, "scalars_equal_golden": True}
    log(out)
    return out


def p20d_hll(client) -> dict:
    """20d: config 2 — PFADD of 2**21 keys into each of 4 HLLs spread
    over the shards, then PFMERGE across shards."""
    from redisson_tpu_torch.ops import golden

    n, k = P20["hll_keys"], P20["hlls"]
    names = [f"p20-h{i}" for i in range(k)]
    eng = client._engine
    t0 = time.perf_counter()
    with client.defer_fetch():
        futs = [client.get_hyper_log_log(nm).add_all_async(
            np.arange(i * n, (i + 1) * n, dtype=np.uint64)) for i, nm in enumerate(names)]
    changed = client.collect(futs)
    dt = time.perf_counter() - t0
    check(all(changed), "20d: a PFADD of new keys changed nothing")
    rows = [eng.registry.lookup(nm).row for nm in names]
    check(len({r % P20["shards"] for r in rows}) == k, f"20d: rows {rows} share a shard")
    regs = []
    for i, nm in enumerate(names):
        g = golden.GoldenHyperLogLog()
        g.add_hashed(*hll_lanes(np.arange(i * n, (i + 1) * n, dtype=np.uint64)))
        check(np.array_equal(tenant_row(client, nm), g.regs), f"20d: {nm}'s registers differ")
        check(client.get_hyper_log_log(nm).count() == g.count(), f"20d: {nm}'s count()")
        regs.append(g.regs)
    client.get_hyper_log_log(names[0]).merge_with(*names[1:])
    merged = np.maximum.reduce(regs)
    check(np.array_equal(tenant_row(client, names[0]), merged), "20d: merged registers != max")
    want = int(round(golden.ertl_estimate(np.bincount(merged, minlength=golden.HLL_Q + 2))))
    got = client.get_hyper_log_log(names[0]).count()
    check(got == want, f"20d: merged count() {got} vs Ertl {want}")
    check(abs(got - k * n) / (k * n) < 0.05, f"20d: merged count {got} vs {k * n}")
    out = {"phase": "20d", "pfadd_ops_per_s": k * n / dt, "merged_count": got,
           "registers_equal_golden": True}
    log(out)
    return out


def p20e_cms(client, rng) -> dict:
    """20e: config 5 at 8 shards — CMS(5, 65536) on 8 tenants, one per
    shard, zipf(1.2) events through add_all_seq, which takes the
    whole-batch path (no K1 while sharded); then CMS.MERGE across shards."""
    from redisson_tpu_torch.ops import golden
    from redisson_tpu_torch.utils import hashing

    d, w = P20["cms"]
    S, chunk = P20["shards"], P20["cms_chunk"]
    names = [f"p20-cms{i}" for i in range(S)]
    eng = client._engine
    for nm in names:
        check(client.get_count_min_sketch(nm).try_init(d, w), "20e: try_init refused")
    check(sorted(eng.registry.lookup(nm).row % S for nm in names) == list(range(S)),
          "20e: the CMS tenants do not cover every shard")
    events = zipf_keys(rng, P20["cms_events"])
    gold = {nm: golden.GoldenCountMinSketch(d, w) for nm in names}
    dt = 0.0
    for j, i in enumerate(range(0, len(events), chunk)):
        nm = names[j % S]
        ev = events[i : i + chunk]
        t0 = time.perf_counter()
        est = client.get_count_min_sketch(nm).add_all_seq(ev)
        dt += time.perf_counter() - t0
        h1w, h2w = hashing.km_reduce_mod(*hashing.hash128_np(*hashing.encode_uint64_batch(ev)), w)
        g = gold[nm]
        g.add_hashed(h1w, h2w)
        want = g.counts[np.arange(d)[None, :], g._cells(h1w, h2w)].min(axis=1)
        check(np.array_equal(est, want), f"20e: {nm} whole-batch estimates differ")
    for nm in names:
        check(np.array_equal(tenant_row(client, nm)[: d * w].reshape(d, w), gold[nm].counts),
              f"20e: {nm}'s table differs from golden")
    client.get_count_min_sketch(names[0]).merge(*names[1:])
    total = np.zeros((d, w), np.uint64)
    for nm in names:
        total += gold[nm].counts
    want = (total & 0xFFFFFFFF).astype(np.uint32)
    check(np.array_equal(tenant_row(client, names[0])[: d * w].reshape(d, w), want),
          "20e: CMS.MERGE differs from the uint32 sum")
    gold[names[0]].counts = want
    out = {"phase": "20e", "events": len(events), "events_per_s": len(events) / dt,
           "tables_equal_golden": True, "merge_equals_sum": True}
    log(out)
    return out, gold[names[0]]


def p20f_reshard(client, rng, cms_golden) -> dict:
    """20f: change_topology(4) under a writer (no acked write lost, every
    other row equal to its pre-swap golden), a 4-shard snapshot restored
    into a fresh 1-shard client, change_topology(1), then K1 on the
    carried CMS equal to golden_seq from its carried table."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.ops import cms_seq
    from redisson_tpu_torch.utils import hashing

    eng = client._engine
    golden_rows = p20_rows(client)
    moved = sum(p.state.numel() * p.state.element_size() for p in eng.registry.pools())
    bf = client.get_bloom_filter("p20-writer")
    check(bf.try_init(1_000_000, 0.01), "20f: try_init refused")
    acked, errors, stop = [], [], threading.Event()

    def writer():
        i, c = 0, P20["writer_chunk"]
        try:
            while not stop.is_set():
                bf.add_all(np.arange(i, i + c, dtype=np.uint64))
                acked.append((i, i + c))
                i += c
        except Exception as e:  # reported below
            errors.append(e)

    th = threading.Thread(target=writer)
    th.start()
    until(lambda: len(acked) >= 4 or errors, "20f: writes before the swap")
    t0 = time.perf_counter()
    check(client.change_topology(4), "20f: change_topology(4) refused")
    swap4_s = time.perf_counter() - t0
    n_at_swap = len(acked)
    until(lambda: len(acked) >= n_at_swap + 4 or errors, "20f: writes after the swap")
    stop.set()
    th.join(timeout=120)
    check(not th.is_alive() and not errors, f"20f: the writer failed: {errors}")
    check(eng.executor.S == 4, "20f: not on 4 shards")
    keys = np.concatenate([np.arange(a, b, dtype=np.uint64) for a, b in acked])
    check(bool(bf.contains_each(keys).all()), "20f: an acked write was lost in the swap")
    e = eng.registry.lookup("p20-writer")
    check(np.array_equal(eng.executor.read_row(e.pool, e.row),
                         p20_bloom_words(golden_bloom(bf, keys), e.pool.row_units)),
          "20f: the writer's row differs from the golden bitmap of the acked keys")
    after = p20_rows(client)
    for nm, row in golden_rows.items():
        check(np.array_equal(after[nm], row), f"20f: {nm}'s row changed in the swap")
    snap = Path("build") / f"phase20-snapshot-{os.getpid()}"
    shutil.rmtree(snap, ignore_errors=True)
    t0 = time.perf_counter()
    client._engine.snapshot(str(snap))
    snap_s = time.perf_counter() - t0
    fresh = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(device=P20_DEVICE))
    try:
        t0 = time.perf_counter()
        check(fresh._engine.restore_snapshot(str(snap)), "20f: no snapshot to restore")
        restore_s = time.perf_counter() - t0
        check(getattr(fresh._engine.executor, "S", 1) == 1, "20f: the fresh client is sharded")
        restored = p20_rows(fresh)
        after = p20_rows(client)
        check(set(restored) == set(after), "20f: the restored keyspace differs")
        for nm, row in after.items():
            check(np.array_equal(restored[nm], row), f"20f: {nm} differs after the restore")
    finally:
        fresh.shutdown()
        shutil.rmtree(snap, ignore_errors=True)
    t0 = time.perf_counter()
    check(client.change_topology(1), "20f: change_topology(1) refused")
    swap1_s = time.perf_counter() - t0
    check(getattr(eng.executor, "S", 1) == 1 and eng.executor.supports_seq_cms,
          "20f: not back on the single-device executor")
    d, w = P20["cms"]
    cms = client.get_count_min_sketch("p20-cms0")
    table = tenant_row(client, "p20-cms0")[: d * w].reshape(d, w)
    check(np.array_equal(table, cms_golden.counts), "20f: the carried CMS table changed")
    ev = zipf_keys(rng, 1 << 16)
    before = cms_seq.LAUNCHES
    est = cms.add_all_seq(ev)
    launches = cms_seq.LAUNCHES - before
    check(launches == -(-len(ev) // client._engine._SEQ_CHUNK), f"20f: {launches} K1 launches")
    h1w, h2w = hashing.km_reduce_mod(*hashing.hash128_np(*hashing.encode_uint64_batch(ev)), w)
    t_want, e_want = cms_seq.golden_seq(table.copy(), h1w, h2w, np.ones(len(ev), np.uint32),
                                        d=d, w=w)
    check(np.array_equal(est, e_want), "20f: K1 estimates differ from golden_seq")
    check(np.array_equal(tenant_row(client, "p20-cms0")[: d * w].reshape(d, w), t_want),
          "20f: K1's table differs from golden_seq")
    out = {"phase": "20f", "change_topology_s": {"8->4": swap4_s, "4->1": swap1_s},
           "pool_bytes_moved": int(moved), "acked_writes": int(len(keys)),
           "snapshot_s": snap_s, "restore_1_shard_s": restore_s, "k1_launches": launches,
           "rows_kept": True, "k1_equals_golden_seq": True}
    log(out)
    return out


def p20_rng(seed: int, sub: str):
    """The stream of sub-phase ``sub`` (20b-20f): phase 21a replays 20b-20e
    on four placements with the same streams."""
    return np.random.default_rng([seed, 20, ord(sub)])


def phase_sharded(seed: int, card: str) -> dict:
    """Phase 20: one client at num_shards=8 on ONE placement of the card
    (device_indices [0]: the single [S, L] stack) through 20a-20f.  Returns
    the rates and every row of 20b-20e's objects after 20e, which phase
    21a's four placements must equal byte for byte."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.ops import cms_seq

    rng = p20_rng(seed, "a")
    client = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        device=P20_DEVICE, num_shards=P20["shards"], device_indices=[0],
        mbit_threshold_words=P20["mbit_threshold_words"]))
    try:
        eng = client._engine
        check(type(eng.executor).__name__ == "ShardedTorchCommandExecutor"
              and eng.executor.S == P20["shards"], "phase 20: not the sharded executor")
        check(str(eng.executor.device).startswith(P20_DEVICE), "phase 20: not on the card")
        nodes = client.get_nodes_group().get_nodes()
        want_addr = "gpu:0" if P20_DEVICE == "cuda" else "cpu:0"
        check([n.shard for n in nodes] == list(range(P20["shards"]))
              and {n.address for n in nodes} == {want_addr},
              f"phase 20: nodes {[(n.shard, n.address) for n in nodes]}")
        check(not eng.executor.ctx.placed, "phase 20: not one placement")
        launches0 = cms_seq.LAUNCHES
        rates = {"20a": p20a_tenants(client, rng)}
        ops0 = p20_shard_ops(client)
        rates["20b"] = p20b_replicated(client, p20_rng(seed, "b"))
        rates["20c"] = p20c_mbit(client, p20_rng(seed, "c"))
        rates["20d"] = p20d_hll(client)
        rates["20e"], cms_golden = p20e_cms(client, p20_rng(seed, "e"))
        rates["shard_ops_20b_20e"] = p20_shard_ops(client) - ops0
        rates["rows"] = {nm: r for nm, r in p20_rows(client).items() if nm.startswith("p20-")}
        check(cms_seq.LAUNCHES == launches0, "phase 20: K1 launched while sharded")
        check_healthy(client, 20)
        rates["20f"] = p20f_reshard(client, p20_rng(seed, "f"), cms_golden)
        check_healthy(client, 20)
    finally:
        client.shutdown()
    out = {"phase": 20, "nodes": len(nodes), "node_address": want_addr,
           "ops_per_s": {"20a": rates["20a"]["ops_per_s"],
                         "20a_phase3_one_shard": rates["20a"]["phase3_ops_per_s"],
                         "20b_add": rates["20b"]["add_ops_per_s"],
                         "20b_contains": rates["20b"]["contains_ops_per_s"],
                         "20c": rates["20c"]["ops_per_s"],
                         "20d_pfadd": rates["20d"]["pfadd_ops_per_s"],
                         "20e_events": rates["20e"]["events_per_s"]},
           "change_topology_s": rates["20f"]["change_topology_s"],
           "pool_bytes_moved": rates["20f"]["pool_bytes_moved"],
           "k1_launches_sharded": 0, "k1_launches_after_reshard": rates["20f"]["k1_launches"],
           "card": card}
    log(out)
    return rates


# -- phase 21: shards on several placements and in several processes ----------

P21 = {"shards": 8, "placements": 4, "bloom_keys": 1 << 20, "bloom_chunk": 1 << 18,
       "outside": 1 << 17, "hll_keys": 1 << 21, "nbits": 1 << 30, "bs_ops": 1 << 21,
       "bs_iters": 8, "bitop_bits": 1 << 20, "bitop_ops": 1 << 16, "x_objects": 6,
       "x_hll_keys": 1 << 14, "x_bs_bits": 1 << 16, "x_bs_ops": 1 << 12, "x_cms": (4, 1 << 12),
       "x_cms_events": 1 << 14, "mbit_threshold_words": 1 << 22, "child_timeout_s": 240}
P21_DEVICE = "cuda"


def p21_slice() -> tuple:
    """21a's device_indices and the enumeration they index: cards 1, 2, 3, 0
    on a machine with four (K1 after the reshard then runs on cuda:1);
    otherwise four entries of the one device (the seam the CPU tests use),
    the second named first all the same."""
    n = torch.cuda.device_count() if P21_DEVICE == "cuda" else 0
    if n >= P21["placements"]:
        return [1, 2, 3, 0], None
    one = torch.device(P21_DEVICE, 0) if P21_DEVICE == "cuda" else torch.device(P21_DEVICE)
    return [1, 2, 3, 0], [one] * P21["placements"]


class p21_enumeration:
    """The local enumeration replaced by ``devices`` (None: left alone)
    for the devices of P21_DEVICE's type, while the block runs."""

    def __init__(self, devices):
        self.devices = devices

    def __enter__(self):
        from redisson_tpu_torch.executor import torch_executor

        self.real = torch_executor.local_devices
        if self.devices is not None:
            kind = self.devices[0].type
            torch_executor.local_devices = (
                lambda d: list(self.devices) if torch.device(d).type == kind else self.real(d))
        return self

    def __exit__(self, *exc):
        from redisson_tpu_torch.executor import torch_executor

        torch_executor.local_devices = self.real
        return False


def p21_client(**kw):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    return rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        device=P21_DEVICE, num_shards=P21["shards"],
        mbit_threshold_words=P21["mbit_threshold_words"], **kw))


def p21a_bitop(client, rng) -> dict:
    """BITOP between tenant-sharded BitSets on different placements, each
    row equal to a numpy bitmap after every op."""
    nbits, B = P21["bitop_bits"], P21["bitop_ops"]
    ctx = client._engine.executor.ctx
    names = [f"p21-b{i}" for i in range(4)]
    maps = {}
    for nm in names:
        bs = client.get_bit_set(nm)
        maps[nm] = np.zeros(nbits // 32, np.uint32)
        idx = rng.integers(0, nbits, B).astype(np.uint32)
        check(np.array_equal(bs.set_many(idx), golden_set(maps[nm], idx)), f"21a: {nm} sets")
    place = {nm: ctx.locate(client._engine.registry.lookup(nm).row % ctx.n_shards)[0]
             for nm in names}
    check(place["p21-b0"] != place["p21-b2"] and place["p21-b1"] != place["p21-b3"],
          f"21a: the BITOP operands share a placement: {place}")
    for dst, op, src in (("p21-b0", "and", "p21-b2"), ("p21-b1", "or", "p21-b3"),
                         ("p21-b3", "xor", "p21-b0")):
        getattr(client.get_bit_set(dst), op + "_op")(src)
        a, b = maps[dst], maps[src]
        maps[dst] = a & b if op == "and" else a | b if op == "or" else a ^ b
        check(np.array_equal(tenant_row(client, dst), maps[dst]), f"21a: {dst} after {op.upper()}")
        card = int(_POPCOUNT8[maps[dst].view(np.uint8)].sum(dtype=np.int64))
        check(client.get_bit_set(dst).cardinality() == card, f"21a: {dst} cardinality")
    return {"bitop_placements": place, "bitop_rows_equal_golden": True}


def p21a_placements(seed: int, ref: dict, card: str) -> dict:
    """21a: one process, 8 shards on 4 placements: phase 20's 20b-20e
    streams replayed (every result and row checked against golden inside
    them), every row byte-equal to phase 20's one-placement client, the
    shard counters equal to its, BITOP across placements, then 20f's
    change_topology(8 -> 4) under a writer, the 1-shard restore and
    change_topology(1), and K1 on the carried CMS on the slice's first
    device."""
    idx, enum = p21_slice()
    t0 = time.perf_counter()
    with p21_enumeration(enum):
        # Every placement's device warmed first (its context, the path's
        # kernels) on a throwaway client, so the rates compare with phase
        # 20's warm card.
        warm = p21_client(device_indices=idx)
        try:
            p21_warm(warm)
        finally:
            warm.shutdown()
        client = p21_client(device_indices=idx)
        try:
            eng = client._engine
            ctx = eng.executor.ctx
            check(ctx.placed and len(ctx.devices) == P21["placements"] and ctx.per == 2,
                  f"21a: {len(ctx.devices)} placements")
            placements_on = [str(d) for d in ctx.devices]
            ops0 = p20_shard_ops(client)
            rates = {"20b": p20b_replicated(client, p20_rng(seed, "b")),
                     "20c": p20c_mbit(client, p20_rng(seed, "c")),
                     "20d": p20d_hll(client)}
            rates["20e"], cms_golden = p20e_cms(client, p20_rng(seed, "e"))
            shard_ops = p20_shard_ops(client) - ops0
            check(np.array_equal(shard_ops, ref["shard_ops_20b_20e"]),
                  f"21a: shard ops {shard_ops.tolist()} vs one placement's "
                  f"{ref['shard_ops_20b_20e'].tolist()}")
            check(bool((shard_ops > 0).all()), "21a: a shard took no ops")
            rows = p20_rows(client)
            check(set(rows) == set(ref["rows"]), "21a: the keyspace differs from phase 20's "
                                                 "20b-20e objects")
            for nm, row in ref["rows"].items():
                check(np.array_equal(rows[nm], row), f"21a: {nm} differs from phase 20's row")
            del rows
            bitop = p21a_bitop(client, np.random.default_rng([seed, 21]))
            check_healthy(client, 21)
            reshard = p20f_reshard(client, p20_rng(seed, "f"), cms_golden)
            k1_device = str(eng.registry.lookup("p20-cms0").pool.state.device)
            check(k1_device == str(ctx.devices[0]), f"21a: the carried CMS is on {k1_device}")
            check_healthy(client, 21)
        finally:
            client.shutdown()
    out = {"phase": "21a", "placements_on": placements_on, "device_indices": idx,
           "ops_per_s": {"20b_add": rates["20b"]["add_ops_per_s"],
                         "20b_contains": rates["20b"]["contains_ops_per_s"],
                         "20c": rates["20c"]["ops_per_s"],
                         "20d_pfadd": rates["20d"]["pfadd_ops_per_s"],
                         "20e_events": rates["20e"]["events_per_s"]},
           "ops_per_s_one_placement": {
               "20b_add": ref["20b"]["add_ops_per_s"],
               "20b_contains": ref["20b"]["contains_ops_per_s"],
               "20c": ref["20c"]["ops_per_s"], "20d_pfadd": ref["20d"]["pfadd_ops_per_s"],
               "20e_events": ref["20e"]["events_per_s"]},
           "shard_ops": shard_ops.tolist(), "rows_equal_one_placement": True,
           "change_topology_s": reshard["change_topology_s"],
           "k1_launches": reshard["k1_launches"], "k1_device": k1_device, **bitop,
           "seconds": time.perf_counter() - t0, "card": card}
    log(out)
    return out


def p21_inputs(seed: int) -> dict:
    """21b's stream inputs, made alike in every process from the seed."""
    rng = np.random.default_rng([seed, 21, 2])
    n, d_w = P21["x_objects"], P21["x_cms"]
    return {
        "outside": rng.integers(3 * P21["bloom_keys"], 8 * P21["bloom_keys"],
                                P21["outside"]).astype(np.uint64),
        "bs": [rng.integers(0, P21["nbits"], P21["bs_ops"]).astype(np.uint32)
               for _ in range(P21["bs_iters"])],
        "x_hll": [rng.integers(0, 1 << 40, P21["x_hll_keys"]).astype(np.uint64)
                  for _ in range(n)],
        "x_bs": [rng.integers(0, P21["x_bs_bits"], P21["x_bs_ops"]).astype(np.uint32)
                 for _ in range(n)],
        "x_cm": [zipf_keys(rng, P21["x_cms_events"], 4096) for _ in range(n)],
        "x_cm_d_w": d_w,
    }


def _digest(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:24]


def p21_warm(client) -> None:
    """One small call of every kind the phase times, on objects of its
    own: every shard body runs, so every placement's device has its
    context and kernels (and a group its communicator) before a clock
    starts."""
    keys = np.arange(1024, dtype=np.uint64)
    bf = client.get_bloom_filter("p21-wbf")
    bf.try_init(10_000, 0.01)
    bf.add_all(keys)
    bf.contains_each(keys)
    client.get_hyper_log_log("p21-whl").add_all(keys)
    client.get_bit_set("p21-wbs").set_many(np.arange(0, 1024, 3, dtype=np.uint32))
    cm = client.get_count_min_sketch("p21-wcm")
    cm.try_init(*P21["x_cms"])
    cm.add_all(keys)


def p21_stream(client, seed: int, snap: str) -> tuple:
    """21b's stream (config sizes): config 1 (2**20 keys at 1%, count()),
    config 2 (PFADD of 2**21 keys), config 3 (8 x 2**21 set ops on a
    2**30-bit m-sharded BitSet, cardinality()), then objects on every
    shard with a PFMERGE, a BITOP and a CMS.MERGE whose rows sit in both
    processes, and a snapshot; a warm-up of every kind first.  Returns
    (results, keys/s)."""
    inp = p21_inputs(seed)
    n, chunk = P21["bloom_keys"], P21["bloom_chunk"]
    res, rate = {}, {}
    p21_warm(client)
    bf = client.get_bloom_filter("p21-cfg1")
    check(bf.try_init(1_000_000, 0.01), "21b: try_init refused")
    t0 = time.perf_counter()
    added = [bf.add_all(np.arange(i, i + chunk, dtype=np.uint64)) for i in range(0, n, chunk)]
    rate["bloom_add"] = n / (time.perf_counter() - t0)
    res["bloom_added"] = int(sum(added))
    t0 = time.perf_counter()
    present = bf.contains_each(np.arange(n, dtype=np.uint64))
    rate["bloom_contains"] = n / (time.perf_counter() - t0)
    res["bloom_present"] = int(present.sum())
    res["bloom_outside"] = _digest(bf.contains_each(inp["outside"]))
    res["bloom_count"] = int(bf.count())
    h = client.get_hyper_log_log("p21-cfg2")
    t0 = time.perf_counter()
    res["hll_changed"] = bool(h.add_all(np.arange(P21["hll_keys"], dtype=np.uint64)))
    rate["hll_add"] = P21["hll_keys"] / (time.perf_counter() - t0)
    res["hll_count"] = int(h.count())
    bs = client.get_bit_set("p21-cfg3")
    res["bs_top"] = bool(bs.set(P21["nbits"] - 1))
    t0 = time.perf_counter()
    res["bs_prev"] = [_digest(bs.set_many(idx)) for idx in inp["bs"]]
    rate["bitset_set"] = P21["bs_iters"] * P21["bs_ops"] / (time.perf_counter() - t0)
    res["bs_card"] = int(bs.cardinality())
    d, w = inp["x_cm_d_w"]
    for i in range(P21["x_objects"]):
        client.get_hyper_log_log(f"p21-xh{i}").add_all(inp["x_hll"][i])
        client.get_bit_set(f"p21-xb{i}").set_many(inp["x_bs"][i])
        cm = client.get_count_min_sketch(f"p21-xc{i}")
        check(cm.try_init(d, w), "21b: try_init refused")
        cm.add_all(inp["x_cm"][i])
    client.get_hyper_log_log("p21-xh0").merge_with("p21-xh4", "p21-xh5")
    res["pfmerge_count"] = int(client.get_hyper_log_log("p21-xh0").count())
    client.get_bit_set("p21-xb5").and_op("p21-xb1")
    client.get_bit_set("p21-xb2").or_op("p21-xb4")
    res["bitop_card"] = [int(client.get_bit_set(f"p21-xb{i}").cardinality()) for i in (5, 2)]
    client.get_count_min_sketch("p21-xc1").merge("p21-xc4", "p21-xc5")
    res["cms_merged"] = _digest(client.get_count_min_sketch("p21-xc1").estimate_all(
        np.arange(4096, dtype=np.uint64)))
    client.snapshot(snap)
    return res, rate


def p21_golden(seed: int, client) -> None:
    """21b's one-process answers against the golden models."""
    from redisson_tpu_torch.executor.torch_executor import bloom_count_from_bitcount
    from redisson_tpu_torch.ops import golden
    from redisson_tpu_torch.utils import hashing

    inp = p21_inputs(seed)
    n = P21["bloom_keys"]
    bf = client.get_bloom_filter("p21-cfg1")
    g = golden_bloom(bf, np.arange(n, dtype=np.uint64))
    e = client._engine.registry.lookup("p21-cfg1")
    check(np.array_equal(tenant_row(client, "p21-cfg1"), p20_bloom_words(g, e.pool.row_units)),
          "21b: the Bloom row differs from the golden bitmap")
    m, k = bf.get_size(), bf.get_hash_iterations()
    check(bf.count() == bloom_count_from_bitcount(int(g.bits.sum()), m, k), "21b: count()")
    fp = bf.contains_each(inp["outside"])
    check(np.array_equal(fp, golden_contains(g, inp["outside"])), "21b: outside keys vs golden")
    p = (1.0 - np.exp(-k * n / m)) ** k
    check(abs(float(fp.mean()) - p) <= 3 * np.sqrt(p * (1 - p) / len(fp)), "21b: FPP")
    gh = golden.GoldenHyperLogLog()
    gh.add_hashed(*hll_lanes(np.arange(P21["hll_keys"], dtype=np.uint64)))
    check(np.array_equal(tenant_row(client, "p21-cfg2"), gh.regs), "21b: HLL registers")
    check(client.get_hyper_log_log("p21-cfg2").count() == gh.count(), "21b: HLL count()")
    bitmap = np.zeros(P21["nbits"] // 32, np.uint32)
    golden_set(bitmap, np.array([P21["nbits"] - 1]))
    for idx in inp["bs"]:
        golden_set(bitmap, idx)
    check(np.array_equal(tenant_row(client, "p21-cfg3"), bitmap), "21b: BitSet row")
    regs = []
    for i in (0, 4, 5):
        gx = golden.GoldenHyperLogLog()
        gx.add_hashed(*hll_lanes(inp["x_hll"][i]))
        regs.append(gx.regs)
    check(np.array_equal(tenant_row(client, "p21-xh0"), np.maximum.reduce(regs)),
          "21b: PFMERGE registers")
    xb = {}
    for i in range(P21["x_objects"]):
        xb[i] = np.zeros(P21["x_bs_bits"] // 32, np.uint32)
        golden_set(xb[i], inp["x_bs"][i])
    check(np.array_equal(tenant_row(client, "p21-xb5")[: len(xb[5])], xb[5] & xb[1]),
          "21b: AND across processes")
    check(np.array_equal(tenant_row(client, "p21-xb2")[: len(xb[2])], xb[2] | xb[4]),
          "21b: OR across processes")
    d, w = inp["x_cm_d_w"]
    total = np.zeros((d, w), np.uint64)
    for i in (1, 4, 5):
        gc = golden.GoldenCountMinSketch(d, w)
        h1w, h2w = hashing.km_reduce_mod(
            *hashing.hash128_np(*hashing.encode_uint64_batch(inp["x_cm"][i])), w)
        gc.add_hashed(h1w, h2w)
        total += gc.counts
    check(np.array_equal(tenant_row(client, "p21-xc1")[: d * w].reshape(d, w),
                         (total & 0xFFFFFFFF).astype(np.uint32)), "21b: CMS.MERGE")


def p21_child(base: str, cfg: dict) -> int:
    """One process of 21b: joins the group, runs the stream in lockstep
    with its peer, prints its line."""
    global P21_DEVICE
    P21.update(cfg["P21"])
    P21_DEVICE = cfg["device"]
    import torch.distributed as dist

    pid = cfg["pid"]
    client = p21_client(coalesce=False, coordinator_address=f"127.0.0.1:{cfg['port']}",
                        num_processes=2, process_id=pid)
    try:
        ready_s = time.time() - cfg["t_spawn"]
        ctx = client._engine.executor.ctx
        check(dist.get_world_size() == 2 and dist.get_rank() == pid, "21b: not in the group")
        check((ctx.lo, ctx.hi) == (4 * pid, 4 * pid + 4), f"21b: shards {ctx.lo}..{ctx.hi}")
        t0 = time.perf_counter()
        res, rate = p21_stream(client, cfg["seed"], os.path.join(base, f"p{pid}"))
        stream_s = time.perf_counter() - t0
        line = {"phase": "21b-child", "pid": pid, "backend": ctx.group.backend,
                "devices": [str(d) for d in ctx.devices], "shards": [ctx.lo, ctx.hi],
                "start_s": ready_s, "stream_s": stream_s, "keys_per_s": rate,
                "results": res, "nearcache_locked_off": client._engine.nearcache.locked_off}
    finally:
        client.shutdown()
    line["group_destroyed"] = not dist.is_initialized()
    log(line)
    return 0


def p21_snapshot(directory: str) -> tuple:
    with open(os.path.join(directory, "sketch_meta.json")) as f:
        meta = json.load(f)
    meta.pop("pools_crc")
    with np.load(os.path.join(directory, "sketch_pools.npz")) as z:
        return meta, {k: z[k] for k in z.files}


def p21b_processes(seed: int, card: str) -> dict:
    """21b: two children of this script join one group over 127.0.0.1 (gloo
    on one card, nccl with a card each), 4 of 8 global shards each, and
    run 21b's stream in lockstep; a one-process client on 21a's placements
    runs it meanwhile.  Both children's answers equal each other, the
    one-process client's and golden; both snapshots hold the one-process
    snapshot's pool arrays byte for byte."""
    t0 = time.perf_counter()
    repo = Path(__file__).resolve().parent
    os.makedirs(repo / "build", exist_ok=True)
    base = tempfile.mkdtemp(prefix="p21-", dir=str(repo / "build"))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(repo), GLOO_SOCKET_IFNAME="lo",
               NCCL_SOCKET_IFNAME="lo")
    procs = []
    try:
        for pid in (0, 1):
            cfg = json.dumps({"P21": P21, "device": P21_DEVICE, "pid": pid, "port": port,
                              "seed": seed, "t_spawn": time.time()})
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--p21-child", base,
                 "--p21-config", cfg], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env, cwd=str(repo)))
        # The one-process reference on 21a's placements, while they run.
        idx, enum = p21_slice()
        with p21_enumeration(enum):
            ref = p21_client(coalesce=False, device_indices=idx)
            try:
                want, one_rate = p21_stream(ref, seed, os.path.join(base, "one"))
                p21_golden(seed, ref)
            finally:
                ref.shutdown()
        outs, deadline = [], time.monotonic() + P21["child_timeout_s"]
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                fail(f"21b: a child ran past {P21['child_timeout_s']} s")
    finally:
        for p in procs:  # a hung or failed child takes its peer down
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = []
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        got = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
        child = next((x for x in got if x.get("phase") == "21b-child"), None)
        check(p.returncode == 0 and child is not None,
              f"21b: child {pid} exited {p.returncode}:\n{err[-6000:]}")
        lines.append(child)
    c0, c1 = lines
    check(c0["results"] == c1["results"], "21b: the two processes' answers differ")
    check(c0["results"] == want, f"21b: the processes' answers differ from one process's: "
                                 f"{c0['results']} vs {want}")
    check(c0["backend"] == c1["backend"] == ("nccl" if torch.cuda.device_count() >= 2
                                             and P21_DEVICE == "cuda" else "gloo"),
          f"21b: backend {c0['backend']}")
    check(all(c["nearcache_locked_off"] and c["group_destroyed"] for c in lines),
          "21b: a lockstep guard did not hold")
    one_meta, one_pools = p21_snapshot(os.path.join(base, "one"))
    for pid in (0, 1):
        meta, pools = p21_snapshot(os.path.join(base, f"p{pid}"))
        check(meta == one_meta, f"21b: process {pid}'s snapshot metadata differs")
        check(pools.keys() == one_pools.keys(), f"21b: process {pid}'s snapshot pools differ")
        for k in pools:
            check(pools[k].dtype == one_pools[k].dtype and pools[k].tobytes()
                  == one_pools[k].tobytes(), f"21b: process {pid}'s {k} differs")
    shutil.rmtree(base, ignore_errors=True)
    out = {"phase": "21b", "backend": c0["backend"],
           "devices": {str(c["pid"]): c["devices"] for c in lines},
           "start_s": {str(c["pid"]): c["start_s"] for c in lines},
           "stream_s": {str(c["pid"]): c["stream_s"] for c in lines},
           "keys_per_s": {str(c["pid"]): c["keys_per_s"] for c in lines},
           "keys_per_s_one_process": one_rate, "answers_equal": True,
           "snapshots_equal": True, "seconds": time.perf_counter() - t0, "card": card}
    log(out)
    return out


def phase_multidevice(seed: int, ref: dict, card: str) -> dict:
    """Phase 21: 21a (4 placements, one process) and 21b (two processes)."""
    t0 = time.perf_counter()
    a = p21a_placements(seed, ref, card)
    b = p21b_processes(seed, card)
    out = {"phase": 21, "seconds": time.perf_counter() - t0, "k1_launches": a["k1_launches"],
           "placements_on": a["placements_on"], "backend": b["backend"], "card": card}
    log(out)
    return out


# -- phase 22: the pre-hashed Bloom path and the host sketch engine ------------

P22 = {"keys": 1 << 20, "chunk": 1 << 18, "queries": 1 << 20, "outside": 1 << 17,
       "sharded_keys": 1 << 18, "shards": 8, "host_keys": 1 << 18, "host_B": 1 << 16,
       "host_iters": 8, "host_range": 1 << 19, "small_keys": 1 << 14,
       "small_bits": 4096, "cms": (4, 4096)}
P22_DEVICE = "cuda"


def p22_sync() -> None:
    if P22_DEVICE == "cuda":
        torch.cuda.synchronize()


def p22_client(**kw):
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    return rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch(
        device=P22_DEVICE, **kw))


def p22_hashed(keys: np.ndarray):
    """(H1, H2): the host murmur halves of LongCodec keys."""
    from redisson_tpu_torch.utils import hashing

    return hashing.hash128_np(*hashing.encode_uint64_batch(keys))


def p22_golden(H1, H2, m: int, k: int, chunk: int):
    """Bit indexes [n, k] of the keys, the sequential flags from an empty
    filter and the flags against the state before each chunk of
    ``chunk`` calls (``bloom_add_fast_st``'s)."""
    from redisson_tpu_torch.ops import golden
    from redisson_tpu_torch.utils import hashing

    idx = golden.GoldenBloomFilter(m, k)._indexes(*hashing.km_reduce_mod(H1, H2, m))
    idx = idx.astype(np.int64)
    n = idx.shape[0]
    first = np.full(m, n, np.int64)  # the first key to set each bit
    np.minimum.at(first, idx.reshape(-1), np.repeat(np.arange(n, dtype=np.int64), k))
    fk = first[idx]
    seq = np.any(fk == np.arange(n)[:, None], axis=1)
    pre = np.any(fk >= ((np.arange(n) // chunk) * chunk)[:, None], axis=1)
    return idx, seq, pre


def p22_words(idx: np.ndarray, row_words: int) -> np.ndarray:
    bits = np.zeros(row_words * 32, bool)
    bits[idx.reshape(-1)] = True
    return np.packbits(bits, bitorder="little").view(np.uint32)


def p22_arm(client, name: str, H1, H2, Q1, Q2, chunk: int) -> dict:
    """Config 1 through the engine's hashed bloom_add / bloom_contains in
    calls of ``chunk`` keys (all issued, then resolved); a warm-up filter
    of the same size class takes the first launches."""
    eng = client._engine
    for nm in (name + "-warm", name):
        check(client.get_bloom_filter(nm).try_init(1_000_000, 0.01), "try_init refused")
    eng.bloom_add(name + "-warm", H1[:chunk], H2[:chunk]).result()
    eng.bloom_contains(name + "-warm", Q1[:chunk], Q2[:chunk]).result()
    p22_sync()
    t0 = time.perf_counter()
    futs = [eng.bloom_add(name, H1[i:i + chunk], H2[i:i + chunk])
            for i in range(0, len(H1), chunk)]
    flags = np.concatenate([np.asarray(f.result(), bool) for f in futs])
    add_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    futs = [eng.bloom_contains(name, Q1[i:i + chunk], Q2[i:i + chunk])
            for i in range(0, len(Q1), chunk)]
    hits = np.concatenate([np.asarray(f.result(), bool) for f in futs])
    contains_s = time.perf_counter() - t0
    return {"flags": flags, "hits": hits, "add_ops_per_s": len(H1) / add_s,
            "contains_ops_per_s": len(Q1) / contains_s}


def p22a_card(rng, g, p2_row: np.ndarray, H1, H2) -> dict:
    """22a: config 1 through the hashed calls, the coalesced exact arm and
    the direct fast arm; flags, rows, contains and FPP against golden."""
    from redisson_tpu_torch.utils import hashing

    n, chunk = P22["keys"], P22["chunk"]
    m, k = g.size, g.hash_iterations
    idx, seq, pre = p22_golden(H1, H2, m, k, chunk)
    q = rng.integers(0, 2 * n, P22["queries"]).astype(np.uint64)
    outside = rng.integers(3 * n, 8 * n, P22["outside"]).astype(np.uint64)
    Q1, Q2 = p22_hashed(np.concatenate([q, outside]))
    want_hits = g.contains_hashed(*hashing.km_reduce_mod(Q1, Q2, m))
    p_theory = (1.0 - np.exp(-k * n / m)) ** k
    sigma = np.sqrt(p_theory * (1.0 - p_theory) / len(outside))
    out = {}
    for arm, kw, want in (("exact", {}, seq),
                          ("fast", {"exact_add_semantics": False, "coalesce": False}, pre)):
        client = p22_client(**kw)
        try:
            r = p22_arm(client, "c22", H1, H2, Q1, Q2, chunk)
            check(np.array_equal(r["flags"], want), f"22a {arm}: add flags differ from golden")
            check(np.array_equal(r["hits"], want_hits), f"22a {arm}: contains differ from golden")
            row = tenant_row(client, "c22")
            check(np.array_equal(row.view(np.uint32), p2_row.view(np.uint32)),
                  f"22a {arm}: the row differs from phase 2's encoded-path row")
            fpp = float(r["hits"][len(q):].mean())
            check(abs(fpp - p_theory) <= 3 * sigma,
                  f"22a {arm}: FPP {fpp} vs {p_theory} +- {3 * sigma}")
            check_healthy(client, 22)
            out[arm] = {"add_ops_per_s": r["add_ops_per_s"],
                        "contains_ops_per_s": r["contains_ops_per_s"], "fpp": fpp,
                        "in_batch_repeat_flags": int(np.sum(r["flags"] & ~seq))}
        finally:
            client.shutdown()
    out["fpp_expected"], out["fpp_3sigma"] = p_theory, 3 * sigma
    out["golden_idx"] = idx
    return out


def p22b_sharded(H1, H2, idx: np.ndarray, m: int, k: int) -> dict:
    """22b: the same calls on phase 20's 8-shard client (one placement):
    both arms route to the exact mixed op on the owner shard."""
    n = P22["sharded_keys"]
    _, seq, _ = p22_golden(H1[:n], H2[:n], m, k, n)
    out = {}
    for arm, kw in (("exact", {}), ("fast", {"exact_add_semantics": False, "coalesce": False})):
        client = p22_client(num_shards=P22["shards"], device_indices=[0], **kw)
        try:
            eng = client._engine
            check(eng.executor.S == P22["shards"], "22b: not the sharded executor")
            check(client.get_bloom_filter("c22s").try_init(1_000_000, 0.01), "try_init refused")
            flags = np.concatenate([
                np.asarray(f.result(), bool) for f in
                [eng.bloom_add("c22s", H1[i:i + n // 4], H2[i:i + n // 4])
                 for i in range(0, n, n // 4)]])
            check(np.array_equal(flags, seq), f"22b {arm}: add flags differ from golden")
            hits = np.asarray(eng.bloom_contains("c22s", H1[:n], H2[:n]).result(), bool)
            check(hits.all(), f"22b {arm}: a loaded key reads absent")
            row = tenant_row(client, "c22s")
            check(np.array_equal(row.view(np.uint32), p22_words(idx[:n], row.shape[0])),
                  f"22b {arm}: the row differs from golden")
            check_healthy(client, 22)
            out[arm] = True
        finally:
            client.shutdown()
    return out


def p22_small(client, rng_seed: int) -> dict:
    """One small HLL, BitSet and CMS (add_all_seq: K1 on the card) driven
    the same way on either engine; their answers."""
    rng = np.random.default_rng(rng_seed)
    h = client.get_hyper_log_log("s22-hll")
    h.add_all(np.arange(P22["small_keys"], dtype=np.uint64))
    bs = client.get_bit_set("s22-bs")
    idx = rng.integers(0, P22["small_bits"], 1000)
    prev = np.asarray(bs.set_many(idx))
    cms = client.get_count_min_sketch("s22-cms")
    d, w = P22["cms"]
    check(cms.try_init(d, w), "CMS try_init refused")
    est = np.asarray(cms.add_all_seq(zipf_keys(rng, P22["small_keys"], 1000)))
    return {"hll": h.count(), "bs_prev": prev.tolist(), "bs_card": bs.cardinality(),
            "bs_len": bs.length(), "bs_bytes": bs.to_byte_array(), "cms_seq": est.tolist(),
            "cms_hot": int(cms.estimate(np.uint64(1)))}


def p22_answers(client, suffix: str, probe: np.ndarray) -> tuple:
    """What each restored object answers."""
    bf = client.get_bloom_filter("host-bf" + suffix)
    bs = client.get_bit_set("s22-bs" + suffix)
    cms = client.get_count_min_sketch("s22-cms" + suffix)
    return (np.asarray(bf.contains_each(probe)).tolist(),
            client.get_hyper_log_log("s22-hll" + suffix).count(),
            bs.cardinality(), bs.length(), bs.to_byte_array(),
            np.asarray(cms.estimate_all(probe[:256] % 1000)).tolist())


def p22c_host() -> dict:
    """22c: the host engine on this machine's host in bench.py's
    measure_host_baseline shape, beside the card engine on the same
    sequence; small objects of the other kinds; DUMPs across engines."""
    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec

    host = rt.create(rt.Config().set_codec(LongCodec()).use_host_sketch())
    card = p22_client()
    try:
        check(type(host._engine).__name__ == "HostSketchEngine", "22c: not the host engine")
        draws = np.random.default_rng(0)
        probes = [draws.integers(0, P22["host_range"], P22["host_B"]).astype(np.uint64)
                  for _ in range(P22["host_iters"])]
        res, rate = {}, {}
        for tag, c in (("host", host), ("card", card)):
            bf = c.get_bloom_filter("host-bf")
            check(bf.try_init(1_000_000, 0.01), "try_init refused")
            added = np.asarray(bf.add_all_async(
                np.arange(P22["host_keys"], dtype=np.uint64)).result(), bool)
            if tag == "card":
                bf.contains_each(probes[0])  # the card's first launches
                p22_sync()
            t0 = time.perf_counter()
            hits = [np.asarray(bf.contains_each(p), bool) for p in probes]
            rate[tag] = P22["host_iters"] * P22["host_B"] / (time.perf_counter() - t0)
            res[tag] = (added, hits, p22_small(c, 22))
        (ha, hh, hs), (ca, ch, cs) = res["host"], res["card"]
        check(np.array_equal(ha, ca), "22c: add flags differ between the engines")
        check(all(np.array_equal(a, b) for a, b in zip(hh, ch)),
              "22c: contains differ between the engines")
        check(hs == cs, f"22c: HLL/BitSet/CMS answers differ: {hs} vs {cs}")
        names = ("host-bf", "s22-hll", "s22-bs", "s22-cms")
        for nm in names:  # each engine's dump into the other
            card._engine.restore(nm + "-from-host", host._engine.dump(nm))
            host._engine.restore(nm + "-from-card", card._engine.dump(nm))
        probe = probes[1]
        base = p22_answers(host, "", probe)
        check(p22_answers(card, "", probe) == base, "22c: the engines answer apart")
        check(p22_answers(card, "-from-host", probe) == base,
              "22c: the host dump restored on the card answers apart")
        check(p22_answers(host, "-from-card", probe) == base,
              "22c: the card dump restored on the host answers apart")
        check_healthy(card, 22)
    finally:
        card.shutdown()
        host.shutdown()
    return {"host_contains_ops_per_s": rate["host"],
            "card_contains_ops_per_s": rate["card"]}


def phase_hashed_host(g, p2_row: np.ndarray, seed: int, card: str) -> None:
    """Phase 22: 22a, 22b and 22c in order (see the module docstring)."""
    rng = np.random.default_rng([seed, 22])
    t0 = time.perf_counter()
    H1, H2 = p22_hashed(np.arange(P22["keys"], dtype=np.uint64))
    a = p22a_card(rng, g, p2_row, H1, H2)
    b = p22b_sharded(H1, H2, a.pop("golden_idx"), g.size, g.hash_iterations)
    c = p22c_host()
    log({"phase": 22,
         "22a_keys_per_s": {arm: {"add": a[arm]["add_ops_per_s"],
                                  "contains": a[arm]["contains_ops_per_s"]}
                            for arm in ("exact", "fast")},
         "22a_fpp": {arm: a[arm]["fpp"] for arm in ("exact", "fast")},
         "22a_fpp_expected": a["fpp_expected"], "22a_fpp_3sigma": a["fpp_3sigma"],
         "22a_fast_flags_beyond_sequential": a["fast"]["in_batch_repeat_flags"],
         "phase2_keys_per_s": {"add": RATES.get("add_ops_per_s"),
                               "contains": RATES.get("contains_ops_per_s")},
         "22b_rows_equal_golden": b,
         "22c_host_contains_keys_per_s": c["host_contains_ops_per_s"],
         "22c_card_contains_keys_per_s": c["card_contains_ops_per_s"],
         "22c_host_rate_of": "this machine's host CPU, one thread",
         "seconds": time.perf_counter() - t0, "card": card})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent-k1", metavar="SOURCE",
                    help="a K1 source with the one-warp-per-row interface, timed beside K1")
    ap.add_argument("--p10c-child", choices=("warm", "cold"), help=argparse.SUPPRESS)
    ap.add_argument("--p14-child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--p14-config", help=argparse.SUPPRESS)
    ap.add_argument("--p19-child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--p19-config", help=argparse.SUPPRESS)
    ap.add_argument("--p21-child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--p21-config", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.p21_child:
        return p21_child(args.p21_child, json.loads(args.p21_config))
    if args.p19_child:
        global P19_DEVICE
        cfg = json.loads(args.p19_config)
        P19.update(cfg["P19"])
        P19_DEVICE = cfg["device"]
        return p19_child(args.p19_child, args.seed)
    if args.p14_child:
        global P14_DEVICE
        cfg = json.loads(args.p14_config)
        P14.update(cfg["P14"])
        P14_DEVICE = cfg["device"]
        return p14_child(args.p14_child, args.seed)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.p10c_child:
        return p10c_child(args.p10c_child)

    import redisson_tpu_torch as rt
    from redisson_tpu_torch.codecs import LongCodec
    from redisson_tpu_torch.ops import _build, cms_seq

    t_run = time.perf_counter()
    dev = torch.device("cuda")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = nvidia_smi()
    build_s = _build.build(["cms_seq"])
    ptxas = _build.BUILD_LOG.get("cms_seq", "")
    log({"phase": 0, "device": name, "count": count, "nvidia_smi": card,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": build_s, "ptxas": [  # registers, shared memory, spills
             line.split("ptxas info    : ")[-1] for line in ptxas.splitlines()
             if "registers" in line or "spill" in line or "Compiling" in line]})
    rng = np.random.default_rng(args.seed)
    marks = [("0", t_run)]
    kernel = phase_k1(rng, dev, args.parent_k1)
    marks.append(("1", time.perf_counter()))

    # LongCodec: integer keys take the vectorized 8-byte encoding, as in
    # the JAX package's benchmark configs.
    client = rt.create(rt.Config().set_codec(LongCodec()).use_gpu_sketch())
    try:
        cms_seq.LAUNCHES = 0  # count the main path's launches only
        g = phase_bloom(client, rng, card)
        check_healthy(client, 2)
        p2_row = tenant_row(client, "cfg1")  # phase 22's hashed path must equal it
        RATES["tenants_ops_per_s"] = phase_tenants(client, rng)
        check_healthy(client, 3)
        phase_cms(client, rng, card)
        check_healthy(client, 4)
        kernel["launches"] = cms_seq.LAUNCHES
        by_phase = kernel["launches_by_phase"] = {"2-4": cms_seq.LAUNCHES}
        check(kernel["launches"] > 0, "the main path never launched K1")
        phase_hll(client, rng, card)
        check_healthy(client, 5)
        phase_bitset(client, rng, card)
        check_healthy(client, 6)
        cms_seq.LAUNCHES = 0  # phase 8's path, counted on its own
        phase_lifecycle(client, rng, g, args.seed, card)
        check_healthy(client, 8)
        marks.append(("2-8", time.perf_counter()))
        check(cms_seq.LAUNCHES > 0, "phase 8 never launched K1")
        kernel["launches"] += cms_seq.LAUNCHES
        by_phase["8"] = cms_seq.LAUNCHES
    finally:
        client.shutdown()
    phase_interleaved(rng)
    marks.append(("7i", time.perf_counter()))
    cms_seq.LAUNCHES = 0  # phase 9's path, counted on its own
    phase_failover(rng, args.seed, card)
    marks.append(("9", time.perf_counter()))
    check(cms_seq.LAUNCHES > 0, "phase 9 never launched K1")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["9"] = cms_seq.LAUNCHES
    cms_seq.LAUNCHES = 0  # phase 10's path, counted on its own
    phase_tiers(rng, card)
    marks.append(("10", time.perf_counter()))
    check(cms_seq.LAUNCHES > 0, "phase 10 never launched K1")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["10"] = cms_seq.LAUNCHES
    phase_frontdoor(rng, args.seed, card)
    marks.append(("11", time.perf_counter()))
    cms_seq.LAUNCHES = 0  # phase 12's path: the bridge takes cms_add, not K1
    phase_grid(card)
    marks.append(("12", time.perf_counter()))
    by_phase["12"] = cms_seq.LAUNCHES
    check(by_phase["12"] == 0, "phase 12's bridge launched K1")
    cms_seq.LAUNCHES = 0  # phase 13's path: K1 through the executor service
    phase_services(rng, card)
    marks.append(("13", time.perf_counter()))
    check(cms_seq.LAUNCHES > 0, "phase 13 never launched K1")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["13"] = cms_seq.LAUNCHES
    cms_seq.LAUNCHES = 0  # phase 14's path: K1 under the journal and on a recovered row
    phase_durability(args.seed, card)
    marks.append(("14", time.perf_counter()))
    check(cms_seq.LAUNCHES > 0, "phase 14 never launched K1")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["14"] = cms_seq.LAUNCHES
    cms_seq.LAUNCHES = 0  # phase 15's path: K1 under the dispatch records
    phase_telemetry(rng, args.seed, card)
    marks.append(("15", time.perf_counter()))
    check(cms_seq.LAUNCHES > 0, "phase 15 never launched K1")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["15"] = cms_seq.LAUNCHES
    cms_seq.LAUNCHES = 0  # phase 16's path: scripts and the front door take no K1
    phase_scripting_frontdoor(rng, args.seed, card)
    marks.append(("16", time.perf_counter()))
    by_phase["16"] = cms_seq.LAUNCHES
    check(by_phase["16"] == 0, "phase 16 launched K1")
    cms_seq.LAUNCHES = 0  # phase 17's path: K1 on a CMS row moved between nodes
    phase_cluster(rng, args.seed, card)
    marks.append(("17", time.perf_counter()))
    check(cms_seq.LAUNCHES > 0, "phase 17 never launched K1")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["17"] = cms_seq.LAUNCHES
    cms_seq.LAUNCHES = 0  # phase 18's path: K1 on a CMS row the rebalancer moved
    phase_rebalance(rng, card)
    marks.append(("18", time.perf_counter()))
    check(cms_seq.LAUNCHES > 0, "phase 18 never launched K1")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["18"] = cms_seq.LAUNCHES
    # Phase 19's path runs in a child under the armed witness: its K1
    # launches are the child's count, reported on its line.
    p19 = phase_witness(args.seed, card)
    marks.append(("19", time.perf_counter()))
    check(p19["k1_launches"] > 0, "phase 19 never launched K1")
    kernel["launches"] += p19["k1_launches"]
    by_phase["19"] = p19["k1_launches"]
    cms_seq.LAUNCHES = 0  # phase 20's path: none while sharded, K1 after change_topology(1)
    p20 = phase_sharded(args.seed, card)
    marks.append(("20", time.perf_counter()))
    check(cms_seq.LAUNCHES > 0, "phase 20 never launched K1 after the reshard")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["20"] = cms_seq.LAUNCHES
    cms_seq.LAUNCHES = 0  # phase 21's path: none on 4 placements, K1 after change_topology(1)
    phase_multidevice(args.seed, p20, card)
    del p20
    marks.append(("21", time.perf_counter()))
    check(cms_seq.LAUNCHES > 0, "phase 21 never launched K1 after the reshard")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["21"] = cms_seq.LAUNCHES
    cms_seq.LAUNCHES = 0  # phase 22's path: K1 on 22c's small CMS on the card
    phase_hashed_host(g, p2_row, args.seed, card)
    del g, p2_row
    marks.append(("22", time.perf_counter()))
    check(cms_seq.LAUNCHES > 0, "phase 22 never launched K1")
    kernel["launches"] += cms_seq.LAUNCHES
    by_phase["22"] = cms_seq.LAUNCHES
    log({"phase": "all", "seconds": time.perf_counter() - t_run,
         "by_phase_s": {n: t - marks[i][1] for i, (n, t) in enumerate(marks[1:])}})
    log({"kernels": [kernel]})
    print(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
