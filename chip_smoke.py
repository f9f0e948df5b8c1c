#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's main paths at the size the project names, a seeded
1 GiB RS 10+4 volume of real needles, through the entry points a user
calls (`ec_encode_volume`, `rebuild_ec_files`, `EcVolume`,
`ec_decode_volume`, `TorchBackend`, `CpuBackend`, `rebuild_from_peers`,
`VolumeServer`, `MasterServer`, `python -m seaweedfs_tpu_torch.server
master|volume`).
Phases:

1. print the card (`nvidia-smi` name and power limit), and build from
   csrc/ the CUDA kernel (nvcc) and the host library (g++: CRC32C,
   batched reads, the shard sink, the GF(2^8) apply of the native CPU
   backend), both at once; then print the host's CPU model and count,
   whether it has AVX2 and the host library's pool threads;
2. hold `gf2_apply` (the bit-major entry point) against its plain torch
   version on the card with the 4-row encode matrix and a 2-row decode
   matrix, at ragged widths, at the widths on its tiles' edges and on
   data 1 byte off alignment (the masked byte path), and against the
   numpy oracle on a sampled 64 KiB window (tolerance 0: exact integer GF
   arithmetic), and at k = 1 with one generator column of 10+4 (m = 4)
   and of 4+2 (m = 2), the streaming encoder's parity delta, at widths
   under, on and past one 16-byte word; time it at the encode and rebuild
   shapes, (10, 1 MiB) and (10, 16 MiB) with each matrix, and at the
   stream's (1, 256 KiB) and ragged (1, 8 KiB + 5), beside the plain version,
   torch._int_mm on the same bit-plane product (a yardstick the port
   never calls), a device copy that moves the same bytes (the memory
   stream's time under the same method), and the host time of one
   wrapper call, and the native CPU backend's apply of the same bytes on
   the host (`cpu_ms`, a median of host-timer runs after a warm-up; its
   output must equal the kernel's);
2b. the same for `gf2_apply_planes` (the plane-stack entry point) with
   m = 1, 2 and 4 at m_pad 32 (pack_width 1) and 16 (pack_width 2), also
   at the widths on its tiles' edges and on misaligned data; timed at
   m = 1 at the read path's widths, (10, 64 KiB), (10, 256 KiB),
   (10, 1 MiB) and the decode's (10, 16 MiB), beside `gf2_apply` (the
   table body) on the bit-major expansion of the same coefficients at
   (10, 1 MiB) and (10, 16 MiB), m = 1, timed in the same run;
3. write a seeded 1 GiB .dat of real version-3 needles (about 1 MiB
   random bodies, real CRC32C and append time) and its .idx;
4. encode through the native byte plane; every shard must verify
   against the new .ecsum, sampled parity windows must equal the
   oracle's, the kernel's launch count must equal the batch count, and
   so must the native batched reads, the fused sink's appends and the
   batches that `to_device` sent from their page-locked landing matrix
   without a copy; the landing pool may hold no more matrices than the
   pipeline has batches in flight. The same .dat is encoded once more
   with SEAWEED_EC_NATIVE=0 (the Python plane): its 14 shards must be
   sha256-identical and its block and leaf CRC lists equal;
5. delete shards 3 and 11 and rebuild; the rebuilt files must be
   sha256-identical to the deleted ones, and every batch must have come
   through one native read (CRCs rolled inline), the fused sink and a
   page-locked landing matrix;
6. degraded needle reads with `EcVolume(..., TorchBackend(ctx,
   impl="cuda_planes"))` and data shard 3 unmounted: every needle that
   touches shard 3 must read back bit-exact, cached re-reads must launch
   nothing and read no shard-3 sibling bytes, reads that avoid shard 3
   must launch nothing, a needle over a flipped byte of shard 5 must heal
   through verified reconstruction, the planes kernel's launch count
   must equal the reconstructions that missed the cache, and each of
   those must have read k siblings through the native plane;
6b. scrub with crash-safe leaf repair, on the same volume with every
   shard back in place: a clean `scrub_ec_volume` pass (wall s, GB/s of
   shard bytes verified, no launch); then bytes flipped in three leaves
   of data shard 3 (two of them adjacent) and one of parity shard 12 are
   found, rebuilt from k verified siblings through `gf2_apply` (one
   launch per leaf range) and patched in place under the repair journal,
   with nothing quarantined; then each journal window (and a crash of
   recovery itself) is hit in a child process that reconstructs on the
   card and dies with exit code 137, and the next `EcVolume` mount must
   replay or roll back its journal to a shard that is fully new (or
   fully old where the window allows it), with the needles over the
   patched leaves read back bit-exact; a closing scrub leaves shard 3
   bit-exact; last, shard 5 cut by 4 KiB is quarantined to `.bad` and
   rebuilt through `gf2_apply` and the native plane, sha256-identical.
   Every shard ends sha256-identical to its encode-time bytes;
7. `ec.decode` after 5 deletions, with shard 3 removed: the regenerated
   shard, the .dat (the original cut to the live extent) and the .idx
   must be identical to what they should be, the planes kernel must
   have launched once per rebuild batch, and the rebuild's and the
   de-stripe's reads must have gone through the native plane;
7a. streaming EC: the first 256 MiB of the same .dat appended in 8 KiB
   pieces to an `EcStreamEncoder` (10+4, 1 MiB blocks, 64 KiB small
   blocks), flushed whenever 256 KiB is pending, closed with finalize:
   the 14 shards must be sha256-identical to one `write_ec_files` over
   the same bytes, with equal CRC lists, and `gf2_apply` must have
   launched once per chunk processed plus once per finalize tail stripe;
   it prints time-to-durable-parity p50/p99 per append, appends/s, the
   batch encode's wall, the stage tables, the device's busy share and
   the launches on each body;
7b. the MQ durable-parity partition: `PartitionParity` at the broker's
   defaults (4+2, 1 MiB blocks, flush at 256 KiB or 200 ms, rotation at
   64 MiB) takes 144 MiB of 1 KB records (16-byte keys) at 50,000
   records/s while a flusher thread applies the policy every 100 ms;
   closed and recovered by a fresh partition, every record must come
   back byte-exact, no parity may be rewritten, and recovery must launch
   once per stripe it re-derives. Then, for `ec.stream.seal`,
   `ec.stream.before_fsync` and `ec.stream.before_journal`, a child
   partition appending 8 MiB of the same records dies at the point
   (exit code 137; a fresh interpreter, as `fork` does not mix with
   CUDA), and the parent must recover a dense, byte-exact prefix reaching
   the child's last completed flush, verify every generation clean on a
   second pass, and append densely after it.
8. the native CPU backend (`CpuBackend`, the host library's AVX2 GF(2^8)
   apply) on the card's host, each run beside its card counterpart and
   on the same inputs (hard links to what it only reads, copies of what
   it writes): encode of the same .dat through the native byte plane
   (14 shards sha256-identical to the card's, CRC lists equal), rebuild
   of the same lost shards (sha256-identical), every degraded needle of
   phase 6 read cold through `EcVolume(..., backend=CpuBackend(ctx))`
   (bit-exact), and decode of the same state (.dat, .idx and the
   regenerated shard identical to the card's). No kernel may launch
   during a CpuBackend run. One line gives each operation's card and CPU
   walls, their ratio and both stage tables (the CPU's are host wall
   time: its "kernel" is the wall of its applies, and it has no pin,
   h2d or d2h), beside the card and the host's CPU.
9. the flight recorder (seaweedfs_tpu_torch/utils/trace.py) armed, the
   only phase that arms it, in a directory of hard links to the same .dat
   and .idx: encode (two armed runs between two disarmed ones, for the
   tracer's cost), rebuild of shards 3 and 11, 20 cold degraded reads of
   shard 3 (the `.heat` sidecar written at close must hold the reads'
   counters, and a fresh mount must read them back), one rotten leaf of
   shard 3 leaf-repaired, decode with shard 3 removed, a 32 MiB phase 7a
   stream and phase 7b's partition at its own traffic for at least 4
   flushes; every output sha256-identical to its disarmed counterpart
   (stream records replayed byte-exact). Then `trace.traces()` must hold
   one root per op, as `sw_ec_traces_total{op}` counts, every span tree
   the JAX package's invariants (one trace id, children inside their
   root, no stage but queue_wait longer than its span), the device
   stages (`admission_wait`, `h2d_dispatch`, `device_drain`) one per
   launch, labeled as the JAX package's call sites label them (a
   `TorchBackend` has no chip label, so its scheduled dispatch carries
   its device queue's label), every overlap efficiency in [0, 1], the
   registry's text parse line by
   line with the leaf repair counted, and the Chrome trace load. One line
   gives each op's wall, stage totals and counts and overlap efficiency,
   the armed over the disarmed encode wall, the partition's stage ms per
   flush beside phase 7b's solo flush and the share of flush wall no
   stage names, and the Chrome trace's event count.
10. the device scheduler and the CPU failover, on the same .dat (hard
   links) with every path a client of the per-chip `DeviceQueue`:
   10a the bounded device probe (`utils/devices.py`, a subprocess) and
   its wall, and `get_backend("auto", 10, 4)`, which must be a
   `FallbackBackend` over a `TorchBackend` on cuda:0 with no CPU
   resolution counted; 10b an encode through it: 14 shards
   sha256-identical to phase 4's, no batch on the CPU, the breaker and
   its gauge closed, one launch and one foreground admission
   (`sw_ec_queue_admitted_total`) per batch; 10b' the scheduler's cost:
   the same encode and 30 cold degraded reads of shard 3 with the scope
   disabled and enabled, in turns (off, on, on, off) in one process,
   outputs identical, admissions only when enabled; 10c failover armed by the
   smoke itself: an encode with every `to_host` failing
   (`ec.backend.device.to_host`, threshold 3, a short reset timeout) is
   sha256-identical with every batch recomputed on the CPU, the launches
   equal the batches that reached the card, the gauge reads 1 while the
   breaker is open; after the timeout an unarmed encode closes the
   breaker through its half-open probe; a rebuild of shards 3 and 11
   through the staged-apply driver on a card that loses three batches
   (two at `apply_staged`, before they launch, one at `to_host`, after;
   an OSError each, raised by a `TorchBackend` subclass of the smoke,
   since an armed fault registry sends rebuild down the chaos byte path)
   is sha256-identical, with those three batches on the CPU, the
   breaker closed and the launches equal to the batches that reached the
   card; 10d a foreground encode alone, then again
   beside a concurrent `priority="recovery"` rebuild of shards 3 and 11
   on the same `auto` backend under one `QueueScope`: both outputs
   sha256-identical, per-class admitted batches, cost and admission
   wait, both foreground walls and the ratio the JAX package's bar reads
   (an observation); 10e a 32 MiB phase 7a stream through
   `place_stream` (its and its batch encode's foreground admissions
   equal their launches) and phase 7b's partition with
   `SEAWEED_EC_STREAM_BACKEND=auto` for at least 4 flushes, replayed
   byte-exact. Any batch served on the CPU, or any CPU resolution of
   `auto`, outside 10c fails the run; in 10c the count must equal what
   the smoke injected.
11. peer-fetch rebuild (`rebuild_from_peers`) over the shard net plane,
   from copies made right after phase 5: a local holder of shards 0, 1,
   2 and 4 (fewer than k; two non-adjacent 64 KiB leaves of shard 4
   rotten) and three peers in one child process (a fresh interpreter
   that touches no CUDA), a `ShardNetPlane` each with its own generation
   fence, one holder per shard of 5-10, 12 and 13, plus a fourth holder
   of shard 5, first in its list, serving one flipped byte outside shard
   4's rotten leaves. 11a, native plane (`fetch_into` =
   `make_fetch_into`, `fetch` = `NetPlaneClient.read_bytes`): shard 4
   leaf-repaired from 7 peers and 3 local sources per range with no
   re-read, the rotten holder excluded after one granule re-read, shards
   5-10 fetched, 3 and 11 rebuilt on `TorchBackend`, all sha256-identical;
   `gf2_apply` launches == the rebuild's batches + the 2 leaf ranges; the
   `sw_net_bytes_received_total` deltas exact per plane; no staging and
   no no-plane memo left. 11b: the same over the Python plane, outputs
   identical. 11c: two peers stopped, fewer than k sources reachable:
   `ECError`, every local file sha256-unchanged. One line gives per run
   the wall, the nested rebuild's wall, the fetched bytes and GB/s over
   loopback, each transport's calls, bytes and seconds, the backend's
   stages and the `sw_net_*` deltas, the peers' status and whether a 4
   MiB fused recv takes the overlapped core.

12. remote stream shards: phase 7b's partition and traffic with a mounted
   root and a net-plane root (blob writes to a peer in a child process).
13. phase 3's needles through a `Store`, encoded on the card, read
   degraded through it, one leaf repaired by `ScrubDaemon`.
14. the volume server (`seaweedfs_tpu_torch.server.VolumeServer`,
   ec_backend="cuda") in this process on loopback: 14a phase 3's needles
   POSTed as multipart uploads into one volume and the first 256 MiB
   written into another with `NetPlaneClient.write_needle`, each read
   back bit-exact (GET, `read_needle`), the two volumes' records equal
   with the append time normalised; 14b the first volume sealed and
   encoded on the card through the server's scheduler (launches ==
   batches, every shard verified), mounted as an EC volume with shard 3
   unmounted; 14c every needle over shard 3 read with GET, cold from one
   client (p50/p99) and then by 8 clients (requests/s, no 503), launches
   == reconstructions, none on a read that avoids shard 3; HEAD, a Range
   (206) and a range past the end (416); 14d deletes (202, then 404), the
   answers of a server without a master to a replicated write (refused)
   and an EC delete (the failed holder lookup), /status, /metrics,
   /debug/slo and /debug/gateway, and a needle-read frame built by hand,
   as a JAX client sends it.
15. the cluster half (`VolumeServer(master=...)`: the gRPC service,
   heartbeats, the replica fan-out, the remote shard reader, peer-fetch
   rebuild with its hand-off) at full width: a port `MasterServer` and
   four port servers on the card in this process, every EC step an RPC
   over gRPC. The 1 GiB volume (hard links) is mounted and encoded on A (103
   `gf2_apply` launches, shards sha256-identical to phase 4's), its shards
   4-13 copied to B, C and D over the net plane (one again over CopyFile),
   shard 3 unmounted and every needle over it read cold at A with its
   siblings mostly remote (`gf2_apply_planes` launches ==
   reconstructions), shards 3 and 11 lost and rebuilt from peers at A
   (launches == rebuild batches) and handed to their planned holders
   (sha256-identical to phase 5's, advertised once each), 256 MiB of phase
   3's needles POSTed to a `001` volume on A with plane and then gRPC
   replica legs (B's records equal), 5 EC deletes journaled on every
   holder, every holder scrubbed, and the data shards gathered on B and
   decoded there to the original .dat. One JSON line gives each step's
   wall, GB/s and launches.
16. the admin RPCs of plain volumes and the launcher, on the same 1 GiB
   volume (hard links) under a port master child started by name
   (`python3 -m seaweedfs_tpu_torch.server master -mdir ...`): server A
   built in this process by the launcher's `build` (`-ec.backend cuda`),
   B and C child processes started by name (`python3 -m
   seaweedfs_tpu_torch.server volume`). 16a VolumeMount and ReadVolumeFileStatus on A; 16b
   VolumeMarkReadonly, VolumeCopy into B (files sha256-equal),
   VolumeMarkWritable; 16c 64 MiB of new needles POSTed to A and 5
   deleted, B's VolumeTailReceiver from A (.dat and .idx identical),
   VolumeIncrementalCopy (A's .dat suffix); 16d a tenth of the needles
   deleted and VacuumVolume (the bytes reclaimed and the revision
   expected, every live needle read back); 16e ScrubVolume clean on A and
   naming the one needle flipped on B; 16f VolumeCopy into C,
   VolumeTierUpload to a small object endpoint, 20 GETs from the tier,
   VolumeTierDownload (the .dat sha256-equal); 16g the port shell's
   `ec.encode -backend cuda` in this process (`run_command`; readonly on
   every holder, generate on the holder the master lists first: launches
   there == batches, read from a child's /debug/kernels where the holder
   is B or C; mount; the source deleted at every holder) and every needle
   over shard 3 read degraded with GET at that holder (launches ==
   reconstructions). One JSON line per step; each child's
   start-to-first-heartbeat seconds.
17. a cluster of the port alone, every process a child started by name:
   three masters as one raft group (`master -peers ... -mdir ...`) and
   four volume servers on two racks (`volume -master <the group>`, the
   default `-ec.backend`, cuda). Phase 3's needles are written through
   the leader's /dir/assign and POST until the one volume the first
   Assign grew holds about 1 GiB, and read back from its holder; a `001`
   set is read back from both holders /dir/lookup names; one port shell
   child (`python3 -m seaweedfs_tpu_torch.shell -master <the group>`, fed
   on its standard input) runs `ec.encode` (`gf2_apply` launches at the
   holder it names == batches; the .dat deleted) and `ec.balance` (every
   shard once at the leader, on both racks, sha256-equal); the leader is
   killed with SIGKILL, a new one must be elected, list all 14 shards and
   grow a volume whose id was never handed out; a server other than the
   holder, with one to four shards and a data shard among them, is
   stopped and a seeded sample of the needles over its data shards is
   read degraded at the holder (`gf2_apply_planes` launches == its
   interval-cache loads), byte-equal to what was written; then the same
   shell runs `ec.check.replication` (the stopped server's shards
   missing), `ec.rebuild -fromPeers` (`gf2_apply` launches at the
   rebuilding holder == its batches, sha256-equal), `ec.scrub` (clean),
   `ec.decode` (the encoded .dat and .idx back, no launch) and `upload`
   / `download` of a seeded file. The children's launches come from
   their /debug/kernels. One JSON line with each step's walls and rates,
   the failover seconds, the launches and the card. 17k, last, drives
   the filer on the same cluster in this process: two port `Filer`s (an
   SSTableStore and a SqliteStore, each with a `MetaLog` and a
   `FilerGrpcService` on a `grpc.server`), B following A through a
   `MetaAggregator`; small, chunked and manifest files written through
   A; gRPC lookup, list, rename, hard link, KV, `LockRange` and a
   `DeleteEntry` whose needles answer 404; B converges on A; the shell's
   `ec.encode` seals the filer's volume (launches == batches), data
   shard 0 is unmounted and every file reads back through B sha256-equal
   (planes launches == the holder's reconstructions); SubscribeMetadata
   from 0 gives every event A logged. Its own JSON line. 17l drives the
   filer server, a `filer` child by name started at 17k's beginning (its
   start overlaps 17k) with `-notify.webhook` at a sink in this process:
   through its HTTP plane a multipart PUT, a chunked-TE PUT, a TUS upload
   in three PATCHes, raw PUTs, inlined files, `mv.from` and a recursive
   DELETE; the shell's `ec.encode` seals its volume (launches ==
   batches), data shard 0 is unmounted and every file reads back through
   the child, whole and in ranges, sha256-equal (planes launches == the
   holder's reconstructions); the sink's events equal `/~meta/tail`'s;
   the shell's fs.ls, fs.du, fs.verify, volume.fsck and
   cluster.lock.ring in this process answer what was written, with a
   lease through `DlmClient` at the child. Its own JSON line. 17m drives
   S3's libraries and the shell's `s3.*` over a filer pair in this
   process (A served over gRPC where the shell dials a filer, B following
   A): identities, keys and a policy made by the shell and read back
   through `FilerIdentityStore` (SigV4, a presigned URL, tampered and
   stale requests refused with the JAX codes, policy verdicts, an STS
   credential until its expiry); about 16 MiB of objects in the bucket's
   collection under SSE-S3, SSE-C, aws-chunked and versioning; quotas;
   the shell's `ec.encode` (launches == batches), data shard 0 unmounted
   and every object read back through B decrypted, sha256-equal (planes
   launches == the holder's reconstructions); `s3.clean.uploads` and
   `s3.bucket.delete -force`. Its own JSON line. After 17, the offline
   tools (`tools fix|scan|export|compact`, `scaffold`) run as children
   on a copy of 17j's volume.
18. a TLS cluster: a `server -tls.cert -tls.key -tls.ca` child (mutual
   TLS) started before the tools; needles POSTed over https, the port
   shell's `ec.encode` (launches at the child == batches), a data shard
   unmounted and degraded GETs over https byte-exact (planes launches ==
   the child's reconstructions); clients without a certificate or on
   plaintext refused.
19. the S3 gateway by name: a `server -filer -s3 -s3Config` child (a
   master, a volume server on the card, a filer and the gateway in one
   process) started beside phase 18's; identities an admin, a user who
   may read and list, and an STS role. Every request is signed with the
   port's `s3/auth` over one keep-alive `RedialConnection`. 19.1 the
   bucket, anonymous and read-only PUTs refused (AccessDenied), a
   tampered signature (SignatureDoesNotMatch), an AssumeRole credential
   writing under its prefix; 19.2 about 32 MiB of objects: signed PUTs,
   an aws-chunked PUT, a 5 + 5 + 1 MiB multipart upload completed by
   splicing, a CopyObject, SSE-S3 and SSE-C PUTs, a POST-policy upload,
   inlined objects and, under versioning, one key written three times and
   given a delete marker; 19.3 ListObjectsV2 paged by continuation
   tokens, HEADs, whole and ranged GETs, a 304, a presigned GET and a
   `?versionId` read; 19.4 the port shell's `ec.encode` of the bucket's
   volumes (launches at the child == batches), data shard 0 unmounted,
   every object read through the gateway whole and in a range,
   sha256-equal (planes launches == the child's interval-cache loads);
   19.5 a lifecycle rule expiring lc/ through the filer's RunLifecycle;
   19.6 DeleteObjects of every version and marker, the directories left
   removed through the filer's HTTP API, the bucket deleted and its
   collection gone from the master. The child must exit 0 on SIGTERM.
   Its own JSON line: the child's seconds from spawn to serving S3, each
   step's wall, PUT MB/s, GET p50 / p99 per object before and after the
   seal, the launches and the redials.
19b. S3 Tables and the Iceberg REST catalog, the IAM API, OIDC and LDAP
   on phase 19's child, whose `-s3Config` also names an OIDC provider
   (RS256, the key made here) and an LDAP provider (the port's
   `MiniLdapServer`, run in this process): a user, its key and its
   policy through the IAM API; a table bucket, a namespace and a table;
   8 data files of 4 MiB and a tail PUT with the minted key, one snapshot
   commit each, a multi-table transaction and a view; an
   `AssumeRoleWithLdapIdentity` credential writing under ldap/ and a
   wrong password refused; the shell's `ec.encode` of the table bucket's
   collection (launches == batches); data shard 0 unmounted, loadTable
   answering the last commit, every metadata and data file read with an
   OIDC bearer whole and in a range, sha256-equal, a forged and an
   expired bearer refused (planes launches == reconstructions); the
   maintenance route expiring old snapshots; the key deleted and
   refused, the catalog torn down and the collection gone. Its JSON line:
   each step's wall, PUT MB/s, GET p50 / p99, the launches.
19c. remote storage and replication between phase 19's child (cluster A,
   its gateway the "cloud") and `ClusterB` (a port master, a volume
   server on the card and a filer server in this process, started while
   19 and 19b run): a bucket of 12 objects of 1-5 MiB and 1,050 small ones
   PUT through A's gateway and sealed at A (launches == batches), data
   shard 0 unmounted; the port shell at B mounts it (`remote.configure`,
   `remote.mount`: every object mapped, the listing paged) and reads it
   through B's filer whole and in ranges, sha256-equal, each read through
   A's degraded gateway; keys added, overwritten and deleted through the
   gateway and counted by `remote.meta.sync`; `remote.cache` of the large
   files; three `python3 -m seaweedfs_tpu_torch.replication` children
   from A's filer `/src` to B's filer, to `s3://<A's gateway>/mirror/pfx`
   and to a local directory, each copy and a tail of writes, an
   overwrite, a rename and deletes sha256-equal, each child exiting 0 on
   SIGTERM with its state at A's last event; B sealed (launches ==
   batches), data shard 0 unmounted at B, the cached files and B's copy
   of /src read sha256-equal; `remote.uncache`, `remote.unmount` and
   `remote.mount.buckets`; a worker child with `-capabilities iceberg`,
   whose `task.submit -kind iceberg` leaves the table its current
   snapshot alone. Planes launches == reconstructions at each cluster.
   Its JSON line: each step's wall, the objects mounted, the meta.sync
   counts, remote-read p50 / p99 beside cached reads, the replication
   lags, the children's start times, the launches and the redials.

20. the MQ broker by name on phase 19's child. Behind 19b and 19c:
   `fs.configure` sends the child's /topics/ to collection mqseg, an
   `mq.broker -filer <the child's filer> -parityDir -statusPort
   -kafkaPort` child (SEAWEED_MQ_GROUP_COMMIT_MS=10) serves with no
   torch loaded (its `/debug/kernels`), and the first
   durable-parity ConfigureTopic (bench/omb, 4 partitions) loads torch
   inside the RPC. 20a: 24,576 of phase 7b's 1 KB records published by
   4 threads, each with its own `MqClient`, while group g1 follows every
   partition, checks every delivery and commits every 1,024; each
   partition seals one 4,096-record segment into the filer and keeps
   2,048 records that only its parity stream holds. 20b: the port
   shell's 8 `mq.*` answering `mq20_shell_steps` line for line (the CPU
   twin test holds both packages to the same lines). 20f: the Kafka
   topic kafka/k20 (durable parity, 2 partitions) created through the
   gateway by the port's `KafkaClient`, 12,288 of phase 7b's records
   produced in requests of 128 with acks=-1 from 2 connections, gzip,
   snappy, lz4, none and zstd (where the host has `zstandard`) in turn,
   each ack held by the broker's group commit; group kg joins, syncs,
   fetches every record byte-exact and commits; group-commit windows
   between 1 and the produce requests, `/status` with `kafka_pool`. 20c:
   every stream drained, `ec.encode` of mqseg at the child (launches ==
   batches), data shard 0 unmounted, 20f's final cohort of 256 acked
   records and the broker SIGKILLed within 50 ms of its last ack, then
   spawned again by name: every record back through Subscribe and every
   acked Kafka record through Fetch (the spool), dense and byte-exact, the sealed
   segments through the filer with shard 0 gone (planes launches at the
   child == its reconstructions), the tail replayed from the parity
   streams (launches in the broker == both topics' durable stripes), g1's
   and kg's offsets back. 20d, while the broker restarts: three port brokers in this
   process (`mq20_trio`): 4,096 records through the first, forwarded
   and replicated; partition 0's leader stopped, its follower promoted
   and serving every record; launches == the streams' dispatches. 20e:
   an `mq.agent` child by name (1,000 records in one session, a
   subscription acked and committed at the broker) and a `filer
   -notify.mq` child by name with no torch mapped, 200 files written
   through it, every event on default/filer-events. Every child exits 0
   on SIGTERM within 10 s. Its JSON line: each step's wall, the publish
   rate, publish-to-delivery p50 / p99, the parity lag, the children's
   start times, the launches per kernel per process and the redials.

Any failure raises (exit code 1). It exits 2, printing no result, when
no CUDA device is available; run from a directory without the package,
the import fails. The last line is the device JSON.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import shlex
import signal
import struct
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.client import HTTPConnection, HTTPSConnection

import numpy as np
import torch

SEED = 20261016
VOLUME_BYTES = 1 << 30
K, M = 10, 4
LOST = (3, 11)
DEGRADED = 3  # data shard unmounted for the read phase
ROTTEN = 5  # shard whose byte is flipped under one needle
LEAF_DATA, LEAF_PARITY = 3, 12  # shards whose leaves rot in phase 6b
SIZE_ROT = 5  # shard cut short in phase 6b: quarantined and rebuilt
N_DELETED = 5
# batches alive at once in run_pipeline: two queues of 2, one per stage
IN_FLIGHT = 2 * 2 + 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, same sheet


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of `fn()` over `reps` launches, each after
    overwriting a buffer larger than L2, so every launch reads its
    inputs cold from HBM, as a batch that was just copied in would at
    best find them. The overwrite leaves L2 full of dirty lines, which
    the launch's own traffic evicts and writes back. A device-side spin
    queued before the start event keeps the stream busy while the host
    enqueues `fn`, so the span holds the device work and not the host's
    launch latency."""
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_us(fn, reps: int) -> float:
    """Median host time, in microseconds, of one call of `fn`: the
    wrapper's checks, its output's allocation and the library's launch
    set-up. A device-side spin keeps the stream busy, so no call waits
    on the device. On an idle stream this time falls inside the read
    path's `kernel` span."""
    times = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def cpu_ms(coeffs: np.ndarray, data: np.ndarray, want: np.ndarray) -> float:
    """Median host wall, in ms, of the native CPU backend's apply of
    `coeffs` to `data` (numpy, on the host) after one warm-up call, whose
    output must equal `want`, the kernel's."""
    from seaweedfs_tpu_torch.ec import CpuBackend, ECContext

    cpu = CpuBackend(ECContext(K, M))
    if not np.array_equal(cpu.apply(coeffs, data), want):
        raise AssertionError(f"CpuBackend != kernel at m={coeffs.shape[0]}, {data.shape}")
    times = []
    for _ in range(11 if data.nbytes >= (64 << 20) else 21):
        t0 = time.perf_counter()
        cpu.apply(coeffs, data)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def check_kernel(kind, coeffs, n, rng, flush, timed=True, pack_width=1, misaligned=False):
    """Kernel vs plain version vs numpy oracle at (K, n); returns the
    shape's row of measurements. `kind` is "gf2_apply" (bit-major
    operand) or "gf2_apply_planes" (plane stack of `pack_width`).
    `misaligned` puts the data 1 byte past a 16-byte boundary (a
    contiguous view of a larger buffer). A timed row also holds
    `cpu_ms`, the native CPU backend's apply of the same bytes on the
    host (checked equal to the kernel's output)."""
    from seaweedfs_tpu_torch.ops import gf256, rs_kernels, rs_torch

    m, k = coeffs.shape
    data_np = rng.integers(0, 256, size=(k, n), dtype=np.uint8)
    if misaligned:
        data = torch.empty(k * n + 1, dtype=torch.uint8, device="cuda")[1:].view(k, n)
        data.copy_(torch.from_numpy(data_np))
    else:
        data = torch.from_numpy(data_np).cuda()
    if kind == "gf2_apply":
        b = rs_torch.bits_from_numpy(rs_torch.bit_matrix_bitmajor(coeffs), "cuda")
        kernel = lambda: rs_kernels.gf2_apply(b, data, m=m)  # noqa: E731
        plain = lambda: rs_kernels.gf2_apply_plain(b, data, m)  # noqa: E731
        operand_bytes = 64 * m * k
    else:
        b = rs_torch.planes_from_numpy(rs_torch.bit_matrix_planes(coeffs, pack_width), "cuda")
        kernel = lambda: rs_kernels.gf2_apply_planes(b, data, m=m, pack_width=pack_width)  # noqa: E731
        plain = lambda: rs_kernels.gf2_apply_planes_plain(b, data, m)  # noqa: E731
        operand_bytes = b.numel()
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = int((out.to(torch.int16) - ref.to(torch.int16)).abs().max().item())
    if err != 0 or not torch.equal(out, ref):
        raise AssertionError(f"{kind} != plain at m={m}, n={n}: max_abs_err {err}")
    w = min(n, 1 << 16)
    off = int(rng.integers(0, n - w + 1))
    want = gf256.matrix_apply(coeffs, data_np[:, off : off + w])
    if not np.array_equal(out[:, off : off + w].cpu().numpy(), want):
        raise AssertionError(f"{kind} != numpy oracle at m={m}, n={n}, offset {off}")
    row = {"m": m, "k": k, "n": n, "max_abs_err": err}
    if misaligned:
        row["data_offset"] = data.data_ptr() % 16
    if kind == "gf2_apply_planes":
        row["m_pad"] = b.shape[2] // 8
    if not timed:
        return row
    row["ms"] = median_ms(kernel, 21, flush)
    row["cpu_ms"] = cpu_ms(coeffs, data_np, out.cpu().numpy())
    row["host_us"] = host_us(kernel, 101)
    row["plain_ms"] = median_ms(plain, 5, flush)
    # Yardstick: the same GF(2) product (the m real rows) as one int8
    # GEMM with int32 accumulation (torch._int_mm, cuBLASLt), on
    # bit-planes made beforehand. It needs more than 16 rows, so a
    # matrix of 8m <= 16 bit rows is padded with zero rows to 32.
    bits8 = torch.from_numpy(rs_torch.bit_matrix_bitmajor(coeffs)).cuda().to(torch.int8)
    if bits8.shape[0] <= 16:
        bits8 = torch.cat([bits8, torch.zeros((32 - bits8.shape[0], 8 * k), dtype=torch.int8, device="cuda")])
    shifts = torch.arange(8, dtype=torch.uint8, device="cuda").view(8, 1, 1)
    planes = ((data.unsqueeze(0) >> shifts) & 1).reshape(8 * k, n).to(torch.int8)
    if n % 8:  # _int_mm takes a multiple of 8 columns: zero columns pad a ragged width
        planes = torch.cat([planes, torch.zeros((8 * k, 8 - n % 8), dtype=torch.int8, device="cuda")], 1)
    row["library_ms"] = median_ms(lambda: torch._int_mm(bits8, planes), 11, flush)
    del planes
    # The memory stream alone: one device copy that reads and writes as
    # many bytes, (k + m) * n in all, timed the same way.
    src = torch.empty((k + m) * n // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    row["copy_ms"] = median_ms(lambda: dst.copy_(src), 21, flush)
    del src, dst
    nbytes = (k + m) * n + operand_bytes
    ops = 2 * (8 * m) * (8 * k) * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_TENSOR_OPS_PER_S
    row["bound_ms"] = max(t_bytes, t_ops) * 1e3
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return row


# Widths on the edges of the ring bodies' tiles (4096 columns) and of their
# grid (132 x 4096: one wave of one-tile blocks on an H100's 132 SMs), one
# width that is not a multiple of 16 (the masked byte path), and one whose
# blocks walk several tiles, the last of them partial.
TILE_EDGES = (4080, 4096, 4112, 132 * 4096 - 16, 132 * 4096, 132 * 4096 + 16,
              132 * 4096 + 3, (16 << 20) + 48)


# Chunk widths of the stream's k = 1 deltas: below one 16-byte word, on
# and off its edges, a ragged MQ flush, and 256 KiB (the flush threshold).
STREAM_WIDTHS = (1, 5, 15, 16, 17, 1062, 4099, (8 << 10) + 5, 256 << 10, (1 << 20) - 3, 1 << 20)


def kernel_name(mangled: str) -> str:
    """`gf2_table_kernel<4>` or `gf2_apply_kernel<4, bit-major>` from a
    mangled kernel name."""
    kern = re.search(r"(gf2_[a-z]+_kernel)", mangled)
    name = f"{kern.group(1) if kern else mangled}<{', '.join(re.findall(r'Li(\d+)E', mangled))}"
    if layout := re.search(r"LayoutE(\d)E", mangled):
        name += ", " + ("planes" if layout.group(1) == "1" else "bit-major")
    return name + ">"


def ptxas_lines(log: str) -> list[str]:
    """`kernel<M, layout>: <registers line>; <spill line>` for each
    kernel instantiation in the output of ptxas -v."""
    lines, name, spill = [], "", ""
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return lines


def host_info() -> dict:
    """The card's host as the native CPU backend sees it."""
    from seaweedfs_tpu_torch.utils import native

    fields: dict = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    # some hosts' /proc/cpuinfo says "unknown" for the model name: name the
    # part by its vendor, family and model numbers then
    model = fields.get("model name", "unknown")
    if model == "unknown":
        model = " ".join(
            f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model") if k in fields
        ) or "not reported"
    return {"cpu_model": model, "cpus": os.cpu_count(), "has_avx2": native.has_avx2(),
            "pool_threads": native.pool_threads()}


def build() -> None:
    """Phase 1: print the card, build the kernels from csrc/ (nvcc and
    g++ at once) and print ptxas's registers and spills per kernel."""
    from seaweedfs_tpu_torch.ops import _build

    print(f"card: {card_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc and g++ in parallel)")
    print("host: " + json.dumps(host_info()))
    for line in ptxas_lines(logs["gf2_apply"]):
        print(f"  ptxas: {line}")


def host_packages() -> dict:
    """Whether the host has what TLS, thumbnails, the MQ broker's parquet
    archival and the Kafka gateway's zstd batches use: `cryptography`
    (certificates), PIL (thumbnails), pyarrow (`mq.topic.compact`),
    `zstandard` (codec 4) and the `openssl` command."""
    import importlib.util

    out = {}
    for mod in ("cryptography", "PIL", "pyarrow", "zstandard"):
        spec = importlib.util.find_spec(mod)
        out[mod] = __import__(mod).__version__ if spec else None
    out["openssl"] = shutil.which("openssl")
    return out


def rebuild_coeffs(lost: tuple[int, ...]) -> np.ndarray:
    """The (len(lost), K) rows that rebuild shards `lost` from the first
    K others, as the backend builds them."""
    from seaweedfs_tpu_torch.ec.backend import _decode_coeffs
    from seaweedfs_tpu_torch.ops import gf256

    src = tuple(i for i in range(K + M) if i not in lost)[:K]
    return _decode_coeffs(gf256.build_matrix(K, K + M), lost, src)


def kernel_phases(rng, flush):
    """Phases 2 and 2b; returns the timed rows of each entry point."""
    from seaweedfs_tpu_torch.ops import gf256

    encode_coeffs = gf256.parity_rows(K, M)
    decode_coeffs = rebuild_coeffs(LOST)
    read_coeffs = rebuild_coeffs((DEGRADED,))
    widths = (1, 7, 127, 1000, 4099, (1 << 20) + 3)
    for coeffs in (encode_coeffs, decode_coeffs):
        for n in widths + TILE_EDGES:
            check_kernel("gf2_apply", coeffs, n, rng, flush, timed=False)
        row = check_kernel("gf2_apply", coeffs, 1 << 20, rng, flush, timed=False, misaligned=True)
    print(f"gf2_apply exact at widths {list(widths + TILE_EDGES)} and on misaligned data "
          f"(offset {row['data_offset']}), encode m=4 and rebuild m=2 coefficients")
    # the stream's parity deltas: one generator column (k = 1) over a
    # chunk of any width, m = 4 (10+4 volumes) and m = 2 (4+2 MQ streams)
    column_coeffs = (gf256.parity_rows(K, M)[:, 3:4], gf256.parity_rows(4, 2)[:, 1:2])
    for coeffs in column_coeffs:
        for n in STREAM_WIDTHS:
            check_kernel("gf2_apply", coeffs, n, rng, flush, timed=False)
        check_kernel("gf2_apply", coeffs, (1 << 20) + 3, rng, flush, timed=False, misaligned=True)
    print(f"gf2_apply exact at k=1 (the stream's parity deltas), m=4 and m=2, at widths "
          f"{list(STREAM_WIDTHS)} and on misaligned data")
    rows = {}
    for label, coeffs, n in (
        ("encode 10x1MiB m=4", encode_coeffs, 1 << 20),
        ("decode 10x1MiB m=2", decode_coeffs, 1 << 20),
        ("encode 10x16MiB m=4", encode_coeffs, 16 << 20),
        ("decode 10x16MiB m=2", decode_coeffs, 16 << 20),
        ("leaf repair 10x64KiB m=1", read_coeffs, 64 << 10),
        ("stream delta 1x256KiB m=4", column_coeffs[0], 256 << 10),
        ("stream delta 1x(8KiB+5) m=4", column_coeffs[0], (8 << 10) + 5),
        ("stream delta 1x256KiB m=2", column_coeffs[1], 256 << 10),
        ("stream delta 1x(8KiB+5) m=2", column_coeffs[1], (8 << 10) + 5),
    ):
        rows[label] = check_kernel("gf2_apply", coeffs, n, rng, flush)
        print(f"gf2_apply {label} (tolerance 0, exact): " + json.dumps(rows[label]))

    # -- 2b. the plane-stack entry point -------------------------------------
    for pack_width in (1, 2):  # m_pad 32 and 16
        for m in (1, 2, 4):
            coeffs = rng.integers(0, 256, (m, K), dtype=np.uint8)
            for n in widths + TILE_EDGES:
                check_kernel("gf2_apply_planes", coeffs, n, rng, flush, timed=False,
                             pack_width=pack_width)
            row = check_kernel("gf2_apply_planes", coeffs, 1 << 20, rng, flush, timed=False,
                               pack_width=pack_width, misaligned=True)
    print(f"gf2_apply_planes exact at widths {list(widths + TILE_EDGES)} and on misaligned "
          f"data (offset {row['data_offset']}), m 1, 2, 4, m_pad 32 and 16")
    prows = {}
    for label, n in (
        ("degraded read 10x64KiB m=1", 64 << 10),
        ("degraded read 10x256KiB m=1", 256 << 10),
        ("degraded read 10x1MiB m=1", 1 << 20),
        ("decode 10x16MiB m=1", 16 << 20),
    ):
        prows[label] = check_kernel("gf2_apply_planes", read_coeffs, n, rng, flush)
        print(f"gf2_apply_planes {label} (tolerance 0, exact): " + json.dumps(prows[label]))
    for label, n in (("10x1MiB m=1", 1 << 20), ("10x16MiB m=1", 16 << 20)):
        row = check_kernel("gf2_apply", read_coeffs, n, rng, flush)
        print(f"yardstick: gf2_apply (the table body) on the same coefficients "
              f"{label}: " + json.dumps(row))
    return rows, prows


def needle_stream(rng):
    """The smoke's seeded needles, in write order: (needle id, cookie,
    random body of 512 KiB to 1.5 MiB, about 1 MiB on average)."""
    ids = np.unique(rng.integers(1, 1 << 40, size=8192))
    rng.shuffle(ids)
    for nid in ids:
        cookie = int(rng.integers(0, 1 << 32))
        yield int(nid), cookie, rng.bytes(int(rng.integers(512 << 10, 1536 << 10)))


def write_volume(base: str, rng) -> list[tuple[int, int, int, int]]:
    """Seeded .dat of at most VOLUME_BYTES: the 8-byte superblock, then
    real version-3 needles (`needle_stream`: CRC32C, append time), and one
    .idx entry each. Returns (needle id, cookie, .dat offset, body
    length) per needle."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock
    from seaweedfs_tpu_torch.storage.types import NeedleValue, to_stored_offset

    stream = needle_stream(rng)
    records = []
    entries = []
    with open(base + ".dat", "wb") as dat:
        dat.write(SuperBlock(version=3).to_bytes())
        off = dat.tell()
        while True:
            nid, cookie, body = next(stream)
            n = Needle(cookie=cookie, needle_id=nid, data=body, append_at_ns=time.time_ns())
            raw = n.to_bytes(3)
            if off + len(raw) > VOLUME_BYTES:
                break
            dat.write(raw)
            size = struct.unpack(">I", raw[12:16])[0]  # the header's body size
            entries.append(NeedleValue(n.needle_id, to_stored_offset(off), size).to_bytes())
            records.append((n.needle_id, n.cookie, off, len(n.data)))
            off += len(raw)
    with open(base + ".idx", "wb") as f:
        f.write(b"".join(entries))
    return records


def sha256(path: str, limit: int | None = None) -> str:
    """sha256 of the file, or of its first `limit` bytes."""
    h = hashlib.sha256()
    left = os.path.getsize(path) if limit is None else limit
    with open(path, "rb") as f:
        while left > 0 and (chunk := f.read(min(16 << 20, left))):
            h.update(chunk)
            left -= len(chunk)
    return h.hexdigest()


def percentile_ms(seconds: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def python_plane_encode(work, base, ctx, digests, prot) -> dict:
    """Phase 4, second half: the same .dat (hard-linked) encoded with
    SEAWEED_EC_NATIVE=0, the Python byte plane. Its 14 shards must be
    sha256-identical to the native plane's and its sidecar's block and
    leaf CRC lists equal (not the files: each carries a fresh uuid).
    Returns its wall and stage table."""
    from seaweedfs_tpu_torch.ec import BitrotProtection, TorchBackend, ec_encode_volume, native_io

    d = os.path.join(work, "python-plane")
    os.makedirs(d)
    pbase = os.path.join(d, "1")
    for ext in (".dat", ".idx"):
        os.link(base + ext, pbase + ext)
    backend = TorchBackend(ctx)
    native_io.reset_counts()
    before = os.environ.get("SEAWEED_EC_NATIVE")
    os.environ["SEAWEED_EC_NATIVE"] = "0"
    try:
        t0 = time.perf_counter()
        ec_encode_volume(pbase, ctx, backend=backend)
        dt = time.perf_counter() - t0
    finally:
        if before is None:
            del os.environ["SEAWEED_EC_NATIVE"]
        else:
            os.environ["SEAWEED_EC_NATIVE"] = before
    if any(native_io.COUNTS.values()) or backend.pin_skips:
        raise AssertionError(f"the Python plane used the native one: {native_io.COUNTS}")
    pprot = BitrotProtection.load(pbase + ".ecsum")
    lists = lambda pr: (pr.shard_sizes, pr.shard_crcs, pr.leaf_size, pr.shard_leaf_crcs)  # noqa: E731
    if lists(pprot) != lists(prot):
        raise AssertionError("the Python plane's block or leaf CRC lists differ from the native plane's")
    for i in range(ctx.total):
        if sha256(pbase + ctx.to_ext(i)) != digests[i]:
            raise AssertionError(f"shard {i} of the Python plane differs from the native plane's")
    shutil.rmtree(d)
    return {"seconds": dt, "stage_seconds": dict(backend.stage_seconds)}


def needle_intervals(rec, dat_size: int) -> list[tuple[int, int, int]]:
    """(shard id, shard offset, size) of each piece of a needle record."""
    _, _, off, body = rec
    # the record's size field from the body length: data size(4) + data + flags(1)
    return record_intervals(off, 4 + body + 1, dat_size)


def record_intervals(off: int, size: int, dat_size: int) -> list[tuple[int, int, int]]:
    """(shard id, shard offset, size) of each piece of the record at .dat
    offset `off` whose size field is `size`."""
    from seaweedfs_tpu_torch.ec.decoder import record_actual_size
    from seaweedfs_tpu_torch.ec.locate import locate_data

    return [(*iv.to_shard_and_offset(K), iv.size)
            for iv in locate_data(off, record_actual_size(size, 3), dat_size // K, K)]


def degraded_records(records, dat_size: int) -> list:
    """The needles with a piece on shard DEGRADED."""
    return [r for r in records if any(sid == DEGRADED for sid, _, _ in needle_intervals(r, dat_size))]


def read_phase(work, base, ctx, records, dat_size, rng):
    """Phase 6: degraded needle reads with shard DEGRADED unmounted."""
    from seaweedfs_tpu_torch.ec import EcVolume, TorchBackend, native_io
    from seaweedfs_tpu_torch.ops import rs_kernels

    def intervals(rec):
        return needle_intervals(rec, dat_size)

    degraded = degraded_records(records, dat_size)
    healthy = [
        r for r in records if all(sid not in (DEGRADED, ROTTEN) for sid, _, _ in intervals(r))
    ]
    dat_fd = os.open(base + ".dat", os.O_RDONLY)

    def original(rec) -> bytes:
        return os.pread(dat_fd, rec[3], rec[2] + 20)  # header(16) + data size(4)

    backend = TorchBackend(ctx, impl="cuda_planes")
    ev = EcVolume(work, 1, backend=backend)
    cache = ev.interval_cache
    try:
        ev.unmount_shards([DEGRADED])
        rs_kernels.reset_launches()
        native_io.reset_counts()
        lat, returned = [], 0
        b0, t_all = ev.bytes_read, time.perf_counter()
        for rec in degraded:
            t0 = time.perf_counter()
            n = ev.read_needle(rec[0], cookie=rec[1])
            lat.append(time.perf_counter() - t0)
            if n.data != original(rec):
                raise AssertionError(f"degraded read of needle {rec[0]:x} differs")
            returned += sum(s for _, _, s in intervals(rec))
        cold_s = time.perf_counter() - t_all
        cold_read = ev.bytes_read - b0
        cold_launches = rs_kernels.LAUNCHES["gf2_apply_planes"]
        if cold_launches != cache.loads or cache.hits:
            raise AssertionError(
                f"{cold_launches} launches for {cache.loads} cache misses, {cache.hits} hits"
            )

        # cached re-reads: no launch, and only the needles' healthy
        # intervals are read from disk
        lat_cached = []
        for rec in degraded[-8:]:
            b1 = ev.bytes_read
            t0 = time.perf_counter()
            n = ev.read_needle(rec[0], cookie=rec[1])
            lat_cached.append(time.perf_counter() - t0)
            healthy_bytes = sum(s for sid, _, s in intervals(rec) if sid != DEGRADED)
            if n.data != original(rec) or ev.bytes_read - b1 != healthy_bytes:
                raise AssertionError(f"cached re-read of needle {rec[0]:x} went wrong")
        if rs_kernels.LAUNCHES["gf2_apply_planes"] != cold_launches or cache.hits < 8:
            raise AssertionError("cached re-reads launched the kernel or missed the cache")

        # reads that avoid the lost shard launch nothing
        lat_healthy = []
        for i in rng.choice(len(healthy), size=min(100, len(healthy)), replace=False):
            rec = healthy[int(i)]
            t0 = time.perf_counter()
            n = ev.read_needle(rec[0], cookie=rec[1])
            lat_healthy.append(time.perf_counter() - t0)
            if n.data != original(rec):
                raise AssertionError(f"healthy read of needle {rec[0]:x} differs")
        if rs_kernels.LAUNCHES["gf2_apply_planes"] != cold_launches:
            raise AssertionError("a healthy read launched the kernel")

        # a flipped byte of shard ROTTEN under one needle: the CRC check
        # fails and the read heals through verified reconstruction
        rec = next(
            r for r in records
            if any(sid == ROTTEN for sid, _, _ in intervals(r))
            and all(sid != DEGRADED for sid, _, _ in intervals(r))
        )
        sid, shard_off, size = next(iv for iv in intervals(rec) if iv[0] == ROTTEN)
        at = shard_off + size // 2
        with open(base + ctx.to_ext(ROTTEN), "r+b") as f:
            f.seek(at)
            byte = f.read(1)
            f.seek(at)
            f.write(bytes([byte[0] ^ 0x5A]))
        loads0 = cache.loads
        n = ev.read_needle(rec[0], cookie=rec[1])
        if n.data != original(rec):
            raise AssertionError("self-heal read is not bit-exact")
        heal_launches = rs_kernels.LAUNCHES["gf2_apply_planes"] - cold_launches
        if heal_launches < 1 or heal_launches != cache.loads - loads0:
            raise AssertionError(f"self-heal: {heal_launches} launches, {cache.loads - loads0} misses")
        launches = rs_kernels.LAUNCHES["gf2_apply_planes"]
        if launches != cache.loads or rs_kernels.LAUNCHES["gf2_apply"]:
            raise AssertionError("read path launches do not match its cache misses")
        sibling_reads = native_io.COUNTS["read_exact"]
        if sibling_reads < K * cache.loads:
            raise AssertionError(f"{sibling_reads} native sibling reads for {cache.loads} reconstructions")
        result = {
            "degraded_reads": len(degraded),
            "cold_seconds": cold_s,
            "cold_p50_ms": percentile_ms(lat, 50),
            "cold_p99_ms": percentile_ms(lat, 99),
            "cached_p50_ms": percentile_ms(lat_cached, 50),
            "cached_p99_ms": percentile_ms(lat_cached, 99),
            "healthy_reads": len(lat_healthy),
            "healthy_p50_ms": percentile_ms(lat_healthy, 50),
            "degraded_reads_per_s": len(degraded) / cold_s,
            "bytes_read_per_byte_returned": cold_read / returned,
            "reconstructions": launches,
            "native_sibling_reads": sibling_reads,
            "self_heal_launches": heal_launches,
            "read_stage_seconds": dict(ev.stage_seconds),
            "backend_stage_seconds": {
                k: v for k, v in backend.stage_seconds.items() if k in ("pin", "h2d", "kernel", "d2h")
            },
        }
        first = len(records) // 3
        deleted = [r[0] for r in records[first :: (len(records) - first) // N_DELETED]][:N_DELETED]
        if len(deleted) != N_DELETED or any(ev.delete_needle(nid) <= 0 for nid in deleted):
            raise AssertionError(f"deleting needles {deleted} failed")
    finally:
        ev.close()
        os.close(dat_fd)
    return result, launches, deleted


# Each window of the repair journal: (point the child dies at, mutate
# point torn at the same seam, whether recovery must roll forward), and
# last a crash of recovery itself, mid-replay.
WINDOWS = [
    ("ec.repair.journal_write", "ec.repair.journal_bytes", False),
    ("ec.repair.journal_write", None, False),
    ("ec.repair.after_journal", None, True),
    ("ec.repair.patch_write", "ec.repair.patch_bytes", True),
    ("ec.repair.patch_write", None, True),
    ("ec.repair.after_patch", None, True),
    ("ec.repair.after_sidecar", None, True),
    ("ec.repair.patch_write", None, True),  # recovery killed mid-replay
]

# The child of one crash window: arms the port's fault registry, then
# either repairs the rotten leaves of a shard (reconstructing on the
# card) or recovers a pending journal, and dies at the armed point.
CRASH_CHILD = r"""
import sys
from seaweedfs_tpu_torch import faults
from seaweedfs_tpu_torch.ec import ECContext, TorchBackend, reconstruct_leaves
from seaweedfs_tpu_torch.ec.bitrot import BitrotProtection
from seaweedfs_tpu_torch.ec.repair_journal import (
    apply_leaf_repair, leaf_verdict, recover_volume_journals,
)
from seaweedfs_tpu_torch.ops import rs_kernels

base, sid, point, mutate_point, mode = sys.argv[1:6]
sid, ctx = int(sid), ECContext(10, 4)
faults.inject(point, faults.hard_exit(137))
if mutate_point != "-":
    faults.inject(mutate_point, faults.truncate(0.5))
if mode == "recover":
    recover_volume_journals(base, ctx)
else:
    prot = BitrotProtection.load(base + ".ecsum")
    path = base + ctx.to_ext(sid)

    def read_range(s, lo, size):
        with open(base + ctx.to_ext(s), "rb") as f:
            f.seek(lo)
            return f.read(size)

    patches = reconstruct_leaves(
        prot, ctx, sid, leaf_verdict(path, sid, prot), read_range,
        [i for i in range(ctx.total) if i != sid], backend=TorchBackend(ctx),
    )
    print("leaves", [p.leaf for p in patches], "launches",
          rs_kernels.LAUNCHES["gf2_apply"], flush=True)
    apply_leaf_repair(path, sid, prot, patches)
sys.exit(3)  # the armed point never fired
"""


def flip(path: str, at: int) -> None:
    with open(path, "r+b") as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0xA5]))


def scrub_phase(work, base, ctx, records, dat_size, digests):
    """Phase 6b: scrub, leaf repair, crash windows healed at mount,
    quarantine and rebuild. Returns (result, gf2_apply launches)."""
    from seaweedfs_tpu_torch.ec import (
        BitrotProtection, EcVolume, LeafPatch, RepairJournal, TorchBackend, native_io, scrub_ec_volume,
    )
    from seaweedfs_tpu_torch.ec.repair_journal import journal_path, leaf_ranges
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.utils.crc import crc32c
    from seaweedfs_tpu_torch.utils.fs import atomic_write

    shard = {i: base + ctx.to_ext(i) for i in range(ctx.total)}
    for i in range(ctx.total):
        if sha256(shard[i]) != digests[i]:
            raise AssertionError(f"phase 6b starts with shard {i} not as encoded")
    prot = BitrotProtection.load(base + ".ecsum")
    lsize, n_leaves = prot.leaf_size, len(prot.shard_leaf_crcs[LEAF_DATA])
    shard_bytes = sum(prot.shard_sizes)
    backend = TorchBackend(ctx)
    launches = 0
    result: dict = {}

    def kernel_stages() -> dict:
        return {k: v for k, v in backend.stage_seconds.items() if k in ("pin", "h2d", "kernel", "d2h")}

    # -- a clean pass: every leaf of every shard read and CRC'd -----------
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    r = scrub_ec_volume(base, ctx, backend=backend, repair=True)
    clean_s = time.perf_counter() - t0
    if not r.healthy or r.checked_bytes != shard_bytes or r.leaf_repaired or any(rs_kernels.LAUNCHES.values()):
        raise AssertionError(f"clean scrub pass is not clean: {r}")
    result["clean_pass"] = {"seconds": clean_s, "shard_bytes": shard_bytes,
                            "gb_per_s": shard_bytes / clean_s / 1e9, "leaves": r.checked_leaves}

    # -- leaf repair: three leaves of shard 3 (two adjacent), one of 12 ---
    a, b, c = n_leaves // 3, 2 * n_leaves // 3, n_leaves // 2
    rotten = {LEAF_DATA: [a, a + 1, b], LEAF_PARITY: [c]}
    for sid, leaves in rotten.items():
        for li in leaves:
            flip(shard[sid], li * lsize + 1000)
    n_ranges = sum(len(leaf_ranges(ls, lsize, prot.shard_sizes[s])) for s, ls in rotten.items())
    backend.reset_stages()
    rs_kernels.reset_launches()
    stages: dict = {}
    t0 = time.perf_counter()
    r = scrub_ec_volume(base, ctx, backend=backend, repair=True, stages=stages)
    repair_s = time.perf_counter() - t0
    repair_launches = rs_kernels.LAUNCHES["gf2_apply"]
    if r.leaf_repaired != rotten or r.quarantined or r.rebuilt or r.refused or r.corrupt_shards:
        raise AssertionError(f"leaf repair: {r}")
    if repair_launches != n_ranges or rs_kernels.LAUNCHES["gf2_apply_planes"]:
        raise AssertionError(f"leaf repair launched {rs_kernels.LAUNCHES} for {n_ranges} leaf ranges")
    for sid in rotten:
        if sha256(shard[sid]) != digests[sid]:
            raise AssertionError(f"leaf-repaired shard {sid} differs from its encode-time bytes")
    for i in range(ctx.total):
        if prot.verify_shard_file(shard[i], i):
            raise AssertionError(f"shard {i} fails .ecsum after leaf repair")
    launches += repair_launches
    # the JAX stage names: repair_patch's split keys ("repair_patch.*") are in it
    per_range = sum(v for k, v in stages.items() if "." not in k) / n_ranges
    result["leaf_repair"] = {
        "leaves": rotten, "ranges": n_ranges, "launches": repair_launches,
        "scrub_seconds": repair_s, "ms_per_range": per_range * 1e3,
        "stage_seconds": stages, "backend_stage_seconds": kernel_stages(),
    }

    # -- crash windows, each healed by the next mount ----------------------
    def intervals(rec):
        return needle_intervals(rec, dat_size)

    dat_fd = os.open(base + ".dat", os.O_RDONLY)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    jpath = journal_path(shard[LEAF_DATA])
    windows = []
    try:
        for w, (point, mutate_point, expect_new) in enumerate(WINDOWS):
            recovery_crash = w == len(WINDOWS) - 1
            leaf = n_leaves // 8 + 3 * w
            lo = leaf * lsize
            with open(shard[LEAF_DATA], "rb") as f:
                f.seek(lo)
                good = f.read(lsize)
            flip(shard[LEAF_DATA], lo + 77)
            pre = sha256(shard[LEAF_DATA])
            if recovery_crash:  # a pending journal that carries the right bytes
                atomic_write(jpath, RepairJournal(
                    LEAF_DATA, prot.generation, prot.uuid, lsize, prot.shard_sizes[LEAF_DATA],
                    [LeafPatch(leaf, lo, good, crc32c(good))],
                ).to_bytes())
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", CRASH_CHILD, base, str(LEAF_DATA), point,
                 mutate_point or "-", "recover" if recovery_crash else "repair"],
                cwd=repo, env=env, capture_output=True, text=True, timeout=60,
            )
            child_s = time.perf_counter() - t0
            if proc.returncode != 137 or not os.path.exists(jpath):
                raise AssertionError(
                    f"window {w} ({point}): child exit {proc.returncode}, journal "
                    f"{'present' if os.path.exists(jpath) else 'absent'}\n{proc.stdout}{proc.stderr}"
                )
            rs_kernels.reset_launches()
            t0 = time.perf_counter()
            ev = EcVolume(work, 1, backend=backend)
            mount_s = time.perf_counter() - t0
            try:
                rec = ev.journal_recovery
                after = sha256(shard[LEAF_DATA])
                fully_new, fully_old = after == digests[LEAF_DATA], after == pre
                if os.path.exists(jpath) or rec is None or not (fully_new or fully_old):
                    raise AssertionError(f"window {w} ({point}): mount left {rec}, "
                                         f"fully new {fully_new}, fully old {fully_old}")
                if expect_new and not (fully_new and rec["replayed"].get(LEAF_DATA)):
                    raise AssertionError(f"window {w} ({point}) did not roll forward: {rec}")
                if fully_old and rec["rolled_back"] != [jpath]:
                    raise AssertionError(f"window {w} ({point}) is fully old but {rec}")
                patched = rec["replayed"].get(LEAF_DATA, [leaf])
                over = [
                    needle for needle in records
                    if any(sid == LEAF_DATA and any(off < (p + 1) * lsize and p * lsize < off + n
                                                   for p in patched)
                           for sid, off, n in intervals(needle))
                ]
                for nid, cookie, off, body in over:
                    if ev.read_needle(nid, cookie=cookie).data != os.pread(dat_fd, body, off + 20):
                        raise AssertionError(f"window {w}: needle {nid:x} over the patched leaves differs")
            finally:
                ev.close()
            launches += rs_kernels.LAUNCHES["gf2_apply"]
            windows.append({
                "point": point + (f"+{mutate_point}" if mutate_point else "")
                + (" (recovery)" if recovery_crash else ""),
                "child": proc.stdout.strip(), "child_s": child_s, "mount_s": mount_s,
                "replayed": rec["replayed"].get(LEAF_DATA, []), "rolled_back": len(rec["rolled_back"]),
                "state": "new" if fully_new else "old", "needles_read": len(over),
            })
    finally:
        os.close(dat_fd)
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    r = scrub_ec_volume(base, ctx, backend=backend, repair=True)
    closing_s = time.perf_counter() - t0
    launches += rs_kernels.LAUNCHES["gf2_apply"]
    if not r.complete or r.refused or r.quarantined or sha256(shard[LEAF_DATA]) != digests[LEAF_DATA]:
        raise AssertionError(f"closing scrub did not restore shard {LEAF_DATA}: {r}")
    result["crash_windows"] = windows
    result["closing_scrub"] = {"seconds": closing_s, "leaf_repaired": r.leaf_repaired}

    # -- size rot: quarantine to .bad and rebuild through gf2_apply --------
    os.truncate(shard[SIZE_ROT], prot.shard_sizes[SIZE_ROT] - 4096)
    backend.reset_stages()
    rs_kernels.reset_launches()
    native_io.reset_counts()
    t0 = time.perf_counter()
    r = scrub_ec_volume(base, ctx, backend=backend, repair=True)
    quarantine_s = time.perf_counter() - t0
    q_launches = rs_kernels.LAUNCHES["gf2_apply"]
    bad = shard[SIZE_ROT] + ".bad"
    if r.quarantined != [bad] or r.rebuilt != [SIZE_ROT] or r.refused or q_launches < 1:
        raise AssertionError(f"quarantine and rebuild: {r}, {q_launches} launches")
    if sha256(shard[SIZE_ROT]) != digests[SIZE_ROT]:
        raise AssertionError(f"rebuilt shard {SIZE_ROT} differs from its encode-time bytes")
    q_plane = dict(native_io.COUNTS)
    if not q_plane["read_batch"] or q_plane["sink_append"] != q_plane["read_batch"]:
        raise AssertionError(f"the quarantine's rebuild did not run on the native plane: {q_plane}")
    os.unlink(bad)
    launches += q_launches
    result["quarantine_rebuild"] = {"seconds": quarantine_s, "launches": q_launches,
                                    "native_plane": q_plane,
                                    "backend_stage_seconds": kernel_stages()}
    for i in range(ctx.total):
        if sha256(shard[i]) != digests[i]:
            raise AssertionError(f"phase 6b leaves shard {i} not as encoded")
    result["gf2_apply_launches"] = launches
    return result, launches


def decode_phase(base, ctx, digest3, deleted):
    """Phase 7: ec.decode with shard DEGRADED removed (5 needles deleted)."""
    from seaweedfs_tpu_torch.ec import TorchBackend, ec_decode_volume, native_io
    from seaweedfs_tpu_torch.ec.decoder import find_dat_file_size
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.storage.types import NEEDLE_MAP_ENTRY_SIZE

    with open(base + ".ecx", "rb") as f:
        ecx = bytearray(f.read())
    for o in range(0, len(ecx), NEEDLE_MAP_ENTRY_SIZE):  # .ecj folded in place
        if int.from_bytes(ecx[o : o + 8], "big") in deleted:
            ecx[o + 12 : o + 16] = b"\xff\xff\xff\xff"
    shard_size = os.path.getsize(base + ctx.to_ext(DEGRADED))
    os.unlink(base + ctx.to_ext(DEGRADED))
    os.replace(base + ".dat", base + ".dat.orig")
    os.unlink(base + ".idx")
    stages: dict = {}
    backend = TorchBackend(ctx, impl="cuda_planes")
    rs_kernels.reset_launches()
    native_io.reset_counts()
    t0 = time.perf_counter()
    if not ec_decode_volume(base, ctx, backend=backend, stages=stages):
        raise AssertionError("decode found no live needle")
    dt = time.perf_counter() - t0
    launches = rs_kernels.LAUNCHES["gf2_apply_planes"]
    batches = -(-shard_size // DEFAULT_BATCH)
    if launches != batches or rs_kernels.LAUNCHES["gf2_apply"]:
        raise AssertionError(f"decode launched {launches} planes kernels for {batches} batches")
    plane = dict(native_io.COUNTS)
    if plane["read_batch"] != batches or plane["sink_append"] != batches or not plane["read_exact"]:
        raise AssertionError(f"decode's reads did not run on the native plane: {plane}")
    if sha256(base + ctx.to_ext(DEGRADED)) != digest3:
        raise AssertionError(f"regenerated shard {DEGRADED} differs from the original")
    live = find_dat_file_size(base, 3)
    if os.path.getsize(base + ".dat") != live or sha256(base + ".dat") != sha256(base + ".dat.orig", live):
        raise AssertionError("decoded .dat differs from the original cut to its live extent")
    with open(base + ".idx", "rb") as f:
        if f.read() != bytes(ecx):
            raise AssertionError(".idx differs from .ecx with the deletions as tombstones")
    stages.update({k: v for k, v in backend.stage_seconds.items() if k in ("pin", "h2d", "kernel", "d2h")})
    return {
        "deleted_needles": len(deleted),
        "dat_bytes": live,
        "seconds": dt,
        "gb_per_s": live / dt / 1e9,
        "launches": launches,
        "rebuild_batches": batches,
        "native_plane": plane,
        "stage_seconds": stages,
    }, launches


# -- 8. the native CPU backend on the card's host --------------------------------
#
# Each run below sits next to its card counterpart in main() and works on
# the same inputs: a directory of hard links to the files the operation
# only reads, and copies of those it writes. CpuBackend has no CUDA
# events: its stage table is host wall time ("kernel" is the wall of its
# applies), and its pin, h2d and d2h stay 0.


def same_inputs(base: str, d: str, shards, copy=(".ecx", ".ecj", ".vif", ".ecsum")) -> str:
    """A directory `d` holding hard links to `shards` of volume `base`
    and copies of its small files `copy` (where they exist); returns the
    new base."""
    os.makedirs(d)
    nbase = os.path.join(d, os.path.basename(base))
    for i in shards:
        os.link(base + f".ec{i:02d}", nbase + f".ec{i:02d}")
    for ext in copy:
        if os.path.exists(base + ext):
            shutil.copy(base + ext, nbase + ext)
    return nbase


class NoLaunch:
    """Fails unless the kernels' launch counts stay where they were
    across the block: a CpuBackend run never reaches the card."""

    def __enter__(self):
        from seaweedfs_tpu_torch.ops import rs_kernels

        self.before = (dict(rs_kernels.LAUNCHES), dict(rs_kernels.MASKED))
        return self

    def __exit__(self, *exc):
        from seaweedfs_tpu_torch.ops import rs_kernels

        if exc[0] is None and (dict(rs_kernels.LAUNCHES), dict(rs_kernels.MASKED)) != self.before:
            raise AssertionError(f"a CpuBackend run launched a kernel: {self.before} -> "
                                 f"{rs_kernels.LAUNCHES}, {rs_kernels.MASKED}")


def cpu_encode(work, base, ctx, digests, prot, n_batches) -> dict:
    """Phase 8, encode: the same .dat (hard-linked) encoded on CpuBackend
    through the native byte plane; its 14 shards must be sha256-identical
    to the card's and its block and leaf CRC lists equal."""
    from seaweedfs_tpu_torch.ec import BitrotProtection, CpuBackend, ec_encode_volume, native_io

    d = os.path.join(work, "cpu-encode")
    os.makedirs(d)
    cbase = os.path.join(d, "1")
    for ext in (".dat", ".idx"):
        os.link(base + ext, cbase + ext)
    backend = CpuBackend(ctx)
    native_io.reset_counts()
    with NoLaunch():
        t0 = time.perf_counter()
        ec_encode_volume(cbase, ctx, backend=backend)
        dt = time.perf_counter() - t0
    plane = dict(native_io.COUNTS, pin_skips=backend.pin_skips)
    if not (plane["read_batch"] == plane["sink_append"] == n_batches) or plane["pin_skips"]:
        raise AssertionError(f"the CPU encode's {n_batches} batches did not all take the native plane: {plane}")
    lists = lambda pr: (pr.shard_sizes, pr.shard_crcs, pr.leaf_size, pr.shard_leaf_crcs)  # noqa: E731
    if lists(BitrotProtection.load(cbase + ".ecsum")) != lists(prot):
        raise AssertionError("the CPU encode's block or leaf CRC lists differ from the card's")
    for i in range(ctx.total):
        if sha256(cbase + ctx.to_ext(i)) != digests[i]:
            raise AssertionError(f"shard {i} of the CPU encode differs from the card's")
    shutil.rmtree(d)
    return {"seconds": dt, "stage_seconds": dict(backend.stage_seconds), "native_plane": plane}


def cpu_rebuild(work, base, ctx, digests) -> dict:
    """Phase 8, rebuild: shards LOST regenerated on CpuBackend from the
    same 12 shards; sha256-identical to the originals."""
    from seaweedfs_tpu_torch.ec import CpuBackend, rebuild_ec_files

    cbase = same_inputs(base, os.path.join(work, "cpu-rebuild"),
                        [i for i in range(ctx.total) if i not in LOST])
    backend = CpuBackend(ctx)
    with NoLaunch():
        t0 = time.perf_counter()
        rebuilt = rebuild_ec_files(cbase, backend=backend)
        dt = time.perf_counter() - t0
    if rebuilt != list(LOST):
        raise AssertionError(f"the CPU rebuild regenerated {rebuilt}, expected {list(LOST)}")
    for i in LOST:
        if sha256(cbase + ctx.to_ext(i)) != digests[i]:
            raise AssertionError(f"shard {i} rebuilt on the CPU differs from the original")
    shutil.rmtree(os.path.dirname(cbase))
    return {"seconds": dt, "stage_seconds": dict(backend.stage_seconds)}


def cpu_reads(work, base, ctx, records, dat_size) -> dict:
    """Phase 8, degraded reads: every needle on shard DEGRADED, cache
    cold, through EcVolume on CpuBackend with that shard unmounted, over
    the shards as encoded (before any needle is deleted); bit-exact."""
    from seaweedfs_tpu_torch.ec import CpuBackend, EcVolume

    cbase = same_inputs(base, os.path.join(work, "cpu-read"), range(ctx.total),
                        copy=(".ecx", ".vif", ".ecsum"))
    degraded = degraded_records(records, dat_size)
    backend = CpuBackend(ctx)
    lat = []
    dat_fd = os.open(base + ".dat", os.O_RDONLY)
    ev = EcVolume(os.path.dirname(cbase), 1, backend=backend)
    try:
        ev.unmount_shards([DEGRADED])
        with NoLaunch():
            t_all = time.perf_counter()
            for rec in degraded:
                t0 = time.perf_counter()
                n = ev.read_needle(rec[0], cookie=rec[1])
                lat.append(time.perf_counter() - t0)
                if n.data != os.pread(dat_fd, rec[3], rec[2] + 20):
                    raise AssertionError(f"degraded read of needle {rec[0]:x} on the CPU differs")
            cold_s = time.perf_counter() - t_all
        cache = ev.interval_cache
        if cache.hits or not cache.loads or backend.stage_seconds["kernel"] <= 0:
            raise AssertionError(f"CPU reads: {cache.loads} loads, {cache.hits} hits")
        result = {
            "degraded_reads": len(degraded), "cold_seconds": cold_s,
            "cold_p50_ms": percentile_ms(lat, 50), "cold_p99_ms": percentile_ms(lat, 99),
            "reconstructions": cache.loads,
            "read_stage_seconds": dict(ev.stage_seconds),
            "backend_stage_seconds": dict(backend.stage_seconds),
        }
    finally:
        ev.close()
        os.close(dat_fd)
    shutil.rmtree(os.path.dirname(cbase))
    return result


def cpu_decode(cbase, base, ctx) -> dict:
    """Phase 8, decode: the state the card decoded (the same deletions,
    shard DEGRADED removed), prepared in `cbase`'s directory before the
    card ran, decoded on CpuBackend; the .dat, the .idx and the
    regenerated shard must be identical to the card's."""
    from seaweedfs_tpu_torch.ec import CpuBackend, ec_decode_volume

    backend = CpuBackend(ctx)
    stages: dict = {}
    with NoLaunch():
        t0 = time.perf_counter()
        if not ec_decode_volume(cbase, ctx, backend=backend, stages=stages):
            raise AssertionError("the CPU decode found no live needle")
        dt = time.perf_counter() - t0
    for ext in (".dat", ".idx", ctx.to_ext(DEGRADED)):
        if sha256(cbase + ext) != sha256(base + ext):
            raise AssertionError(f"the CPU decode's {ext} differs from the card's")
    stages.update({k: v for k, v in backend.stage_seconds.items() if k in ("pin", "h2d", "kernel", "d2h")})
    shutil.rmtree(os.path.dirname(cbase))
    return {"seconds": dt, "stage_seconds": stages}


def versus(card_s: float, card_stages: dict, cpu: dict) -> dict:
    return {"card_seconds": card_s, "cpu_seconds": cpu["seconds"],
            "cpu_over_card": cpu["seconds"] / card_s,
            "card_stage_seconds": card_stages, "cpu_stage_seconds": cpu["stage_seconds"]}


# -- 7a, 7b. streaming EC and the MQ durable-parity partition -------------------

DEVICE = "cuda"
STREAM_BYTES = 256 << 20  # phase 7a: the first 256 MiB of the volume's .dat
APPEND_BYTES = 8 << 10  # one append
FLUSH_BYTES = 256 << 10  # the broker's flush threshold (SEAWEED_EC_STREAM_FLUSH_KB)
MQ_BYTES = 144 << 20  # phase 7b: records appended to one partition
MQ_ROTATE_BYTES = 64 << 20  # the broker's generation size (SEAWEED_EC_STREAM_ROTATE_MB)
MQ_KEY, MQ_VALUE = 16, 1024  # the OpenMessaging Benchmark's 1 KB message, 16-byte keys
MQ_RATE = 50_000  # records/s: the OpenMessaging Benchmark's 1 KB workload rate
MQ_FLUSH_EVERY_S = 0.1  # the flusher's cadence: half the 200 ms lag deadline
MQ_CRASH_BYTES = 8 << 20  # records a crash-window child appends
MQ_SEED = SEED + 7
# point -> the arrival the child dies at: the first seal (one 4 MiB stripe
# in), the twentieth flush's fsync or journal
MQ_CRASH_POINTS = {"ec.stream.seal": 1, "ec.stream.before_fsync": 20, "ec.stream.before_journal": 20}


def row_chunks(lo: int, hi: int, block: int) -> int:
    """Chunks (one k = 1 delta each) that processing the linear bytes
    [lo, hi) takes: one per block-sized row segment it touches."""
    return (hi - 1) // block - lo // block + 1 if hi > lo else 0


def stream_phase(work, src, ctx, nbytes: int = STREAM_BYTES, cards=None) -> tuple[dict, int]:
    """Phase 7a: the first `nbytes` of `src` appended in 8 KiB pieces
    to an `EcStreamEncoder` at its defaults (1 MiB blocks, 64 KiB small
    blocks), flushed at 256 KiB pending, closed with finalize; against
    one `write_ec_files` over the same bytes. Returns (result, launches):
    the stream's and the batch encode's, apart in the result. Both
    backends are appended to `cards` where it is given."""
    from seaweedfs_tpu_torch.ec import BitrotProtection, EcStreamEncoder, TorchBackend, write_ec_files
    from seaweedfs_tpu_torch.ops import gf256, rs_kernels

    d = os.path.join(work, "stream")
    os.makedirs(d)
    with open(src, "rb") as f:
        payload = f.read(nbytes)
    if len(payload) != nbytes:
        raise AssertionError(f"the .dat holds {len(payload)} bytes, fewer than {nbytes}")
    sbase, bbase = os.path.join(d, "s"), os.path.join(d, "b")
    backend = TorchBackend(ctx, device=DEVICE)
    rs_kernels.reset_launches()
    enc = EcStreamEncoder(sbase, ctx, backend=backend)
    block, small, k = enc.block_size, enc.small_block_size, ctx.data_shards
    if (block, small) != (1 << 20, 64 << 10) or backend.device.type != DEVICE:
        raise AssertionError(f"stream at block {block}, small {small}, on {backend.device}")
    n_app = len(payload) // APPEND_BYTES
    view = memoryview(payload)
    t_append = np.zeros(n_app)
    lags: list[float] = []
    covered = processed = chunks = flushes = 0

    def flushed(durable: int) -> None:
        nonlocal covered, processed, chunks, flushes
        now = time.perf_counter()
        chunks += row_chunks(processed, durable, block)
        processed = durable
        flushes += 1
        while covered < n_app and (covered + 1) * APPEND_BYTES <= durable:
            lags.append(now - t_append[covered])
            covered += 1

    t0 = time.perf_counter()
    for i in range(n_app):
        t_append[i] = time.perf_counter()
        enc.append(view[i * APPEND_BYTES : (i + 1) * APPEND_BYTES])
        if enc.pending_bytes >= FLUSH_BYTES:
            flushed(enc.flush())
    flushed(enc.flush())
    stream_s = time.perf_counter() - t0
    if covered != n_app or processed != len(payload):
        raise AssertionError(f"{covered} of {n_app} appends durable, {processed} bytes processed")
    flush_launches = rs_kernels.LAUNCHES["gf2_apply"]
    t0 = time.perf_counter()
    prot = enc.close()
    close_s = time.perf_counter() - t0
    stripe = block * k
    tail_stripes = -(-(len(payload) % stripe) // (small * k))
    launches = rs_kernels.LAUNCHES["gf2_apply"]
    masked = rs_kernels.MASKED["gf2_apply"]
    if flush_launches != chunks or launches != chunks + tail_stripes:
        raise AssertionError(f"stream launched {flush_launches} + {launches - flush_launches} kernels "
                             f"for {chunks} chunks + {tail_stripes} tail stripes")

    with open(bbase + ".dat", "wb") as f:
        f.write(payload)
    del payload, view
    bbackend = TorchBackend(ctx, device=DEVICE)
    if cards is not None:
        cards += [backend, bbackend]
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    bprot = write_ec_files(bbase, ctx, bbackend, large_block_size=block, small_block_size=small)
    batch_s = time.perf_counter() - t0
    batch_launches = rs_kernels.LAUNCHES["gf2_apply"]
    lists = lambda pr: (pr.shard_sizes, pr.shard_crcs, pr.leaf_size, pr.shard_leaf_crcs)  # noqa: E731
    if lists(prot) != lists(bprot) or lists(BitrotProtection.load(sbase + ".ecsum")) != lists(bprot):
        raise AssertionError("the stream's block or leaf CRC lists differ from the batch encode's")
    for i in range(ctx.total):
        if sha256(sbase + ctx.to_ext(i)) != sha256(bbase + ctx.to_ext(i)):
            raise AssertionError(f"stream shard {i} differs from the batch encode's")
    if os.path.exists(sbase + ".stream"):
        raise AssertionError("finalize left the stream's journal behind")
    shutil.rmtree(d)
    st = backend.stage_seconds
    device_s = st["h2d"] + st["kernel"] + st["d2h"]
    split = round_trip_split(backend, gf256.parity_rows(K, M)[:, :1])
    return {
        "bytes": nbytes, "appends": n_app, "append_bytes": APPEND_BYTES,
        "flush_bytes": FLUSH_BYTES, "flushes": flushes, "block": block, "small_block": small,
        "time_to_durable_parity_p50_ms": percentile_ms(lags, 50),
        "time_to_durable_parity_p99_ms": percentile_ms(lags, 99),
        "time_to_durable_parity_max_ms": percentile_ms(lags, 100),
        "appends_per_s": n_app / stream_s, "stream_seconds": stream_s,
        "close_finalize_seconds": close_s, "stream_mb_per_s": nbytes / (stream_s + close_s) / 1e6,
        "batch_encode_seconds": batch_s, "batch_launches": batch_launches,
        "launches": launches, "chunks": chunks, "tail_stripes": tail_stripes,
        "launches_table_body": launches - masked, "launches_masked_path": masked,
        "host_us_per_launch": (enc.stage_seconds["h2d_dispatch"] + enc.stage_seconds["device_drain"])
        / launches * 1e6,
        "device_busy_share": st["kernel"] / (stream_s + close_s),
        "device_h2d_kernel_d2h_share": device_s / (stream_s + close_s),
        "encoder_stage_seconds": dict(enc.stage_seconds), "backend_stage_seconds": dict(st),
        "round_trip_host_us": split,
    }, launches + batch_launches


def round_trip_split(backend, coeffs, reps: int = 200) -> dict:
    """Median host time, in microseconds, of each hook of one stream
    delta's round trip (a (1, 256 KiB) chunk, m = 4) on an idle stream:
    `to_device` (the pin copy and queueing the H2D copy), `apply_staged`
    (the launch) and `to_host` (the wait, the D2H copy and the wait for
    it). Not counted as main-path launches."""
    from seaweedfs_tpu_torch.ops import rs_kernels

    chunk = np.random.default_rng(SEED).integers(0, 256, (1, FLUSH_BYTES), dtype=np.uint8)
    launches, masked = dict(rs_kernels.LAUNCHES), dict(rs_kernels.MASKED)
    times = {"to_device": [], "apply_staged": [], "to_host": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        staged = backend.to_device(chunk)
        t1 = time.perf_counter()
        handle = backend.apply_staged(coeffs, staged)
        t2 = time.perf_counter()
        backend.to_host(handle)
        t3 = time.perf_counter()
        for key, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
            times[key].append(dt)
    rs_kernels.LAUNCHES.update(launches)
    rs_kernels.MASKED.update(masked)
    return {key: float(np.median(v) * 1e6) for key, v in times.items()}


def mq_source(n: int) -> tuple[bytes, bytes]:
    """The phase 7b records' keys and values, seeded: record i has key
    keys[16i:16i+16] and value values[1024i:1024i+1024]."""
    rng = np.random.default_rng(MQ_SEED)
    return rng.bytes(MQ_KEY * n), rng.bytes(MQ_VALUE * n)


def mq_record_bytes() -> int:
    from seaweedfs_tpu_torch.mq.stream_parity import encode_record

    return len(encode_record(0, 0, bytes(MQ_KEY), bytes(MQ_VALUE)))


def check_records(recs, keys, values, ts0: int, first: int = 0) -> None:
    """Raise unless `recs` are the records appended, dense from offset
    `first`."""
    for i, (off, ts, key, value) in enumerate(recs, first):
        if (off, ts) != (i, ts0 + i) or key != keys[i * MQ_KEY : (i + 1) * MQ_KEY] \
                or value != values[i * MQ_VALUE : (i + 1) * MQ_VALUE]:
            raise AssertionError(f"recovered record {i} (offset {off}) differs from the one appended")


def gens_of(d: str) -> list[int]:
    return sorted({int(n[4:].split(".", 1)[0]) for n in os.listdir(d) if n.startswith("gen-")})


def verify_gens(d: str, ctx, backend) -> int:
    """A second recovery pass over every generation of partition dir
    `d`: raises if any parity is rewritten. Returns the stripes checked."""
    from seaweedfs_tpu_torch.ec import load_stream_journal, recover_stream
    from seaweedfs_tpu_torch.mq.stream_parity import dense_frame_scan

    stripes = 0
    for g in gens_of(d):
        base = os.path.join(d, f"gen-{g:08d}")
        j = load_stream_journal(base)
        rec = recover_stream(base, ctx, backend, frame_scan=dense_frame_scan(j.meta))
        if rec.parity_rewritten:
            raise AssertionError(f"{base}: a second recovery pass rewrote {rec.parity_rewritten} stripes")
        stripes += -(-rec.head // (ctx.data_shards * j.block_size))
    return stripes


# A partition that appends the phase 7b records and flushes by the
# broker's policy, printing the records durable after each flush, until
# the armed point kills it.
MQ_CRASH_CHILD = r"""
import sys
from chip_smoke import MQ_KEY, MQ_VALUE, mq_source
from seaweedfs_tpu_torch import faults
from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity

root, point, nth, n, n_source, ts0 = sys.argv[1:7]
n, ts0 = int(n), int(ts0)
keys, values = mq_source(int(n_source))  # the parent's records, the first n of them appended
faults.inject(point, faults.hard_exit(137), when=faults.nth_call(int(nth)))
pp = PartitionParity(root, "bench", "crash", 0)
for i in range(n):
    pp.append_record(i, ts0 + i, keys[i * MQ_KEY:(i + 1) * MQ_KEY], values[i * MQ_VALUE:(i + 1) * MQ_VALUE])
    if pp.needs_flush():
        pp.flush()
        print("flushed", i + 1, flush=True)
pp.flush()
print("flushed", n, flush=True)
sys.exit(3)  # the armed point never fired
"""


def mq_publish(root: str, topic: str, n: int, keys: bytes, values: bytes, ts0: int,
               backend_name: str = DEVICE, after_flush=None) -> dict:
    """One partition at the broker's defaults takes the first `n` records
    at MQ_RATE from the calling thread while a flusher thread applies the
    policy every MQ_FLUSH_EVERY_S; then it closes. The kernel counters
    are reset first. Returns the partition's context and backend, each
    flush call's (start, end), each append's time, the append and close
    times and each generation's encoder. `backend_name` is the backend
    that SEAWEED_EC_STREAM_BACKEND names (the cached one the partition
    takes at its first generation). `after_flush(pp)`, where given, runs
    on the flusher thread after each of its flushes."""
    import threading

    from seaweedfs_tpu_torch.ec import get_backend
    from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity
    from seaweedfs_tpu_torch.ops import rs_kernels

    pp = PartitionParity(root, "bench", topic, 0)
    ctx = pp.ctx
    # the cached backend the partition builds at its first generation
    backend = get_backend(backend_name, ctx.data_shards, ctx.parity_shards)
    if ((ctx.data_shards, ctx.parity_shards), pp.block_size, pp.flush_bytes, pp.max_lag_s,
            pp.rotate_bytes, backend.device.type) != ((4, 2), 1 << 20, 256 << 10, 0.2, MQ_ROTATE_BYTES,
                                                      DEVICE):
        raise AssertionError("the partition is not at the broker's defaults on the card")
    backend.reset_stages()
    rs_kernels.reset_launches()
    stop = threading.Event()
    calls: list[tuple[float, float]] = []
    errors: list[BaseException] = []
    encoders = {}  # each generation's encoder, for its stage table

    def flusher() -> None:
        try:
            while not stop.wait(MQ_FLUSH_EVERY_S):
                if pp.needs_flush():
                    if pp._enc is not None:
                        encoders[id(pp._enc)] = pp._enc
                    t = time.perf_counter()
                    pp.flush()
                    calls.append((t, time.perf_counter()))
                    if after_flush is not None:
                        after_flush(pp)
        except BaseException as e:  # noqa: BLE001 - raised on the main thread
            errors.append(e)

    thread = threading.Thread(target=flusher, name="mq-parity-flusher")
    thread.start()
    t_append = np.zeros(n)
    t0 = time.perf_counter()
    try:
        for i in range(n):
            ahead = t0 + i / MQ_RATE - time.perf_counter()
            if ahead > 0.001:
                time.sleep(ahead)
            t_append[i] = time.perf_counter()
            pp.append_record(i, ts0 + i, keys[i * MQ_KEY : (i + 1) * MQ_KEY],
                             values[i * MQ_VALUE : (i + 1) * MQ_VALUE])
    finally:
        stop.set()
        thread.join()
    if errors:
        raise errors[0]
    if pp.backend is not backend:
        raise AssertionError(f"the partition runs on {pp.backend}, not on the card's backend")
    append_s = time.perf_counter() - t0
    if pp._enc is not None:
        encoders[id(pp._enc)] = pp._enc
    t_close = time.perf_counter()
    pp.close()
    t_end = time.perf_counter()
    return {"ctx": ctx, "backend": backend, "calls": calls, "t_append": t_append,
            "append_s": append_s, "t_close": t_close, "t_end": t_end, "encoders": encoders}


def mq_phase(work) -> tuple[dict, int]:
    """Phase 7b: one partition at the broker's defaults (4+2, 1 MiB
    blocks, flush at 256 KiB or 200 ms, rotation at 64 MiB) takes
    MQ_BYTES of 1 KB records at MQ_RATE from the main thread while a
    flusher thread applies the policy every 100 ms; closed, then
    recovered by a fresh partition; then each crash window, in a child.
    Returns (result, launches)."""
    from seaweedfs_tpu_torch.ec import load_stream_journal, stream_summary
    from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity
    from seaweedfs_tpu_torch.ops import rs_kernels

    root = os.path.join(work, "mq")
    rec_bytes = mq_record_bytes()
    n = MQ_BYTES // rec_bytes
    keys, values = mq_source(n)
    ts0 = time.time_ns()
    pub = mq_publish(root, "omb", n, keys, values, ts0)
    ctx, backend, calls, t_append = pub["ctx"], pub["backend"], pub["calls"], pub["t_append"]
    append_s, t_close, t_end, encoders = pub["append_s"], pub["t_close"], pub["t_end"], pub["encoders"]
    launches = rs_kernels.LAUNCHES["gf2_apply"]
    masked = rs_kernels.MASKED["gf2_apply"]
    st = dict(backend.stage_seconds)
    # an append's parity is durable once a flush called after it returns
    # (or the close): an upper bound on its time-to-durable-parity
    starts = np.array([c[0] for c in calls])
    ends = np.array([c[1] for c in calls] + [t_end])
    lags = ends[np.searchsorted(starts, t_append, side="left")] - t_append
    part = os.path.join(root, "bench", "omb", "0000")
    gens = gens_of(part)

    rs_kernels.reset_launches()
    rewritten0 = stream_summary()["recovered"].get("parity_rewritten", 0)
    t0 = time.perf_counter()
    recs = PartitionParity(root, "bench", "omb", 0).recover()
    recover_s = time.perf_counter() - t0
    rec_launches = rs_kernels.LAUNCHES["gf2_apply"]
    if len(recs) != n:
        raise AssertionError(f"recovered {len(recs)} of {n} records")
    check_records(recs, keys, values, ts0)
    del recs
    if stream_summary()["recovered"].get("parity_rewritten", 0) != rewritten0:
        raise AssertionError("recovery of a cleanly closed partition rewrote parity")
    stripes = 0
    for g in gens:
        j = load_stream_journal(os.path.join(part, f"gen-{g:08d}"))
        stripes += -(-j.durable // (ctx.data_shards * j.block_size))
    if rec_launches != stripes:
        raise AssertionError(f"recovery launched {rec_launches} kernels for {stripes} stripes")
    total_launches = launches + rec_launches

    # -- one flush as large as the mean flush above, with no publisher
    # running beside it: what the flush costs on its own
    per_flush = n // max(len(calls), 1)
    solo_root = os.path.join(work, "mq-solo")
    sp = PartitionParity(solo_root, "bench", "solo", 0)
    for i in range(per_flush):
        sp.append_record(i, ts0 + i, keys[i * MQ_KEY : (i + 1) * MQ_KEY],
                         values[i * MQ_VALUE : (i + 1) * MQ_VALUE])
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    sp.flush()
    solo = {"records": per_flush, "flush_ms": (time.perf_counter() - t0) * 1e3,
            "encoder_stage_seconds": dict(sp._enc.stage_seconds)}
    total_launches += rs_kernels.LAUNCHES["gf2_apply"]
    sp.close()
    shutil.rmtree(solo_root)

    # -- crash windows: a child dies at each point, the parent recovers --
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    n_crash = -(-MQ_CRASH_BYTES // rec_bytes)
    windows = []
    for point, nth in MQ_CRASH_POINTS.items():
        croot = os.path.join(work, "mq-crash-" + point.rsplit(".", 1)[1])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", MQ_CRASH_CHILD, croot, point, str(nth), str(n_crash), str(n),
             str(ts0)],
            cwd=repo, env=env, capture_output=True, text=True, timeout=60,
        )
        child_s = time.perf_counter() - t0
        done = [int(line.split()[1]) for line in proc.stdout.splitlines() if line.startswith("flushed")]
        if proc.returncode != 137 or not done:
            raise AssertionError(f"{point}: child exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
        rs_kernels.reset_launches()
        rewritten0 = stream_summary()["recovered"].get("parity_rewritten", 0)
        t0 = time.perf_counter()
        cp = PartitionParity(croot, "bench", "crash", 0)
        got = cp.recover()
        rec_s = time.perf_counter() - t0
        if len(got) < done[-1]:
            raise AssertionError(f"{point}: recovered {len(got)} records, the child flushed {done[-1]}")
        check_records(got, keys, values, ts0)
        rewritten = stream_summary()["recovered"].get("parity_rewritten", 0) - rewritten0
        cdir = os.path.join(croot, "bench", "crash", "0000")
        checked = verify_gens(cdir, ctx, backend)
        nxt = len(got)
        for i in range(nxt, nxt + 3):  # appends continue dense after the tail
            cp.append_record(i, ts0 + i, keys[i * MQ_KEY : (i + 1) * MQ_KEY],
                             values[i * MQ_VALUE : (i + 1) * MQ_VALUE])
        cp.flush()
        cp.close()
        again = PartitionParity(croot, "bench", "crash", 0).recover()
        if len(again) != nxt + 3:
            raise AssertionError(f"{point}: {len(again)} records after 3 more appends to {nxt}")
        check_records(again, keys, values, ts0)
        total_launches += rs_kernels.LAUNCHES["gf2_apply"]
        windows.append({
            "point": point, "child_s": child_s, "child_flushed_records": done[-1],
            "recovered_records": nxt, "recovery_s": rec_s, "parity_rewritten_first_pass": rewritten,
            "second_pass_stripes_clean": checked, "appended_after": 3,
        })
        shutil.rmtree(croot)
    shutil.rmtree(root)
    return {
        "records": n, "record_bytes": rec_bytes, "bytes": n * rec_bytes, "rate_per_s": MQ_RATE,
        "appends_per_s": n / append_s, "append_seconds": append_s, "close_seconds": t_end - t_close,
        "flushes": len(calls), "generations": len(gens),
        "flush_ms_p50": float(np.median([e - b for b, e in calls]) * 1e3),
        "flush_ms_max": float(max(e - b for b, e in calls) * 1e3),
        "flush_interval_ms_p50": float(np.median(np.diff(starts)) * 1e3) if len(calls) > 1 else None,
        "solo_flush": solo,
        "time_to_durable_parity_p50_ms": float(np.percentile(lags, 50) * 1e3),
        "time_to_durable_parity_p99_ms": float(np.percentile(lags, 99) * 1e3),
        "time_to_durable_parity_max_ms": float(lags.max() * 1e3),
        "launches": launches, "launches_table_body": launches - masked,
        "launches_masked_path": masked, "masked_share": masked / max(launches, 1),
        "recovery_seconds": recover_s, "recovery_launches": rec_launches, "recovery_stripes": stripes,
        "crash_windows": windows, "backend_stage_seconds": st,
        "encoder_stage_seconds": {
            k: sum(e.stage_seconds[k] for e in encoders.values()) for k in next(iter(encoders.values())).stage_seconds
        },
        "device_busy_share": st["kernel"] / (append_s + t_end - t_close),
    }, total_launches


# -- 9. the flight recorder, armed, over every path ---------------------------------

TRACE_READS = 20  # cold degraded reads of shard DEGRADED
TRACE_STREAM_BYTES = 32 << 20  # a phase 7a stream of this size
TRACE_MQ_FLUSHES = 4  # the phase 7b partition runs for at least this many flushes
TRACE_MQ_SECONDS = 2.0  # of 7b's traffic: 7b's flushes start 207-266 ms apart
TRACE_TOL_S = 0.05  # clock-read ordering slack of the span invariants
_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> dict:
    """Every sample of a Prometheus text exposition: {(name, sorted
    (label, value) pairs): value}. Raises on a line that does not lex."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith("# HELP ") or ln.startswith("# TYPE "):
            continue
        m = _SAMPLE.match(ln)
        if m is None:
            raise AssertionError(f"the registry rendered an unparseable line: {ln!r}")
        labels = tuple(sorted(
            (k, v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\"))
            for k, v in _LABEL.findall(m.group(2) or "")
        ))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def series(parsed: dict, name: str, label: str) -> dict:
    """{label value: sample value} of one single-label metric."""
    return {dict(lab)[label]: v for (n, lab), v in parsed.items() if n == name}


def walk(doc):
    yield doc
    for child in doc["children"]:
        yield from walk(child)


def check_tree(root: dict) -> None:
    """The span invariants of the JAX package's tests/test_trace.py, on
    every node: one trace id, every node inside its root's wall, every
    stage but queue_wait (summed over two threads) no longer than its
    node, every stage counted."""
    lo = root["start_ts"] - TRACE_TOL_S
    hi = root["start_ts"] + root["duration_s"] + TRACE_TOL_S
    for node in walk(root):
        if node["trace_id"] != root["trace_id"] or node["duration_s"] < 0.0 \
                or node["start_ts"] < lo or node["start_ts"] + node["duration_s"] > hi:
            raise AssertionError(f"span {node['op']} lies outside its root {root['op']}")
        for name, acc in node["stages"].items():
            if acc["count"] < 1 or (name != "queue_wait"
                                    and acc["seconds"] > node["duration_s"] + TRACE_TOL_S):
                raise AssertionError(f"stage {name} of {node['op']} exceeds its span: {acc}")


def device_stages(node: dict, launches: int, what: str, drain: str, card_of: dict) -> None:
    """The node's admission_wait, h2d_dispatch and device_drain each
    counted once per launch. A `TorchBackend` has no chip label (as a
    single-device JaxBackend has none), so the scheduled dispatch stages
    carry its device queue's label, "TorchBackend:<k>+<m>@<n>", and the
    drain carries what the JAX call site gives it: that label in the
    staged-apply driver (`drain="queue"`), "" in the encoder and the
    stream (`drain=""`). `card_of` maps each queue label of the phase to
    its backend's device: the label must name a backend on the card."""
    label = node["stages"].get("h2d_dispatch", {"chip": ""})["chip"]
    card0 = "cuda:0" if DEVICE == "cuda" else DEVICE
    want = {"admission_wait": label, "h2d_dispatch": label,
            "device_drain": label if drain == "queue" else ""}
    for s, chip in want.items():
        acc = node["stages"].get(s, {"count": 0, "chip": ""})
        if acc["count"] != launches or acc["chip"] != chip or not label.startswith("TorchBackend:") \
                or card_of.get(label) != card0:
            raise AssertionError(f"{what}: {s} counted {acc['count']} on {acc['chip']!r} "
                                 f"for {launches} launches on {chip!r}, a queue of the backend "
                                 f"on {card_of.get(label)!r}")


def trace_phase(work, base, ctx, records, dat_size, digests, prot, n_batches, mq_solo) -> tuple[dict, dict]:
    """Phase 9: the EC paths once more with the flight recorder armed
    (utils/trace.py), in `work`/trace (hard links to the volume's .dat
    and .idx), each output checked sha256-identical to its disarmed
    counterpart: encode (in turns with disarmed encodes: the tracer's
    cost), rebuild of LOST, TRACE_READS cold degraded reads of DEGRADED
    (then the .heat sidecar checked and read back by a fresh mount), a
    leaf repair of one rotten leaf, decode, a TRACE_STREAM_BYTES stream
    and phase 7b's partition for at least TRACE_MQ_FLUSHES flushes. Then
    every tree's invariants, one root per op (`sw_ec_traces_total`
    alike), device stages counted per launch on cuda:0, overlap
    efficiency in [0, 1], the registry's rendering and the leaf-repair
    counter, and the Chrome trace. Returns (result, launches by kernel)."""
    import collections

    from seaweedfs_tpu_torch.ec import (
        BitrotProtection, EcVolume, TorchBackend, VolumeInfo, ec_decode_volume, ec_encode_volume,
        device_queue, rebuild_ec_files, scrub_ec_volume,
    )
    from seaweedfs_tpu_torch.ec.decoder import find_dat_file_size
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH
    from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.utils import metrics, trace

    tdir = os.path.join(work, "trace")
    tbase = os.path.join(tdir, "1")
    shard = {i: tbase + ctx.to_ext(i) for i in range(ctx.total)}
    launches = dict.fromkeys(("gf2_apply", "gf2_apply_planes"), 0)
    expected = collections.Counter()  # root op -> roots this phase must record
    lists = lambda pr: (pr.shard_sizes, pr.shard_crcs, pr.leaf_size, pr.shard_leaf_crcs)  # noqa: E731

    def counted() -> dict:
        got = {k: rs_kernels.LAUNCHES[k] for k in launches}
        for k, v in got.items():
            launches[k] += v
        return got

    reb_batches = -(-prot.shard_sizes[0] // DEFAULT_BATCH)
    # every backend of the phase, alive until its device stages are
    # checked, so each queue label still names its backend
    cards: list = []

    def card(**kw):
        cards.append(TorchBackend(ctx, **kw))
        return cards[-1]

    before = parse_exposition(metrics.REGISTRY.render().decode())
    trace.configure(enabled=False, ring_size=1024, slow_op_s=0.0)
    trace.reset()
    try:
        # -- encode, disarmed and armed in turns ---------------------------
        walls: dict = {"disarmed": [], "armed": []}
        for armed in (False, True, True, False):
            trace.configure(enabled=armed)
            rs_kernels.reset_launches()
            t0 = time.perf_counter()
            ec_encode_volume(tbase, ctx, backend=card())
            walls["armed" if armed else "disarmed"].append(time.perf_counter() - t0)
            if counted()["gf2_apply"] != n_batches:
                raise AssertionError(f"encode launched {rs_kernels.LAUNCHES} for {n_batches} batches")
            if lists(BitrotProtection.load(tbase + ".ecsum")) != lists(prot):
                raise AssertionError("phase 9's encode gives other CRC lists than phase 4's")
            if armed:
                expected["ec.encode_volume"] += 1
                for i in range(ctx.total):
                    if sha256(shard[i]) != digests[i]:
                        raise AssertionError(f"armed encode: shard {i} differs from phase 4's")
        trace.configure(enabled=True)

        # -- rebuild -------------------------------------------------------
        for i in LOST:
            os.unlink(shard[i])
        rs_kernels.reset_launches()
        t0 = time.perf_counter()
        if rebuild_ec_files(tbase, backend=card()) != list(LOST):
            raise AssertionError("armed rebuild regenerated other shards")
        reb_s = time.perf_counter() - t0
        if counted()["gf2_apply"] != reb_batches or any(sha256(shard[i]) != digests[i] for i in LOST):
            raise AssertionError(f"armed rebuild: {rs_kernels.LAUNCHES}, or a shard differs")
        expected["ec.rebuild"] += 1

        # -- cold degraded reads, and the .heat sidecar ------------------------
        reads = degraded_records(records, dat_size)[:TRACE_READS]
        backend = card(impl="cuda_planes")
        src_fd = os.open(base + ".dat.orig", os.O_RDONLY)
        ev = EcVolume(tdir, 1, backend=backend)
        try:
            if (ev.bytes_read, ev.bytes_reconstructed) != (0, 0):
                raise AssertionError("a fresh mount started with heat")
            ev.unmount_shards([DEGRADED])
            rs_kernels.reset_launches()
            t0 = time.perf_counter()
            for rec in reads:
                if ev.read_needle(rec[0], cookie=rec[1]).data != os.pread(src_fd, rec[3], rec[2] + 20):
                    raise AssertionError(f"armed degraded read of needle {rec[0]:x} differs")
            reads_s = time.perf_counter() - t0
            heat = (ev.bytes_read, ev.bytes_reconstructed)
            loads = ev.interval_cache.loads
        finally:
            ev.close()
            os.close(src_fd)
        if counted()["gf2_apply_planes"] != loads or not heat[1]:
            raise AssertionError(f"armed reads: {rs_kernels.LAUNCHES} for {loads} cache misses")
        expected["ec.degraded_read"] += sum(
            1 for rec in reads for sid, _, _ in needle_intervals(rec, dat_size) if sid == DEGRADED)
        with open(tbase + ".heat") as f:
            blob = json.load(f)
        gen = VolumeInfo.load(tbase + ".vif").encode_ts_ns
        if blob != {"gen": gen, "read_bytes": heat[0], "reconstructed_bytes": heat[1]}:
            raise AssertionError(f".heat holds {blob}, the reads counted {heat} at generation {gen}")
        ev = EcVolume(tdir, 1, backend=backend)
        remount = (ev.bytes_read, ev.bytes_reconstructed)
        ev.close()
        if remount != heat:
            raise AssertionError(f"a fresh mount read {remount} back from .heat, not {heat}")

        # -- one rotten leaf of shard LEAF_DATA, repaired in place ----------------
        tprot = BitrotProtection.load(tbase + ".ecsum")
        leaf = len(tprot.shard_leaf_crcs[LEAF_DATA]) // 5
        flip(shard[LEAF_DATA], leaf * tprot.leaf_size + 500)
        repaired0 = series(before, "sw_ec_leaf_repairs_total", "outcome").get("repaired", 0.0)
        rs_kernels.reset_launches()
        t0 = time.perf_counter()
        r = scrub_ec_volume(tbase, ctx, backend=card(), repair=True)
        scrub_s = time.perf_counter() - t0
        if r.leaf_repaired != {LEAF_DATA: [leaf]} or r.quarantined or r.rebuilt or r.refused \
                or counted()["gf2_apply"] != 1 or sha256(shard[LEAF_DATA]) != digests[LEAF_DATA]:
            raise AssertionError(f"armed leaf repair: {r}, {rs_kernels.LAUNCHES}")
        expected["ec.leaf_repair"] += 1

        # -- decode, shard DEGRADED removed -------------------------------------
        os.unlink(shard[DEGRADED])
        rs_kernels.reset_launches()
        t0 = time.perf_counter()
        if not ec_decode_volume(tbase, ctx, backend=card(impl="cuda_planes")):
            raise AssertionError("armed decode found no live needle")
        dec_s = time.perf_counter() - t0
        if counted()["gf2_apply_planes"] != reb_batches or sha256(shard[DEGRADED]) != digests[DEGRADED]:
            raise AssertionError(f"armed decode: {rs_kernels.LAUNCHES}, or shard {DEGRADED} differs")
        live = find_dat_file_size(tbase, 3)
        if os.path.getsize(tbase + ".dat") != live or sha256(tbase + ".dat") != sha256(base + ".dat.orig", live):
            raise AssertionError("armed decode: the .dat differs from the original")
        expected["ec.decode"] += 1

        # -- a phase 7a stream, and its batch encode ------------------------------
        stream, _ = stream_phase(work, base + ".dat.orig", ctx, TRACE_STREAM_BYTES, cards)
        launches["gf2_apply"] += stream["launches"] + stream["batch_launches"]
        expected["ec.stream_encode"] += 1
        expected["ec.encode"] += 1  # write_ec_files alone is its own root

        # -- phase 7b's partition at its own traffic ----------------------------
        n = int(MQ_RATE * TRACE_MQ_SECONDS)
        keys, values = mq_source(n)
        ts0 = time.time_ns()
        mq_root = os.path.join(work, "mq-trace")
        pub = mq_publish(mq_root, "traced", n, keys, values, ts0)
        mq_launches = counted()["gf2_apply"]
        if len(pub["calls"]) < TRACE_MQ_FLUSHES:
            raise AssertionError(f"the traced partition flushed {len(pub['calls'])} times")
        gens = gens_of(os.path.join(mq_root, "bench", "traced", "0000"))
        expected["ec.stream_encode"] += len(gens)
        rs_kernels.reset_launches()
        recs = PartitionParity(mq_root, "bench", "traced", 0).recover()
        counted()
        if len(recs) != n:
            raise AssertionError(f"the traced partition replayed {len(recs)} of {n} records")
        check_records(recs, keys, values, ts0)
        del recs
        shutil.rmtree(mq_root)
    finally:
        trace.configure(enabled=False)
    docs = trace.traces()
    trace.reset()

    # -- the recorder's own checks ---------------------------------------------
    got = collections.Counter(d["op"] for d in docs)
    after = parse_exposition(metrics.REGISTRY.render().decode())
    counted_roots = {op: v - series(before, "sw_ec_traces_total", "op").get(op, 0.0)
                     for op, v in series(after, "sw_ec_traces_total", "op").items()}
    if got != expected or {op: v for op, v in counted_roots.items() if v} != dict(expected):
        raise AssertionError(f"roots {dict(got)}, sw_ec_traces_total moved {counted_roots}, "
                             f"expected {dict(expected)}")
    if series(after, "sw_ec_leaf_repairs_total", "outcome").get("repaired", 0.0) - repaired0 != 1:
        raise AssertionError("sw_ec_leaf_repairs_total{outcome=repaired} did not count the one range")
    by_op = collections.defaultdict(list)
    for d in docs:
        check_tree(d)
        by_op[d["op"]].append(d)
    card_of = {device_queue._queue_label(be): str(be.device) for be in cards}
    for d in by_op["ec.encode_volume"]:
        (child,) = d["children"]
        device_stages(child, n_batches, "encode", "", card_of)
    device_stages(by_op["ec.rebuild"][0], reb_batches, "rebuild", "queue", card_of)
    device_stages(by_op["ec.decode"][0]["children"][0], reb_batches, "decode's rebuild", "queue", card_of)
    device_stages(by_op["ec.encode"][0], stream["batch_launches"], "the stream's batch encode", "",
                  card_of)
    streams = sorted(by_op["ec.stream_encode"], key=lambda d: d["start_ts"])
    device_stages(streams[0], stream["launches"], "stream", "", card_of)
    mq_docs = streams[1:]
    mq_stages = collections.defaultdict(lambda: [0.0, 0])
    for d in mq_docs:
        for s, acc in d["stages"].items():
            mq_stages[s][0] += acc["seconds"]
            mq_stages[s][1] += acc["count"]
    for s in ("admission_wait", "h2d_dispatch", "device_drain"):
        chips = {d["stages"][s]["chip"] for d in mq_docs if s in d["stages"]}
        ok = all(c.startswith("TorchBackend:4+2@") for c in chips) if s != "device_drain" \
            else chips == {""}
        if mq_stages[s][1] != mq_launches or not ok or len(chips) != 1:
            raise AssertionError(f"partition: {s} counted {mq_stages[s][1]} on {chips} "
                                 f"for {mq_launches} launches of one backend")
    effs = {}
    for d in docs:
        for node in walk(d):
            e = trace.overlap_efficiency(node)
            if e is not None:
                if not 0.0 <= e <= 1.0:
                    raise AssertionError(f"overlap efficiency {e} of {node['op']}")
                effs.setdefault(node["op"], []).append(e)

    def summary(nodes: list) -> dict:
        stages: dict = {}
        for node in nodes:
            for s, acc in node["stages"].items():
                t = stages.setdefault(s, {"seconds": 0.0, "count": 0})
                t["seconds"] += acc["seconds"]
                t["count"] += acc["count"]
        e = [x for x in (trace.overlap_efficiency(nd) for nd in nodes) if x is not None]
        return {"spans": len(nodes), "wall_s": sum(nd["duration_s"] for nd in nodes), "stages": stages,
                "overlap_efficiency": float(np.mean(e)) if e else None}

    ops = {}
    for d in docs:
        for node in walk(d):
            key = d["op"] if node is d else f"{d['op']}/{node['op']}"
            ops.setdefault(key, []).append(node)
    # the stream's own span apart from the partition's generations
    ops["ec.stream_encode"] = streams[:1]
    ops["ec.stream_encode (7b partition)"] = mq_docs
    flushes = len(pub["calls"]) + 1  # and the close's
    flush_wall = sum(e - b for b, e in pub["calls"]) + pub["t_end"] - pub["t_close"]
    named = sum(mq_stages[s][0] for s in ("write_sink", "parity_update", "fsync_publish"))
    chrome = trace.chrome_trace(docs=docs)
    path = os.path.join(work, "phase9_trace.json")
    with open(path, "w") as f:
        json.dump(chrome, f)
    with open(path) as f:
        n_events = len(json.load(f)["traceEvents"])
    return {
        "ops": {k: summary(v) for k, v in sorted(ops.items())},
        "encode": {"armed_s": walls["armed"], "disarmed_s": walls["disarmed"],
                   "armed_over_disarmed": sum(walls["armed"]) / sum(walls["disarmed"])},
        "rebuild_s": reb_s, "reads": len(reads), "reads_s": reads_s, "read_cache_misses": loads,
        "heat": {"read_bytes": heat[0], "reconstructed_bytes": heat[1], "remount": list(remount)},
        "leaf_repair_scrub_s": scrub_s, "decode_s": dec_s,
        "stream": {k: stream[k] for k in ("bytes", "flushes", "launches", "stream_seconds",
                                          "time_to_durable_parity_p50_ms")},
        "partition": {
            "records": n, "flushes": flushes, "generations": len(gens), "launches": mq_launches,
            "flush_ms_mean": flush_wall / flushes * 1e3,
            "stage_ms_per_flush": {s: v[0] / flushes * 1e3 for s, v in sorted(mq_stages.items())},
            "unnamed_share_of_flush_wall": 1.0 - named / flush_wall,
            "phase_7b_solo_flush": mq_solo,
        },
        "overlap_efficiency": {op: [min(v), max(v)] for op, v in sorted(effs.items())},
        "roots": dict(got), "registry_samples": len(after),
        "chrome_trace": {"path": path, "events": n_events},
    }, launches


SCHED_RESET_S = 1.0  # 10c's breaker reset timeout: shorter than an encode, so probes fail mid-run
SCHED_THRESHOLD = 3  # 10c's breaker threshold: consecutive device failures before it opens
JAX_FOREGROUND_BAR = 0.85  # the JAX package's acceptance bar (ec/device_queue.py DEFAULT_SHARES)


def admitted(cls: str) -> tuple[float, float]:
    """`sw_ec_queue_admitted_total` and `..._cost_total` of one class,
    summed over every chip label, from the registry's text."""
    from seaweedfs_tpu_torch.utils import metrics

    parsed = parse_exposition(metrics.REGISTRY.render().decode())
    out = []
    for name in ("sw_ec_queue_admitted_total", "sw_ec_queue_admitted_cost_total"):
        out.append(sum(v for (n, lab), v in parsed.items() if n == name and dict(lab)["cls"] == cls))
    return out[0], out[1]


def gauge_of(be) -> float:
    """The breaker gauge's sample for one FallbackBackend."""
    from seaweedfs_tpu_torch.ec import backend as backend_mod

    label = be.chip_label or f"{type(be.primary).__name__}@{be._seq}"
    return dict((lab["chip"], v) for lab, v in backend_mod._breaker_samples())[label]


SCHED_TURN_READS = 30  # cold degraded reads per turn of 10b's scheduler on / off comparison


def losing_card():
    """`TorchBackend` subclass for 10c: a card that loses chosen batches
    of a staged stream as a reset card would, with an OSError (the class
    `FallbackBackend` fails over on). The `apply_staged` calls numbered
    in `at_dispatch` raise before they launch; the `to_host` calls
    numbered in `at_drain` raise after the batch ran. Made inside a
    function: the smoke imports the package only once it has a card."""
    from seaweedfs_tpu_torch.ec import TorchBackend

    class LosingCard(TorchBackend):
        def __init__(self, ctx, at_dispatch=(), at_drain=(), **kw):
            super().__init__(ctx, **kw)
            self.at_dispatch, self.at_drain = frozenset(at_dispatch), frozenset(at_drain)
            self.dispatched = self.drained = 0

        def apply_staged(self, coeffs, staged):
            self.dispatched += 1
            if self.dispatched in self.at_dispatch:
                raise OSError(f"the card was lost at dispatch {self.dispatched}")
            return super().apply_staged(coeffs, staged)

        def to_host(self, result):
            self.drained += 1
            if self.drained in self.at_drain:
                raise OSError(f"the card was lost at drain {self.drained}")
            return super().to_host(result)

    return LosingCard


def sched_phase(work, base, ctx, records, dat_size, digests, n_batches, enc_s) -> tuple[dict, dict]:
    """Phase 10: the device scheduler and the CPU failover, in
    `work`/sched (hard links to the volume's .dat and .idx, made right
    after phase 4). Returns (result, launches by kernel)."""
    import threading

    from seaweedfs_tpu_torch import faults
    from seaweedfs_tpu_torch.ec import (
        CpuBackend, EcVolume, FallbackBackend, QueueScope, TorchBackend, backend as backend_mod,
        ec_encode_volume, get_backend, rebuild_ec_files,
    )
    from seaweedfs_tpu_torch.mq.stream_parity import PartitionParity
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.utils import devices
    from seaweedfs_tpu_torch.utils.retry import CircuitBreaker

    src = os.path.join(work, "sched")
    launches = dict.fromkeys(("gf2_apply", "gf2_apply_planes"), 0)
    out: dict = {}
    LosingCard = losing_card()

    def volume_dir(name: str, shards_from: str | None = None) -> str:
        """A directory holding links to the .dat and .idx, or (for a
        rebuild) to a finished encode's sidecars and shards but LOST."""
        d = os.path.join(work, "sched-" + name)
        os.makedirs(d)
        if shards_from is None:
            for ext in (".dat", ".idx"):
                os.link(os.path.join(src, "1" + ext), os.path.join(d, "1" + ext))
        else:
            keep = [".ecx", ".ecj", ".vif", ".ecsum"] + [
                ctx.to_ext(i) for i in range(ctx.total) if i not in LOST]
            for ext in keep:
                if os.path.exists(shards_from + ext):
                    os.link(shards_from + ext, os.path.join(d, "1" + ext))
        return os.path.join(d, "1")

    def same_shards(b: str, what: str, ids=None) -> None:
        for i in (range(ctx.total) if ids is None else ids):
            if sha256(b + ctx.to_ext(i)) != digests[i]:
                raise AssertionError(f"{what}: shard {i} differs from phase 4's")

    def counted() -> int:
        for k in launches:
            launches[k] += rs_kernels.LAUNCHES[k]
        return rs_kernels.LAUNCHES["gf2_apply"]

    # -- 10a. the probe and auto --------------------------------------------------
    t0 = time.perf_counter()
    found = devices.probe_accelerators(refresh=True)
    probe_s = time.perf_counter() - t0
    auto = get_backend("auto", K, M)
    card0 = "cuda:0" if DEVICE == "cuda" else DEVICE
    if found < 1 or not isinstance(auto, FallbackBackend) or type(auto.primary) is not TorchBackend \
            or str(auto.primary.device) != card0 or any(backend_mod.AUTO_CPU.values()):
        raise AssertionError(f"auto resolved to {auto!r} with {found} cards probed, "
                             f"CPU resolutions {backend_mod.AUTO_CPU}")
    out["10a"] = {"probe_accelerators": found, "probe_s": probe_s, "auto": type(auto).__name__,
                  "primary": f"{type(auto.primary).__name__} on {auto.primary.device}",
                  "cpu_resolutions": dict(backend_mod.AUTO_CPU)}
    print("10a probe and auto: " + json.dumps(out["10a"]))

    # -- 10b. an unarmed encode through auto --------------------------------------
    b = volume_dir("b")
    fg0 = admitted("foreground")
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    ec_encode_volume(b, ctx, backend=auto)
    wall_b = time.perf_counter() - t0
    fg1 = admitted("foreground")
    n = counted()
    same_shards(b, "10b encode through auto")
    if (n, auto.fallback_batches, auto.breaker.state, gauge_of(auto), fg1[0] - fg0[0]) \
            != (n_batches, 0, "closed", 0.0, n_batches):
        raise AssertionError(f"10b: {n} launches, {auto.fallback_batches} batches on the CPU, "
                             f"breaker {auto.breaker.state}, gauge {gauge_of(auto)}, "
                             f"{fg1[0] - fg0[0]} foreground admissions for {n_batches} batches")
    out["10b"] = {"seconds": wall_b, "phase4_seconds": enc_s, "launches": n,
                  "foreground_admitted": fg1[0] - fg0[0], "foreground_cost": fg1[1] - fg0[1],
                  "fallback_batches": auto.fallback_batches, "breaker": auto.breaker.state,
                  "stage_seconds": dict(auto.stage_seconds)}
    print("10b encode through auto (14 shards sha256-identical, no batch on the CPU, one launch "
          "and one foreground admission per batch): " + json.dumps(out["10b"]))

    # -- 10b'. the scheduler's cost: the same encode and cold degraded reads
    # with the scope disabled and enabled, in turns, in one process ----------
    reads = degraded_records(records, dat_size)[:SCHED_TURN_READS]
    src_fd = os.open(base + ".dat.orig", os.O_RDONLY)
    off_scope = QueueScope(enabled=False)
    turns: dict = {"off": {"encode_s": [], "read_p50_ms": [], "read_p99_ms": []},
                   "on": {"encode_s": [], "read_p50_ms": [], "read_p99_ms": []}}
    try:
        for on in (False, True, True, False):
            scope = None if on else off_scope  # None: the default scope, enabled
            fg0 = admitted("foreground")
            rs_kernels.reset_launches()
            t0 = time.perf_counter()
            ec_encode_volume(b, ctx, backend=TorchBackend(ctx), scheduler=scope)
            wall = time.perf_counter() - t0
            if counted() != n_batches:
                raise AssertionError(f"10b': encode launched {rs_kernels.LAUNCHES}")
            same_shards(b, f"10b' encode with the scheduler {'on' if on else 'off'}")
            ev = EcVolume(os.path.dirname(b), 1, backend=TorchBackend(ctx, impl="cuda_planes"),
                          scheduler=scope)
            lat = []
            try:
                ev.unmount_shards([DEGRADED])
                rs_kernels.reset_launches()
                for rec in reads:
                    t0 = time.perf_counter()
                    got = ev.read_needle(rec[0], cookie=rec[1]).data
                    lat.append(time.perf_counter() - t0)
                    if got != os.pread(src_fd, rec[3], rec[2] + 20):
                        raise AssertionError(f"10b': degraded read of needle {rec[0]:x} differs")
                misses = ev.interval_cache.loads
            finally:
                ev.close()
            counted()
            moved = admitted("foreground")[0] - fg0[0]
            if rs_kernels.LAUNCHES["gf2_apply_planes"] != misses \
                    or moved != ((n_batches + misses) if on else 0):
                raise AssertionError(f"10b': {rs_kernels.LAUNCHES} for {misses} cache misses, "
                                     f"{moved} admissions with the scheduler {'on' if on else 'off'}")
            t = turns["on" if on else "off"]
            t["encode_s"].append(wall)
            t["read_p50_ms"].append(percentile_ms(lat, 50))
            t["read_p99_ms"].append(percentile_ms(lat, 99))
    finally:
        os.close(src_fd)
    out["10b_turns"] = {**turns, "reads_per_turn": len(reads),
                        "encode_on_over_off": sum(turns["on"]["encode_s"]) / sum(turns["off"]["encode_s"]),
                        "read_p50_on_over_off": sum(turns["on"]["read_p50_ms"])
                        / sum(turns["off"]["read_p50_ms"])}
    print("10b' the scheduler's cost, off and on in turns (outputs identical; admissions only when "
          "on): " + json.dumps(out["10b_turns"]))

    # -- 10c. failover on the card, armed by the smoke ----------------------------
    fc = FallbackBackend(TorchBackend(ctx), CpuBackend(ctx), breaker=CircuitBreaker(
        failure_threshold=SCHED_THRESHOLD, reset_timeout=SCHED_RESET_S))
    c = volume_dir("c")
    seen_open = []
    stop = threading.Event()

    def watch() -> None:  # the gauge, sampled while the armed encode runs
        while not stop.wait(0.005):
            seen_open.append(gauge_of(fc))

    watcher = threading.Thread(target=watch)
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    watcher.start()
    try:
        with faults.injected("ec.backend.device.to_host", faults.io_error()) as h:
            ec_encode_volume(c, ctx, backend=fc)
    finally:
        stop.set()
        watcher.join()
    wall_c1 = time.perf_counter() - t0
    state_after, gauge_after = fc.breaker.state, gauge_of(fc)
    n = counted()
    same_shards(c, "10c armed encode")
    to_card = h.hits  # batches that reached the card and failed in to_host
    served = n - to_card  # launched batches whose result came back from the card
    if served + fc.fallback_batches != n_batches or fc.fallback_batches != n_batches \
            or to_card < SCHED_THRESHOLD or max(seen_open, default=0.0) != 1.0 \
            or gauge_after != (1.0 if state_after == "open" else 0.0):
        raise AssertionError(f"10c armed: {fc.fallback_batches} on the CPU of {n_batches}, {n} launches "
                             f"for {to_card} batches on the card, gauge {max(seen_open, default=0.0)}"
                             f" while armed, {gauge_after} at the end ({state_after})")
    armed = {"seconds": wall_c1, "fallback_batches": fc.fallback_batches,
             "device_served": served, "batches_to_card_failed_in_to_host": to_card,
             "launches": n, "breaker_after": state_after, "gauge_max_while_armed": max(seen_open),
             "gauge_samples": len(seen_open)}
    while fc.breaker.state == "open":
        time.sleep(0.05)
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    ec_encode_volume(c, ctx, backend=fc)
    wall_c2 = time.perf_counter() - t0
    n = counted()
    same_shards(c, "10c encode after the reset timeout")
    # The first batch is the half-open probe; the batches the pipeline
    # dispatches while the probe is in flight find the breaker still
    # half-open with its one probe taken, and go to the CPU (the JAX
    # package's semantics); once the probe drains, the breaker is
    # closed and the rest run on the card.
    during_probe = fc.fallback_batches - n_batches
    if n + during_probe != n_batches or not 0 <= during_probe < n_batches \
            or fc.breaker.state != "closed" or gauge_of(fc) != 0.0:
        raise AssertionError(f"10c probe: {n} launches, {during_probe} on the CPU, "
                             f"breaker {fc.breaker.state}")
    probe = {"seconds": wall_c2, "launches": n, "batches_on_cpu_while_probing": during_probe,
             "fallback_batches": fc.fallback_batches, "breaker": fc.breaker.state}
    # The rebuild through the staged-apply driver (run_staged_apply: the
    # path of rebuild, decode's self-heal and wide reads) on a card that
    # loses batches mid-stream. Two in a row fail at dispatch and one
    # after a success fails at drain, so the breaker (threshold 3) never
    # opens and every other batch runs on the card.
    for i in LOST:
        os.unlink(c + ctx.to_ext(i))
    lossy = LosingCard(ctx, at_dispatch=(1, 2), at_drain=(2,))
    fr = FallbackBackend(lossy, CpuBackend(ctx), breaker=CircuitBreaker(
        failure_threshold=SCHED_THRESHOLD, reset_timeout=SCHED_RESET_S))
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    rebuilt = rebuild_ec_files(c, backend=fr)
    wall_c3 = time.perf_counter() - t0
    n = counted()
    same_shards(c, "10c rebuild on a card that loses batches", LOST)
    want_batches = -(-os.path.getsize(c + ctx.to_ext(0)) // (16 << 20))
    lost = len(lossy.at_dispatch) + len(lossy.at_drain)
    if rebuilt != list(LOST) or lossy.dispatched != want_batches or fr.fallback_batches != lost \
            or n != want_batches - len(lossy.at_dispatch) or fr.breaker.state != "closed" \
            or gauge_of(fr) != 0.0:
        raise AssertionError(f"10c rebuild: {rebuilt}, {n} launches and {lossy.dispatched} dispatches "
                             f"for {want_batches} batches, {fr.fallback_batches} on the CPU for {lost} "
                             f"lost, breaker {fr.breaker.state}")
    out["10c"] = {"armed_encode": armed, "probe_encode": probe,
                  "rebuild": {"seconds": wall_c3, "batches": want_batches,
                              "lost_at_dispatch": len(lossy.at_dispatch),
                              "lost_at_drain": len(lossy.at_drain),
                              "fallback_batches": fr.fallback_batches, "launches": n,
                              "breaker": fr.breaker.state},
                  "reset_timeout_s": SCHED_RESET_S, "threshold": SCHED_THRESHOLD}
    print("10c failover on the card (every output sha256-identical; CPU batches == what the smoke "
          "injected; launches == batches that reached the card): " + json.dumps(out["10c"]))

    # -- 10d. contention on one backend under one QueueScope ----------------------
    scope = QueueScope()
    d = volume_dir("d")
    r = volume_dir("r", shards_from=b)
    rs_kernels.reset_launches()
    t0 = time.perf_counter()
    ec_encode_volume(d, ctx, backend=auto, scheduler=scope)
    alone_s = time.perf_counter() - t0
    same_shards(d, "10d encode alone")
    errors: list = []
    reb_wall = []

    def rebuild() -> None:
        try:
            t = time.perf_counter()
            if rebuild_ec_files(r, backend=auto, priority="recovery", scheduler=scope) != list(LOST):
                raise AssertionError("10d rebuild regenerated other shards")
            reb_wall.append(time.perf_counter() - t)
        except BaseException as e:  # noqa: BLE001 - raised on the main thread
            errors.append(e)

    alone = {c: dict(v) for c, v in scope.stats_snapshot()[0]["classes"].items()}
    t = threading.Thread(target=rebuild)
    t0 = time.perf_counter()
    t.start()
    ec_encode_volume(d, ctx, backend=auto, scheduler=scope)
    contended_s = time.perf_counter() - t0
    t.join()
    if errors:
        raise errors[0]
    n = counted()
    same_shards(d, "10d encode beside the rebuild")
    same_shards(r, "10d rebuild beside the encode", LOST)
    (q,) = scope.stats_snapshot()
    classes = q["classes"]
    reb_n = -(-os.path.getsize(b + ctx.to_ext(0)) // (16 << 20))
    if classes["foreground"]["admitted"] != 2 * n_batches or classes["recovery"]["admitted"] != reb_n \
            or n != 2 * n_batches + reb_n or auto.fallback_batches != 0 or q["load"] != 0:
        raise AssertionError(f"10d: {classes}, {n} launches, {auto.fallback_batches} on the CPU")
    ratio = alone_s / contended_s
    out["10d"] = {
        "foreground_alone_s": alone_s, "foreground_beside_rebuild_s": contended_s,
        "rebuild_s": reb_wall[0], "foreground_rate_ratio": ratio,
        "jax_bar_foreground_at_least": JAX_FOREGROUND_BAR, "bar_met": ratio >= JAX_FOREGROUND_BAR,
        "classes": {cls: {"admitted": st["admitted"] - alone[cls]["admitted"],
                          "admitted_cost": st["admitted_cost"] - alone[cls]["admitted_cost"],
                          "wait_s_total": st["wait_s_total"] - alone[cls]["wait_s_total"],
                          "wait_s_max": st["wait_s_max"]}
                    for cls, st in classes.items() if cls != "scrub"},
        "window": q["window"], "queue": q["chip"],
    }
    print("10d foreground encode beside a recovery rebuild on one auto backend (both outputs "
          "sha256-identical; per class for the contended run; the bar is an observation): "
          + json.dumps(out["10d"]))

    # -- 10e. streams -----------------------------------------------------------------
    fg0 = admitted("foreground")
    stream, stream_launches = stream_phase(work, base + ".dat.orig", ctx, TRACE_STREAM_BYTES)
    fg1 = admitted("foreground")
    launches["gf2_apply"] += stream_launches
    if fg1[0] - fg0[0] != stream_launches:
        raise AssertionError(f"10e stream: {fg1[0] - fg0[0]} foreground admissions for "
                             f"{stream_launches} launches")
    os.environ["SEAWEED_EC_STREAM_BACKEND"] = "auto"
    try:
        n_rec = int(MQ_RATE * TRACE_MQ_SECONDS)
        keys, values = mq_source(n_rec)
        ts0 = time.time_ns()
        mq_root = os.path.join(work, "mq-sched")
        fg0 = admitted("foreground")
        pub = mq_publish(mq_root, "auto", n_rec, keys, values, ts0, backend_name="auto")
        fg1 = admitted("foreground")
        mq_launches = counted()
        mq_be = pub["backend"]
        rs_kernels.reset_launches()
        recs = PartitionParity(mq_root, "bench", "auto", 0).recover()
        counted()
    finally:
        os.environ.pop("SEAWEED_EC_STREAM_BACKEND", None)
    if len(pub["calls"]) < TRACE_MQ_FLUSHES or len(recs) != n_rec or not isinstance(mq_be, FallbackBackend) \
            or mq_be.fallback_batches != 0 or fg1[0] - fg0[0] != mq_launches:
        raise AssertionError(f"10e partition: {len(pub['calls'])} flushes, {len(recs)} of {n_rec} "
                             f"records, {type(mq_be).__name__} with {getattr(mq_be, 'fallback_batches', None)}"
                             f" on the CPU, {fg1[0] - fg0[0]} admissions for {mq_launches} launches")
    check_records(recs, keys, values, ts0)
    del recs
    shutil.rmtree(mq_root)
    out["10e"] = {
        "stream": {k: stream[k] for k in ("bytes", "flushes", "launches", "batch_launches",
                                          "stream_seconds", "time_to_durable_parity_p50_ms")},
        "stream_foreground_admitted": stream_launches,
        "partition": {"records": n_rec, "flushes": len(pub["calls"]) + 1, "launches": mq_launches,
                      "foreground_admitted": fg1[0] - fg0[0], "backend": type(mq_be).__name__,
                      "fallback_batches": mq_be.fallback_batches},
    }
    print("10e stream through place_stream and an auto partition (sha256-identical, admissions "
          "== launches, records replayed byte-exact, no batch on the CPU): " + json.dumps(out["10e"]))

    # -- no fallback and no CPU resolution outside 10c ---------------------------
    stray = [be for be in list(backend_mod._FALLBACKS) if be not in (fc, fr) and be.fallback_batches]
    if stray or any(backend_mod.AUTO_CPU.values()):
        raise AssertionError(f"batches on the CPU outside 10c: {[be.fallback_batches for be in stray]}, "
                             f"CPU resolutions {backend_mod.AUTO_CPU}")
    for name in ("b", "c", "d", "r"):
        shutil.rmtree(os.path.join(work, "sched-" + name))
    return out, launches


PEER_LOCAL = (0, 1, 2, 4)  # the local holder's shards: fewer than k
PEER_ROT = 4  # its shard with two rotten leaves, leaf-repaired from peers
# one holder per shard, as on a balanced cluster; shards LOST are held by no one
PEER_SHARDS = {"peer-a": (5, 8, 12), "peer-b": (6, 9, 13), "peer-c": (7, 10)}
ROT_PEER = "peer-rot"  # an extra holder of shard 5, first in its list, serving one flipped byte
ROT_SHARD = 5

# The peers of phases 11 and 12 in one child (a fresh interpreter that
# touches no CUDA, so the sendfile egress and the rebuilding interpreter
# share no GIL): a ShardNetPlane per holder, each with its own resolve and
# generation fence, and, given a fifth argument, "peer-blob": a plane
# with a `resolve_blob` confined to that directory (a volume server's
# stream-blob root), counting the ops it serves. It prints its ports,
# then answers "status" and "stop <name>..." lines on stdin with one JSON
# line each (with "blob": the blob ops, the unlinked paths and this
# process's `sw_net_bytes_received_total`), and "exit".
PEER_CHILD = r"""
import json, os, sys
from seaweedfs_tpu_torch.ec import native_io, net_plane
from seaweedfs_tpu_torch.utils import metrics as M

src, rot, gen, spec = sys.argv[1], sys.argv[2], int(sys.argv[3]), json.loads(sys.argv[4])
blob_root = os.path.realpath(sys.argv[5]) if len(sys.argv) > 5 else None
blob = {"ops": {}, "unlinked": []}
planes = {}
for name, sids in spec.items():
    root = rot if name == "peer-rot" else src
    fds = {}

    def resolve(vid, sid, g, sids=frozenset(sids), root=root, fds=fds):
        if g != gen:
            raise net_plane.NetPlaneError("stale generation")
        if vid != 1 or sid not in sids:
            raise net_plane.NetPlaneError("shard not local")
        if sid not in fds:
            fds[sid] = os.open(os.path.join(root, "1.ec%02d" % sid), os.O_RDONLY)
        return fds[sid], os.fstat(fds[sid]).st_size

    planes[name] = net_plane.ShardNetPlane("127.0.0.1", 0, resolve, server_label=name)
    planes[name].start()


def resolve_blob(path, op, md):
    full = os.path.realpath(os.path.join(blob_root, path))
    if not full.startswith(blob_root + os.sep):
        raise net_plane.NetPlaneError("blob path escapes stream root")
    blob["ops"][op] = blob["ops"].get(op, 0) + 1
    if op == "unlink":
        blob["unlinked"].append(path)
        try:
            os.unlink(full)
        except FileNotFoundError:
            pass
        return None
    os.makedirs(os.path.dirname(full), exist_ok=True)
    return os.open(full, os.O_CREAT | os.O_RDWR, 0o644)


def no_shards(vid, sid, g):
    raise net_plane.NetPlaneError("shard not local")


if blob_root:
    planes["peer-blob"] = net_plane.ShardNetPlane("127.0.0.1", 0, no_shards, server_label="peer-blob",
                                                  resolve_blob=resolve_blob)
    planes["peer-blob"].start()
print(json.dumps({"ports": {n: p.port for n, p in planes.items()},
                  "egress_native": net_plane.egress_native()}), flush=True)
for line in sys.stdin:
    cmd = line.split()
    if cmd[0] == "stop":
        for n in cmd[1:]:
            planes.pop(n).stop()
    elif cmd[0] == "exit":
        break
    status = {n: p.status() for n, p in planes.items()}
    if blob_root:
        status["blob"] = dict(blob, received={"%s,%s" % k: v for k, v in
                                              M.net_bytes_received_total.snapshot().items()})
    print(json.dumps(status), flush=True)
for p in planes.values():
    p.stop()
"""


class PeerChild:
    """PEER_CHILD in a fresh interpreter, its stderr in `log_path`: the
    JSON line it prints when its planes are up (`hello`), `ask` for a
    command's answer, `close` to end it."""

    def __init__(self, args: list[str], log_path: str):
        repo = os.path.dirname(os.path.abspath(__file__))
        self.log_path = log_path
        with open(log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", PEER_CHILD, *args],
                cwd=repo, env=dict(os.environ, PYTHONPATH=repo), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=log, text=True,
            )

    def _line(self, what: str) -> dict:
        got = self.proc.stdout.readline()
        if not got:
            with open(self.log_path) as f:
                raise AssertionError(f"the peer child {what}: {f.read()[-3000:]}")
        return json.loads(got)

    def hello(self) -> dict:
        return self._line("did not start")

    def ask(self, line: str) -> dict:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()
        return self._line("died")

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("exit\n")
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def peer_copies(work: str, base: str, ctx, digests: dict) -> None:
    """Phase 11's inputs, made right after phase 5 while every shard is
    as encoded (checked here): copies, not links, of the shards some
    holder serves or the local holder keeps (later phases patch,
    truncate and replace shards in place), the small files, and the
    rotten holder's copy of shard ROT_SHARD."""
    src = os.path.join(work, "peer", "src")
    os.makedirs(src)
    held = sorted(set(PEER_LOCAL).union(*PEER_SHARDS.values()))
    for i in held:
        if sha256(base + ctx.to_ext(i)) != digests[i]:
            raise AssertionError(f"phase 11's copy of shard {i} is not as encoded")
        shutil.copyfile(base + ctx.to_ext(i), os.path.join(src, "1" + ctx.to_ext(i)))
    for ext in (".ecx", ".ecj", ".vif", ".ecsum"):
        if os.path.exists(base + ext):
            shutil.copyfile(base + ext, os.path.join(src, "1" + ext))
    os.makedirs(os.path.join(work, "peer", "rot"))
    shutil.copyfile(base + ctx.to_ext(ROT_SHARD), os.path.join(work, "peer", "rot", "1" + ctx.to_ext(ROT_SHARD)))


class Timed:
    """A transport wrapped to count its calls, bytes and seconds."""

    def __init__(self, fn, nbytes):
        self.fn, self.nbytes = fn, nbytes
        self.calls = self.bytes = 0
        self.seconds = 0.0
        self.sizes: list[int] = []

    def __call__(self, *args):
        t0 = time.perf_counter()
        try:
            return self.fn(*args)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.bytes += self.nbytes(args)
            self.sizes.append(self.nbytes(args))

    def summary(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes, "seconds": self.seconds,
                "gb_per_s": self.bytes / self.seconds / 1e9 if self.seconds else None}


def net_snapshot() -> dict:
    """The `sw_net_*` counters, keyed "name{plane=..,direction=..}"."""
    from seaweedfs_tpu_torch.utils import metrics as M

    return {f"{name}{{plane={plane},direction={direction}}}": v
            for name, fam in (("sent", M.net_bytes_sent_total), ("received", M.net_bytes_received_total),
                              ("copied", M.net_bytes_copied_total))
            for (plane, direction), v in fam.snapshot().items()}


def net_delta(before: dict) -> dict:
    """What the `sw_net_*` counters moved by since `before` (process-wide
    counters: compared by delta)."""
    return {k: int(v - before.get(k, 0)) for k, v in net_snapshot().items() if v != before.get(k, 0)}


def peer_phase(work, ctx, digests, reb_batches) -> tuple[dict, int]:
    """Phase 11: peer-fetch rebuild of shards LOST from a local holder of
    shards PEER_LOCAL (fewer than k, shard PEER_ROT with two rotten
    leaves) and three peers in a child process serving the rest over the
    shard net plane. 11a native plane, 11b Python plane, 11c two peers
    stopped: a clean refusal. Returns (result, gf2_apply launches)."""
    from seaweedfs_tpu_torch.ec import BitrotProtection, ECError, TorchBackend, native_io, net_plane
    from seaweedfs_tpu_torch.ec import backend as port_backend
    from seaweedfs_tpu_torch.ec import peer_rebuild as pr
    from seaweedfs_tpu_torch.ec.repair_journal import leaf_ranges
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.utils import native

    if not native_io.enabled():
        raise AssertionError("phase 11 needs the native plane (SEAWEED_EC_NATIVE is 0)")
    root = os.path.join(work, "peer")
    src = os.path.join(root, "src")
    src_base = os.path.join(src, "1")
    prot = BitrotProtection.load(src_base + ".ecsum")
    lsize = prot.leaf_size
    size = prot.shard_sizes[0]
    n_leaves = len(prot.shard_leaf_crcs[PEER_ROT])
    rot_leaves = [n_leaves // 4, 3 * n_leaves // 4]  # not adjacent: two ranges
    n_ranges = len(leaf_ranges(rot_leaves, lsize, prot.shard_sizes[PEER_ROT]))
    rot_at = (n_leaves // 2) * lsize + 333  # outside shard PEER_ROT's rotten leaves
    flip(os.path.join(root, "rot", "1" + ctx.to_ext(ROT_SHARD)), rot_at)
    holders = {sid: [name] for name, sids in PEER_SHARDS.items() for sid in sids}
    holders[ROT_SHARD] = [ROT_PEER] + holders[ROT_SHARD]
    spec = {**{n: list(s) for n, s in PEER_SHARDS.items()}, ROT_PEER: [ROT_SHARD]}

    child = PeerChild([src, os.path.join(root, "rot"), str(prot.generation), json.dumps(spec)],
                      os.path.join(root, "peers.log"))
    client = net_plane.NetPlaneClient(timeout=60.0)

    result: dict = {"holders": {str(k): v for k, v in sorted(holders.items())},
                    "rot_leaves": rot_leaves, "rotten_byte": rot_at,
                    "recv_overlap_active_4MiB": native.recv_overlap_active(4 << 20)}
    launches = 0
    try:
        hello = child.hello()
        if not hello["egress_native"]:
            raise AssertionError("the peers would egress through Python")
        addr = {n: ("127.0.0.1", p) for n, p in hello["ports"].items()}
        try:
            client.read_bytes(addr["peer-a"], 1, 5, prot.generation + 1, 0, 16)
            raise AssertionError("a stale generation was served")
        except net_plane.NetPlaneError as e:
            if "stale generation" not in str(e):
                raise

        def transports():
            def fetch(peer, sid, off, n):
                try:
                    return client.read_bytes(addr[peer], 1, sid, prot.generation, off, n)
                except (net_plane.NetPlaneUnavailable, net_plane.NetPlaneError) as e:
                    raise pr.PeerFetchTransient(str(e)) from e

            return (Timed(fetch, lambda a: a[3]),
                    Timed(net_plane.make_fetch_into(client, 1, prot.generation, addr_of=addr.__getitem__),
                          lambda a: a[3]))

        def local(tag: str) -> str:
            from_src = same_inputs(src_base, os.path.join(root, tag), [i for i in PEER_LOCAL if i != PEER_ROT])
            shutil.copyfile(src_base + ctx.to_ext(PEER_ROT), from_src + ctx.to_ext(PEER_ROT))
            for li in rot_leaves:
                flip(from_src + ctx.to_ext(PEER_ROT), li * lsize + 1000)
            return from_src

        def run(tag: str, native_plane: bool) -> dict:
            base = local(tag)
            fetch, fetch_into = transports()
            backend = TorchBackend(ctx)
            rebuild_wall = []
            inner = pr.rebuild_ec_files

            def timed_rebuild(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return inner(*a, **kw)
                finally:
                    rebuild_wall.append(time.perf_counter() - t0)

            cpu_before = dict(port_backend.AUTO_CPU)
            net_before = net_snapshot()
            rs_kernels.reset_launches()
            pr.rebuild_ec_files = timed_rebuild
            t0 = time.perf_counter()
            try:
                rep = pr.rebuild_from_peers(base, holders, fetch, ctx=ctx, targets=list(LOST),
                                            backend=backend,
                                            fetch_into=fetch_into if native_plane else None)
            finally:
                pr.rebuild_ec_files = inner
            wall = time.perf_counter() - t0
            n_launch = rs_kernels.LAUNCHES["gf2_apply"]
            plane = "native" if native_plane else "python"
            if rep.leaf_repaired != {PEER_ROT: rot_leaves} or rep.rebuilt != list(LOST):
                raise AssertionError(f"11{tag}: {rep}")
            for sid in (*LOST, PEER_ROT):
                if sha256(base + ctx.to_ext(sid)) != digests[sid]:
                    raise AssertionError(f"11{tag}: shard {sid} differs from its encode-time bytes")
            k = ctx.data_shards
            local_good = len(PEER_LOCAL) - 1
            if rep.repair_wire_bytes != (k - local_good) * lsize * n_ranges:
                raise AssertionError(f"11{tag}: repair_wire_bytes {rep.repair_wire_bytes}")
            want_fetched = {sid: holders[sid][-1] for sid in range(5, 11)}
            if rep.excluded_peers != [ROT_PEER] or rep.fetched != want_fetched:
                raise AssertionError(f"11{tag}: excluded {rep.excluded_peers}, fetched {rep.fetched}")
            # `fetch` carried the leaf ranges and ONE re-read of the rotten
            # holder's bad granule (the granule, not the chunk)
            n_fetch = (k - local_good) * n_ranges + 1
            if native_plane and fetch.sizes != [lsize] * n_fetch:
                raise AssertionError(f"11{tag}: fetch asked for {fetch.sizes}, expected {n_fetch} "
                                     f"ranges of {lsize}")
            if set(rep.fetched_plane.values()) != {plane}:
                raise AssertionError(f"11{tag}: planes {rep.fetched_plane}")
            if os.path.exists(pr.staging_dir(base)):
                raise AssertionError(f"11{tag}: staging left behind")
            if n_launch != reb_batches + n_ranges or rs_kernels.LAUNCHES["gf2_apply_planes"]:
                raise AssertionError(f"11{tag}: {rs_kernels.LAUNCHES} launches for {reb_batches} "
                                     f"batches and {n_ranges} leaf ranges")
            if dict(port_backend.AUTO_CPU) != cpu_before:
                raise AssertionError(f"11{tag}: a CPU resolution {port_backend.AUTO_CPU}")
            if client._no_plane:
                raise AssertionError(f"11{tag}: no-plane memo for live peers {client._no_plane}")
            # the wire: whole streams on `plane`, the rotten holder's up to
            # and including its bad chunk, one granule re-read and the
            # leaf ranges through `fetch` (the Python plane)
            delta = net_delta(net_before)
            chunk = pr.NATIVE_FETCH_CHUNK if native_plane else pr.FETCH_CHUNK
            streamed = len(want_fetched) * size + min(size, (rot_at // chunk + 1) * chunk)
            want = {"native": streamed if native_plane else 0,
                    "python": rep.repair_wire_bytes + lsize + (0 if native_plane else streamed)}
            got = {p: delta.get(f"received{{plane={p},direction=read}}", 0) for p in ("native", "python")}
            if got != want:
                raise AssertionError(f"11{tag}: sw_net_bytes_received_total moved {got}, expected {want}")
            return {
                "wall_s": wall, "rebuild_wall_s": sum(rebuild_wall),
                "fetched_bytes": streamed, "fetched_gb_per_s_over_loopback":
                    streamed / (fetch_into if native_plane else fetch).seconds / 1e9,
                "fetch_into": fetch_into.summary(), "fetch": fetch.summary(),
                "launches": n_launch, "leaf_ranges": n_ranges, "rebuild_batches": reb_batches,
                "repair_wire_bytes": rep.repair_wire_bytes, "excluded": rep.excluded_peers,
                "fetched": {str(s): p for s, p in rep.fetched.items()}, "plane": plane,
                "backend_stage_seconds": dict(backend.stage_seconds), "sw_net_delta": delta,
                "outputs": {str(s): sha256(base + ctx.to_ext(s)) for s in (*LOST, PEER_ROT)},
            }

        t0 = time.perf_counter()
        a = run("a", True)
        launches += a["launches"]
        b = run("b", False)
        launches += b["launches"]
        if a["outputs"] != b["outputs"]:
            raise AssertionError("11b's outputs differ from 11a's")
        result["11a_native"], result["11b_python"] = a, b
        result["peers_status"] = child.ask("status")

        # -- 11c. two of the three peers stopped: fewer than k reachable ------
        child.ask("stop peer-a peer-b")
        base = local("c")
        before = {name: sha256(os.path.join(root, "c", name)) for name in sorted(os.listdir(os.path.join(root, "c")))}
        fetch, fetch_into = transports()
        rs_kernels.reset_launches()
        t1 = time.perf_counter()
        try:
            pr.rebuild_from_peers(base, holders, fetch, ctx=ctx, targets=list(LOST),
                                  backend=TorchBackend(ctx), fetch_into=fetch_into)
            raise AssertionError("11c: the rebuild did not refuse")
        except ECError as e:
            refusal = str(e)
        after = {name: sha256(os.path.join(root, "c", name)) for name in sorted(os.listdir(os.path.join(root, "c")))}
        if after != before or os.path.exists(pr.staging_dir(base)):
            raise AssertionError(f"11c: the local directory changed: {sorted(before)} -> {sorted(after)}")
        launches += rs_kernels.LAUNCHES["gf2_apply"]
        result["11c_refusal"] = {"wall_s": time.perf_counter() - t1, "message": refusal,
                                 "launches": rs_kernels.LAUNCHES["gf2_apply"],
                                 "memoized_unreachable": sorted(f"{h}:{p}" for h, p in client._no_plane)}
        result["phase_s"] = time.perf_counter() - t0
    finally:
        client.close()
        child.close()
    return result, launches


# -- 12. a durable-parity partition with remote stream shards --------------------------

REMOTE_ROOTS_ENV = "SEAWEED_EC_STREAM_REMOTE_ROOTS"
# generation 0 is pruned, live, by the first flush that finds this
# generation open: at phase 7b's traffic the partition rotates once or
# twice (flush timing decides), so generation 1 is the one every run opens
PRUNE_WHEN_OPEN = 1


def remote_stream_phase(work: str, mq_local: dict) -> tuple[dict, int]:
    """Phase 12: phase 7b's partition and traffic with two remote roots,
    a mounted path (`hostA`, a local directory standing in for the
    mount) and a net plane (`peer`, the blob plane of PEER_CHILD); the
    flusher prunes generation 0, live, once generation PRUNE_WHEN_OPEN is
    open (the phase fails if the traffic ends before it opens).
    Checked: placements on both roots in every generation, remote data
    shards sha256-identical at close (a parity shard on the peer only of
    its local length: both packages push each extent once, so its rows of
    a stripe open at a flush stay stale), the prune's remote unlinks, a byte-exact
    recovery of every unpruned record, `delete()` leaving both roots
    empty, one `gf2_apply` launch per parity delta, every pushed byte on
    the native plane. Returns (result, gf2_apply launches)."""
    import logging

    from seaweedfs_tpu_torch.ec import backend as port_backend
    from seaweedfs_tpu_torch.ec import load_stream_journal, native_io, net_plane
    from seaweedfs_tpu_torch.ec.stream_encode import EcStreamEncoder
    from seaweedfs_tpu_torch.mq import stream_parity as sp
    from seaweedfs_tpu_torch.ops import rs_kernels

    if not native_io.enabled():
        raise AssertionError("phase 12 needs the native plane (SEAWEED_EC_NATIVE is 0)")
    root = os.path.join(work, "remote-stream")
    host_a, blobs, local = (os.path.join(root, d) for d in ("hostA", "peer-blobs", "local"))
    os.makedirs(host_a)
    os.makedirs(blobs)
    child = PeerChild([root, root, "0", "{}", blobs], os.path.join(root, "peer.log"))
    rec_bytes = mq_record_bytes()
    n = MQ_BYTES // rec_bytes
    keys, values = mq_source(n)
    ts0 = time.time_ns()
    part = os.path.join(local, "bench", "remote", "0000")

    class Warnings(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.lines: list[str] = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    warned = Warnings()
    deltas = [0]
    pushes: list[float] = []
    placement: dict[int, dict] = {}
    pruned: dict = {}
    live: list = []  # the partition, as the flusher hook sees it
    enc_apply, push = EcStreamEncoder._dispatch_apply, sp.PartitionParity._push_net_shards

    def counted_apply(self, coeffs, data):
        deltas[0] += 1
        return enc_apply(self, coeffs, data)

    def timed_push(self):
        t = time.perf_counter()
        try:
            return push(self)
        finally:
            pushes.append(time.perf_counter() - t)

    def place(pp) -> None:
        """Each generation's placement, read once its files exist."""
        with pp._lock:
            plans = {g: dict(p) for g, p in pp._net_shards.items()}
        for g in gens_of(pp.dir):
            if g in placement:
                continue
            gbase = os.path.join(pp.dir, f"gen-{g:08d}")
            links = {sid: os.readlink(gbase + pp.ctx.to_ext(sid)) for sid in range(pp.ctx.total)
                     if os.path.islink(gbase + pp.ctx.to_ext(sid))}
            net = {sid: rpath for sid in range(pp.ctx.total)
                   for path, (_addr, rpath) in plans.get(g, {}).items() if path == gbase + pp.ctx.to_ext(sid)}
            if not links or not net:
                raise AssertionError(f"12: generation {g} placed on hostA {sorted(links)}, "
                                     f"on the peer {sorted(net)}: both roots must hold shards")
            placement[g] = {"hostA": links, "peer": net,
                            "local": sorted(set(range(pp.ctx.total)) - set(links) - set(net))}

    def prune_gen0(pp, when: str) -> None:
        keep = load_stream_journal(os.path.join(pp.dir, "gen-00000001")).meta
        pruned.update(removed=pp.prune(keep), keep_from=keep, when=when)

    def after_flush(pp) -> None:
        live[:] = [pp]
        place(pp)
        opened = os.path.join(pp.dir, f"gen-{PRUNE_WHEN_OPEN:08d}")
        if not pruned and load_stream_journal(opened) is not None:
            prune_gen0(pp, f"flush, generation {PRUNE_WHEN_OPEN} open")

    logger = logging.getLogger(sp.__name__)
    prev_env = os.environ.get(REMOTE_ROOTS_ENV)
    result: dict = {}
    try:
        port = child.hello()["ports"]["peer-blob"]
        gport = port - net_plane.NET_PLANE_PORT_OFFSET
        if gport < 1 or net_plane.derive_port(gport) != port:
            raise AssertionError(f"12: no gRPC port derives the blob plane's port {port}")
        os.environ[REMOTE_ROOTS_ENV] = f"hostA={host_a},peer=net:127.0.0.1:{gport}/sub"
        logger.addHandler(warned)
        net_before = net_snapshot()
        cpu_before = dict(port_backend.AUTO_CPU)
        EcStreamEncoder._dispatch_apply = counted_apply
        sp.PartitionParity._push_net_shards = timed_push
        try:
            pub = mq_publish(local, "remote", n, keys, values, ts0, after_flush=after_flush)
        finally:
            EcStreamEncoder._dispatch_apply = enc_apply
            sp.PartitionParity._push_net_shards = push
        launches = rs_kernels.LAUNCHES["gf2_apply"]
        masked = rs_kernels.MASKED["gf2_apply"]
        if launches != deltas[0]:
            raise AssertionError(f"12: {launches} gf2_apply launches for {deltas[0]} parity deltas")
        ctx, calls, t_append = pub["ctx"], pub["calls"], pub["t_append"]
        place(live[0])
        if not pruned:
            raise AssertionError(f"12: generation {PRUNE_WHEN_OPEN} never opened under traffic")
        gens = gens_of(part)
        if pruned["removed"] != 1 or gens[0] != 1:
            raise AssertionError(f"12: the prune ({pruned}) left generations {gens}")
        status = child.ask("status")
        # every unpruned net-planned data shard's remote copy is its local
        # file; a parity shard's has its length (stale rows: ROADMAP Queue 3)
        stale_parity = []
        for g in gens:
            gbase = os.path.join(part, f"gen-{g:08d}")
            for sid, rpath in placement[g]["peer"].items():
                # an empty shard (a row the generation never reached) pushes nothing
                rp, lp = os.path.join(blobs, rpath), gbase + ctx.to_ext(sid)
                remote = sha256(rp) if os.path.exists(rp) else hashlib.sha256(b"").hexdigest()
                if sha256(lp) == remote:
                    continue
                if sid < ctx.data_shards or os.path.getsize(rp) != os.path.getsize(lp):
                    raise AssertionError(f"12: the peer's {rpath} differs from its local shard")
                stale_parity.append(rpath)
            for sid, target in placement[g]["hostA"].items():
                if not (os.path.realpath(gbase + ctx.to_ext(sid)).startswith(os.path.realpath(host_a))
                        and os.path.isfile(target) and not os.path.islink(target)):
                    raise AssertionError(f"12: generation {g} shard {sid}'s link target {target}")
        # the prune: generation 0's remote blobs unlinked, its link targets gone
        gen0 = placement[0]
        unlinked = set(status["blob"]["unlinked"])
        if not set(gen0["peer"].values()) <= unlinked or any(
                os.path.exists(os.path.join(blobs, r)) for r in gen0["peer"].values()):
            raise AssertionError(f"12: generation 0's blobs {gen0['peer']} not unlinked ({sorted(unlinked)})")
        if any(os.path.lexists(t) for t in gen0["hostA"].values()):
            raise AssertionError("12: the prune left generation 0's link targets on hostA")
        # every pushed byte rode the native plane into the child
        delta = net_delta(net_before)
        pushed = delta.get("sent{plane=native,direction=write}", 0)
        child_got = status["blob"]["received"]
        if (pushed <= 0 or child_got.get("native,write", 0) != pushed
                or child_got.get("python,write", 0) or delta.get("sent{plane=python,direction=write}", 0)):
            raise AssertionError(f"12: pushed {delta}, the child received {child_got}")
        if dict(port_backend.AUTO_CPU) != cpu_before:
            raise AssertionError(f"12: a CPU resolution {port_backend.AUTO_CPU}")
        if warned.lines:
            raise AssertionError(f"12: the partition warned: {warned.lines[:5]}")

        # a fresh partition over the same local dir: every unpruned record
        rs_kernels.reset_launches()
        t0 = time.perf_counter()
        recs = sp.PartitionParity(local, "bench", "remote", 0).recover()
        recover_s = time.perf_counter() - t0
        rec_launches = rs_kernels.LAUNCHES["gf2_apply"]
        first = pruned["keep_from"]
        if len(recs) != n - first:
            raise AssertionError(f"12: recovered {len(recs)} records, {n - first} unpruned")
        check_records(recs, keys, values, ts0, first)
        del recs
        # delete: no byte left on either root
        rs_kernels.reset_launches()
        sp.PartitionParity(local, "bench", "remote", 0).delete()
        rec_launches += rs_kernels.LAUNCHES["gf2_apply"]
        left = [os.path.join(d, f) for r in (host_a, blobs) for d, _s, fs in os.walk(r) for f in fs]
        if left:
            raise AssertionError(f"12: delete() left {left[:5]}")
        if warned.lines:
            raise AssertionError(f"12: the partition warned: {warned.lines[:5]}")
        final = child.ask("status")

        starts = np.array([c[0] for c in calls])
        ends = np.array([c[1] for c in calls] + [pub["t_end"]])
        lags = ends[np.searchsorted(starts, t_append, side="left")] - t_append
        result = {
            "records": n, "rate_per_s": MQ_RATE, "appends_per_s": n / pub["append_s"],
            "time_to_durable_parity_p50_ms": float(np.percentile(lags, 50) * 1e3),
            "time_to_durable_parity_p99_ms": float(np.percentile(lags, 99) * 1e3),
            "phase_7b_local_only": {k: mq_local[k] for k in (
                "appends_per_s", "time_to_durable_parity_p50_ms", "time_to_durable_parity_p99_ms")},
            "flushes": len(calls), "generations": len(gens) + 1, "pruned": pruned,
            "stale_parity_on_peer": stale_parity,
            "pushed_bytes": pushed, "pushes": len(pushes), "push_seconds": sum(pushes),
            "push_ms_per_flush_p50": float(np.median(pushes) * 1e3),
            "push_ms_per_flush_max": float(max(pushes) * 1e3),
            "placement": {str(g): {"hostA": sorted(p["hostA"]), "peer": sorted(p["peer"]),
                                   "local": p["local"]} for g, p in sorted(placement.items())},
            "blob_ops": final["blob"]["ops"], "blob_plane": final["peer-blob"],
            "launches": launches, "launches_masked_path": masked, "parity_deltas": deltas[0],
            "recovery_seconds": recover_s, "recovery_launches": rec_launches,
        }
    finally:
        logger.removeHandler(warned)
        if prev_env is None:
            os.environ.pop(REMOTE_ROOTS_ENV, None)
        else:
            os.environ[REMOTE_ROOTS_ENV] = prev_env
        sp._net_client().close()
        child.close()
    shutil.rmtree(root)
    return result, launches + rec_launches


# -- 13. the Store at the smoke's volume size -----------------------------------------

STORE_VID = 7
STORE_ROT_SHARD = 7  # a mounted shard with one rotten leaf, repaired by ScrubDaemon
SCRUB_BYTES_PER_S = float(8 << 30)  # the daemon's read budget: above what 9p reads


def store_phase(work: str, ctx, vol_rng_state: dict) -> tuple[dict, dict]:
    """Phase 13: phase 3's needles (the same seeded sizes and bodies)
    written through `Store.write_needle` into a volume the Store
    allocated, read back, 5 deleted, the volume remounted (the .idx
    replayed), sealed and encoded on the card; its EC volume mounted with
    shard DEGRADED unmounted, every live needle over that shard read
    through `Store.read_needle` (reconstructed by `gf2_apply_planes`);
    one rotten leaf of shard STORE_ROT_SHARD repaired by a `ScrubDaemon`
    pass through `gf2_apply`. Phase 11's copies are removed first, and
    this phase's directory at its end. Returns (result, launches by
    kernel)."""
    from seaweedfs_tpu_torch.ec import (
        BitrotProtection, ScrubDaemon, TorchBackend, ec_encode_volume, native_io,
    )
    from seaweedfs_tpu_torch.ec import backend as port_backend
    from seaweedfs_tpu_torch.ec import scrub as scrub_mod
    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.ec_volume import EcNotFoundError
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.ec.repair_journal import leaf_ranges
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.volume import NotFoundError

    if not native_io.enabled():
        raise AssertionError("phase 13 needs the native plane (SEAWEED_EC_NATIVE is 0)")
    shutil.rmtree(os.path.join(work, "peer"), ignore_errors=True)  # phase 11's copies
    root = os.path.join(work, "store")
    os.makedirs(root)
    rng = np.random.default_rng()
    rng.bit_generator.state = vol_rng_state  # phase 3's needles
    cpu_before = dict(port_backend.AUTO_CPU)
    launches = {"gf2_apply": 0, "gf2_apply_planes": 0}
    result: dict = {}
    store = Store([root], ec_backend="cuda")
    try:
        # -- write, read back, delete, remount ------------------------------
        v = store.allocate_volume(STORE_VID)
        want: dict[int, tuple[int, bytes, int]] = {}  # id -> (cookie, sha256, body length)
        to_bytes, built = Needle.to_bytes, [0.0]  # the write's record build, timed apart

        def timed_to_bytes(self, *a, **kw):
            t = time.perf_counter()
            try:
                return to_bytes(self, *a, **kw)
            finally:
                built[0] += time.perf_counter() - t

        Needle.to_bytes = timed_to_bytes
        t0 = time.perf_counter()
        try:
            for nid, cookie, body in needle_stream(rng):
                n = Needle(cookie=cookie, needle_id=nid, data=body)
                if v.size + n.disk_size(3) > VOLUME_BYTES:
                    break
                store.write_needle(STORE_VID, n)
                want[nid] = (cookie, hashlib.sha256(body).digest(), len(body))
            write_s = time.perf_counter() - t0
        finally:
            Needle.to_bytes = to_bytes
        written = v.size
        t0 = time.perf_counter()
        for nid, (cookie, digest, _) in want.items():
            if hashlib.sha256(store.read_needle(STORE_VID, nid, cookie).data).digest() != digest:
                raise AssertionError(f"13: needle {nid:x} read back differs")
        read_s = time.perf_counter() - t0
        ids = list(want)
        first = len(ids) // 3
        deleted = ids[first :: (len(ids) - first) // N_DELETED][:N_DELETED]
        if any(store.delete_needle(STORE_VID, nid) <= 0 for nid in deleted):
            raise AssertionError(f"13: deleting {deleted} failed")
        records = [(nid, want[nid][0], v.needle_map.get(nid).offset * 8, want[nid][2])
                   for nid in ids if nid not in deleted]
        store.unmount_volume(STORE_VID)
        t0 = time.perf_counter()
        v = store.mount_volume(STORE_VID)
        remount_s = time.perf_counter() - t0
        st = store.status()["volumes"]
        if len(st) != 1 or (st[0]["id"], st[0]["file_count"], st[0]["deleted_count"], st[0]["read_only"],
                            st[0]["size"]) != (STORE_VID, len(ids), N_DELETED, False, v.size) \
                or v.size <= written:
            raise AssertionError(f"13: status after the remount {st}")

        # -- seal, encode on the card ----------------------------------------
        v.set_read_only(True)
        base = v.dat_path[:-4]
        dat_size = os.path.getsize(base + ".dat")
        n_batches = len(list(batch_plan(dat_size, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)))
        rs_kernels.reset_launches()
        t0 = time.perf_counter()
        ec_encode_volume(base, ctx, backend=TorchBackend(ctx))
        enc_s = time.perf_counter() - t0
        if rs_kernels.LAUNCHES["gf2_apply"] != n_batches:
            raise AssertionError(f"13: encode launched {rs_kernels.LAUNCHES} for {n_batches} batches")
        launches["gf2_apply"] += n_batches
        prot = BitrotProtection.load(base + ".ecsum")
        for i in range(ctx.total):
            if prot.verify_shard_file(base + ctx.to_ext(i), i):
                raise AssertionError(f"13: shard {i} fails .ecsum")
        shard_digest = {i: sha256(base + ctx.to_ext(i)) for i in range(ctx.total)}

        # -- the EC volume, shard DEGRADED unmounted: degraded reads ---------
        store.unmount_volume(STORE_VID)
        ev = store.mount_ec_volume(STORE_VID)
        be = ev.backend
        if not (isinstance(be, TorchBackend) and be.device.type == DEVICE and be.impl == "cuda_planes"):
            raise AssertionError(f"13: the Store's EC volume runs on {be}")
        store.unmount_ec_shards(STORE_VID, [DEGRADED])
        degraded = degraded_records(records, dat_size)
        cache = ev.interval_cache
        rs_kernels.reset_launches()
        loads0, hits0 = cache.loads, cache.hits
        lat = []
        for nid, cookie, _, _ in degraded:
            t0 = time.perf_counter()
            got = store.read_needle(STORE_VID, nid, cookie).data
            lat.append(time.perf_counter() - t0)
            if hashlib.sha256(got).digest() != want[nid][1]:
                raise AssertionError(f"13: degraded read of needle {nid:x} differs")
        planes = rs_kernels.LAUNCHES["gf2_apply_planes"]
        if planes != cache.loads - loads0 or planes < 1 or rs_kernels.LAUNCHES["gf2_apply"]:
            raise AssertionError(f"13: reads launched {rs_kernels.LAUNCHES}, "
                                 f"{cache.loads - loads0} reconstructions")
        launches["gf2_apply_planes"] += planes
        for nid in deleted:
            try:
                store.read_needle(STORE_VID, nid)
                raise AssertionError(f"13: deleted needle {nid:x} was read")
            except (NotFoundError, EcNotFoundError):
                pass

        # -- ScrubDaemon: one rotten leaf repaired in place ------------------
        leaf = len(prot.shard_leaf_crcs[STORE_ROT_SHARD]) // 3
        flip(base + ctx.to_ext(STORE_ROT_SHARD), leaf * prot.leaf_size + 4321)
        legit = ev.legitimate_shards()
        if legit != [i for i in range(ctx.total) if i != DEGRADED]:  # served + quarantined
            raise AssertionError(f"13: legitimate shards {legit}")
        stages: dict = {}
        scrub_once = scrub_mod.scrub_ec_volume

        def staged(*a, **kw):
            return scrub_once(*a, stages=stages, **kw)

        daemon = ScrubDaemon(store, interval=3600.0, bytes_per_sec=SCRUB_BYTES_PER_S, repair=True)
        rs_kernels.reset_launches()
        scrub_mod.scrub_ec_volume = staged
        t0 = time.perf_counter()
        try:
            report = daemon.scrub_once()[STORE_VID]
        finally:
            scrub_mod.scrub_ec_volume = scrub_once
        scrub_s = time.perf_counter() - t0
        n_ranges = len(leaf_ranges([leaf], prot.leaf_size, prot.shard_sizes[STORE_ROT_SHARD]))
        if (report.leaf_repaired != {STORE_ROT_SHARD: [leaf]} or report.quarantined or report.rebuilt
                or report.refused or rs_kernels.LAUNCHES["gf2_apply"] != n_ranges
                or rs_kernels.LAUNCHES["gf2_apply_planes"]):
            raise AssertionError(f"13: scrub {report}, launches {rs_kernels.LAUNCHES}")
        if sha256(base + ctx.to_ext(STORE_ROT_SHARD)) != shard_digest[STORE_ROT_SHARD]:
            raise AssertionError("13: the repaired shard differs from its encode-time bytes")
        if daemon.breakers[STORE_VID].state != "closed" or ev.legitimate_shards() != legit:
            raise AssertionError("13: the daemon's breaker opened or the shard set changed")
        launches["gf2_apply"] += n_ranges
        if dict(port_backend.AUTO_CPU) != cpu_before:
            raise AssertionError(f"13: a CPU resolution {port_backend.AUTO_CPU}")
        shard_bytes = sum(prot.shard_sizes)
        result = {
            "needles": len(ids), "deleted": N_DELETED, "volume_bytes": written,
            "write_seconds": write_s, "write_mb_per_s": written / write_s / 1e6,
            "write_record_build_seconds": built[0],
            "read_back_seconds": read_s, "read_back_mb_per_s": written / read_s / 1e6,
            "remount_seconds": remount_s, "status": st[0],
            "encode_seconds": enc_s, "encode_gb_per_s": dat_size / enc_s / 1e9, "encode_batches": n_batches,
            "degraded_reads": len(degraded), "degraded_p50_ms": percentile_ms(lat, 50),
            "degraded_p99_ms": percentile_ms(lat, 99), "reconstructions": planes,
            "cache_hits": cache.hits - hits0,
            "scrub_pass_seconds": scrub_s, "scrub_gb_per_s": shard_bytes / scrub_s / 1e9,
            "leaf_ranges": n_ranges,
            "repair_ms_per_range": sum(sec for k, sec in stages.items() if "." not in k) / n_ranges * 1e3,
            "repair_stage_seconds": stages, "legitimate_shards": legit,
            "launches": launches,
        }
    finally:
        store.close()
    shutil.rmtree(root)
    return result, launches



# -- 14. the volume server on the card ------------------------------------------------

SERVER_VID, PLANE_VID, REPLICATED_VID = 21, 22, 23
PLANE_BYTES = 256 << 20  # 14a's net-plane writes: phase 3's first 256 MiB of needles
CLIENT_THREADS = 8  # 14c's second pass: concurrent clients of the pooled front end
UPLOAD_MIME = "application/octet-stream"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CONNECT_S = 5.0  # one loopback connect attempt; they take under 20 ms on the card's host
CONNECT_TRIES = 4
CONNECT_RETRIES = [0]  # connects that got no answer and were dialled again


class _Redial:
    """Dials again when a connect (and, for https, its handshake) gets no
    answer within CONNECT_S. On the card's host (gVisor's network stack)
    about one loopback connect in 2,000 carrying MiB bodies never
    completes, while a new one goes through (`chip_loopback.py`). Nothing
    is sent on a connection that never opened, so each request is sent
    once."""

    def connect(self):
        timeout, self.timeout = self.timeout, CONNECT_S
        try:
            for attempt in range(CONNECT_TRIES):
                try:
                    super().connect()
                    break
                except TimeoutError:
                    if attempt == CONNECT_TRIES - 1:
                        raise
                    CONNECT_RETRIES[0] += 1
        finally:
            self.timeout = timeout
        self.sock.settimeout(timeout)


class RedialConnection(_Redial, HTTPConnection):
    pass


class RedialHTTPSConnection(_Redial, HTTPSConnection):
    pass


class RedialHandler(urllib.request.HTTPHandler):
    def http_open(self, req):
        return self.do_open(RedialConnection, req)


class RedialHTTPSHandler(urllib.request.HTTPSHandler):
    def https_open(self, req):
        return self.do_open(RedialHTTPSConnection, req, context=self._context)


OPENER = urllib.request.build_opener(RedialHandler)


def http(url: str, method: str = "GET", body: bytes | None = None, headers=None):
    """(status, headers, body) of one urllib request; an HTTP error status
    is an answer, not a raise. An https URL takes the port's process-wide
    client context (`utils/urls.py`, set by `enable_https`). A request
    with no answer raises with where each thread of this process is."""
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    opener = OPENER
    if url.startswith("https://"):
        from seaweedfs_tpu_torch.utils import urls

        opener = urllib.request.build_opener(RedialHTTPSHandler(context=urls.client_context()))
    t0 = time.perf_counter()
    try:
        with opener.open(req, timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()
    except OSError as e:  # URLError, a timeout, a reset
        frames = sys._current_frames()
        where = [f"{t.name}@{os.path.basename(s.filename)}:{s.lineno}:{s.name}"
                 for t in threading.enumerate() if t.ident in frames
                 for s in traceback.extract_stack(frames[t.ident], limit=1)]
        raise AssertionError(f"{method} {url} after {time.perf_counter() - t0:.1f} s: {e!r}; "
                             f"threads {where}") from e


def multipart_upload(payload: bytes, name: str) -> tuple[bytes, dict]:
    head = (f"--smoke-b0undary\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{name}\"\r\nContent-Type: {UPLOAD_MIME}\r\n\r\n").encode()
    return (head + payload + b"\r\n--smoke-b0undary--\r\n",
            {"Content-Type": "multipart/form-data; boundary=smoke-b0undary"})


def email_parse(headers, body: bytes) -> tuple[str, str, bytes]:
    """The first part of a multipart body through the email parser, as the
    server parses a body of another shape than clients send."""
    import email.parser
    import email.policy

    head = b"Content-Type: " + headers["Content-Type"].encode() + b"\r\n\r\n"
    part = next(email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(head + body).iter_parts())
    return part.get_filename() or "", part.get_content_type(), part.get_payload(decode=True)


def canon_record(raw: bytes) -> bytes:
    """A needle record with its append time normalised: the one field two
    transports may disagree on."""
    from seaweedfs_tpu_torch.storage.needle import Needle

    n = Needle.from_bytes(bytes(raw))
    n.append_at_ns = 1
    return n.to_bytes()


def server_phase(work: str, ctx, vol_rng_state: dict) -> tuple[dict, dict]:
    """Phase 14: a port `VolumeServer` (ec_backend="cuda") in this process,
    on loopback. 14a: phase 3's needles POSTed as multipart uploads into
    volume SERVER_VID, the first PLANE_BYTES of them also written into
    PLANE_VID with `NetPlaneClient.write_needle`; every needle read back
    (HTTP GET, `read_needle`) and the two volumes' records equal. 14b:
    SERVER_VID sealed, encoded on the card through the server's
    scheduler, mounted as an EC volume with shard DEGRADED unmounted.
    14c: every needle over that shard read with GET, cold from one
    client, then by CLIENT_THREADS clients; HEAD, a Range and a range past
    the end. 14d: deletes, the fan-out refusals, the status surfaces and
    a needle-read frame built by hand. Returns (result, launches)."""
    import threading

    from seaweedfs_tpu_torch.ec import BitrotProtection, TorchBackend, ec_encode_volume, native_io
    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.ec import net_plane
    from seaweedfs_tpu_torch.ec.net_plane import _REQ, _RESP, NetPlaneClient
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.server.volume_server import FAN_OUT_REFUSED, VolumeServer, _parse_upload
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.types import actual_offset
    from seaweedfs_tpu_torch.utils import metrics

    if not native_io.enabled():
        raise AssertionError("phase 14 needs the native plane (SEAWEED_EC_NATIVE is 0)")
    root = os.path.join(work, "server")
    os.makedirs(root)
    rng = np.random.default_rng()
    rng.bit_generator.state = vol_rng_state  # phase 3's needles
    launches = {"gf2_apply": 0, "gf2_apply_planes": 0}
    port = free_port()
    server = VolumeServer([root], ip="127.0.0.1", port=port,
                          grpc_port=net_plane.free_grpc_port(), ec_backend="cuda")
    if server.net_plane is None:
        raise AssertionError("14: the server has no net plane")
    server.start()
    url = f"http://127.0.0.1:{port}"
    addr = ("127.0.0.1", server.net_plane.port)
    client = NetPlaneClient(timeout=60)
    result: dict = {}
    try:
        # -- 14a. writes: multipart POSTs, and net-plane writes of the first 256 MiB
        store = server.store
        vol = store.allocate_volume(SERVER_VID, replica_placement="000")
        store.allocate_volume(PLANE_VID)
        want: dict[int, tuple[int, bytes, int]] = {}  # id -> (cookie, sha256, body length)
        post_s = plane_s = 0.0
        plane_ids, plane_bytes = [], 0
        for nid, cookie, body in needle_stream(rng):
            name = f"{nid:x}.bin"
            if vol.size + len(body) + 2 * len(name) + 64 > VOLUME_BYTES:
                break
            fid = FileId(SERVER_VID, nid, cookie)
            upload, hdrs = multipart_upload(body, name)
            t0 = time.perf_counter()
            status, _, answer = http(f"{url}/{fid}", "POST", upload, hdrs)
            post_s += time.perf_counter() - t0
            if status != 201 or json.loads(answer)["name"] != name:
                raise AssertionError(f"14a: POST {fid}: {status} {answer[:200]!r}")
            want[nid] = (cookie, hashlib.sha256(body).digest(), len(body))
            last = (hdrs, upload, body)
            if plane_bytes + len(body) <= PLANE_BYTES:
                t0 = time.perf_counter()
                client.write_needle(addr, PLANE_VID, nid, cookie, body, name=name, mime=UPLOAD_MIME)
                plane_s += time.perf_counter() - t0
                plane_ids.append(nid)
                plane_bytes += len(body)
        posted = sum(n for _, _, n in want.values())
        # the multipart parse of the last upload: the server's path, and the
        # email parser it takes for bodies of another shape
        parse_ms = {}
        hdrs, upload, body = last
        for how, parse in (("server", _parse_upload), ("email", email_parse)):
            t0 = time.perf_counter()
            if parse(hdrs, upload)[2] != body:
                raise AssertionError(f"14a: the {how} multipart parse differs")
            parse_ms[how] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for nid, (cookie, digest, _) in want.items():
            status, _, got = http(f"{url}/{FileId(SERVER_VID, nid, cookie)}")
            if status != 200 or hashlib.sha256(got).digest() != digest:
                raise AssertionError(f"14a: GET of needle {nid:x} differs ({status})")
        get_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for nid in plane_ids:
            if hashlib.sha256(client.read_needle(addr, PLANE_VID, nid, want[nid][0])).digest() \
                    != want[nid][1]:
                raise AssertionError(f"14a: read_needle of {nid:x} differs")
        plane_read_s = time.perf_counter() - t0
        plane_vol = store.find_volume(PLANE_VID)
        for nid in plane_ids:
            a, b = (v.needle_map.get(nid) for v in (vol, plane_vol))
            if canon_record(vol._pread_record(actual_offset(a.offset), a.size)) != \
                    canon_record(plane_vol._pread_record(actual_offset(b.offset), b.size)):
                raise AssertionError(f"14a: the HTTP and plane records of needle {nid:x} differ")
        plane_status = server.net_plane.status()
        if plane_status["write_native_bytes"] != plane_bytes or plane_status["write_python_bytes"]:
            raise AssertionError(f"14a: plane writes not all native: {plane_status}")
        result["14a"] = {
            "needles": len(want), "bytes": posted, "post_seconds": post_s,
            "post_mb_per_s": posted / post_s / 1e6, "get_seconds": get_s,
            "get_mb_per_s": posted / get_s / 1e6,
            "plane_needles": len(plane_ids), "plane_bytes": plane_bytes, "plane_write_seconds": plane_s,
            "plane_write_mb_per_s": plane_bytes / plane_s / 1e6, "plane_read_seconds": plane_read_s,
            "plane_read_mb_per_s": plane_bytes / plane_read_s / 1e6,
            "records_equal": len(plane_ids), "net_plane": plane_status,
            "multipart_parse_ms": parse_ms,
        }

        # -- 14b. seal, encode on the card, mount the EC volume with shard DEGRADED out
        records = [(nid, want[nid][0], actual_offset(vol.needle_map.get(nid).offset),
                    vol.needle_map.get(nid).size) for nid in want]
        vol.set_read_only(True)
        base = vol.dat_path[:-4]
        dat_size = os.path.getsize(base + ".dat")
        n_batches = len(list(batch_plan(dat_size, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)))
        rs_kernels.reset_launches()
        t0 = time.perf_counter()
        ec_encode_volume(base, ctx, backend=TorchBackend(ctx), scheduler=store.ec_scheduler)
        enc_s = time.perf_counter() - t0
        if rs_kernels.LAUNCHES["gf2_apply"] != n_batches:
            raise AssertionError(f"14b: encode launched {rs_kernels.LAUNCHES} for {n_batches} batches")
        launches["gf2_apply"] += n_batches
        prot = BitrotProtection.load(base + ".ecsum")
        for i in range(ctx.total):
            if prot.verify_shard_file(base + ctx.to_ext(i), i):
                raise AssertionError(f"14b: shard {i} fails .ecsum")
        store.unmount_volume(SERVER_VID)
        ev = store.mount_ec_volume(SERVER_VID)
        be = ev.backend
        if not (isinstance(be, TorchBackend) and be.device.type == DEVICE and be.impl == "cuda_planes"):
            raise AssertionError(f"14b: the server's EC volume runs on {be}")
        store.unmount_ec_shards(SERVER_VID, [DEGRADED])
        result["14b"] = {"dat_bytes": dat_size, "encode_seconds": enc_s,
                         "encode_gb_per_s": dat_size / enc_s / 1e9, "encode_batches": n_batches}

        # -- 14c. degraded reads over HTTP: cold from one client, then 8 at once
        degraded = [r for r in records
                    if any(sid == DEGRADED for sid, _, _ in record_intervals(r[2], r[3], dat_size))]
        healthy = [r for r in records
                   if all(sid != DEGRADED for sid, _, _ in record_intervals(r[2], r[3], dat_size))]
        cache = ev.interval_cache

        def get_checked(nid, cookie):
            t = time.perf_counter()
            status, _, got = http(f"{url}/{FileId(SERVER_VID, nid, cookie)}")
            dt = time.perf_counter() - t
            if status != 200 or hashlib.sha256(got).digest() != want[nid][1]:
                raise AssertionError(f"14c: degraded GET of needle {nid:x} differs ({status})")
            return dt

        rs_kernels.reset_launches()
        loads0, hits0 = cache.loads, cache.hits
        cold = [get_checked(nid, cookie) for nid, cookie, _, _ in degraded]
        cold_loads = cache.loads - loads0
        planes = rs_kernels.LAUNCHES["gf2_apply_planes"]
        if planes != cold_loads or planes < 1 or rs_kernels.LAUNCHES["gf2_apply"]:
            raise AssertionError(f"14c: cold reads launched {rs_kernels.LAUNCHES} for {cold_loads} "
                                 "reconstructions")
        rejected0 = metrics.gateway_rejected_total.snapshot().get(("volume",), 0)
        loads1 = cache.loads
        errors: list = []
        work_q = list(degraded)
        lock = threading.Lock()

        def reader():
            while True:
                with lock:
                    if not work_q:
                        return
                    nid, cookie, _, _ = work_q.pop()
                try:
                    get_checked(nid, cookie)
                except Exception as e:  # noqa: BLE001 — raised below
                    errors.append(e)
                    return

        threads = [threading.Thread(target=reader) for _ in range(CLIENT_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        par_s = time.perf_counter() - t0
        if errors:
            raise errors[0]
        rejected = metrics.gateway_rejected_total.snapshot().get(("volume",), 0) - rejected0
        if rejected:
            raise AssertionError(f"14c: the pooled front end rejected {rejected} connections")
        planes = rs_kernels.LAUNCHES["gf2_apply_planes"]
        if planes != cache.loads - loads0:
            raise AssertionError(f"14c: {planes} launches for {cache.loads - loads0} reconstructions")
        launches["gf2_apply_planes"] += planes
        before = dict(rs_kernels.LAUNCHES)
        for nid, cookie, _, _ in healthy[:20]:
            get_checked(nid, cookie)
        if dict(rs_kernels.LAUNCHES) != before:
            raise AssertionError("14c: a read that touches no missing shard launched a kernel")
        nid, cookie, _, _ = degraded[0]
        blen = want[nid][2]
        fid_url = f"{url}/{FileId(SERVER_VID, nid, cookie)}"
        status, hdrs, got = http(fid_url, "HEAD")
        if (status, hdrs["Content-Length"], got, hdrs["Accept-Ranges"]) != (200, str(blen), b"", "bytes"):
            raise AssertionError(f"14c: HEAD answered {status} {dict(hdrs)}")
        status, hdrs, got = http(fid_url, headers={"Range": "bytes=100-4195"})
        full = http(fid_url)[2]
        if (status, hdrs["Content-Range"], got) != (206, f"bytes 100-4195/{blen}", full[100:4196]):
            raise AssertionError(f"14c: Range answered {status} {dict(hdrs)}")
        status, hdrs, got = http(fid_url, headers={"Range": f"bytes={blen}-"})
        if (status, hdrs["Content-Range"]) != (416, f"bytes */{blen}"):
            raise AssertionError(f"14c: a range past the end answered {status} {dict(hdrs)}")
        result["14c"] = {
            "degraded_reads": len(degraded), "cold_p50_ms": percentile_ms(cold, 50),
            "cold_p99_ms": percentile_ms(cold, 99), "cold_seconds": sum(cold),
            "reconstructions": cold_loads, "cold_cache_hits": cache.hits - hits0,
            "threads": CLIENT_THREADS, "parallel_seconds": par_s,
            "parallel_requests_per_s": len(degraded) / par_s,
            "parallel_reconstructions": cache.loads - loads1, "rejected": rejected,
            "launches": planes, "healthy_reads_without_launch": len(healthy[:20]),
        }

        # -- 14d. deletes, fan-out refusals, status surfaces, a hand-built frame --
        codes = []
        for nid in plane_ids[1 : 1 + N_DELETED]:
            fid_b = f"{url}/{FileId(PLANE_VID, nid, want[nid][0])}"
            codes.append((http(fid_b, "DELETE")[0], http(fid_b)[0]))
        if codes != [(202, 404)] * N_DELETED:
            raise AssertionError(f"14d: deletes answered {codes}")
        store.allocate_volume(REPLICATED_VID, replica_placement="001")
        rep = http(f"{url}/{FileId(REPLICATED_VID, 0x51, 0x52)}", "POST", b"r" * 4096)
        ec_del = http(f"{url}/{FileId(SERVER_VID, nid, cookie)}", "DELETE")
        # a server without a master: the replicated write is refused, and the
        # EC delete answers the JAX server's failed holder lookup
        for what, (status, _, answer), phrase in (
                ("replicated write", rep, FAN_OUT_REFUSED),
                ("ec delete", ec_del, "ec tombstone fan-out: holder lookup failed")):
            if status != 500 or phrase not in json.loads(answer)["error"]:
                raise AssertionError(f"14d: the {what} answered {status} {answer[:200]!r}")
        st = json.loads(http(f"{url}/status")[2])
        missing = {"ec_device_queue", "ec_net_plane", "ec_streams", "ec_residency"} - set(st)
        if missing:
            raise AssertionError(f"14d: /status lacks {missing}")
        parsed = parse_exposition(http(f"{url}/metrics")[2].decode())
        names = {n for n, _ in parsed}
        served = {dict(lab).get("server") for n, lab in parsed if n == "sw_request_seconds_count"}
        if "sw_volumes" not in names or "volume" not in served:
            raise AssertionError("14d: /metrics lacks sw_volumes or sw_request_seconds{server=volume}")
        slo = json.loads(http(f"{url}/debug/slo")[2])
        gateway = json.loads(http(f"{url}/debug/gateway")[2])
        if "volume.read" not in slo or gateway["front_end"]["kind"] != "pooled":
            raise AssertionError(f"14d: /debug/slo {list(slo)}, /debug/gateway {gateway}")
        # the JAX package's needle-read frame, built by hand from its layout:
        # the shard slot carries the cookie and the generation slot the id
        nid = plane_ids[0]
        with socket.create_connection(addr, timeout=30) as s:
            s.sendall(_REQ.pack(b"SWNR", PLANE_VID, want[nid][0], nid, 0, 0, 0))
            head = b""
            while len(head) < _RESP.size + 4:
                head += s.recv(_RESP.size + 4 - len(head))
            status, n = _RESP.unpack(head[: _RESP.size])
            body = b""
            while len(body) < n:
                body += s.recv(min(1 << 20, n - len(body)))
        if status != 0 or hashlib.sha256(body).digest() != want[nid][1]:
            raise AssertionError(f"14d: the hand-built needle-read frame got status {status}")
        result["14d"] = {
            "deletes": codes, "replicated_write": rep[0], "ec_delete": ec_del[0],
            "status_keys": sorted(st), "slo_ops": sorted(slo), "front_end": gateway["front_end"],
            "frame_status": status, "frame_bytes": n,
        }
        result["launches"] = launches
    finally:
        client.close()
        server.stop()
    shutil.rmtree(root)
    return result, launches

# -- 15. the cluster half: four port servers under a stand-in master -------------


CLUSTER_VID, CLUSTER_REP_VID = 1, 2  # the 1 GiB volume (hard links), a `001` volume
CLUSTER_SPLIT = {"b": (4, 5, 6, 7), "c": (8, 9, 10, 11), "d": (12, 13)}  # A keeps 0-3
CLUSTER_LOST = {3: "a", 11: "c"}  # lost at these holders, rebuilt from peers at A
CLUSTER_REP_BYTES = 256 << 20  # 15f: phase 3's first needles, POSTed to the `001` volume
CLUSTER_DELETES = 5  # 15g: EC deletes fanned out to every holder


def wait_until(cond, what: str, timeout: float = 30.0, phase: str = "15") -> float:
    """Poll `cond` until true; returns the seconds waited."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{phase}: {what} within {timeout} s")
        time.sleep(0.02)
    return time.perf_counter() - t0


def wait_value(fn, what: str, timeout: float = 30.0, phase: str = "17"):
    """Poll `fn` until it returns something other than None; returns that."""
    t0 = time.perf_counter()
    while True:
        v = fn()
        if v is not None:
            return v
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{phase}: {what} within {timeout} s")
        time.sleep(0.02)


def cluster_phase(work: str, ctx, digests: dict, records, n_batches: int, reb_batches: int,
                  vol_rng_state: dict) -> tuple[dict, dict]:
    """Phase 15: the cluster half on the card. A port `MasterServer` and
    four port `VolumeServer`s (ec_backend="cuda") in this process on
    loopback,
    every EC step an RPC over gRPC: 15a VolumeMount of the 1 GiB volume
    (hard links into A); 15b VolumeEcShardsGenerate on A (launches ==
    batches, shards sha256-identical to phase 4's), VolumeEcShardsMount,
    VolumeDelete of the plain volume; 15c VolumeEcShardsCopy of shards 4-13
    to B, C and D over the net plane (shard 7 again over CopyFile under
    SEAWEED_EC_NATIVE=0), mounts, unmounts and deletes at A, until the
    master holds 14 shards on four holders; 15d shard 3 unmounted at A, and
    cold degraded GETs at A of every needle over it, its siblings mostly
    remote (bit-exact, planes launches == reconstructions); 15e shards 3
    and 11 deleted at their holders and VolumeEcShardsRebuild(from_peers)
    at A (launches == rebuild batches, rebuilt and handed-off shards
    sha256-identical to phase 5's, mounted and advertised by their planned
    holders); 15f a `001` volume on A and B, 256 MiB of phase 3's needles
    POSTed to A, half with plane legs and half with gRPC legs, B's records
    equal, then ReadNeedle on B, DeleteNeedle on A (fanned out to B), and
    VolumeUnmount and VolumeMount on B as the master sees them; 15g EC deletes reaching every holder; 15h ScrubEcVolume and
    VolumeServerStatus on every holder; 15i the data shards gathered on B
    and VolumeEcShardsToVolume there: the original .dat. Returns (result,
    launches)."""
    import grpc

    from seaweedfs_tpu_torch.ec import native_io, net_plane
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.types import actual_offset

    if not native_io.enabled():
        raise AssertionError("phase 15 needs the native plane (SEAWEED_EC_NATIVE is 0)")
    root = os.path.join(work, "cluster")
    dat = os.path.join(root, "a", f"{CLUSTER_VID}.dat")
    dat_size = os.path.getsize(dat)
    want_dat = sha256(dat)
    dat_fd = os.open(dat, os.O_RDONLY)  # the original needles, after VolumeDelete too

    def original(rec) -> bytes:
        return os.pread(dat_fd, rec[3], rec[2] + 20)  # header(16) + data size(4)

    launches = {"gf2_apply": 0, "gf2_apply_planes": 0}
    result: dict = {}
    steps: dict = {}
    mport = net_plane.free_grpc_port()  # the master's HTTP port; its gRPC port is +10000
    master = MasterServer(ip="127.0.0.1", port=mport)
    master.start()
    servers: dict = {}
    channels = []
    lookup = None
    try:
        for name in "abcd":
            d = os.path.join(root, name)
            os.makedirs(d, exist_ok=True)
            servers[name] = VolumeServer([d], master=f"127.0.0.1:{mport}", ip="127.0.0.1",
                                         port=free_port(), grpc_port=net_plane.free_grpc_port(),
                                         ec_backend="cuda")
            if servers[name].net_plane is None:
                raise AssertionError(f"15: server {name} has no net plane")
            servers[name].start()
        url = {n: f"127.0.0.1:{vs.port}" for n, vs in servers.items()}
        name_of = {u: n for n, u in url.items()}
        gaddr = {n: f"127.0.0.1:{vs.grpc_port}" for n, vs in servers.items()}
        for n in "abcd":
            channels.append(grpc.insecure_channel(gaddr[n]))
        stub = {n: rpc.volume_stub(ch) for n, ch in zip("abcd", channels)}
        mchan = grpc.insecure_channel(f"127.0.0.1:{mport + 10000}")
        channels.append(mchan)
        mstub = rpc.master_stub(mchan)

        def ec_holders() -> dict:
            resp = mstub.LookupEcVolume(pb.LookupEcVolumeRequest(volume_id=CLUSTER_VID), timeout=10)
            return {sl.shard_id: sorted(name_of[loc.url] for loc in sl.locations)
                    for sl in resp.shard_locations}

        def step(label, fn, nbytes=0):
            t0 = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t0
            steps[label] = {"seconds": dt, **({"gb_per_s": nbytes / dt / 1e9, "bytes": nbytes}
                                                if nbytes else {})}
            return out

        step("register", lambda: wait_until(lambda: len(master.topo.nodes) == 4, "servers registered"))

        # -- 15a, 15b. mount the volume, encode it on the card over gRPC -----------
        step("15a VolumeMount", lambda: stub["a"].VolumeMount(
            pb.AllocateVolumeRequest(volume_id=CLUSTER_VID), timeout=60))
        rs_kernels.reset_launches()
        gen = step("15b VolumeEcShardsGenerate", lambda: stub["a"].VolumeEcShardsGenerate(
            pb.EcShardsGenerateRequest(volume_id=CLUSTER_VID), timeout=600), dat_size).generation
        if rs_kernels.LAUNCHES["gf2_apply"] != n_batches or rs_kernels.LAUNCHES["gf2_apply_planes"]:
            raise AssertionError(f"15b: generate launched {rs_kernels.LAUNCHES} for {n_batches} batches")
        launches["gf2_apply"] += n_batches
        steps["15b VolumeEcShardsGenerate"]["launches"] = n_batches
        abase = os.path.join(root, "a", str(CLUSTER_VID))
        for i in range(ctx.total):
            if sha256(abase + ctx.to_ext(i)) != digests[i]:
                raise AssertionError(f"15b: generated shard {i} differs from phase 4's")
        step("15b VolumeEcShardsMount", lambda: stub["a"].VolumeEcShardsMount(
            pb.EcShardsMountRequest(volume_id=CLUSTER_VID), timeout=60))
        if stub["a"].VolumeDelete(pb.VolumeCommandRequest(volume_id=CLUSTER_VID), timeout=60).error:
            raise AssertionError("15b: VolumeDelete of the plain volume failed")
        shard_size = os.path.getsize(abase + ctx.to_ext(0))

        # -- 15c. spread shards 4-13 over B, C and D -------------------------------
        served0 = servers["a"].net_plane.status()["sendfile_bytes"]
        for n, sids in CLUSTER_SPLIT.items():
            step(f"15c VolumeEcShardsCopy to {n}", lambda n=n, sids=sids: stub[n].VolumeEcShardsCopy(
                pb.EcShardsCopyRequest(volume_id=CLUSTER_VID, shard_ids=list(sids), source_url=gaddr["a"],
                                       copy_ecx=True, copy_ecj=True, copy_vif=True, copy_ecsum=True),
                timeout=600), len(sids) * shard_size)
        native_bytes = servers["a"].net_plane.status()["sendfile_bytes"] - served0
        if native_bytes != (ctx.total - 4) * shard_size:
            raise AssertionError(f"15c: the net plane served {native_bytes} bytes for "
                                 f"{ctx.total - 4} shards of {shard_size}")
        # once more over CopyFile, with the native plane off
        stub["b"].VolumeEcShardsDelete(pb.EcShardsDeleteRequest(volume_id=CLUSTER_VID, shard_ids=[7]),
                                       timeout=60)
        os.environ["SEAWEED_EC_NATIVE"] = "0"
        try:
            step("15c VolumeEcShardsCopy over CopyFile", lambda: stub["b"].VolumeEcShardsCopy(
                pb.EcShardsCopyRequest(volume_id=CLUSTER_VID, shard_ids=[7], source_url=gaddr["a"]),
                timeout=600), shard_size)
        finally:
            del os.environ["SEAWEED_EC_NATIVE"]
        if servers["a"].net_plane.status()["sendfile_bytes"] - served0 != native_bytes:
            raise AssertionError("15c: the CopyFile copy moved bytes on the net plane")
        for n, sids in CLUSTER_SPLIT.items():
            for i in sids:
                if sha256(os.path.join(root, n, str(CLUSTER_VID)) + ctx.to_ext(i)) != digests[i]:
                    raise AssertionError(f"15c: shard {i} copied to {n} differs")
            stub[n].VolumeEcShardsMount(pb.EcShardsMountRequest(volume_id=CLUSTER_VID), timeout=60)
        moved = [i for sids in CLUSTER_SPLIT.values() for i in sids]
        stub["a"].VolumeEcShardsUnmount(pb.EcShardsUnmountRequest(volume_id=CLUSTER_VID, shard_ids=moved),
                                        timeout=60)
        stub["a"].VolumeEcShardsDelete(pb.EcShardsDeleteRequest(volume_id=CLUSTER_VID, shard_ids=moved),
                                       timeout=60)
        placed = {i: ["a"] for i in range(4)} | {i: [n] for n, sids in CLUSTER_SPLIT.items() for i in sids}
        step("15c master holds 14 shards on four holders",
             lambda: wait_until(lambda: ec_holders() == placed, "the split reached the master"))

        # -- 15d. cold degraded GETs at A, shard 3 unmounted, siblings remote ------
        stub["a"].VolumeEcShardsUnmount(pb.EcShardsUnmountRequest(volume_id=CLUSTER_VID, shard_ids=[3]),
                                        timeout=60)
        servers["a"].notify_deleted_ec_shards(CLUSTER_VID, "", [3])
        wait_until(lambda: 3 not in ec_holders(), "shard 3's unmount reached the master")
        degraded = degraded_records(records, dat_size)
        cache = servers["a"].store.ec_interval_cache
        net0 = net_snapshot()
        loads0 = cache.loads
        rs_kernels.reset_launches()
        lat = []
        for rec in degraded:
            t0 = time.perf_counter()
            status, _, got = http(f"http://{url['a']}/{FileId(CLUSTER_VID, rec[0], rec[1])}")
            lat.append(time.perf_counter() - t0)
            if status != 200 or got != original(rec):
                raise AssertionError(f"15d: degraded GET of needle {rec[0]:x} differs ({status})")
        recon = cache.loads - loads0
        planes = rs_kernels.LAUNCHES["gf2_apply_planes"]
        if planes != recon or planes < 1 or rs_kernels.LAUNCHES["gf2_apply"]:
            raise AssertionError(f"15d: {rs_kernels.LAUNCHES} launches for {recon} reconstructions")
        launches["gf2_apply_planes"] += planes
        got_bytes = sum(r[3] for r in degraded)
        steps["15d degraded GETs"] = {
            "seconds": sum(lat), "needles": len(degraded), "bytes": got_bytes,
            "gb_per_s": got_bytes / sum(lat) / 1e9, "p50_ms": percentile_ms(lat, 50),
            "p99_ms": percentile_ms(lat, 99), "reconstructions": recon, "launches": planes,
            "net": net_delta(net0),
        }

        # -- 15e. shards 3 and 11 lost, peer-fetch rebuild at A, hand-off ------------
        for sid, holder in CLUSTER_LOST.items():
            stub[holder].VolumeEcShardsUnmount(
                pb.EcShardsUnmountRequest(volume_id=CLUSTER_VID, shard_ids=[sid]), timeout=60)
            stub[holder].VolumeEcShardsDelete(
                pb.EcShardsDeleteRequest(volume_id=CLUSTER_VID, shard_ids=[sid]), timeout=60)
        wait_until(lambda: not set(CLUSTER_LOST) & set(ec_holders()), "the losses reached the master")
        rs_kernels.reset_launches()
        net0 = net_snapshot()
        resp = step("15e VolumeEcShardsRebuild from peers", lambda: stub["a"].VolumeEcShardsRebuild(
            pb.EcShardsRebuildRequest(volume_id=CLUSTER_VID, from_peers=True), timeout=600),
            (ctx.data_shards - 3) * shard_size)
        reb = {"rebuilt": list(resp.rebuilt_shard_ids), "fetched": list(resp.fetched_shard_ids),
               "distributed": list(resp.distributed_shard_ids), "repaired": list(resp.repaired_shard_ids)}
        if (reb["rebuilt"] != sorted(CLUSTER_LOST) or reb["distributed"] != sorted(CLUSTER_LOST)
                or len(reb["fetched"]) != ctx.data_shards - 3 or reb["repaired"]):
            raise AssertionError(f"15e: peer-fetch rebuild answered {reb}")
        if rs_kernels.LAUNCHES["gf2_apply"] != reb_batches or rs_kernels.LAUNCHES["gf2_apply_planes"]:
            raise AssertionError(f"15e: rebuild launched {rs_kernels.LAUNCHES} for {reb_batches} batches")
        launches["gf2_apply"] += reb_batches
        steps["15e VolumeEcShardsRebuild from peers"]["launches"] = reb_batches
        steps["15e VolumeEcShardsRebuild from peers"]["net"] = net_delta(net0)
        steps["15e VolumeEcShardsRebuild from peers"]["answer"] = reb
        wait_until(lambda: all(len(ec_holders().get(i, [])) == 1 for i in range(ctx.total)),
                   "the rebuilt shards were not advertised once each")
        planned = ec_holders()
        for sid in CLUSTER_LOST:
            (n,) = planned[sid]
            path = os.path.join(root, n, str(CLUSTER_VID)) + ctx.to_ext(sid)
            if sha256(path) != digests[sid]:
                raise AssertionError(f"15e: shard {sid} at its planned holder {n} differs")
            if sid not in servers[n].store.find_ec_volume(CLUSTER_VID).shard_fds:
                raise AssertionError(f"15e: shard {sid} not mounted at {n}")
        steps["15e VolumeEcShardsRebuild from peers"]["planned_holders"] = {
            sid: planned[sid][0] for sid in CLUSTER_LOST}

        # -- 15f. a replicated volume: POSTs to A, records equal on B ----------------
        for n in "ab":
            stub[n].AllocateVolume(pb.AllocateVolumeRequest(volume_id=CLUSTER_REP_VID, replication="001"),
                                   timeout=60)
        wait_until(lambda: len(mstub.LookupVolume(pb.LookupVolumeRequest(volume_ids=[CLUSTER_REP_VID]),
                                                  timeout=10).volume_locations[0].locations) == 2,
                   "the replicas registered")
        rng = np.random.default_rng()
        rng.bit_generator.state = vol_rng_state  # phase 3's needles
        items, total = [], 0
        for nid, cookie, body in needle_stream(rng):
            if total + len(body) > CLUSTER_REP_BYTES:
                break
            items.append((nid, cookie, body))
            total += len(body)
        half = len(items) // 2
        legs = {}
        for leg, part in (("plane", items[:half]), ("grpc", items[half:])):
            writes0 = servers["b"].net_plane.write_requests
            if leg == "grpc":
                os.environ["SEAWEED_EC_NATIVE"] = "0"
            try:
                t0 = time.perf_counter()
                for nid, cookie, body in part:
                    status, _, answer = http(f"http://{url['a']}/{FileId(CLUSTER_REP_VID, nid, cookie)}",
                                             "POST", body, {"Content-Type": "application/octet-stream"})
                    if status != 201:
                        raise AssertionError(f"15f: replicated POST answered {status} {answer[:200]!r}")
                dt = time.perf_counter() - t0
            finally:
                os.environ.pop("SEAWEED_EC_NATIVE", None)
            nbytes = sum(len(b) for _, _, b in part)
            plane_writes = servers["b"].net_plane.write_requests - writes0
            if plane_writes != (len(part) if leg == "plane" else 0):
                raise AssertionError(f"15f: {plane_writes} plane writes on B for {len(part)} {leg} legs")
            legs[leg] = {"needles": len(part), "bytes": nbytes, "seconds": dt,
                         "mb_per_s": nbytes / dt / 1e6, "plane_writes_on_b": plane_writes}
        va, vb = (servers[n].store.find_volume(CLUSTER_REP_VID) for n in "ab")
        for nid, _, _ in items:
            a, b = va.needle_map.get(nid), vb.needle_map.get(nid)
            if canon_record(va._pread_record(actual_offset(a.offset), a.size)) != \
                    canon_record(vb._pread_record(actual_offset(b.offset), b.size)):
                raise AssertionError(f"15f: the replica's record of needle {nid:x} differs")
        steps["15f replicated POSTs"] = {**legs, "records_equal": len(items)}

        # ReadNeedle, DeleteNeedle (fanned out to B), VolumeUnmount and
        # VolumeMount of the `001` volume, each over gRPC
        def rep_holders() -> int:
            return len(mstub.LookupVolume(pb.LookupVolumeRequest(volume_ids=[CLUSTER_REP_VID]),
                                          timeout=10).volume_locations[0].locations)

        def read_b(nid, cookie):
            return stub["b"].ReadNeedle(pb.ReadNeedleRequest(
                volume_id=CLUSTER_REP_VID, needle_id=nid, cookie=cookie), timeout=60)

        t0 = time.perf_counter()
        (nid0, cookie0, body0), (nid1, cookie1, body1) = items[0], items[-1]
        r = read_b(nid0, cookie0)
        if r.error or r.data != body0:
            raise AssertionError(f"15f: ReadNeedle on B answered {r.error!r}, {len(r.data)} bytes")
        r = stub["a"].DeleteNeedle(pb.DeleteNeedleRequest(volume_id=CLUSTER_REP_VID, needle_id=nid0),
                                   timeout=60)
        if r.error:
            raise AssertionError(f"15f: DeleteNeedle on A answered {r.error!r}")
        if not read_b(nid0, cookie0).error.startswith("not found"):
            raise AssertionError("15f: the deleted needle still reads on B")
        r = stub["b"].VolumeUnmount(pb.VolumeCommandRequest(volume_id=CLUSTER_REP_VID), timeout=60)
        if r.error:
            raise AssertionError(f"15f: VolumeUnmount on B answered {r.error!r}")
        wait_until(lambda: rep_holders() == 1, "the master dropping B's unmounted replica")
        r = stub["b"].VolumeMount(pb.AllocateVolumeRequest(volume_id=CLUSTER_REP_VID), timeout=60)
        if r.error:
            raise AssertionError(f"15f: VolumeMount on B answered {r.error!r}")
        wait_until(lambda: rep_holders() == 2, "the master listing B's remounted replica")
        r = read_b(nid1, cookie1)
        if r.error or r.data != body1:
            raise AssertionError(f"15f: ReadNeedle on B after the remount answered {r.error!r}")
        steps["15f needle RPCs and remount"] = {"seconds": time.perf_counter() - t0}

        # -- 15g. EC deletes fanned out to every holder ------------------------------
        gone = [r for r in records[1 : 1 + CLUSTER_DELETES]]
        t0 = time.perf_counter()
        for rec in gone:
            status, _, answer = http(f"http://{url['a']}/{FileId(CLUSTER_VID, rec[0], rec[1])}", "DELETE")
            if status != 202:
                raise AssertionError(f"15g: EC delete answered {status} {answer[:200]!r}")
        steps["15g EC deletes"] = {"seconds": time.perf_counter() - t0, "needles": len(gone)}
        for n, vs in servers.items():
            ev = vs.store.find_ec_volume(CLUSTER_VID)
            for rec in gone:
                if http(f"http://{url[n]}/{FileId(CLUSTER_VID, rec[0], rec[1])}")[0] != 404:
                    raise AssertionError(f"15g: needle {rec[0]:x} still reads at {n}")
            with open(ev.base + ".ecj", "rb") as f:
                if len(f.read()) != 8 * len(gone):
                    raise AssertionError(f"15g: {n}'s .ecj does not hold the {len(gone)} deletes")

        # -- 15h. ScrubEcVolume and VolumeServerStatus on every holder ---------------
        scrubs, bits = {}, 0
        t0 = time.perf_counter()
        for n in "abcd":
            sr = stub[n].ScrubEcVolume(pb.ScrubRequest(volume_id=CLUSTER_VID), timeout=600)
            if sr.error or sr.bad_shards or sr.quarantined_shards:
                raise AssertionError(f"15h: scrub at {n}: {sr}")
            scrubs[n] = list(sr.checked_shards)
            st = stub[n].VolumeServerStatus(pb.VolumeServerStatusRequest(), timeout=60)
            bits += sum(bin(e.shard_bits).count("1") for e in st.ec_shards if e.id == CLUSTER_VID)
        if sorted(i for v in scrubs.values() for i in v) != list(range(ctx.total)) or bits != ctx.total:
            raise AssertionError(f"15h: scrubs {scrubs}, {bits} shard bits in the status answers")
        steps["15h scrub and status"] = {"seconds": time.perf_counter() - t0, "checked": scrubs}

        # -- 15i. the data shards gathered on B, VolumeEcShardsToVolume there ---------
        holders = ec_holders()
        bbase = os.path.join(root, "b", str(CLUSTER_VID))
        t0 = time.perf_counter()
        for sid in range(ctx.data_shards):
            if os.path.exists(bbase + ctx.to_ext(sid)):
                continue
            src = holders[sid][0]
            stub["b"].VolumeEcShardsCopy(pb.EcShardsCopyRequest(
                volume_id=CLUSTER_VID, shard_ids=[sid], source_url=gaddr[src]), timeout=600)
        steps["15i gather data shards on b"] = {"seconds": time.perf_counter() - t0}
        rs_kernels.reset_launches()
        step("15i VolumeEcShardsToVolume", lambda: stub["b"].VolumeEcShardsToVolume(
            pb.EcShardsToVolumeRequest(volume_id=CLUSTER_VID), timeout=600), dat_size)
        if any(rs_kernels.LAUNCHES.values()):
            raise AssertionError(f"15i: decode with every data shard launched {rs_kernels.LAUNCHES}")
        if os.path.getsize(bbase + ".dat") != dat_size or sha256(bbase + ".dat") != want_dat:
            raise AssertionError("15i: the decoded .dat differs from the original")
        rec = records[-1]
        status, _, got = http(f"http://{url['b']}/{FileId(CLUSTER_VID, rec[0], rec[1])}")
        if status != 200 or got != original(rec):
            raise AssertionError(f"15i: GET from the decoded volume answered {status}")
        result["steps"] = steps
        result["launches"] = launches
        result["shard_bytes"] = shard_size
    finally:
        for ch in channels:
            ch.close()
        for vs in servers.values():
            vs.stop()
        master.stop()
        os.close(dat_fd)
    shutil.rmtree(root)
    return result, launches


ADMIN_VID = 1  # phase 16's volume: the 1 GiB volume (hard links into A)
ADMIN_NEW_BYTES = 64 << 20  # 16c: new needles POSTed to A at phase 3's sizes
ADMIN_NEW_DELETES = 5  # 16c: of those, deleted before the catch-up
ADMIN_VACUUM_EVERY = 10  # 16d: every 10th original needle deleted before the vacuum
ADMIN_TIER_GETS = 20  # 16f: GETs served from the cold tier
CHILD_STOP_S = 10.0  # a child server that outlives SIGTERM by this much is killed


class ObjectEndpoint:
    """Phase 16's cold tier: a small object endpoint that answers PUT, GET
    (with `Range`), HEAD and DELETE from a directory, as the S3-style URL
    the port's `storage/backend.py` reads and writes (the port has no S3
    gateway of its own). It counts the ranged GETs it serves."""

    def __init__(self, root: str):
        import http.server
        import threading

        os.makedirs(root, exist_ok=True)
        endpoint = self
        self.root = root
        self.ranged_gets = 0

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _path(self) -> str:
                return os.path.join(root, self.path.strip("/").replace("/", "_"))

            def _reply(self, code: int, length: int = 0, headers=()) -> None:
                self.send_response(code)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(length))
                self.end_headers()

            def do_PUT(self):
                left = int(self.headers["Content-Length"])
                tmp = self._path() + ".part"
                with open(tmp, "wb") as f:
                    while left > 0:
                        chunk = self.rfile.read(min(8 << 20, left))
                        if not chunk:
                            break
                        f.write(chunk)
                        left -= len(chunk)
                if left:
                    os.unlink(tmp)
                    return self._reply(400)
                os.replace(tmp, self._path())
                self._reply(200)

            def do_HEAD(self):
                p = self._path()
                if not os.path.exists(p):
                    return self._reply(404)
                self._reply(200, os.path.getsize(p))

            def do_GET(self):
                p = self._path()
                if not os.path.exists(p):
                    return self._reply(404)
                size = os.path.getsize(p)
                lo, hi, code, headers = 0, size - 1, 200, []
                rng = re.fullmatch(r"bytes=(\d+)-(\d+)", self.headers.get("Range", ""))
                if rng:
                    lo, hi = int(rng[1]), min(int(rng[2]), size - 1)
                    code, headers = 206, [("Content-Range", f"bytes {lo}-{hi}/{size}")]
                    endpoint.ranged_gets += 1
                self._reply(code, hi - lo + 1, headers)
                with open(p, "rb") as f:
                    self.connection.sendfile(f, lo, hi - lo + 1)

            def do_DELETE(self):
                p = self._path()
                if not os.path.exists(p):
                    return self._reply(404)
                os.unlink(p)
                self._reply(204)

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def server_port() -> int:
    """An HTTP port whose gRPC port (+10000) and net-plane port are free:
    a launched server derives both from its `-port`."""
    from seaweedfs_tpu_torch.ec import net_plane

    while True:
        p = net_plane.free_grpc_port()
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", net_plane.derive_port(p + 10000)))
        except OSError:
            continue
        return p


def admin_phase(work: str, ctx, records, vol_rng_state: dict) -> tuple[dict, dict]:
    """Phase 16: the admin RPCs of plain volumes and the launcher, on the
    1 GiB volume (hard links made right after phase 4) under a port master
    started by name (`python3 -m seaweedfs_tpu_torch.server master`, a
    child process). Server A is built in this process by the launcher's
    `build` (-ec.backend cuda), so its launches count here; B and C are
    children started by name (`python3 -m seaweedfs_tpu_torch.server
    volume ... -ec.backend cuda`). 16a VolumeMount and ReadVolumeFileStatus
    on A; 16b VolumeMarkReadonly on A, VolumeCopy into B (sha256-equal
    files), VolumeMarkWritable; 16c 64 MiB of new needles POSTed to A and 5
    deleted, B's VolumeTailReceiver from A (B's .dat and .idx identical to
    A's), VolumeIncrementalCopy from A (A's .dat suffix); 16d a tenth of
    the needles deleted, VacuumVolume (the reclaimed bytes and revision
    expected, every live needle read back); 16e ScrubVolume on A (clean)
    and on B with one needle's body flipped (that needle named); 16f
    VolumeCopy into C, VolumeTierUpload to an `ObjectEndpoint`, 20 GETs
    from the tier, VolumeTierDownload (the .dat sha256-equal); 16g the
    shell's `ec.encode` flow (readonly on every holder, generate on A:
    `gf2_apply` launches == batches; mount; VolumeDelete on every holder),
    shard 3 unmounted and every needle over it read with GET at A
    (`gf2_apply_planes` launches == reconstructions). Every body read is
    sha256-equal to phase 3's (or the new needle's). Prints one JSON line
    per step; returns (result, launches)."""
    import grpc

    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.server.__main__ import build
    from seaweedfs_tpu_torch.shell.commands import ShellEnv, run_command
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.types import NeedleValue, actual_offset, padded_record_size

    root = os.path.join(work, "admin")
    dirs = {n: os.path.join(root, n) for n in "abc"}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    vid = ADMIN_VID
    repo = os.path.dirname(os.path.abspath(__file__))
    launches = {"gf2_apply": 0, "gf2_apply_planes": 0}
    result: dict = {}

    def digest(b: bytes) -> str:
        return hashlib.sha256(b).hexdigest()

    def check(resp, what: str):
        if resp.error:
            raise AssertionError(f"{what}: {resp.error}")
        return resp

    def line(label: str, out: dict) -> None:
        result[label] = out
        print(f"{label}: {json.dumps(out)}")

    mport = server_port()
    endpoint = ObjectEndpoint(os.path.join(root, "tier"))
    endpoint.start()
    children: dict = {}
    servers: list = []
    channels: list = []
    ports = {n: server_port() for n in "abc"}
    url = {n: f"127.0.0.1:{p}" for n, p in ports.items()}
    gaddr = {n: f"127.0.0.1:{p + 10000}" for n, p in ports.items()}
    failed = True
    try:
        # -- the master and servers B and C started by name, A built here by
        # the launcher ------------------------------------------------------------
        env = dict(os.environ, PYTHONPATH=repo)
        os.makedirs(os.path.join(root, "mdir"))
        log = open(os.path.join(root, "master.log"), "wb")
        children["master"] = (subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.server", "master", "-ip", "127.0.0.1",
             "-port", str(mport), "-mdir", os.path.join(root, "mdir")],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT), log)
        mchan = grpc.insecure_channel(f"127.0.0.1:{mport + 10000}")
        channels.append(mchan)
        mstub = rpc.master_stub(mchan)
        spawned = {}
        for n in "bc":
            log = open(os.path.join(root, f"{n}.log"), "wb")
            spawned[n] = time.perf_counter()
            children[n] = (subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch.server", "volume", "-dir", dirs[n],
                 "-master", f"127.0.0.1:{mport}", "-ip", "127.0.0.1", "-port", str(ports[n]),
                 "-ec.backend", "cuda"],
                cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT), log)
        t0 = time.perf_counter()
        (server_a,) = build(["volume", "-dir", dirs["a"], "-master", f"127.0.0.1:{mport}", "-ip",
                             "127.0.0.1", "-port", str(ports["a"]), "-ec.backend", "cuda"],
                            config_dirs=())
        servers.append(server_a)
        build_s = time.perf_counter() - t0
        if server_a.store.ec_backend != "cuda" or server_a.net_plane is None:
            raise AssertionError("16: the launcher built A without cuda or its net plane")

        # phase 3's bodies, as digests, and 64 MiB of new needles at its sizes,
        # while the children start
        rng = np.random.default_rng()
        rng.bit_generator.state = vol_rng_state
        stream = needle_stream(rng)
        want = {}
        for rec in records:
            nid, cookie, body = next(stream)
            if (nid, cookie, len(body)) != (rec[0], rec[1], rec[3]):
                raise AssertionError("16: phase 3's needle stream does not replay")
            want[nid] = (cookie, digest(body))
        new, total = [], 0
        for nid, cookie, body in needle_stream(np.random.default_rng(SEED + 16)):
            if total + len(body) > ADMIN_NEW_BYTES:
                break
            if nid not in want:
                new.append((nid, cookie, body))
                total += len(body)

        first_seen: dict = {}

        def registered() -> bool:
            for n, (proc, _) in children.items():
                if proc.poll() is not None:
                    raise AssertionError(f"16: child {n} exited with {proc.returncode}: "
                                         + open(os.path.join(root, f"{n}.log"), "rb").read()[-2000:]
                                         .decode(errors="replace"))
            try:
                nodes = {nd.id for nd in mstub.Topology(pb.TopologyRequest(), timeout=10).nodes}
            except grpc.RpcError:
                return False  # the master is not up, or not yet its own leader
            for u in nodes:
                first_seen.setdefault(u, time.perf_counter())
            return all(u in nodes for u in url.values())

        wait_until(registered, "three servers registered", timeout=120, phase="16")
        first_heartbeat_s = {n: first_seen[url[n]] - spawned[n] for n in "bc"}
        stub = {}
        for n in "abc":
            channels.append(grpc.insecure_channel(gaddr[n]))
            stub[n] = rpc.volume_stub(channels[-1])

        def holders() -> list:
            locs = mstub.LookupVolume(pb.LookupVolumeRequest(volume_ids=[vid]), timeout=10)
            names = {u: n for n, u in url.items()}
            return sorted(names[loc.url] for loc in locs.volume_locations[0].locations)

        def status(n: str):
            return check(stub[n].ReadVolumeFileStatus(pb.VolumeFileStatusRequest(volume_id=vid),
                                                      timeout=60), f"ReadVolumeFileStatus on {n}")

        def files(*names: str) -> list:
            """Each server's volume files, ext -> sha256, hashed on threads."""
            paths = [(n, ext, os.path.join(dirs[n], str(vid)) + ext) for n in names
                     for ext in (".dat", ".idx", ".vif")]
            paths = [p for p in paths if os.path.exists(p[2])]
            with ThreadPoolExecutor(len(paths)) as ex:
                digests = list(ex.map(sha256, [p[2] for p in paths]))
            return [{ext: d for (m, ext, _), d in zip(paths, digests) if m == n} for n in names]

        def get(n: str, nid: int, cookie: int, digest_want: str, what: str) -> float:
            t0 = time.perf_counter()
            code, _, body = http(f"http://{url[n]}/{FileId(vid, nid, cookie)}")
            dt = time.perf_counter() - t0
            if code != 200 or digest(body) != digest_want:
                raise AssertionError(f"{what}: GET of needle {nid:x} at {n} answered {code}, "
                                     f"{len(body)} bytes not equal to the written ones")
            return dt

        def counters(n: str) -> tuple[dict, int]:
            """(kernel launches, interval-cache loads) of server n: A's in this
            process, a child's from its /debug/kernels."""
            if n == "a":
                return dict(rs_kernels.LAUNCHES), server_a.store.ec_interval_cache.loads
            code, _, body = http(f"http://{url[n]}/debug/kernels")
            if code != 200:
                raise AssertionError(f"16: /debug/kernels at {n} answered {code}")
            doc = json.loads(body)
            return doc["launches"], doc["interval_cache"]["loads"]

        line("16 servers", {"build_a_seconds": build_s,
                            "child_start_to_first_heartbeat_s": first_heartbeat_s})

        # -- 16a. mount on A by hard link, and the file status ------------------
        abase = os.path.join(dirs["a"], str(vid))
        t0 = time.perf_counter()
        check(stub["a"].VolumeMount(pb.AllocateVolumeRequest(volume_id=vid), timeout=120), "16a mount")
        mount_s = time.perf_counter() - t0
        st = status("a")
        last = records[-1]
        with open(abase + ".dat", "rb") as f:
            f.seek(last[2])
            raw = f.read(16 + 4 + last[3] + 1 + 4 + 8)
        last_ns = struct.unpack(">Q", raw[-8:])[0]
        if (st.dat_size, st.idx_size, st.version, st.compaction_revision, st.last_append_at_ns) != (
                os.path.getsize(abase + ".dat"), os.path.getsize(abase + ".idx"), 3, 0, last_ns):
            raise AssertionError(f"16a: ReadVolumeFileStatus answered {st}")
        dat_size = st.dat_size
        line("16a mount and status", {"mount_seconds": mount_s, "dat_size": st.dat_size,
                                      "idx_size": st.idx_size, "needles": len(records)})

        # -- 16b. volume.move's copy: readonly at A, VolumeCopy into B ----------
        check(stub["a"].VolumeMarkReadonly(pb.VolumeCommandRequest(volume_id=vid), timeout=60),
              "16b readonly")
        t0 = time.perf_counter()
        check(stub["b"].VolumeCopy(pb.EcShardsCopyRequest(volume_id=vid, source_url=gaddr["a"]),
                                   timeout=600), "16b VolumeCopy into B")
        copy_s = time.perf_counter() - t0
        fa, fb = files("a", "b")
        if fa != fb or ".dat" not in fa:
            raise AssertionError(f"16b: B's files {fb} differ from A's {fa}")
        wait_until(lambda: holders() == ["a", "b"], "the master lists the volume at A and B", phase="16b")
        check(stub["a"].VolumeMarkWritable(pb.VolumeCommandRequest(volume_id=vid), timeout=60),
              "16b writable")
        line("16b copy", {"seconds": copy_s, "bytes": dat_size, "gb_per_s": dat_size / copy_s / 1e9,
                          "files": sorted(fa)})

        # -- 16c. catch-up: B down (unmounted) while A takes 64 MiB of POSTs and 5
        # deletes, then B back, tailing A ---------------------------------------
        def a_sees(names: list) -> bool:
            seen = sorted(loc.url for loc in server_a.cluster._master_client().lookup(vid))
            return holders() == names and seen == sorted(url[n] for n in names)

        check(stub["b"].VolumeUnmount(pb.VolumeCommandRequest(volume_id=vid), timeout=60), "16c B down")
        wait_until(lambda: a_sees(["a"]), "B's unmount reached the master and A", phase="16c")
        before_ns = status("a").last_append_at_ns
        before_size = os.path.getsize(abase + ".dat")
        t0 = time.perf_counter()
        for nid, cookie, body in new:
            code, _, answer = http(f"http://{url['a']}/{FileId(vid, nid, cookie)}", "POST", body,
                                   {"Content-Type": "application/octet-stream"})
            if code != 201:
                raise AssertionError(f"16c: POST answered {code} {answer[:200]!r}")
        post_s = time.perf_counter() - t0
        gone_new = new[:ADMIN_NEW_DELETES]
        for nid, cookie, _ in gone_new:
            code, _, answer = http(f"http://{url['a']}/{FileId(vid, nid, cookie)}", "DELETE")
            if code != 202:
                raise AssertionError(f"16c: DELETE answered {code} {answer[:200]!r}")
        for nid, cookie, body in new[ADMIN_NEW_DELETES:]:
            want[nid] = (cookie, digest(body))
        check(stub["b"].VolumeMount(pb.AllocateVolumeRequest(volume_id=vid), timeout=120), "16c B back")
        t0 = time.perf_counter()
        r = check(stub["b"].VolumeTailReceiver(pb.VolumeTailReceiverRequest(
            volume_id=vid, since_ns=0, source_volume_server=gaddr["a"], idle_timeout_seconds=1),
            timeout=600), "16c VolumeTailReceiver")
        tail_s = time.perf_counter() - t0
        if r.received != len(new) + ADMIN_NEW_DELETES:
            raise AssertionError(f"16c: B received {r.received} records for "
                                 f"{len(new)} puts and {ADMIN_NEW_DELETES} deletes")
        status("a")  # flushes A's files
        status("b")
        fa, fb = files("a", "b")
        if fa != fb:
            raise AssertionError("16c: B's .dat and .idx differ from A's after the catch-up")
        t0 = time.perf_counter()
        start, parts = None, []
        for chunk in stub["a"].VolumeIncrementalCopy(pb.VolumeIncrementalCopyRequest(
                volume_id=vid, since_ns=before_ns), timeout=600):
            if start is None:
                if not chunk.has_start:
                    raise AssertionError("16c: the incremental copy's first chunk has no start")
                start = chunk.start_offset
            parts.append(chunk.file_content)
        inc_s = time.perf_counter() - t0
        suffix = b"".join(parts)
        with open(abase + ".dat", "rb") as f:
            f.seek(before_size)
            if start != before_size or suffix != f.read():
                raise AssertionError(f"16c: the incremental copy from {start} is not A's .dat suffix "
                                     f"from {before_size}")
        tail_bytes = sum(len(b) for _, _, b in new)
        line("16c catch-up", {
            "posts": len(new), "post_bytes": tail_bytes, "post_mb_per_s": tail_bytes / post_s / 1e6,
            "deletes": len(gone_new), "tail_records": r.received, "tail_seconds": tail_s,
            "tail_records_per_s": r.received / tail_s, "tail_mb_per_s": tail_bytes / tail_s / 1e6,
            "incremental_bytes": len(suffix), "incremental_seconds": inc_s,
            "incremental_mb_per_s": len(suffix) / inc_s / 1e6})
        del parts, suffix

        # -- 16d. a tenth of the needles deleted at A (and at B, its replica), vacuum
        wait_until(lambda: a_sees(["a", "b"]), "B's mount reached the master and A", phase="16d")
        gone = records[::ADMIN_VACUUM_EVERY]
        for nid, cookie, _, _ in gone:
            code, _, answer = http(f"http://{url['a']}/{FileId(vid, nid, cookie)}", "DELETE")
            if code != 202:
                raise AssertionError(f"16d: DELETE answered {code} {answer[:200]!r}")
            del want[nid]
        va = server_a.store.find_volume(vid)
        live_sizes = [nv.size for nv in va.needle_map.ascending_visit()]
        if len(live_sizes) != len(want):
            raise AssertionError(f"16d: A's map holds {len(live_sizes)} live needles, {len(want)} written")
        old = status("a")
        expect = old.dat_size - 8 - sum(padded_record_size(16 + s + 12) for s in live_sizes)
        t0 = time.perf_counter()
        vr = stub["a"].VacuumVolume(pb.VacuumRequest(volume_id=vid, garbage_threshold=0.05), timeout=600)
        vac_s = time.perf_counter() - t0
        now = status("a")
        if vr.reclaimed_bytes != expect or now.compaction_revision != old.compaction_revision + 1 \
                or now.dat_size != old.dat_size - expect or vr.garbage_ratio < 0.05:
            raise AssertionError(f"16d: vacuum answered {vr} (expected {expect} bytes), revision "
                                 f"{old.compaction_revision} -> {now.compaction_revision}")
        t0 = time.perf_counter()
        lat = [get("a", nid, cookie, d, "16d") for nid, (cookie, d) in want.items()]
        line("16d vacuum", {"deleted": len(gone), "seconds": vac_s, "reclaimed_bytes": vr.reclaimed_bytes,
                            "garbage_ratio": vr.garbage_ratio, "revision": now.compaction_revision,
                            "reads": len(lat), "read_seconds": time.perf_counter() - t0})

        # -- 16e. scrub: A clean, B with one flipped body byte ------------------
        t0 = time.perf_counter()
        sa = check(stub["a"].ScrubVolume(pb.ScrubRequest(volume_id=vid), timeout=600), "16e scrub A")
        scrub_s = time.perf_counter() - t0
        if sa.checked != len(want) or list(sa.bad_needles):
            raise AssertionError(f"16e: scrub of A answered {sa}, {len(want)} live needles")
        rot = next(rec for rec in records[len(records) // 2:] if rec[0] in want)
        check(stub["b"].VolumeUnmount(pb.VolumeCommandRequest(volume_id=vid), timeout=60), "16e unmount B")
        with open(os.path.join(dirs["b"], f"{vid}.dat"), "r+b") as f:
            f.seek(rot[2] + 16 + 4 + rot[3] // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
        check(stub["b"].VolumeMount(pb.AllocateVolumeRequest(volume_id=vid), timeout=120), "16e mount B")
        t0 = time.perf_counter()
        sb = check(stub["b"].ScrubVolume(pb.ScrubRequest(volume_id=vid), timeout=600), "16e scrub B")
        scrub_b_s = time.perf_counter() - t0
        if list(sb.bad_needles) != [rot[0]] or sb.checked != len(want):
            raise AssertionError(f"16e: scrub of B answered {sb.checked} checked, bad "
                                 f"{list(sb.bad_needles)}; expected {len(want)} and [{rot[0]}]")
        # B's byte flipped back: the shell's ec.encode may generate on any holder
        check(stub["b"].VolumeUnmount(pb.VolumeCommandRequest(volume_id=vid), timeout=60),
              "16e unmount B")
        with open(os.path.join(dirs["b"], f"{vid}.dat"), "r+b") as f:
            f.seek(rot[2] + 16 + 4 + rot[3] // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
        check(stub["b"].VolumeMount(pb.AllocateVolumeRequest(volume_id=vid), timeout=120), "16e mount B")
        line("16e scrub", {"a_checked": sa.checked, "a_seconds": scrub_s,
                           "a_needles_per_s": sa.checked / scrub_s, "b_checked": sb.checked,
                           "b_seconds": scrub_b_s, "b_bad": list(sb.bad_needles)})

        # -- 16f. the cold tier on C --------------------------------------------
        check(stub["c"].VolumeCopy(pb.EcShardsCopyRequest(volume_id=vid, source_url=gaddr["a"]),
                                   timeout=600), "16f VolumeCopy into C")
        cdat = os.path.join(dirs["c"], f"{vid}.dat")
        fa, fc = files("a", "c")
        if fa != fc:
            raise AssertionError("16f: C's copy differs from A's files")
        c_sha = fc[".dat"]
        c_size = os.path.getsize(cdat)
        check(stub["c"].VolumeMarkReadonly(pb.VolumeCommandRequest(volume_id=vid), timeout=60),
              "16f readonly")
        dest = f"http://127.0.0.1:{endpoint.port}/tier/{vid}.dat"
        t0 = time.perf_counter()
        up = check(stub["c"].VolumeTierUpload(pb.TierRequest(volume_id=vid, dest_url=dest), timeout=600),
                   "16f VolumeTierUpload")
        up_s = time.perf_counter() - t0
        if up.moved_bytes != c_size or os.path.exists(cdat):
            raise AssertionError(f"16f: tier upload moved {up.moved_bytes} of {c_size} bytes")
        ranged0 = endpoint.ranged_gets
        picks = list(want.items())[:: max(1, len(want) // ADMIN_TIER_GETS)][:ADMIN_TIER_GETS]
        tier_lat = [get("c", nid, cookie, d, "16f") for nid, (cookie, d) in picks]
        if endpoint.ranged_gets - ranged0 < len(picks):
            raise AssertionError("16f: the tiered GETs did not read from the endpoint")
        t0 = time.perf_counter()
        down = check(stub["c"].VolumeTierDownload(pb.TierRequest(volume_id=vid, delete_remote=True),
                                                  timeout=600), "16f VolumeTierDownload")
        down_s = time.perf_counter() - t0
        if down.moved_bytes != c_size or sha256(cdat) != c_sha or os.listdir(endpoint.root):
            raise AssertionError("16f: the downloaded .dat differs, or the object was kept")
        line("16f tier", {"bytes": c_size, "up_seconds": up_s, "up_gb_per_s": c_size / up_s / 1e9,
                          "tier_gets": len(tier_lat), "tier_get_p50_ms": percentile_ms(tier_lat, 50),
                          "down_seconds": down_s, "down_gb_per_s": c_size / down_s / 1e9})

        # -- 16g. the port shell's ec.encode, in this process, then degraded GETs
        # at the holder it names -----------------------------------------------
        wait_until(lambda: holders() == ["a", "b", "c"], "the master lists A, B and C", phase="16g")
        sizes = {n: status(n).dat_size for n in "abc"}  # flushes every holder
        senv = ShellEnv(f"127.0.0.1:{mport}")
        try:
            rs_kernels.reset_launches()
            before = {n: counters(n)[0] for n in "abc"}
            t0 = time.perf_counter()
            out = run_command(senv, f"ec.encode -volumeId {vid} -backend cuda")
            enc_s = time.perf_counter() - t0
        finally:
            senv.close()
        m = re.fullmatch(rf"ec\.encode volume {vid}: generation (\d+) on (\S+)", out)
        if m is None or m[2] not in url.values():
            raise AssertionError(f"16g: ec.encode answered {out!r}")
        h = {u: n for n, u in url.items()}[m[2]]
        enc_size = sizes[h]
        n_batches = len(list(batch_plan(enc_size, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE,
                                        SMALL_BLOCK_SIZE)))
        got = {n: {k: counters(n)[0][k] - before[n][k] for k in launches} for n in "abc"}
        if got[h]["gf2_apply"] != n_batches or any(
                got[n][k] for n in got for k in launches if (n, k) != (h, "gf2_apply")):
            raise AssertionError(f"16g: ec.encode launched {got} for {n_batches} batches at {h}")
        launches["gf2_apply"] += n_batches
        left = [n for n in "abc" if os.path.exists(os.path.join(dirs[n], f"{vid}.dat"))]
        if left:
            raise AssertionError(f"16g: the source volume is left at {left}")
        hbase = os.path.join(dirs[h], str(vid))
        with open(hbase + ".ecx", "rb") as f:
            ecx = f.read()
        final = {}
        for i in range(0, len(ecx), 16):
            nv = NeedleValue.from_bytes(ecx[i : i + 16])
            if nv.needle_id in want:
                final[nv.needle_id] = (actual_offset(nv.offset), nv.size)
        if set(final) != set(want):
            raise AssertionError(f"16g: {h}'s .ecx holds {len(final)} of the {len(want)} live needles")
        stub[h].VolumeEcShardsUnmount(pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=[DEGRADED]),
                                      timeout=60)
        degraded = [nid for nid, (off, size) in final.items()
                    if any(sid == DEGRADED for sid, _, _ in record_intervals(off, size, enc_size))]
        rs_kernels.reset_launches()
        before, loads0 = counters(h)
        lat = [get(h, nid, want[nid][0], want[nid][1], "16g") for nid in degraded]
        now, loads = counters(h)
        recon = loads - loads0
        planes = now["gf2_apply_planes"] - before["gf2_apply_planes"]
        if planes != recon or planes < 1 or now["gf2_apply"] != before["gf2_apply"]:
            raise AssertionError(f"16g: {now} launches (from {before}) for {recon} reconstructions")
        launches["gf2_apply_planes"] += planes
        line("16g ec.encode", {"shell": out, "holder": h,
                               "dat_size": enc_size, "command_seconds": enc_s,
                               "encode_gb_per_s": enc_size / enc_s / 1e9, "launches": n_batches,
                               "degraded_gets": len(lat), "p50_ms": percentile_ms(lat, 50),
                               "p99_ms": percentile_ms(lat, 99), "reconstructions": recon,
                               "planes_launches": planes, "card": card_line()})
        failed = False
    finally:
        for ch in channels:
            ch.close()
        for vs in servers:
            vs.stop()
        stuck = stop_children(children)
        endpoint.stop()
    if stuck and not failed:
        raise AssertionError(f"16: child servers did not stop cleanly on SIGTERM: {stuck}")
    shutil.rmtree(root)
    return result, launches


HA_MASTERS = 3  # phase 17's master group
HA_RACKS = {"a": "r1", "b": "r1", "c": "r2", "d": "r2"}  # four volume servers on two racks
HA_COLLECTION = "ha"  # the 1 GiB volume's collection
HA_REP_COLLECTION = "harep"  # 17c's `001` set
HA_REP_NEEDLES = 32  # 17c: needles written at replication 001 (bodies of SEED + 17)
HA_GETS = 40  # 17f and 17g: GETs of a seeded sample of the needles
HA_UPLOAD_BYTES = (4 << 20) + 12345  # 17g: the file the shell uploads and downloads
SHELL_TIMEOUT_S = 600.0  # one shell command's answer
HA_VACUUM_S = 2  # the masters' maintenance tick (master.toml): the scanners' clock in 17h-17i
HA_SIZE_LIMIT = 30 << 30  # the masters' volume size limit, the launcher's default
HA_AUTO_COLLECTION = "haauto"  # 17h's volume, encoded by the auto-EC scanner's task
HA_QUIET_S = 1  # 17h: ec_quiet_seconds
TASK_TIMEOUT_S = 180.0  # a worker task's wait, from the config change that submits it
HA_FAST_COLLECTION = "hafast"  # 17j's plain volume: ?locate, the sidecar, then the offline tools
HA_FAST_BYTES = 48 << 20  # 17j: needles written to it (bodies of SEED + 19)
HA_IMG_COLLECTION = "haimg"  # 17j's thumbnails: a seeded PNG and JPEG, encoded, a shard gone
THUMBS = ((64, 0, ""), (64, 64, "fill"))  # 17j: ?width=64, ?width=64&height=64&mode=fill
TELEMETRY_FIRST_S = 60.0  # utils/telemetry.py: a master's first report, after its start


def metric_value(text: str, name: str) -> float:
    """An unlabelled sample of a /metrics page (0 where it has none)."""
    for ln in text.splitlines():
        if ln.startswith(name + " "):
            return float(ln.split()[1])
    return 0.0


class ShellChild:
    """The port shell as one REPL child (`python3 -m seaweedfs_tpu_torch.shell
    -master <group>`) fed commands on its standard input. Each command is
    followed by an unknown command whose error line marks the end of the
    answer, so an answer may hold any text."""

    MARK = "end.of.answer"

    def __init__(self, master: str, cwd: str, env: dict, log_path: str):
        import queue
        import threading

        self.log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.shell", "-master", master], cwd=cwd, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.log, text=True, bufsize=1)
        self._lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for ln in self.proc.stdout:
            self._lines.put(ln)
        self._lines.put(None)

    def run(self, command: str, timeout: float = SHELL_TIMEOUT_S) -> str:
        """The command's answer, its lines without the REPL's prompts."""
        import queue

        self.proc.stdin.write(f"{command}\n{self.MARK}\n")
        self.proc.stdin.flush()
        out, deadline = [], time.perf_counter() + timeout
        while True:
            try:
                ln = self._lines.get(timeout=max(deadline - time.perf_counter(), 0.01))
            except queue.Empty:
                raise AssertionError(f"17: the shell gave no answer to {command!r} in {timeout} s")
            if ln is None:
                raise AssertionError(f"17: the shell exited ({self.proc.wait()}) during {command!r}")
            while ln.startswith("> "):
                ln = ln[2:]
            if f"unknown command '{self.MARK}'" in ln:
                return "".join(out).rstrip("\n")
            out.append(ln)

    def close(self) -> int | None:
        """`exit`, then a kill if the child is alive CHILD_STOP_S later;
        returns the exit code (None where killed)."""
        try:
            self.proc.stdin.write("exit\n")
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            rc = self.proc.wait(timeout=CHILD_STOP_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=CHILD_STOP_S)
            rc = None
        self.log.close()
        return rc


def stop_children(children: dict, dead=()) -> list:
    """SIGTERM every child still running, the last started first; a child
    alive CHILD_STOP_S later is killed. Returns the children, other than
    those named in `dead` (killed on purpose), that did not exit with 0."""
    stuck = []
    for n, (proc, log) in reversed(list(children.items())):
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=CHILD_STOP_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=CHILD_STOP_S)
            rc = None
        log.close()
        if rc != 0 and n not in dead:
            stuck.append(f"{n} ({'killed' if rc is None else f'exit {rc}'})")
    return stuck


def ha_phase(work: str, ctx, vol_rng_state: dict) -> tuple[dict, dict, dict]:
    """Phase 17: a cluster of the port alone, every process started by name
    (`python3 -m seaweedfs_tpu_torch.server master|volume`, and the shell
    `python3 -m seaweedfs_tpu_torch.shell`): three masters as one raft
    group (`-peers`, `-mdir`) and four volume servers on two racks
    (`-master <the group>`, the default `-ec.backend`, cuda). 17a the group
    elects a leader and the servers register with it; 17b phase 3's
    needles written through the leader's /dir/assign and POST into a
    collection of their own until its one volume holds about 1 GiB (the
    first Assign grows it through AllocateVolume, the rest pick it) and
    read back from its holder; 17c a `001` set, every write read back from
    both holders /dir/lookup names; 17d one port shell child at the group
    (`-master a,b,c`, commands on its standard input): `ec.encode` (the
    holder it names launches `gf2_apply` once per batch) and `ec.balance`
    (every shard listed once at the leader, on both racks, each moved file
    sha256-equal to what generate wrote); 17e the leader killed with
    SIGKILL, a new leader elected, the servers re-homed, LookupEcVolume
    there lists all 14 shards and an Assign grows a volume whose id was
    never handed out; 17f a server other than the holder, with one to four
    shards and a data shard among them, stopped, and degraded GETs of a
    seeded sample of the needles over its data shards at the holder
    (`gf2_apply_planes` launches == its interval-cache loads), byte-equal
    to what was written; 17g the same shell child: `ec.check.replication`
    names the stopped server's shards, `ec.rebuild -fromPeers` rebuilds
    them (`gf2_apply` launches at the rebuilding holder == its batches,
    the files sha256-equal to generate's), `ec.check.replication` finds
    all 14, `ec.scrub` no bitrot and nothing missing, `ec.decode` gives
    the encoded .dat and .idx back (no launch: every data shard is
    there) and GETs through /dir/lookup read the written bytes, and
    `upload` then `download` of a seeded file give it back. 17h auto-EC:
    the decoded collection deleted, a worker child (`python3 -m
    seaweedfs_tpu_torch.worker -master <the group> -backend cuda`) named
    by `worker.list` and `cluster.ps`, a fresh volume of seeded needles
    written through assign and POST, `maintenance.config -set
    ec_auto_fullness -set ec_quiet_seconds` at the leader (the fleet
    commands run through `run_command` in this process, at the leader
    alone: they parse `-master` as one address): the scanner submits one
    `ec_encode` task, done, the holder launches `gf2_apply` once per batch,
    the plain volume is gone, the 14 shards verify against `.ecsum` and
    every needle reads back. 17i fleet scrub: the shell's `ec.balance`
    spreads the shards, one data shard of a holder of fewer than k is
    quarantined (unmounted, renamed `.bad`), degraded GETs over it at that
    holder (`gf2_apply_planes` launches == its interval-cache loads), then
    `ec_scrub_interval_seconds` at the leader: the `ec_scrub` task reports
    the holder unrebuildable, `sw_ec_fleet_peer_rebuild_dispatch_total`
    rises by 1, the `ec_rebuild -fromPeers` task is done, the holder
    launched `gf2_apply` once per rebuild batch, the shard is back there
    sha256-equal to generate's, `/cluster/status`'s `EcFleetScrub` names
    it, and the next scrub reports the fleet clean. The children's
    launches are read from their /debug/kernels. Prints one JSON line;
    returns (result, launches of 17a-17f, launches of 17g, launches of
    17h-17i)."""
    import grpc

    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.types import NeedleValue, actual_offset

    from seaweedfs_tpu_torch.ec.bitrot import BitrotProtection
    from seaweedfs_tpu_torch.shell.commands import ShellEnv, run_command

    root = os.path.join(work, "ha")
    os.makedirs(root)
    # the masters' maintenance tick: the scanners of 17h-17i run on it
    with open(os.path.join(root, "master.toml"), "w") as f:
        f.write(f"[master.vacuum]\ninterval_seconds = {HA_VACUUM_S}\n")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    mports = [server_port() for _ in range(HA_MASTERS)]
    maddr = [f"127.0.0.1:{p}" for p in mports]
    vports = {n: server_port() for n in HA_RACKS}
    url = {n: f"127.0.0.1:{p}" for n, p in vports.items()}
    name_of = {u: n for n, u in url.items()}
    gaddr = {n: f"127.0.0.1:{p + 10000}" for n, p in vports.items()}
    children: dict = {}
    channels: list = []
    launches = {"gf2_apply": 0, "gf2_apply_planes": 0}
    steps: dict = {}
    killed = None
    failed = True

    def spawn(name: str, args: list) -> None:
        log = open(os.path.join(root, f"{name}.log"), "wb")
        children[name] = (subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.server", *args], cwd=root, env=env,
            stdout=log, stderr=subprocess.STDOUT), log)

    def alive() -> None:
        for n, (proc, _) in children.items():
            if n != killed and n != stopped and proc.poll() is not None:
                raise AssertionError(f"17: child {n} exited with {proc.returncode}: "
                                     + open(os.path.join(root, f"{n}.log"), "rb").read()[-2000:]
                                     .decode(errors="replace"))

    def check(resp, what: str):
        if resp.error:
            raise AssertionError(f"17 {what}: {resp.error}")
        return resp

    def kernels(n: str) -> dict:
        code, _, body = http(f"http://{url[n]}/debug/kernels")
        if code != 200:
            raise AssertionError(f"17: /debug/kernels at {n} answered {code}")
        return json.loads(body)

    def launched(before: dict) -> dict:
        """Each kernel's launches in every live server since `before`."""
        now = {n: kernels(n)["launches"] for n in HA_RACKS if n != stopped}
        return {k: sum(now[n][k] - before[n][k] for n in now) for k in launches}

    stopped = None
    shell = None
    fenv = None
    launches_hi = {"gf2_apply": 0, "gf2_apply_planes": 0}
    launches_j = {"gf2_apply": 0, "gf2_apply_planes": 0}
    launches_k = {"gf2_apply": 0, "gf2_apply_planes": 0}
    launches_l = {"gf2_apply": 0, "gf2_apply_planes": 0}
    launches_m = {"gf2_apply": 0, "gf2_apply_planes": 0}
    sink = None
    tools_src = None
    tport = free_port()
    try:
        # -- 17a. the group and the servers, started by name, and the telemetry
        # collector the masters report to ------------------------------------------
        spawn("telemetry", ["telemetry", "-ip", "127.0.0.1", "-port", str(tport), "-file",
                            os.path.join(root, "telemetry.jsonl")])
        t_spawn = time.perf_counter()
        for i, p in enumerate(mports):
            os.makedirs(os.path.join(root, f"m{i}"))
            spawn(f"m{i}", ["master", "-ip", "127.0.0.1", "-port", str(p), "-peers", ",".join(maddr),
                            "-mdir", os.path.join(root, f"m{i}"), "-telemetry.url",
                            f"http://127.0.0.1:{tport}/api/collect"])
        for n, rack in HA_RACKS.items():
            os.makedirs(os.path.join(root, n))
            spawn(n, ["volume", "-dir", os.path.join(root, n), "-master", ",".join(maddr), "-ip",
                      "127.0.0.1", "-port", str(vports[n]), "-rack", rack])
        for p in mports:
            channels.append(grpc.insecure_channel(f"127.0.0.1:{p + 10000}"))
        raft = {a: rpc.Stub(ch, rpc.RAFT_SERVICE) for a, ch in zip(maddr, channels)}
        mstub = {a: rpc.master_stub(ch) for a, ch in zip(maddr, channels)}

        def leader(live: list) -> str | None:
            """The master every live member names as leader, if one leads."""
            alive()
            try:
                sts = [raft[a].RaftStatus(pb.RaftStatusRequest(), timeout=5) for a in live]
            except grpc.RpcError:
                return None
            leads = [st.node_id for st in sts if st.role == "leader"]
            if len(leads) == 1 and all(st.leader == leads[0] for st in sts):
                return leads[0]
            return None

        def nodes_at(a: str) -> dict:
            try:
                return {nd.id: nd for nd in mstub[a].Topology(pb.TopologyRequest(), timeout=10).nodes}
            except grpc.RpcError:
                return {}

        lead = wait_value(lambda: leader(maddr), "a leader of the group", timeout=60, phase="17a")
        elected_s = time.perf_counter() - t_spawn
        wait_until(lambda: alive() or len(nodes_at(lead)) == len(HA_RACKS),
                   "four servers registered at the leader", timeout=120, phase="17a")
        steps["17a start"] = {"elected_s": elected_s, "registered_s": time.perf_counter() - t_spawn,
                              "leader": maddr.index(lead)}
        before = {n: kernels(n)["launches"] for n in HA_RACKS}
        if any(any(v.values()) for v in before.values()):
            raise AssertionError(f"17a: servers launched kernels before any EC step: {before}")

        def assign(query: str) -> dict:
            code, _, body = http(f"http://{lead}/dir/assign?{query}")
            if code != 200:
                raise AssertionError(f"17: /dir/assign?{query} answered {code} {body[:200]!r}")
            return json.loads(body)

        def lookup(vid: int) -> list:
            code, _, body = http(f"http://{lead}/dir/lookup?volumeId={vid}")
            if code != 200:
                raise AssertionError(f"17: /dir/lookup of {vid} answered {code} {body[:200]!r}")
            return sorted(name_of[loc["url"]] for loc in json.loads(body)["locations"])

        # -- 17b. phase 3's needles through /dir/assign and POST -----------------
        rng = np.random.default_rng()
        rng.bit_generator.state = vol_rng_state
        written: dict = {}  # fid -> (needle id, sha256 of the body, body length)
        vids, total, post_s, assign_lat = set(), 8, 0.0, []
        t0 = time.perf_counter()
        for _, _, body in needle_stream(rng):
            if total + len(body) + 64 > VOLUME_BYTES:
                break
            ta = time.perf_counter()
            a = assign(f"collection={HA_COLLECTION}")
            tp = time.perf_counter()
            code, _, answer = http(f"http://{a['url']}/{a['fid']}", "POST", body,
                                   {"Content-Type": UPLOAD_MIME})
            post_s += time.perf_counter() - tp
            assign_lat.append(tp - ta)
            if code != 201:
                raise AssertionError(f"17b: POST answered {code} {answer[:200]!r}")
            fid = FileId.parse(a["fid"])
            vids.add(fid.volume_id)
            written[a["fid"]] = (fid.needle_id, hashlib.sha256(body).hexdigest(), len(body))
            total += len(body) + 64
        write_s = time.perf_counter() - t0
        if len(vids) != 1:
            raise AssertionError(f"17b: the assigns spread over volumes {sorted(vids)}")
        (vid,) = vids
        (h,) = lookup(vid)
        nbytes = sum(w[2] for w in written.values())
        t0 = time.perf_counter()
        for fid, (_, want, _) in written.items():
            code, _, got = http(f"http://{url[h]}/{fid}")
            if code != 200 or hashlib.sha256(got).hexdigest() != want:
                raise AssertionError(f"17b: GET of {fid} at {h} answered {code}, not the written bytes")
        read_s = time.perf_counter() - t0
        steps["17b writes"] = {
            "needles": len(written), "bytes": nbytes, "volume": vid, "holder": h,
            "write_seconds": write_s, "write_mb_per_s": nbytes / write_s / 1e6,
            "post_mb_per_s": nbytes / post_s / 1e6, "assign_p50_ms": percentile_ms(assign_lat, 50),
            "assign_p99_ms": percentile_ms(assign_lat, 99), "read_seconds": read_s,
            "get_gb_per_s": nbytes / read_s / 1e9}

        # -- 17c. a `001` set: every write read back from both holders ---------
        rep_vids = set()
        t0 = time.perf_counter()
        for k, (_, _, body) in enumerate(needle_stream(np.random.default_rng(SEED + 17))):
            if k == HA_REP_NEEDLES:
                break
            a = assign(f"collection={HA_REP_COLLECTION}&replication=001")
            code, _, answer = http(f"http://{a['url']}/{a['fid']}", "POST", body,
                                   {"Content-Type": UPLOAD_MIME})
            if code != 201:
                raise AssertionError(f"17c: replicated POST answered {code} {answer[:200]!r}")
            rvid = FileId.parse(a["fid"]).volume_id
            rep_vids.add(rvid)
            holders = lookup(rvid)
            if len(holders) != 2 or HA_RACKS[holders[0]] != HA_RACKS[holders[1]]:
                raise AssertionError(f"17c: /dir/lookup names {holders} for a `001` volume")
            for n in holders:
                code, _, got = http(f"http://{url[n]}/{a['fid']}")
                if code != 200 or got != body:
                    raise AssertionError(f"17c: the write of {a['fid']} does not read back at {n}")
        steps["17c replicated writes"] = {"needles": HA_REP_NEEDLES, "volumes": sorted(rep_vids),
                                          "holders": lookup(min(rep_vids)),
                                          "seconds": time.perf_counter() - t0}

        # -- 17d. the port shell, one REPL child at the group: ec.encode, ec.balance
        def ec_holders(a: str, v: int | None = None) -> dict:
            try:
                resp = mstub[a].LookupEcVolume(pb.LookupEcVolumeRequest(volume_id=v or vid),
                                               timeout=10)
            except grpc.RpcError:
                return {}
            return {sl.shard_id: sorted(name_of[loc.url] for loc in sl.locations)
                    for sl in resp.shard_locations}

        def spread(v: int | None = None) -> dict | None:
            """{shard: holder} where the leader lists every shard once."""
            alive()
            got = ec_holders(lead, v)
            if sorted(got) != list(range(ctx.total)) or any(len(v) != 1 for v in got.values()):
                return None
            return {sid: v[0] for sid, v in got.items()}

        def hashed(paths: dict) -> dict:
            with ThreadPoolExecutor(8) as ex:
                return dict(zip(paths, ex.map(sha256, paths.values())))

        base = {n: os.path.join(root, n, f"{HA_COLLECTION}_{vid}") for n in HA_RACKS}
        t0 = time.perf_counter()
        shell = ShellChild(",".join(maddr), root, env, os.path.join(root, "shell.log"))
        if HA_COLLECTION not in shell.run("collection.list").split():
            raise AssertionError("17d: the shell's collection.list misses the written collection")
        shell_start_s = time.perf_counter() - t0
        dat_size = os.path.getsize(base[h] + ".dat")
        source = hashed({ext: base[h] + ext for ext in (".dat", ".idx")})
        n_batches = len(list(batch_plan(dat_size, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE,
                                        SMALL_BLOCK_SIZE)))
        before = {n: kernels(n)["launches"] for n in HA_RACKS}
        t0 = time.perf_counter()
        out = shell.run(f"ec.encode -volumeId {vid} -collection {HA_COLLECTION}")
        enc_s = time.perf_counter() - t0
        m = re.fullmatch(rf"ec\.encode volume {vid}: generation (\d+) on (\S+)", out)
        if m is None or name_of.get(m[2]) != h:
            raise AssertionError(f"17d: ec.encode answered {out!r}; the volume's one holder is {h}")
        now = {n: kernels(n)["launches"] for n in HA_RACKS}
        got = {n: {k: now[n][k] - before[n][k] for k in launches} for n in HA_RACKS}
        if got[h]["gf2_apply"] != n_batches or any(
                got[n][k] for n in got for k in launches if (n, k) != (h, "gf2_apply")):
            raise AssertionError(f"17d: ec.encode launched {got} for {n_batches} batches at {h}")
        launches["gf2_apply"] += n_batches
        if os.path.exists(base[h] + ".dat"):
            raise AssertionError("17d: ec.encode left the source volume")
        shard_size = os.path.getsize(base[h] + ctx.to_ext(0))
        generated = hashed({sid: base[h] + ctx.to_ext(sid) for sid in range(ctx.total)})
        with open(base[h] + ".ecx", "rb") as f:
            ecx = f.read()
        offsets = {}
        for i in range(0, len(ecx), 16):
            nv = NeedleValue.from_bytes(ecx[i : i + 16])
            offsets[nv.needle_id] = (actual_offset(nv.offset), nv.size)
        wait_until(lambda: spread() == dict.fromkeys(range(ctx.total), h),
                   "the 14 shards listed at the holder", phase="17d")
        t0 = time.perf_counter()
        out = shell.run(f"ec.balance -collection {HA_COLLECTION}")
        bal_s = time.perf_counter() - t0
        moves = [re.fullmatch(rf"ec {vid}\.(\d\d): (\S+) -> (\S+) \((\S+)\)", ln)
                 for ln in out.splitlines()]
        if not moves or None in moves:
            raise AssertionError(f"17d: ec.balance answered {out!r}")
        planned = {int(mv[1]): name_of[mv[3]] for mv in moves}
        placed = wait_value(lambda: (lambda got: got if got and all(
            got[sid] == n for sid, n in planned.items()) else None)(spread()),
            "every shard listed once, where ec.balance moved it", phase="17d")
        if {HA_RACKS[n] for n in placed.values()} != set(HA_RACKS.values()):
            raise AssertionError(f"17d: ec.balance left every shard on one rack: {placed}")
        landed = hashed({sid: base[n] + ctx.to_ext(sid) for sid, n in placed.items()})
        if landed != generated:
            raise AssertionError(f"17d: shards {[s for s in landed if landed[s] != generated[s]]} "
                                 "differ from what generate wrote")
        steps["17d ec.encode and ec.balance"] = {
            "shell_start_s": shell_start_s, "dat_size": dat_size, "encode_seconds": enc_s,
            "encode_gb_per_s": dat_size / enc_s / 1e9, "launches": n_batches,
            "balance_seconds": bal_s, "moves": len(moves),
            "moved_bytes": len(moves) * shard_size,
            "placement": {n: sorted(sid for sid, m in placed.items() if m == n) for n in HA_RACKS}}
        placed = {sid: [n] for sid, n in placed.items()}

        # -- 17e. the leader killed; the new one rebuilt from heartbeats ------------
        handed = max(vids | rep_vids)
        killed = f"m{maddr.index(lead)}"
        t0 = time.perf_counter()
        killed_at = t0 - t_spawn
        children[killed][0].send_signal(signal.SIGKILL)
        children[killed][0].wait(timeout=CHILD_STOP_S)
        live = [a for a in maddr if a != lead]
        lead = wait_value(lambda: leader(live), "a new leader", timeout=60, phase="17e")
        failover_s = time.perf_counter() - t0
        wait_until(lambda: ec_holders(lead) == placed, "14 shards listed at the new leader",
                   timeout=60, phase="17e")
        rehomed_s = time.perf_counter() - t0
        a = assign(f"collection={HA_COLLECTION}new")
        new_vid = FileId.parse(a["fid"]).volume_id
        if new_vid <= handed:
            raise AssertionError(f"17e: the new leader handed out volume {new_vid}, "
                                 f"not past {handed}")
        code, _, answer = http(f"http://{a['url']}/{a['fid']}", "POST", b"after the failover",
                               {"Content-Type": UPLOAD_MIME})
        if code != 201 or http(f"http://{a['url']}/{a['fid']}")[2] != b"after the failover":
            raise AssertionError(f"17e: a write after the failover answered {code} {answer[:200]!r}")
        new_holders = lookup(new_vid)
        steps["17e failover"] = {"killed": killed, "new_leader": maddr.index(lead),
                                 "elected_s": failover_s, "fourteen_shards_s": rehomed_s,
                                 "new_volume": new_vid, "new_volume_holders": new_holders,
                                 "handed_before": handed}

        # -- 17f. a server other than the GET holder, with 1-4 shards of which one
        # or more are data shards, stopped; degraded GETs at the holder ----------
        held: dict = {}
        for sid, (n,) in placed.items():
            held.setdefault(n, set()).add(sid)
        fit = [n for n in sorted(held) if n != h and len(held[n]) <= ctx.parity_shards
               and any(sid < ctx.data_shards for sid in held[n])]
        if not fit:
            raise AssertionError(f"17f: no server but {h} holds 1-{ctx.parity_shards} shards with a "
                                 f"data shard among them: {held}")
        stopped = fit[0]
        proc, _ = children[stopped]
        proc.send_signal(signal.SIGTERM)
        if proc.wait(timeout=CHILD_STOP_S) != 0:
            raise AssertionError(f"17f: {stopped} exited with {proc.returncode} on SIGTERM")
        lost = held[stopped]
        wait_until(lambda: not lost & set(ec_holders(lead)), "the stopped holder leaving the leader",
                   phase="17f")
        lost_data = {sid for sid in lost if sid < ctx.data_shards}
        over = [fid for fid, (nid, _, _) in written.items()
                if any(sid in lost_data for sid, _, _ in record_intervals(*offsets[nid], dat_size))]
        sample = [over[i] for i in sorted(np.random.default_rng(SEED + 170).choice(
            len(over), size=min(HA_GETS, len(over)), replace=False))]
        before = {n: kernels(n)["launches"] for n in HA_RACKS if n != stopped}
        loads0 = kernels(h)["interval_cache"]["loads"]
        lat = []
        for fid in sample:
            t0 = time.perf_counter()
            code, _, got = http(f"http://{url[h]}/{fid}")
            lat.append(time.perf_counter() - t0)
            if code != 200 or hashlib.sha256(got).hexdigest() != written[fid][1]:
                raise AssertionError(f"17f: degraded GET of {fid} at {h} answered {code}, "
                                     "not the written bytes")
        got = launched(before)
        recon = kernels(h)["interval_cache"]["loads"] - loads0
        if got["gf2_apply_planes"] != recon or recon < 1 or got["gf2_apply"]:
            raise AssertionError(f"17f: {got} launches for {recon} reconstructions")
        launches["gf2_apply_planes"] += recon
        got_bytes = sum(written[fid][2] for fid in sample)
        steps["17f degraded GETs"] = {
            "stopped": stopped, "lost": sorted(lost), "needles": len(sample),
            "over_lost_shards": len(over), "bytes": got_bytes, "seconds": sum(lat),
            "mb_per_s": got_bytes / sum(lat) / 1e6, "p50_ms": percentile_ms(lat, 50),
            "p99_ms": percentile_ms(lat, 99), "reconstructions": recon, "planes_launches": recon}

        # -- 17g. the shell after the loss: check, rebuild from peers, check, scrub,
        # decode, then upload and download -----------------------------------------
        t17g = time.perf_counter()
        up = [n for n in HA_RACKS if n != stopped]
        out = shell.run("ec.check.replication")
        if out != f"ec volume {vid}: MISSING shards {sorted(lost)} (run ec.rebuild)":
            raise AssertionError(f"17g: ec.check.replication answered {out!r}; {sorted(lost)} lost")
        before = {n: kernels(n)["launches"] for n in up}
        t0 = time.perf_counter()
        out = shell.run(f"ec.rebuild -volumeId {vid} -collection {HA_COLLECTION} -fromPeers")
        reb_s = time.perf_counter() - t0
        m = re.fullmatch(r"rebuilt shards \[([\d, ]*)\] on (\S+) \(fetched \[[\d, ]*\] from peers, "
                         r"distributed \[([\d, ]*)\]\)", out)
        if m is None or sorted(int(x) for x in m[1].split(", ")) != sorted(lost):
            raise AssertionError(f"17g: ec.rebuild answered {out!r}; {sorted(lost)} lost")
        r = name_of[m[2]]
        reb_batches = -(-shard_size // DEFAULT_BATCH)
        now = {n: kernels(n)["launches"] for n in up}
        got = {n: {k: now[n][k] - before[n][k] for k in launches} for n in up}
        if got[r]["gf2_apply"] != reb_batches or any(
                got[n][k] for n in got for k in launches if (n, k) != (r, "gf2_apply")):
            raise AssertionError(f"17g: ec.rebuild launched {got} for {reb_batches} batches at {r}")
        launches_g = {"gf2_apply": reb_batches, "gf2_apply_planes": 0}
        healed = wait_value(spread, "all 14 shards listed once after the rebuild", phase="17g")
        rebuilt = hashed({sid: base[healed[sid]] + ctx.to_ext(sid) for sid in sorted(lost)})
        if any(rebuilt[sid] != generated[sid] for sid in lost):
            raise AssertionError("17g: rebuilt shards differ from what generate wrote")
        out = shell.run("ec.check.replication")
        if out != f"ec volume {vid}: all {ctx.total} shards present":
            raise AssertionError(f"17g: ec.check.replication after the rebuild answered {out!r}")
        t0 = time.perf_counter()
        # the holders find a collection's EC volume by its collection: ec.scrub
        # without it answers "ec volume not found", in both packages
        out = shell.run(f"ec.scrub -volumeId {vid} -collection {HA_COLLECTION}")
        scrub_s = time.perf_counter() - t0
        holders_now = len(set(healed.values()))
        fleet = (f"fleet: {holders_now} holders, {ctx.total} shards checked, 0 bitrot, 0 missing, "
                 "0 quarantined")
        if out.splitlines()[-1] != fleet:
            raise AssertionError(f"17g: ec.scrub answered {out!r}")
        before = {n: kernels(n)["launches"] for n in up}
        t0 = time.perf_counter()
        out = shell.run(f"ec.decode -volumeId {vid} -collection {HA_COLLECTION}")
        dec_s = time.perf_counter() - t0
        m = re.fullmatch(rf"decoded ec volume {vid} back to a normal volume on (\S+)", out)
        if m is None:
            raise AssertionError(f"17g: ec.decode answered {out!r}")
        d = name_of[m[1]]
        now = {n: kernels(n)["launches"] for n in up}
        if any(now[n][k] != before[n][k] for n in up for k in launches):
            raise AssertionError(f"17g: ec.decode of a whole shard set launched: {before} -> {now}")
        if hashed({ext: base[d] + ext for ext in (".dat", ".idx")}) != source:
            raise AssertionError(f"17g: the decoded .dat or .idx at {d} differs from the encoded volume's")
        wait_until(lambda: lookup(vid) == [d], f"the decoded volume listed at {d}", phase="17g")
        picks = [list(written)[i] for i in sorted(np.random.default_rng(SEED + 171).choice(
            len(written), size=HA_GETS, replace=False))]
        for fid in picks:
            code, _, body = http(f"http://{lead}/dir/lookup?volumeId={vid}")
            where = json.loads(body)["locations"][0]["url"]
            code, _, got = http(f"http://{where}/{fid}")
            if code != 200 or hashlib.sha256(got).hexdigest() != written[fid][1]:
                raise AssertionError(f"17g: GET of {fid} at {where} after the decode answered {code}")
        src = os.path.join(root, "upload.bin")
        with open(src, "wb") as f:
            f.write(np.random.default_rng(SEED + 172).bytes(HA_UPLOAD_BYTES))
        t0 = time.perf_counter()
        fid = shell.run(f"upload {src} -collection {HA_COLLECTION}shell")
        up_s = time.perf_counter() - t0
        dst = os.path.join(root, "download.bin")
        t0 = time.perf_counter()
        out = shell.run(f"download -fid {fid} -o {dst}")
        down_s = time.perf_counter() - t0
        if out != f"{HA_UPLOAD_BYTES} bytes -> {dst}" or sha256(dst) != sha256(src):
            raise AssertionError(f"17g: upload answered {fid!r}, download {out!r}")
        steps["17g shell"] = {
            "check_replication_missing": sorted(lost), "rebuild_holder": r,
            "rebuild_seconds": reb_s, "rebuild_batches": reb_batches,
            "rebuild_gb_per_s": len(lost) * shard_size / reb_s / 1e9, "scrub_seconds": scrub_s,
            "scrub_gb_per_s": ctx.total * shard_size / scrub_s / 1e9, "decode_holder": d,
            "decode_seconds": dec_s, "decode_gb_per_s": dat_size / dec_s / 1e9,
            "gets_after_decode": len(picks), "upload_bytes": HA_UPLOAD_BYTES,
            "upload_seconds": up_s, "download_seconds": down_s,
            "seconds": time.perf_counter() - t17g}

        # -- 17h. auto-EC: the leader's scanner submits ec_encode, a worker child
        # runs it -------------------------------------------------------------------
        t17h = time.perf_counter()
        # every collection of 17b-17g dropped: the fresh volume is the one
        # plain volume left, the scanner's one candidate
        for col in (HA_COLLECTION, HA_REP_COLLECTION, f"{HA_COLLECTION}new",
                    f"{HA_COLLECTION}shell"):
            out = shell.run(f"collection.delete -collection {col}")
            # 17e's volume left the topology with 17f's stopped server where
            # that server was its one holder: the leader lists none of it
            vols = r"\[\]" if col == f"{HA_COLLECTION}new" and new_holders == [stopped] \
                else r"\[[\d, ]+\]"
            if not re.fullmatch(rf"deleted collection '{col}': volumes {vols}", out):
                raise AssertionError(f"17h: collection.delete answered {out!r}; 17e's volume "
                                     f"{new_vid} was at {new_holders}, {stopped} stopped")
        wait_until(lambda: alive() or not any(nd.volumes for nd in nodes_at(lead).values()),
                   "no plain volume left at the leader", phase="17h")
        t0 = time.perf_counter()
        wlog = open(os.path.join(root, "worker.log"), "wb")
        children["worker"] = (subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.worker", "-master", ",".join(maddr),
             "-backend", "cuda", "-capabilities", "ec_encode,ec_scrub,ec_rebuild,vacuum"],
            cwd=root, env=env, stdout=wlog, stderr=subprocess.STDOUT), wlog)
        # the worker child imports torch while the volume fills
        auto: dict = {}  # fid -> (needle id, sha256 of the body, body length)
        vids2, total = set(), 8
        for _, _, body in needle_stream(np.random.default_rng(SEED + 18)):
            if total + len(body) + 64 > VOLUME_BYTES // 4:
                break
            a = assign(f"collection={HA_AUTO_COLLECTION}")
            code, _, answer = http(f"http://{a['url']}/{a['fid']}", "POST", body,
                                   {"Content-Type": UPLOAD_MIME})
            if code != 201:
                raise AssertionError(f"17h: POST answered {code} {answer[:200]!r}")
            vids2.add(FileId.parse(a["fid"]).volume_id)
            auto[a["fid"]] = (FileId.parse(a["fid"]).needle_id, hashlib.sha256(body).hexdigest(),
                              len(body))
            total += len(body) + 64
        fill_s = time.perf_counter() - t0
        if len(vids2) != 1:
            raise AssertionError(f"17h: the assigns spread over volumes {sorted(vids2)}")
        (vid2,) = vids2
        (h2,) = lookup(vid2)
        up = [n for n in HA_RACKS if n != stopped]
        base2 = {n: os.path.join(root, n, f"{HA_AUTO_COLLECTION}_{vid2}") for n in HA_RACKS}
        dat2 = os.path.getsize(base2[h2] + ".dat")
        fenv = ShellEnv(lead)  # the leader alone: the fleet commands parse one address

        def worker_line() -> str | None:
            alive()
            lines = run_command(fenv, "worker.list").splitlines()
            return lines[0] if len(lines) == 1 and lines[0].startswith("worker-") else None

        def fleet_tasks() -> list[tuple[str, str, int, str]]:
            """`task.list` at the leader as (task id, kind, volume, state) rows."""
            out = run_command(fenv, "task.list")
            if out == "(no tasks)":
                return []
            rows = [re.match(r"(\w+) (\w+) vol=(\d+) (\w+)", ln) for ln in out.splitlines()]
            if None in rows:
                raise AssertionError(f"17: task.list answered {out!r}")
            return [(m[1], m[2], int(m[3]), m[4]) for m in rows]

        wline = wait_value(worker_line, "the worker child listed at the leader", timeout=120,
                           phase="17h")
        worker_s = time.perf_counter() - t0
        wid = wline.split()[0]
        if wline != f"{wid} caps=ec_encode,ec_rebuild,ec_scrub,vacuum active=0/2 backend=cuda":
            raise AssertionError(f"17h: worker.list answered {wline!r}")
        ps = run_command(fenv, "cluster.ps").splitlines()
        if f"worker {wid} caps=ec_encode,ec_rebuild,ec_scrub,vacuum active=0" not in ps or not any(
                ln.startswith(f"master {lead} role=leader") for ln in ps):
            raise AssertionError(f"17h: cluster.ps answered {ps}")
        if fleet_tasks():
            raise AssertionError("17h: tasks before the scanner was turned on")
        wait_until(lambda: alive() or any(
            v.id == vid2 and v.size == dat2 for nd in nodes_at(lead).values() for v in nd.volumes),
            f"the leader listing volume {vid2} at its .dat size", phase="17h")
        n_batches2 = len(list(batch_plan(dat2, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE,
                                         SMALL_BLOCK_SIZE)))
        fullness = 0.5 * dat2 / HA_SIZE_LIMIT  # half this volume: the others stay below
        before = {n: kernels(n)["launches"] for n in up}
        t0 = time.perf_counter()
        cfg = json.loads(run_command(fenv, f"maintenance.config -set ec_auto_fullness={fullness!r} "
                                           f"-set ec_quiet_seconds={HA_QUIET_S}"))
        if (cfg["ec_auto_fullness"], cfg["ec_quiet_seconds"]) != (fullness, HA_QUIET_S):
            raise AssertionError(f"17h: maintenance.config answered {cfg}")

        def task_done(kind: str, v: int, count: int = 1) -> list | None:
            alive()
            rows = fleet_tasks()
            if any(r[3] == "failed" for r in rows):
                raise AssertionError(f"17: a task failed: {run_command(fenv, 'task.list')}")
            done = [r for r in rows if r[1:] == (kind, v, "done")]
            return rows if len(done) >= count else None

        rows = wait_value(lambda: task_done("ec_encode", vid2), f"the ec_encode task of {vid2} done",
                          timeout=TASK_TIMEOUT_S, phase="17h")
        auto_s = time.perf_counter() - t0
        run_command(fenv, "maintenance.config -set ec_auto_fullness=0")
        if [r[1:] for r in rows] != [("ec_encode", vid2, "done")]:
            raise AssertionError(f"17h: the scanner submitted {rows}")
        now = {n: kernels(n)["launches"] for n in up}
        per = {n: {k: now[n][k] - before[n][k] for k in launches} for n in up}
        if per[h2]["gf2_apply"] != n_batches2 or any(
                per[n][k] for n in up for k in launches if (n, k) != (h2, "gf2_apply")):
            raise AssertionError(f"17h: the ec_encode task launched {per} for {n_batches2} "
                                 f"batches at {h2}")
        launches_hi["gf2_apply"] += n_batches2
        if os.path.exists(base2[h2] + ".dat") or any(
                v.id == vid2 for nd in nodes_at(lead).values() for v in nd.volumes):
            raise AssertionError(f"17h: the plain volume {vid2} outlived its encode")
        wait_until(lambda: spread(vid2) == dict.fromkeys(range(ctx.total), h2),
                   "the 14 shards listed at the holder", phase="17h")
        prot = BitrotProtection.load(base2[h2] + ".ecsum")
        rotten = [sid for sid in range(ctx.total)
                  if prot.verify_shard_file(base2[h2] + ctx.to_ext(sid), sid)]
        if rotten:
            raise AssertionError(f"17h: shards {rotten} do not verify against .ecsum")
        shard2 = os.path.getsize(base2[h2] + ctx.to_ext(0))
        generated2 = hashed({sid: base2[h2] + ctx.to_ext(sid) for sid in range(ctx.total)})
        with open(base2[h2] + ".ecx", "rb") as f:
            ecx = f.read()
        offsets2 = {}
        for i in range(0, len(ecx), 16):
            nv = NeedleValue.from_bytes(ecx[i : i + 16])
            offsets2[nv.needle_id] = (actual_offset(nv.offset), nv.size)
        before = {n: kernels(n)["launches"] for n in up}
        t0 = time.perf_counter()
        for fid, (_, want, _) in auto.items():
            code, _, got_body = http(f"http://{url[h2]}/{fid}")
            if code != 200 or hashlib.sha256(got_body).hexdigest() != want:
                raise AssertionError(f"17h: GET of {fid} at {h2} answered {code}, not the written bytes")
        reads_s = time.perf_counter() - t0
        if any(launched(before).values()):
            raise AssertionError(f"17h: healthy EC reads launched {launched(before)}")
        nbytes2 = sum(w[2] for w in auto.values())
        steps["17h auto-EC"] = {
            "worker": wid, "volume": vid2, "holder": h2, "needles": len(auto), "bytes": nbytes2,
            "dat_size": dat2, "fill_seconds": fill_s, "worker_listed_s": worker_s,
            "fullness": fullness, "config_to_done_s": auto_s, "launches": n_batches2,
            "reads_seconds": reads_s, "seconds": time.perf_counter() - t17h}

        # -- 17i. the fleet scrub finds a quarantined shard and dispatches a
        # peer-fetch rebuild -------------------------------------------------------
        t17i = time.perf_counter()
        t0 = time.perf_counter()
        out = shell.run(f"ec.balance -collection {HA_AUTO_COLLECTION}")
        bal2_s = time.perf_counter() - t0
        moves = [re.fullmatch(rf"ec {vid2}\.(\d\d): (\S+) -> (\S+) \((\S+)\)", ln)
                 for ln in out.splitlines()]
        if not moves or None in moves:
            raise AssertionError(f"17i: ec.balance answered {out!r}")
        planned = {int(mv[1]): name_of[mv[3]] for mv in moves}
        placed2 = wait_value(lambda: (lambda got: got if got and all(
            got[sid] == n for sid, n in planned.items()) else None)(spread(vid2)),
            "every shard listed once, where ec.balance moved it", phase="17i")
        held2: dict = {}
        for sid, n in placed2.items():
            held2.setdefault(n, set()).add(sid)
        fit = [n for n in sorted(held2) if len(held2[n]) < ctx.data_shards
               and any(sid < ctx.data_shards for sid in held2[n])]
        if not fit:
            raise AssertionError(f"17i: no holder of fewer than {ctx.data_shards} shards with a "
                                 f"data shard: {held2}")
        q = fit[0]
        qsid = min(sid for sid in held2[q] if sid < ctx.data_shards)
        qpath = base2[q] + ctx.to_ext(qsid)
        with grpc.insecure_channel(gaddr[q]) as ch:
            rpc.volume_stub(ch).VolumeEcShardsUnmount(
                pb.EcShardsUnmountRequest(volume_id=vid2, shard_ids=[qsid]), timeout=30)
        os.replace(qpath, qpath + ".bad")  # the scrub's quarantine
        wait_until(lambda: alive() or qsid not in ec_holders(lead, vid2),
                   f"shard {qsid} leaving the leader's listing", phase="17i")
        over2 = [fid for fid, (nid, _, _) in auto.items()
                 if any(sid == qsid for sid, _, _ in record_intervals(*offsets2[nid], dat2))]
        sample2 = [over2[i] for i in sorted(np.random.default_rng(SEED + 180).choice(
            len(over2), size=min(HA_GETS, len(over2)), replace=False))]
        before = {n: kernels(n)["launches"] for n in up}
        loads0 = kernels(q)["interval_cache"]["loads"]
        lat = []
        for fid in sample2:
            t0 = time.perf_counter()
            code, _, got_body = http(f"http://{url[q]}/{fid}")
            lat.append(time.perf_counter() - t0)
            if code != 200 or hashlib.sha256(got_body).hexdigest() != auto[fid][1]:
                raise AssertionError(f"17i: degraded GET of {fid} at {q} answered {code}, "
                                     "not the written bytes")
        got = launched(before)
        recon2 = kernels(q)["interval_cache"]["loads"] - loads0
        if got["gf2_apply_planes"] != recon2 or recon2 < 1 or got["gf2_apply"]:
            raise AssertionError(f"17i: {got} launches for {recon2} reconstructions")
        launches_hi["gf2_apply_planes"] += recon2
        _, _, body = http(f"http://{lead}/metrics")
        dispatched0 = metric_value(body.decode(), "sw_ec_fleet_peer_rebuild_dispatch_total")
        before = {n: kernels(n)["launches"] for n in up}
        t0 = time.perf_counter()
        run_command(fenv, "maintenance.config -set ec_scrub_interval_seconds=3600")

        def fleet_scrub() -> dict:
            code, _, body = http(f"http://{lead}/cluster/status")
            if code != 200:
                raise AssertionError(f"17i: /cluster/status answered {code}")
            return json.loads(body)["EcFleetScrub"]

        rows = wait_value(lambda: task_done("ec_rebuild", vid2), "the dispatched ec_rebuild done",
                          timeout=TASK_TIMEOUT_S, phase="17i")
        heal_s = time.perf_counter() - t0
        first = fleet_scrub()
        hq = first["reports"].get(str(vid2), {}).get("holders", {}).get(url[q], {})
        if (first["unrebuildable_volumes"] != [vid2] or hq.get("quarantined") != [qsid]
                or not hq.get("unrebuildable")):
            raise AssertionError(f"17i: EcFleetScrub after the first scrub: {first}")
        _, _, body = http(f"http://{lead}/metrics")
        dispatched = metric_value(body.decode(), "sw_ec_fleet_peer_rebuild_dispatch_total") \
            - dispatched0
        if dispatched != 1:
            raise AssertionError(f"17i: sw_ec_fleet_peer_rebuild_dispatch_total rose by {dispatched}")
        reb2_batches = -(-shard2 // DEFAULT_BATCH)
        now = {n: kernels(n)["launches"] for n in up}
        per = {n: {k: now[n][k] - before[n][k] for k in launches} for n in up}
        if per[q]["gf2_apply"] != reb2_batches or any(
                per[n][k] for n in up for k in launches if (n, k) != (q, "gf2_apply")):
            raise AssertionError(f"17i: the scrub and the peer-fetch rebuild launched {per} for "
                                 f"{reb2_batches} batches at {q}")
        launches_hi["gf2_apply"] += reb2_batches
        healed2 = wait_value(lambda: spread(vid2), "all 14 shards listed once after the heal",
                             phase="17i")
        if healed2[qsid] != q or sha256(qpath) != generated2[qsid]:
            raise AssertionError(f"17i: shard {qsid} came back at {healed2[qsid]}, or differs "
                                 "from what generate wrote")
        # the next period: the fleet clean, the healed holder not dispatched at
        t0 = time.perf_counter()
        run_command(fenv, "maintenance.config -set ec_scrub_interval_seconds=1")

        def clean() -> dict | None:
            alive()
            fs = fleet_scrub()
            holders = fs["reports"].get(str(vid2), {}).get("holders", {})
            return fs if (fs["corrupt_shards"] == fs["missing_shards"] == 0
                          and fs["unrebuildable_volumes"] == [] and url[q] in holders
                          and not holders[url[q]]["quarantined"]) else None

        second = wait_value(clean, "a clean fleet scrub report", timeout=TASK_TIMEOUT_S,
                            phase="17i")
        run_command(fenv, "maintenance.config -set ec_scrub_interval_seconds=0")
        rescrub_s = time.perf_counter() - t0
        rows = fleet_tasks()
        kinds = [r[1] for r in rows]
        if kinds.count("ec_rebuild") != 1 or kinds.count("ec_scrub") < 2 or any(
                r[3] == "failed" for r in rows):
            raise AssertionError(f"17i: the fleet ran {rows}")
        if any(now[n][k] != kernels(n)["launches"][k] for n in up for k in launches):
            raise AssertionError("17i: the clean scrub launched")
        steps["17i fleet scrub"] = {
            "balance_seconds": bal2_s, "moves": len(moves), "quarantined": {q: qsid},
            "holder_shards": sorted(held2[q]), "degraded_gets": len(sample2),
            "over_quarantined_shard": len(over2), "get_p50_ms": percentile_ms(lat, 50),
            "get_p99_ms": percentile_ms(lat, 99), "reconstructions": recon2,
            "scrub_to_healed_s": heal_s, "rebuild_batches": reb2_batches,
            "dispatched": dispatched, "first_report": first["reports"][str(vid2)]["holders"],
            "clean_report_s": rescrub_s, "corrupt_after": second["corrupt_shards"],
            "tasks": [r[1:] for r in rows], "seconds": time.perf_counter() - t17i}

        # -- 17j. the servers' last parts: ?locate and the fastread sidecar,
        # /debug/pprof, thumbnails over a degraded read, the telemetry collector
        t17j = time.perf_counter()
        from seaweedfs_tpu_torch.client import operations
        from seaweedfs_tpu_torch.utils import images
        from seaweedfs_tpu_torch.utils.crc import crc32c
        from seaweedfs_tpu_torch.utils.fastread import FastReadClient, FastReadError, read_fid_fast

        fast: dict = {}  # fid -> body
        vids3, total = set(), 0
        for _, _, body in needle_stream(np.random.default_rng(SEED + 19)):
            if total >= HA_FAST_BYTES:
                break
            a = assign(f"collection={HA_FAST_COLLECTION}")
            code, _, answer = http(f"http://{a['url']}/{a['fid']}", "POST", body,
                                   {"Content-Type": UPLOAD_MIME})
            if code != 201:
                raise AssertionError(f"17j: POST answered {code} {answer[:200]!r}")
            vids3.add(FileId.parse(a["fid"]).volume_id)
            fast[a["fid"]] = body
            total += len(body)
        if len(vids3) != 1:
            raise AssertionError(f"17j: the assigns spread over volumes {sorted(vids3)}")
        (vid3,) = vids3
        (h3,) = lookup(vid3)
        locs, etags = {}, {}
        for fid, body in fast.items():
            code, _, answer = http(f"http://{url[h3]}/{fid}?locate=true")
            if code != 200:
                raise AssertionError(f"17j: ?locate=true of {fid} at {h3} answered {code}")
            locs[fid] = json.loads(answer)
            code, hdrs, got = http(f"http://{url[h3]}/{fid}")
            if code != 200 or got != body:
                raise AssertionError(f"17j: GET of {fid} at {h3} answered {code}")
            etags[fid] = int(hdrs["ETag"].strip('"'), 16)
        sock = os.path.join(root, h3, ".fastread.sock")
        if {loc["socket"] for loc in locs.values()} != {sock} or not os.path.exists(sock):
            raise AssertionError(f"17j: ?locate named sockets {set(l['socket'] for l in locs.values())}, "
                                 f"not the live {sock}")
        t0 = time.perf_counter()
        for fid, body in fast.items():
            if read_fid_fast(locs[fid]) != body or not (
                    locs[fid]["crc32c"] == etags[fid] == crc32c(body)):
                raise AssertionError(f"17j: the sidecar's bytes or CRC of {fid} differ from the GET's")
        side_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for fid, body in fast.items():
            if http(f"http://{url[h3]}/{fid}")[2] != body:
                raise AssertionError(f"17j: GET of {fid} at {h3} changed")
        http_s = time.perf_counter() - t0
        # the client's read order: the net plane first, so it is switched off
        # for these reads; then the sidecar, then HTTP
        ops = operations.Operations(master=lead)
        os.environ["SEAWEED_CHUNK_NET_PLANE"] = "0"
        try:
            served0 = operations.FAST_READS["sidecar"]
            picks3 = list(fast)[:8]
            for fid in picks3:
                if ops.read(fid) != fast[fid]:
                    raise AssertionError(f"17j: Operations.read of {fid} gave other bytes")
            served = operations.FAST_READS["sidecar"] - served0
        finally:
            del os.environ["SEAWEED_CHUNK_NET_PLANE"]
            ops.close()
        if served != len(picks3):
            raise AssertionError(f"17j: the sidecar served {served} of {len(picks3)} same-host reads")
        c = FastReadClient(sock)
        try:
            c.read(os.path.abspath(__file__), 0, 16)
            raise AssertionError("17j: the sidecar served a path outside its root")
        except FastReadError as e:
            if "outside" not in str(e):
                raise
        finally:
            c.close()
        # the offline tools' scratch copy: the volume unmounted (its files
        # closed) and copied
        with grpc.insecure_channel(gaddr[h3]) as ch:
            rpc.volume_stub(ch).VolumeUnmount(pb.VolumeCommandRequest(volume_id=vid3), timeout=30)
        tools_dir = os.path.join(work, "tools")
        os.makedirs(tools_dir)
        for ext in (".dat", ".idx"):
            shutil.copy(os.path.join(root, h3, f"{HA_FAST_COLLECTION}_{vid3}{ext}"), tools_dir)
        fast_bytes = sum(len(b) for b in fast.values())
        steps["17j sidecar"] = {
            "volume": vid3, "holder": h3, "needles": len(fast), "bytes": fast_bytes,
            "sidecar_seconds": side_s, "sidecar_mb_per_s": fast_bytes / side_s / 1e6,
            "http_seconds": http_s, "http_mb_per_s": fast_bytes / http_s / 1e6,
            "operations_reads_by_sidecar": served, "refused_outside_root": True}
        tools_src = (tools_dir, vid3, {FileId.parse(f).needle_id: b for f, b in fast.items()})
        del fast

        t0 = time.perf_counter()
        prof = {}
        places = {"leader": lead, h3: url[h3]}
        with ThreadPoolExecutor(4) as ex:  # the two 1 s profiles at once
            answers = {(who, path): ex.submit(http, f"http://{where}/debug/pprof{path}")
                       for who, where in places.items() for path in ("", "/profile?seconds=1")}
            for who in places:
                code, _, stacks = answers[who, ""].result()
                code2, _, sampled = answers[who, "/profile?seconds=1"].result()
                if code != 200 or b"thread MainThread" not in stacks or code2 != 200:
                    raise AssertionError(f"17j: /debug/pprof at {who} answered {code} / {code2}")
                prof[who] = {"stack_bytes": len(stacks),
                             "profile_stacks": len(sampled.splitlines())}
        steps["17j pprof"] = {**prof, "seconds": time.perf_counter() - t0}

        t0 = time.perf_counter()
        pics = seeded_images(np.random.default_rng(SEED + 190))
        img_fids = {}
        for fmt, (body, mime) in pics.items():
            a = assign(f"collection={HA_IMG_COLLECTION}")
            code, _, answer = http(f"http://{a['url']}/{a['fid']}", "POST", body, {"Content-Type": mime})
            if code != 201:
                raise AssertionError(f"17j: POST of the {fmt} answered {code} {answer[:200]!r}")
            img_fids[fmt] = a["fid"]
        (vid4,) = {FileId.parse(f).volume_id for f in img_fids.values()}
        (h4,) = lookup(vid4)
        dat4 = os.path.getsize(os.path.join(root, h4, f"{HA_IMG_COLLECTION}_{vid4}.dat"))
        n_batches4 = len(list(batch_plan(dat4, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)))
        if dat4 > SMALL_BLOCK_SIZE:
            raise AssertionError(f"17j: the images' .dat is {dat4} bytes, past data shard 0")
        before = {n: kernels(n)["launches"] for n in up}
        out = shell.run(f"ec.encode -volumeId {vid4} -collection {HA_IMG_COLLECTION}")
        if not re.fullmatch(rf"ec\.encode volume {vid4}: generation \d+ on {re.escape(url[h4])}", out):
            raise AssertionError(f"17j: ec.encode answered {out!r}")
        wait_until(lambda: spread(vid4) == dict.fromkeys(range(ctx.total), h4),
                   "the thumbnails' 14 shards listed at the holder", phase="17j")
        enc4 = launched(before)
        if enc4 != {"gf2_apply": n_batches4, "gf2_apply_planes": 0}:
            raise AssertionError(f"17j: ec.encode of the images launched {enc4} for {n_batches4} batches")
        # every image lies in the .dat's first MiB: data shard 0 holds it
        with grpc.insecure_channel(gaddr[h4]) as ch:
            rpc.volume_stub(ch).VolumeEcShardsUnmount(
                pb.EcShardsUnmountRequest(volume_id=vid4, shard_ids=[0]), timeout=30)
        wait_until(lambda: alive() or 0 not in ec_holders(lead, vid4),
                   "shard 0 of the thumbnails leaving the leader's listing", phase="17j")
        before = {n: kernels(n)["launches"] for n in up}
        loads0 = kernels(h4)["interval_cache"]["loads"]
        thumbs = {}
        for fmt, fid in img_fids.items():
            body, mime = pics[fmt]
            crc = crc32c(body)
            for w, hgt, mode in THUMBS:
                q = f"?width={w}" + (f"&height={hgt}&mode={mode}" if mode else "")
                code, hdrs, got = http(f"http://{url[h4]}/{fid}{q}")
                want, _, _ = images.resized(body, w, hgt, mode)
                resized = want is not body
                fmt_out = images.detect_format(want) if resized else None
                etag = f'"{crc:08x}-{w}x{hgt}{mode}"' if resized else f'"{crc:08x}"'
                ctype = f"image/{fmt_out.lower()}" if fmt_out else mime
                if code != 200 or got != want or hdrs["ETag"] != etag or hdrs["Content-Type"] != ctype:
                    raise AssertionError(f"17j: {fid}{q} at {h4} answered {code} {hdrs['ETag']} "
                                         f"{hdrs['Content-Type']}, not images.resized's {etag} {ctype}")
                thumbs[f"{fmt} {q}"] = {"bytes": len(got), "resized": resized}
        got4 = launched(before)
        recon4 = kernels(h4)["interval_cache"]["loads"] - loads0
        if got4["gf2_apply_planes"] != recon4 or recon4 < 1 or got4["gf2_apply"]:
            raise AssertionError(f"17j: the thumbnails launched {got4} for {recon4} reconstructions")
        launches_j = {"gf2_apply": enc4["gf2_apply"], "gf2_apply_planes": recon4}
        steps["17j thumbnails"] = {"volume": vid4, "holder": h4, "pil": images_have_pil(),
                                   "encode_launches": enc4, "reconstructions": recon4,
                                   "thumbnails": thumbs, "seconds": time.perf_counter() - t0}

        # the collector: each master sends its first report TELEMETRY_FIRST_S
        # after it starts, and only where it leads then (the interval after is
        # a day), so one report, the leader's, unless 17e's failover straddled
        # the masters' first reports
        t0 = time.perf_counter()
        settle = TELEMETRY_FIRST_S + 10.0 - (time.perf_counter() - t_spawn)
        if settle > 0:
            time.sleep(settle)
        stats = json.loads(http(f"http://127.0.0.1:{tport}/api/stats")[2])
        _, _, prom = http(f"http://127.0.0.1:{tport}/metrics")
        reporters = {ln.split('"')[1] for ln in prom.decode().splitlines()
                     if ln.startswith("seaweed_telemetry_server_count{")}
        straddled = abs(killed_at - TELEMETRY_FIRST_S) < 8.0
        if (stats["clusters"] != 1 and not straddled) or stats["clusters"] > 2 or \
                len(reporters) != stats["clusters"]:
            raise AssertionError(f"17j: the collector holds {stats['clusters']} reports from "
                                 f"{sorted(reporters)}; the leader was killed {killed_at:.1f} s "
                                 "after the masters started")
        steps["17j telemetry"] = {"clusters": stats["clusters"], "leader_killed_at_s": killed_at,
                                  "total_server_count": stats["total_server_count"],
                                  "failover_straddled_first_report": straddled,
                                  "wait_seconds": time.perf_counter() - t0}
        steps["17j"] = {"seconds": time.perf_counter() - t17j}

        # -- 17k. the filer's core and its gRPC service on this cluster, while 17l's
        # filer child starts (its torch import overlaps 17k) ---------------------------
        import types

        sink = WebhookSink()
        fport = server_port()
        os.makedirs(os.path.join(root, "filer17l"))
        spawn("filer", ["filer", "-ip", "127.0.0.1", "-port", str(fport), "-master", ",".join(maddr),
                        "-store", "sstable", "-dir", os.path.join(root, "filer17l"), "-collection",
                        FILER_HTTP_COLLECTION, "-notify.webhook", sink.url])
        serving: dict = {}
        watcher = watch_serving(fport, time.perf_counter(), serving)
        hx = types.SimpleNamespace(lead=lead, url=url, gaddr=gaddr, up=up, kernels=kernels,
                                   launched=launched, spread=spread, lookup=lookup,
                                   ec_holders=ec_holders, fenv=fenv, alive=alive)
        steps["17k filer"], launches_k = filer_check(root, ctx, hx)

        # -- 17l. the filer server, a child by name, through its HTTP plane ------------
        steps["17l filer server"], launches_l = filer_http_check(root, ctx, hx, fport, serving,
                                                                 watcher, sink)

        # -- 17m. S3's libraries and the shell's s3.* over a filer pair in this process
        steps["17m s3"], launches_m = s3_check(root, ctx, hx)
        failed = False
    finally:
        if fenv is not None:
            fenv.close()
        if sink is not None:
            sink.stop()
        for ch in channels:
            ch.close()
        if shell is not None and shell.close() != 0:
            stuck = ["shell"]
        else:
            stuck = []
        stuck += stop_children(children, dead=(killed, stopped))
    if stuck and not failed:
        raise AssertionError(f"17: children did not stop cleanly: {stuck}")
    shutil.rmtree(root)
    result = {"steps": steps, "launches": launches, "launches_17g": launches_g,
              "launches_17h_17i": launches_hi, "launches_17j": launches_j,
              "launches_17k": launches_k, "launches_17l": launches_l, "launches_17m": launches_m,
              "card": card_line()}
    return (result, launches, launches_g, launches_hi, launches_j, launches_k, launches_l, launches_m,
            tools_src)


FILER_COLLECTION = "hafiler"  # 17k: the filer's chunks (bodies of SEED + 20)
FILER_SMALL = 16  # 17k: files under the inline limit, in their entries
FILER_BIG = (48 << 20, 64 << 20)  # 17k: files of 1-12 MiB in 4 MiB chunks, this much in all
FILER_MANY_CHUNK = 1024  # 17k: the one file past 1000 chunks, cut this fine
FILER_MANY_CHUNKS = 1002


def redial_connection(url: str, timeout: float):
    """utils/urls.connection with the smoke's redial for http URLs: 17k's
    filers open a loopback connection per chunk request."""
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    return RedialConnection(parts.hostname, parts.port or 80, timeout=timeout)


def filer_check(root: str, ctx, hx) -> tuple[dict, dict]:
    """17k: two port Filers on phase 17's cluster, in this process. A on an
    SSTableStore and B on a SqliteStore, each with a MetaLog and a
    FilerGrpcService on a grpc.server started here, B following A with a
    MetaAggregator. Through A, in a collection of its own: small files
    (inlined), files of 1-12 MiB in 4 MiB chunks and one file of
    FILER_MANY_CHUNKS chunks (a manifest entry). gRPC round trips on A:
    lookup, list, rename, hard link, KV, LockRange, and DeleteEntry with
    is_delete_data, whose needles answer 404 after flush_gc. B must list
    A's namespace entry for entry. The shell's ec.encode seals the
    collection's volume (the holder launches gf2_apply once per batch),
    data shard 0 is unmounted at the holder, and every file reads back
    through B sha256-equal with B's chunk cache cold: gf2_apply_planes
    launches == the holder's interval-cache loads, and nothing else
    launches. SubscribeMetadata from 0 on A yields every event A logged.
    `hx` holds ha_phase's helpers. Returns (the step's numbers, launches)."""
    from concurrent import futures as cf

    import grpc

    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.filer import Filer, SqliteStore, SSTableStore
    from seaweedfs_tpu_torch.filer.grpc_service import FilerGrpcService
    from seaweedfs_tpu_torch.filer.meta_aggregator import MetaAggregator
    from seaweedfs_tpu_torch.filer.meta_log import MetaLog
    from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
    from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.shell.commands import run_command
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.utils import urls

    t_all = time.perf_counter()
    d = os.path.join(root, "filer")
    launches = {"gf2_apply": 0, "gf2_apply_planes": 0}
    plain_connection = urls.connection
    urls.connection = redial_connection
    servers, channels, filers, logs, agg = [], [], [], [], None
    redials0 = CONNECT_RETRIES[0]
    try:
        def hosted(name: str, store):
            f = Filer(store, master=hx.lead, collection=FILER_COLLECTION)
            ml = MetaLog(os.path.join(d, name, "meta"))
            f.subscribe(ml)
            srv = grpc.server(cf.ThreadPoolExecutor(max_workers=8))
            rpc.add_service(srv, rpc.FILER_SERVICE, FilerGrpcService(f, ml))
            port = srv.add_insecure_port("127.0.0.1:0")
            srv.start()
            servers.append(srv)
            filers.append(f)
            logs.append(ml)
            return f, ml, f"127.0.0.1:{port}"

        a, a_log, a_addr = hosted("a", SSTableStore(os.path.join(d, "a", "store")))
        b, b_log, _ = hosted("b", SqliteStore(os.path.join(d, "b", "filer.db")))
        caused = []
        a.subscribe(caused.append)
        agg = MetaAggregator(b, [a_addr], client_name="17k")
        agg.start()
        ch = grpc.insecure_channel(a_addr)
        channels.append(ch)
        st = rpc.filer_stub(ch)

        def ok(resp, what: str):
            if resp.error:
                raise AssertionError(f"17k: {what} answered {resp.error!r}")
            return resp

        # -- writes through A ------------------------------------------------------
        rng = np.random.default_rng(SEED + 20)
        want: dict = {}  # path -> sha256 of its body
        t0 = time.perf_counter()
        small_bytes = 0
        for i in range(FILER_SMALL):
            body = rng.bytes(int(rng.integers(1, 512)))
            small_bytes += len(body)
            e = a.write_file(f"/17k/small/s{i:02d}.txt", body, mime="text/plain")
            if e.chunks or e.content != body:
                raise AssertionError(f"17k: a {len(body)}-byte file was not inlined")
            want[e.full_path] = hashlib.sha256(body).hexdigest()
        big_bytes, i = 0, 0
        while big_bytes < FILER_BIG[0]:
            n = max(min(int(rng.integers(1 << 20, (12 << 20) + 1)), FILER_BIG[1] - big_bytes), 1 << 20)
            body = rng.bytes(n)
            e = a.write_file(f"/17k/big/b{i:02d}.bin", body)
            if [c.size for c in e.chunks] != [min(4 << 20, n - off) for off in range(0, n, 4 << 20)]:
                raise AssertionError(f"17k: a {n}-byte file landed in chunks {[c.size for c in e.chunks]}")
            want[e.full_path] = hashlib.sha256(body).hexdigest()
            big_bytes += n
            i += 1
        big_s = time.perf_counter() - t0
        a.chunk_size = FILER_MANY_CHUNK
        many = rng.bytes(FILER_MANY_CHUNK * (FILER_MANY_CHUNKS - 1) + 17)
        t1 = time.perf_counter()
        e = a.write_file("/17k/many.bin", many)
        many_s = time.perf_counter() - t1
        a.chunk_size = 4 << 20
        if [c.is_chunk_manifest for c in e.chunks] != [True, True]:
            raise AssertionError(f"17k: {FILER_MANY_CHUNKS} chunks made {len(e.chunks)} entry chunks")
        want[e.full_path] = hashlib.sha256(many).hexdigest()
        doomed = rng.bytes(3 << 19)
        e = a.write_file("/17k/doomed.bin", doomed)
        doomed_fids = [c.fid for c in e.chunks]
        write_s = time.perf_counter() - t0
        written = small_bytes + big_bytes + len(many) + len(doomed)
        vids = {FileId.parse(c.fid).volume_id for c in e.chunks} | {
            FileId.parse(c.fid).volume_id for p in want for c in a.find_entry(p).chunks} | {
            FileId.parse(c.fid).volume_id for c in a.resolve_chunks(a.find_entry("/17k/many.bin"))}
        if len(vids) != 1:
            raise AssertionError(f"17k: the filer's chunks spread over volumes {sorted(vids)}")
        (vid,) = vids
        (h,) = hx.lookup(vid)

        # -- gRPC round trips on A -------------------------------------------------
        t1 = time.perf_counter()
        r = ok(st.LookupDirectoryEntry(fpb.LookupEntryRequest(directory="/17k", name="many.bin"),
                                       timeout=30), "LookupDirectoryEntry")
        if [c.is_chunk_manifest for c in r.entry.chunks] != [True, True] or \
                r.entry.attributes.file_size != len(many):
            raise AssertionError("17k: LookupDirectoryEntry of the manifest file differs")
        listed = [x.entry.name for x in st.ListEntries(fpb.ListEntriesRequest(
            directory="/17k/big", limit=1000), timeout=30)]
        if listed != sorted(p.rsplit("/", 1)[1] for p in want if p.startswith("/17k/big/")):
            raise AssertionError(f"17k: ListEntries answered {listed}")
        ok(st.AtomicRenameEntry(fpb.AtomicRenameEntryRequest(
            old_directory="/17k/big", old_name="b00.bin", new_directory="/17k/renamed",
            new_name="b00.bin"), timeout=30), "AtomicRenameEntry")
        want["/17k/renamed/b00.bin"] = want.pop("/17k/big/b00.bin")
        src = max(p for p in want if p.startswith("/17k/big/"))
        ok(st.HardLink(fpb.HardLinkRequest(src_path=src, dst_path="/17k/links/linked.bin"),
                       timeout=30), "HardLink")
        want["/17k/links/linked.bin"] = want[src]
        ok(st.KvPut(fpb.FilerKvPutRequest(key=b"17k", value=b"kv"), timeout=30), "KvPut")
        if st.KvGet(fpb.FilerKvGetRequest(key=b"17k"), timeout=30).value != b"kv":
            raise AssertionError("17k: KvGet does not give KvPut's value back")
        lk = [st.LockRange(fpb.LockRangeRequest(path="/17k/many.bin", owner=o, start=0, end=100,
                                                exclusive=True, op=op), timeout=30)
              for o, op in (("x", 0), ("y", 0), ("y", 2), ("x", 1), ("y", 0))]
        if [(x.granted, x.conflict_owner) for x in lk] != [
                (True, ""), (False, "x"), (False, "x"), (True, ""), (True, "")]:
            raise AssertionError(f"17k: LockRange answered {lk}")
        ok(st.DeleteEntry(fpb.DeleteEntryRequest(directory="/17k", name="doomed.bin",
                                                 is_delete_data=True), timeout=30), "DeleteEntry")
        rpc_s = time.perf_counter() - t1

        # -- B converges on A, from A's last event ---------------------------------
        def namespace(f, top="/") -> list:
            out = []
            for x in f.store.list(top, limit=100_000):
                out.append((x.full_path, x.to_proto().SerializeToString(deterministic=True)))
                if x.is_directory:
                    out += namespace(f, x.full_path)
            return out

        ns = namespace(a)
        wait_until(lambda: namespace(b) == ns, "B listing A's namespace", phase="17k")
        converge_s = time.perf_counter() - t1 - rpc_s
        t1 = time.perf_counter()
        a.flush_gc()
        wait_until(lambda: all(http(f"http://{hx.url[h]}/{fid}")[0] == 404 for fid in doomed_fids),
                   "the deleted file's needles answering 404", phase="17k")
        gc_s = time.perf_counter() - t1

        # -- seal the collection, one data shard gone, read through B --------------
        dat = os.path.getsize(os.path.join(root, h, f"{FILER_COLLECTION}_{vid}.dat"))
        n_batches = len(list(batch_plan(dat, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)))
        before = {n: hx.kernels(n)["launches"] for n in hx.up}
        t1 = time.perf_counter()
        out = run_command(hx.fenv, f"ec.encode -volumeId {vid} -collection {FILER_COLLECTION}")
        enc_s = time.perf_counter() - t1
        if not re.fullmatch(rf"ec\.encode volume {vid}: generation \d+ on {re.escape(hx.url[h])}", out):
            raise AssertionError(f"17k: ec.encode answered {out!r}")
        wait_until(lambda: hx.spread(vid) == dict.fromkeys(range(ctx.total), h),
                      "the filer volume's 14 shards listed at the holder", phase="17k")
        enc = hx.launched(before)
        if enc != {"gf2_apply": n_batches, "gf2_apply_planes": 0}:
            raise AssertionError(f"17k: ec.encode launched {enc} for {n_batches} batches")
        launches["gf2_apply"] += n_batches
        with grpc.insecure_channel(hx.gaddr[h]) as vch:
            rpc.volume_stub(vch).VolumeEcShardsUnmount(
                pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=[0]), timeout=30)
        wait_until(lambda: hx.alive() or 0 not in hx.ec_holders(hx.lead, vid),
                      "shard 0 of the filer volume leaving the leader's listing", phase="17k")
        before = {n: hx.kernels(n)["launches"] for n in hx.up}
        loads0 = hx.kernels(h)["interval_cache"]["loads"]
        lat, big_read_s = [], 0.0
        t1 = time.perf_counter()
        for path, digest in want.items():
            t2 = time.perf_counter()
            got = b.read_file(path)
            dt = time.perf_counter() - t2
            if b.find_entry(path).chunks:
                lat.append(dt)
            if "/17k/big/" in path or "/17k/renamed/" in path:
                big_read_s += dt
            if hashlib.sha256(got).hexdigest() != digest:
                raise AssertionError(f"17k: {path} read through B differs from what A wrote")
        read_s = time.perf_counter() - t1
        got = hx.launched(before)
        recon = hx.kernels(h)["interval_cache"]["loads"] - loads0
        if got["gf2_apply_planes"] != recon or recon < 1 or got["gf2_apply"]:
            raise AssertionError(f"17k: the reads through B launched {got} for {recon} reconstructions")
        launches["gf2_apply_planes"] += recon

        # -- A's whole event stream ------------------------------------------------
        logged = a_log.read_since(0, limit=1_000_000)
        evs = []
        call = st.SubscribeMetadata(fpb.SubscribeMetadataRequest(client_name="17k", since_ns=0),
                                    timeout=60)
        for ev in call:
            evs.append(ev.ts_ns)
            if len(evs) == len(logged):
                break
        call.cancel()
        if evs != [rec["tsNs"] for rec in logged] or len(evs) != len(caused) or \
                evs != [ev.ts_ns for ev in caused]:
            raise AssertionError(f"17k: SubscribeMetadata from 0 gave {len(evs)} events; A logged "
                                 f"{len(logged)} and caused {len(caused)}")
        step = {
            "files": len(want), "small_files": FILER_SMALL, "bytes": written,
            "big_bytes": big_bytes, "write_seconds": write_s,
            "write_mb_per_s": written / write_s / 1e6,
            "big_write_mb_per_s": big_bytes / big_s / 1e6,
            "many_chunks": FILER_MANY_CHUNKS, "many_write_seconds": many_s,
            "rpc_seconds": rpc_s, "converged_s": converge_s, "gc_to_404_s": gc_s,
            "entries": len(ns),
            "applied_by_b": agg.applied, "volume": vid, "holder": h, "dat_size": dat,
            "encode_seconds": enc_s, "encode_launches": n_batches,
            "read_seconds": read_s, "big_read_mb_per_s": big_bytes / big_read_s / 1e6,
            "degraded_read_p50_ms": percentile_ms(lat, 50),
            "degraded_read_p99_ms": percentile_ms(lat, 99), "reconstructions": recon,
            "planes_launches": recon, "events": len(evs),
            "redials": CONNECT_RETRIES[0] - redials0, "seconds": time.perf_counter() - t_all}
    finally:
        urls.connection = plain_connection
        if agg is not None:
            agg.stop()
        for ch in channels:
            ch.close()
        for srv in servers:
            srv.stop(grace=None)
        for f in filers:
            f.close()
        for ml in logs:
            ml.close()
    return step, launches


FILER_HTTP_COLLECTION = "hafilerhttp"  # 17l: the filer child's chunks (bodies of SEED + 21)
FILER_HTTP_SMALL = 8  # 17l: files under the inline limit, in their entries
FILER_HTTP_SIZES = {  # 17l: the chunked files and how each is written (about 21 MiB)
    "/17l/multipart.bin": (6 << 20, "multipart"), "/17l/chunked.bin": ((5 << 20) + 4321, "chunked"),
    "/17l/tus.bin": ((6 << 20) + 77, "tus"), "/17l/raw/r0.bin": (3 << 20, "raw"),
    "/17l/raw/r1.bin": ((3 << 19) + 123, "raw")}
FILER_HTTP_DOOMED = (200_000, 300_000)  # 17l: a directory's files, deleted recursively
FILER_CHILD_START_S = 180.0  # 17l: the child's wait to serve (its torch import included)


class WebhookSink:
    """17l's webhook: a local HTTP server in this process keeping every
    event the filer child POSTs, and when the last one came."""

    def __init__(self):
        import http.server

        sink = self
        self.events: list = []
        self.last_at = 0.0
        self.lock = threading.Lock()

        class Hook(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_POST(self):
                doc = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                with sink.lock:
                    sink.events.append(doc)
                    sink.last_at = time.perf_counter()
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Hook)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/events"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def watch_serving(port: int, t_spawn: float, out: dict) -> threading.Thread:
    """A thread that polls the filer child's /debug/slo until it answers:
    `out["serving_s"]` is then the seconds from its spawn."""
    def poll():
        deadline = t_spawn + FILER_CHILD_START_S
        while time.perf_counter() < deadline:
            try:
                c = HTTPConnection("127.0.0.1", port, timeout=2)
                c.request("GET", "/debug/slo")
                ok = c.getresponse().status == 200
                c.close()
                if ok:
                    out["serving_s"] = time.perf_counter() - t_spawn
                    return
            except OSError:
                pass
            time.sleep(0.1)

    t = threading.Thread(target=poll, daemon=True)
    t.start()
    return t


def filer_http_check(root: str, ctx, hx, fport: int, serving: dict, watcher, sink) -> tuple[dict, dict]:
    """17l: the filer child (`python3 -m seaweedfs_tpu_torch.server filer`,
    started at 17k's beginning with `-master <the group> -store sstable` and
    `-notify.webhook` at `sink`) through its HTTP plane. Writes: a multipart
    PUT, a chunked-TE PUT, a TUS upload in three PATCHes, raw PUTs, inlined
    small files, a `mv.from`, and a directory deleted recursively (its
    needles answer 404 at the holder). The shell's ec.encode seals the
    collection's volume (gf2_apply launches at the holder == its batches),
    data shard 0 is unmounted there, and every file reads back through the
    child, whole and in ranges, sha256-equal (gf2_apply_planes launches ==
    the holder's interval-cache loads). The sink's events equal
    /~meta/tail's. In this process the shell's fs.ls, fs.du, fs.verify,
    volume.fsck and cluster.lock.ring answer what was written, the lease
    taken and given back through `DlmClient` at the child's gRPC port.
    Returns (the step's numbers, launches)."""
    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.filer.lock_ring import DlmClient
    from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.shell.commands import ShellEnv, run_command
    from seaweedfs_tpu_torch.storage.file_id import FileId

    import grpc

    t_all = time.perf_counter()
    launches = {"gf2_apply": 0, "gf2_apply_planes": 0}
    base = f"http://127.0.0.1:{fport}"
    watcher.join(timeout=max(FILER_CHILD_START_S - (time.perf_counter() - t_all), 1.0))
    hx.alive()
    if "serving_s" not in serving:
        raise AssertionError(f"17l: the filer child did not serve in {FILER_CHILD_START_S} s")

    def call(path: str, method: str = "GET", body=None, headers=None, want: int = 200):
        code, hdrs, got = http(base + path, method, body, headers)
        if code != want:
            raise AssertionError(f"17l: {method} {path} answered {code} {got[:300]!r}, not {want}")
        return hdrs, got

    # -- writes through the child's HTTP plane ---------------------------------------
    rng = np.random.default_rng(SEED + 21)
    want: dict = {}  # path -> body
    t0 = time.perf_counter()
    for i in range(FILER_HTTP_SMALL):
        body = rng.bytes(int(rng.integers(1, 512)))
        call(f"/17l/small/s{i}.txt", "POST", body, {"Content-Type": "text/plain"}, want=201)
        want[f"/17l/small/s{i}.txt"] = body
    tus_parts = 0
    for path, (n, how) in FILER_HTTP_SIZES.items():
        body = rng.bytes(n)
        if how == "multipart":
            payload, hdrs = multipart_upload(body, os.path.basename(path))
            call(path, "PUT", payload, hdrs, want=201)
        elif how == "chunked":
            # an iterable body with no length goes out with chunked transfer coding
            call(path, "PUT", iter([body[i:i + (1 << 20)] for i in range(0, n, 1 << 20)]),
                 {"Content-Type": "application/octet-stream"}, want=201)
        elif how == "tus":
            hdrs, _ = call(path, "POST", b"", {"Tus-Resumable": "1.0.0", "Upload-Length": str(n)},
                           want=201)
            loc = hdrs["Location"]
            cuts = [0, n // 3, 2 * n // 3, n]
            for lo, hi in zip(cuts, cuts[1:]):
                hdrs, _ = call(loc, "PATCH", body[lo:hi], {"Tus-Resumable": "1.0.0",
                                                          "Upload-Offset": str(lo)}, want=204)
                if int(hdrs["Upload-Offset"]) != hi:
                    raise AssertionError(f"17l: a PATCH ended at {hdrs['Upload-Offset']}, not {hi}")
                tus_parts += 1
            call(loc, "HEAD", headers={"Tus-Resumable": "1.0.0"}, want=404)  # completed
        else:
            call(path, "PUT", body, want=201)
        want[path] = body
    call("/17l/doomed/", "POST", b"", want=201)
    doomed = {}
    for i, n in enumerate(FILER_HTTP_DOOMED):
        doomed[f"/17l/doomed/d{i}.bin"] = rng.bytes(n)
        call(f"/17l/doomed/d{i}.bin", "PUT", doomed[f"/17l/doomed/d{i}.bin"], want=201)
    doomed_fids = [f for p in doomed for f in json.loads(call(p + "?chunks=true")[1])["chunks"]]
    call("/17l/moved/r0.bin?mv.from=/17l/raw/r0.bin", "POST", b"", want=200)
    want["/17l/moved/r0.bin"] = want.pop("/17l/raw/r0.bin")
    call("/17l/doomed", "DELETE", want=409)  # not empty
    call("/17l/doomed?recursive=true", "DELETE", want=204)
    t_last_write = time.perf_counter()
    write_s = t_last_write - t0
    written = sum(len(b) for b in want.values()) + sum(len(b) for b in doomed.values())
    fids = {p: json.loads(call(p + "?chunks=true")[1])["chunks"] for p in want}
    chunked = [p for p in want if fids[p]]
    vids = {FileId.parse(f).volume_id for fs in fids.values() for f in fs} | {
        FileId.parse(f).volume_id for f in doomed_fids}
    if len(vids) != 1:
        raise AssertionError(f"17l: the child's chunks spread over volumes {sorted(vids)}")
    (vid,) = vids
    (h,) = hx.lookup(vid)
    wait_until(lambda: all(http(f"http://{hx.url[h]}/{f}")[0] == 404 for f in doomed_fids),
               "the deleted directory's needles answering 404", phase="17l")

    # -- seal the collection, one data shard gone ------------------------------------
    dat = os.path.getsize(os.path.join(root, h, f"{FILER_HTTP_COLLECTION}_{vid}.dat"))
    n_batches = len(list(batch_plan(dat, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)))
    before = {n: hx.kernels(n)["launches"] for n in hx.up}
    t1 = time.perf_counter()
    out = run_command(hx.fenv, f"ec.encode -volumeId {vid} -collection {FILER_HTTP_COLLECTION}")
    enc_s = time.perf_counter() - t1
    if not re.fullmatch(rf"ec\.encode volume {vid}: generation \d+ on {re.escape(hx.url[h])}", out):
        raise AssertionError(f"17l: ec.encode answered {out!r}")
    wait_until(lambda: hx.spread(vid) == dict.fromkeys(range(ctx.total), h),
               "the child's volume's 14 shards listed at the holder", phase="17l")
    enc = hx.launched(before)
    if enc != {"gf2_apply": n_batches, "gf2_apply_planes": 0}:
        raise AssertionError(f"17l: ec.encode launched {enc} for {n_batches} batches")
    launches["gf2_apply"] += n_batches
    with grpc.insecure_channel(hx.gaddr[h]) as vch:
        rpc.volume_stub(vch).VolumeEcShardsUnmount(
            pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=[0]), timeout=30)
    wait_until(lambda: hx.alive() or 0 not in hx.ec_holders(hx.lead, vid),
               "shard 0 of the child's volume leaving the leader's listing", phase="17l")

    # -- every file back through the child, whole and in ranges ----------------------
    before = {n: hx.kernels(n)["launches"] for n in hx.up}
    loads0 = hx.kernels(h)["interval_cache"]["loads"]
    lat, ranges = [], 0
    t1 = time.perf_counter()
    for path, body in want.items():
        t2 = time.perf_counter()
        hdrs, got = call(path)
        if fids[path]:
            lat.append(time.perf_counter() - t2)
        if hashlib.sha256(got).hexdigest() != hashlib.sha256(body).hexdigest():
            raise AssertionError(f"17l: {path} read through the child differs from what was written")
        n = len(body)
        for rng_hdr, lo, hi in ((f"bytes={(4 << 20) - 100}-{(4 << 20) + 99}", (4 << 20) - 100,
                                 (4 << 20) + 100), ("bytes=-1000", max(n - 1000, 0), n),
                                (f"bytes={n // 2}-", n // 2, n)):
            if lo >= n:
                continue
            hdrs, got = call(path, headers={"Range": rng_hdr}, want=206)
            if got != body[lo:hi] or hdrs["Content-Range"] != f"bytes {lo}-{min(hi, n) - 1}/{n}":
                raise AssertionError(f"17l: {path} {rng_hdr} answered {hdrs['Content-Range']}")
            ranges += 1
        call(path, headers={"Range": f"bytes={n}-"}, want=416)
    read_s = time.perf_counter() - t1
    got = hx.launched(before)
    recon = hx.kernels(h)["interval_cache"]["loads"] - loads0
    if got["gf2_apply_planes"] != recon or recon < 1 or got["gf2_apply"]:
        raise AssertionError(f"17l: the reads through the child launched {got} for {recon} "
                             "reconstructions")
    launches["gf2_apply_planes"] += recon

    # -- the webhook's events are the meta tail's ------------------------------------
    tail = json.loads(call("/~meta/tail?sinceNs=0&limit=1000000")[1])
    wait_until(lambda: hx.alive() or len(sink.events) >= len(tail["events"]),
               "the webhook sink receiving every event", phase="17l")
    with sink.lock:
        events, last_at = list(sink.events), sink.last_at
    if events != tail["events"] or tail["droppedBeforeTsNs"] != 0:
        raise AssertionError(f"17l: the sink holds {len(events)} events, the tail "
                             f"{len(tail['events'])}; they differ")

    # -- the shell in this process, at the child -------------------------------------
    env = ShellEnv(hx.lead, f"127.0.0.1:{fport}")
    dlm = DlmClient([f"127.0.0.1:{fport + 10000}"])
    before = {n: hx.kernels(n)["launches"] for n in hx.up}
    loads0 = hx.kernels(h)["interval_cache"]["loads"]
    t1 = time.perf_counter()
    try:
        listing = json.loads(call("/17l")[1])["Entries"]
        files = {p: len(b) for p, b in want.items() if p.count("/") == 2}
        if {e["FullPath"]: e["FileSize"] for e in listing if not e["IsDirectory"]} != files:
            raise AssertionError(f"17l: the listing of /17l holds {listing}")
        expect = {
            "fs.ls /17l": "\n".join(f"{'d' if e['IsDirectory'] else '-'} {e['FileSize']:>12} "
                                    f"{e['FullPath']}" for e in listing),
            "fs.du /17l": f"{sum(len(b) for b in want.values()):,} bytes in {len(want)} files, "
                          "3 directories under /17l",
            "cluster.lock.ring": "no live leases",
        }
        # volume.fsck reads each chunk through ReadNeedle on a channel with
        # gRPC's default 4 MiB receive limit, in both packages: a 4 MiB
        # chunk answers RESOURCE_EXHAUSTED (ROADMAP Queue 3), so it checks
        # the directories whose chunks are smaller
        for d in ("/17l/raw", "/17l/moved", "/17l/small"):
            under = [p for p in want if p.startswith(d + "/")]
            expect[f"volume.fsck -path {d}"] = (
                f"fsck: {len(under)} entries, {sum(len(fids[p]) for p in under)} chunk references "
                "checked\nno broken chunk references")
        for p in chunked:
            expect[f"fs.verify {p}"] = (f"{p}: {len(want[p])} bytes readable, md5 "
                                        f"{hashlib.md5(want[p]).hexdigest()}")
        shell = {}
        for cmd, line in expect.items():
            shell[cmd] = run_command(env, cmd)
            if shell[cmd] != line:
                raise AssertionError(f"17l: {cmd} answered {shell[cmd]!r}, not {line!r}")
        lease = dlm.lock("17l/lock", "smoke", ttl=30.0)
        ring = run_command(env, "cluster.lock.ring")
        if not lease.ok or not re.fullmatch(r"17l/lock +smoke +\d+\.\ds", ring):
            raise AssertionError(f"17l: the lease {lease} and cluster.lock.ring {ring!r}")
        if not dlm.unlock("17l/lock", lease.token).ok or \
                run_command(env, "cluster.lock.ring") != "no live leases":
            raise AssertionError("17l: the lease was not given back through the ring")
    finally:
        dlm.close()
        env.close()
    shell_s = time.perf_counter() - t1
    got = hx.launched(before)
    recon2 = hx.kernels(h)["interval_cache"]["loads"] - loads0
    if got["gf2_apply_planes"] != recon2 or got["gf2_apply"]:
        raise AssertionError(f"17l: the shell's reads launched {got} for {recon2} reconstructions")
    launches["gf2_apply_planes"] += recon2
    step = {
        "child_start_to_serving_s": serving["serving_s"], "files": len(want),
        "chunked_files": len(chunked), "small_files": FILER_HTTP_SMALL, "tus_patches": tus_parts,
        "chunks": sum(len(f) for f in fids.values()), "bytes": written,
        "write_seconds": write_s, "write_mb_per_s": written / write_s / 1e6,
        "volume": vid, "holder": h, "dat_size": dat, "encode_seconds": enc_s,
        "encode_launches": n_batches, "read_seconds": read_s, "ranges": ranges,
        "read_mb_per_s": sum(len(want[p]) for p in chunked) / sum(lat) / 1e6,
        "degraded_read_p50_ms": percentile_ms(lat, 50),
        "degraded_read_p99_ms": percentile_ms(lat, 99), "reconstructions": recon,
        "shell_reconstructions": recon2, "events": len(events),
        "last_webhook_after_last_write_s": last_at - t_last_write, "shell_seconds": shell_s,
        "seconds_after_serving": time.perf_counter() - t_all}
    return step, launches


S3_BUCKET = "has3"  # 17m: the bucket, and the collection its objects go to (bodies of SEED + 22)
S3_OBJECTS = {  # 17m: the chunked objects (4 MiB chunks) and how each is sealed (about 16 MiB)
    "obj/plain.bin": ((3 << 20) + 4321, "chunked"), "obj/sse-s3-a.bin": ((9 << 19) + 77, "sse-s3"),
    "obj/sse-s3-b.bin": ((5 << 20) - 555, "sse-s3"), "obj/sse-c.bin": ((7 << 19) + 9, "sse-c")}
S3_SMALL = 6  # 17m: objects under the inline limit, in their entries
S3_VERSIONS = (256 << 10, 192 << 10, 320 << 10)  # 17m: one key written three times


def s3_check(root: str, ctx, hx) -> tuple[dict, dict]:
    """17m: S3's libraries and the shell's s3.* commands over a pair of port
    Filers on phase 17's cluster, in this process (A on an SSTableStore,
    served over gRPC at a port the shell dials; B on a SqliteStore,
    following A through a MetaAggregator). The shell's s3.configure,
    s3.accesskey.create, s3.policy.put/.get, s3.user.list and
    s3.bucket.create against A; the minted keys read back through
    `FilerIdentityStore(A)`: a request signed by `sign_v4` passes
    `verify_v4`, a tampered byte and a stale X-Amz-Date fail with the JAX
    codes, a presigned URL verifies, the attached policy allows and denies
    through iam/policy, and an `assume_role` credential works until its
    expiry. About 16 MiB of objects written through A into /buckets/<b>
    with collection <b>, as the gateway stores them: two sealed under
    SSE-S3 (a `LocalKeyring` in A's KV), one under SSE-C, one sent through
    aws-chunked with its chunk signatures verified, small ones inlined,
    and one key written three times under versioning with a delete marker
    and `promote_latest`. s3.bucket.quota.set/.get/.enforce: the usage is
    the bytes stored, the exceeded flag set once the quota is below it.
    The shell's ec.encode seals the bucket's volume (the holder launches
    gf2_apply once per batch), data shard 0 is unmounted, and every object
    reads back through B, whole and in one range, decrypted by
    `read_decrypted`, sha256-equal: gf2_apply_planes launches == the
    holder's interval-cache loads. s3.clean.uploads removes a stale upload,
    s3.bucket.delete -force drops the bucket and its collection, and
    s3.bucket.list and the master no longer name it. Returns (the step's
    numbers, launches)."""
    import types
    from concurrent import futures as cf

    import grpc

    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.filer import Filer, SqliteStore, SSTableStore
    from seaweedfs_tpu_torch.filer.entry import new_entry
    from seaweedfs_tpu_torch.filer.grpc_service import FilerGrpcService
    from seaweedfs_tpu_torch.filer.meta_aggregator import MetaAggregator
    from seaweedfs_tpu_torch.filer.meta_log import MetaLog
    from seaweedfs_tpu_torch.iam import policy, sts
    from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.s3 import auth, chunked, config, sse, versioning
    from seaweedfs_tpu_torch.shell.commands import ShellEnv, run_command
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.utils import urls

    t_all = time.perf_counter()
    d = os.path.join(root, "s3")
    b = S3_BUCKET
    launches = {"gf2_apply": 0, "gf2_apply_planes": 0}
    walls: dict = {}
    plain_connection = urls.connection
    urls.connection = redial_connection
    servers, filers, logs, agg, env = [], [], [], None, None
    redials0 = CONNECT_RETRIES[0]

    def shell(line: str, want: str | None = None, pattern: str | None = None) -> str:
        out = run_command(env, line)
        if (want is not None and out != want) or (pattern is not None and not re.fullmatch(
                pattern, out, re.DOTALL)):
            raise AssertionError(f"17m: {line.split(' -policy')[0]} answered {out!r}")
        return out

    def refused(code: str, fn, *args):
        try:
            fn(*args)
        except auth.S3AuthError as e:
            if e.code != code:
                raise AssertionError(f"17m: refused with {e.code}, not {code}: {e}") from None
            return
        raise AssertionError(f"17m: a request that must fail with {code} passed")

    try:
        t0 = time.perf_counter()
        fport = server_port()

        def hosted(name: str, store, grpc_addr: str):
            f = Filer(store, master=hx.lead)
            ml = MetaLog(os.path.join(d, name, "meta"))
            f.subscribe(ml)
            srv = grpc.server(cf.ThreadPoolExecutor(max_workers=8))
            rpc.add_service(srv, rpc.FILER_SERVICE, FilerGrpcService(f, ml))
            port = srv.add_insecure_port(grpc_addr)
            srv.start()
            servers.append(srv)
            filers.append(f)
            logs.append(ml)
            return f, f"127.0.0.1:{port}"

        # A's gRPC at the filer port + 10000, where the shell dials a filer
        a, a_addr = hosted("a", SSTableStore(os.path.join(d, "a", "store")),
                           f"127.0.0.1:{fport + 10000}")
        fb, _ = hosted("b", SqliteStore(os.path.join(d, "b", "filer.db")), "127.0.0.1:0")
        agg = MetaAggregator(fb, [a_addr], client_name="17m")
        agg.start()
        env = ShellEnv(hx.lead, f"127.0.0.1:{fport}")
        walls["filers"] = time.perf_counter() - t0

        # -- identities through the shell ------------------------------------------
        t0 = time.perf_counter()
        doc = {"Version": "2012-10-17", "Statement": [
            {"Effect": "Allow", "Action": ["s3:GetObject", "s3:PutObject", "s3:ListBucket"],
             "Resource": [f"arn:aws:s3:::{b}", f"arn:aws:s3:::{b}/*"]},
            {"Effect": "Allow", "Action": "sts:AssumeRole", "Resource": "arn:aws:iam:::role/*"},
            {"Effect": "Deny", "Action": "s3:DeleteObject", "Resource": "*"}]}
        shell("s3.user.list", "no identities configured (gateway is in open mode)")
        shell("s3.configure -user admin -access_key SWADMIN17M -secret_key admin17m-secret "
              "-actions Admin", "configured admin")
        minted = shell("s3.accesskey.create -user alice -actions Read",
                       pattern=r"user=alice\naccess_key=SW[0-9A-F]{18}\nsecret_key=\S{40}")
        ak = minted.split("access_key=")[1].split("\n")[0]
        sk = minted.split("secret_key=")[1]
        shell(f"s3.policy.put -user alice -policy '{json.dumps(doc)}'",
              "policy attached to alice (1 credential(s))")
        if json.loads(shell("s3.policy.get -user alice")) != [doc]:
            raise AssertionError("17m: s3.policy.get gives another document back")
        shell("s3.user.list", f"{'admin':20s} {'SWADMIN17M':24s} Admin\n"
              f"{'alice':20s} {ak:24s} policies:1")
        shell(f"s3.bucket.create -name {b}", f"created bucket {b}")
        shell(f"s3.bucket.create -name {b}", f"bucket {b} exists")
        walls["identities"] = time.perf_counter() - t0

        # -- the keys read back, SigV4, presigned URLs, policies and STS -----------
        t0 = time.perf_counter()
        roles = sts.StsService()
        ids = config.FilerIdentityStore(a, base=auth.IdentityStore(sts=roles), ttl=0.0)
        alice = ids.lookup(ak)
        if alice is None or alice.secret_key != sk or list(alice.policies) != [doc] or \
                ids.lookup("SWADMIN17M").actions != ("Admin",):
            raise AssertionError(f"17m: FilerIdentityStore reads {alice}")
        host = {"host": f"127.0.0.1:{fport}"}
        path, query = f"/{b}/obj/plain.bin", "partNumber=1&uploadId=17m"
        h = auth.sign_v4("PUT", path, query, access_key=ak, secret_key=sk, headers=host,
                         payload_hash="UNSIGNED-PAYLOAD")
        if auth.verify_v4(ids, "PUT", path, query, h, "UNSIGNED-PAYLOAD").name != "alice":
            raise AssertionError("17m: verify_v4 names another identity")
        refused("SignatureDoesNotMatch", auth.verify_v4, ids, "PUT", path.replace("plain", "plaim"),
                query, h, "UNSIGNED-PAYLOAD")
        stale = auth.sign_v4("GET", path, access_key=ak, secret_key=sk, headers=host,
                             payload_hash="UNSIGNED-PAYLOAD",
                             amz_date=time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(time.time() - 1200)))
        refused("RequestTimeTooSkewed", auth.verify_v4, ids, "GET", path, "", stale,
                "UNSIGNED-PAYLOAD")
        presigned = presign_v4("GET", path, ak, sk, host["host"], 300)
        if auth.verify_v4(ids, "GET", path, presigned, host, "").name != "alice":
            raise AssertionError("17m: the presigned URL does not verify")
        refused("SignatureDoesNotMatch", auth.verify_v4, ids, "GET", path + "x", presigned, host, "")
        verdicts = {}
        for method, key, q in (("GET", "obj/plain.bin", {}), ("PUT", "obj/x", {}),
                               ("DELETE", "obj/plain.bin", {}), ("GET", "", {}),
                               ("PUT", "", {"policy": ""})):
            action, resource = policy.s3_action_and_resource(method, b, key, q)
            verdicts[action] = policy.evaluate_policies_verdict(alice.policies, action, resource)
        other = policy.evaluate_policies(alice.policies, *policy.s3_action_and_resource(
            "GET", "otherbucket", "k", {}))
        if verdicts != {"s3:GetObject": "allow", "s3:PutObject": "allow",
                        "s3:DeleteObject": "deny", "s3:ListBucket": "allow",
                        "s3:PutBucketPolicy": None} or other:
            raise AssertionError(f"17m: the policy's verdicts are {verdicts}, other bucket {other}")
        roles.put_role(sts.Role("uploader", policies=[doc], trusted=[ak]))
        cred = roles.assume_role(ak, list(alice.policies), "uploader", duration=900)
        th = auth.sign_v4("GET", path, access_key=cred.access_key, secret_key=cred.secret_key,
                          headers={**host, "x-amz-security-token": cred.session_token},
                          payload_hash="UNSIGNED-PAYLOAD")
        if auth.verify_v4(ids, "GET", path, "", th, "UNSIGNED-PAYLOAD").name != "sts:uploader":
            raise AssertionError("17m: the assumed role's credential does not verify")
        tokenless = auth.sign_v4("GET", path, access_key=cred.access_key,
                                 secret_key=cred.secret_key, headers=host,
                                 payload_hash="UNSIGNED-PAYLOAD")
        refused("InvalidToken", auth.verify_v4, ids, "GET", path, "", tokenless, "UNSIGNED-PAYLOAD")
        real_time = sts.time
        try:  # the STS clock past the credential's expiry
            for ahead, ok in ((cred.expires_at - time.time() - 5, True),
                              (cred.expires_at - time.time() + 1, False)):
                sts.time = types.SimpleNamespace(time=lambda a=ahead: real_time.time() + a,
                                                 time_ns=real_time.time_ns)
                if ok:
                    auth.verify_v4(ids, "GET", path, "", th, "UNSIGNED-PAYLOAD")
                else:
                    refused("InvalidAccessKeyId", auth.verify_v4, ids, "GET", path, "", th,
                            "UNSIGNED-PAYLOAD")
        finally:
            sts.time = real_time
        walls["auth"] = time.perf_counter() - t0

        # -- the bucket's objects, as the gateway stores them ----------------------
        rng = np.random.default_rng(SEED + 22)
        keyring = sse.load_or_create_keyring(a.store.kv_get, a.store.kv_put, a.store.kv_put_if_absent)
        ssec_key = rng.bytes(32)
        plain: dict = {}  # object path -> its plaintext
        stored_bytes = 0
        t0 = time.perf_counter()
        for i in range(S3_SMALL):
            body = rng.bytes(int(rng.integers(1, 400)))
            e = a.write_file(f"/buckets/{b}/small/s{i}.txt", body, collection=b)
            if e.chunks:
                raise AssertionError(f"17m: a {len(body)}-byte object was not inlined")
            plain[e.full_path] = body
            stored_bytes += len(body)
        for key, (n, how) in S3_OBJECTS.items():
            body = rng.bytes(n)
            data = body
            ssec, algo = (ssec_key, "") if how == "sse-c" else (None, "AES256" if how == "sse-s3"
                                                                else "")
            if how == "chunked":  # aws-chunked, each chunk's signature checked
                sh = auth.sign_v4("PUT", f"/{b}/{key}", access_key=ak, secret_key=sk,
                                  headers={**host, "x-amz-decoded-content-length": str(n)},
                                  payload_hash="STREAMING-AWS4-HMAC-SHA256-PAYLOAD")
                _, sctx = auth.verify_v4_ex(ids, "PUT", f"/{b}/{key}", "", sh,
                                            "STREAMING-AWS4-HMAC-SHA256-PAYLOAD")
                wire = chunked.encode_aws_chunked(body, sctx, chunk_size=64 << 10)
                data = chunked.decode_aws_chunked(wire, sctx, signed=True)
                bad = bytearray(wire)
                bad[len(wire) // 2] ^= 1
                refused("SignatureDoesNotMatch", chunked.decode_aws_chunked, bytes(bad), sctx, True)
            ct, ext, _ = sse.encrypt_for_put(data, ssec, algo, keyring)
            e = a.write_file(f"/buckets/{b}/{key}", ct, collection=b, extended=ext)
            if [c.size for c in e.chunks] != [min(4 << 20, n - off) for off in range(0, n, 4 << 20)]:
                raise AssertionError(f"17m: {key} landed in chunks {[c.size for c in e.chunks]}")
            if (how != "chunked") != (ct != body):
                raise AssertionError(f"17m: {key} was stored {'in clear' if ct == body else 'sealed'}")
            plain[e.full_path] = body
            stored_bytes += len(ct)
        vkey = "ver/k.bin"
        vids_written = []
        for n in S3_VERSIONS:
            body = rng.bytes(n)
            vid = versioning.new_version_id()
            versioning.archive_current(a, "/buckets", b, vkey)
            e = a.write_file(f"/buckets/{b}/{vkey}", body, collection=b, inline=False,
                             extended={versioning.VID_KEY: vid.encode()})
            vids_written.append(vid)
            plain[f"/buckets/{b}/{versioning.VERSIONS_DIR}/{vkey}/{vid}"] = body
            stored_bytes += n
        marker = versioning.write_delete_marker(a, "/buckets", b, vkey, "Enabled")
        if not versioning.is_delete_marker(a.find_entry(f"/buckets/{b}/{vkey}")):
            raise AssertionError("17m: the delete marker is not the current version")
        a.delete_entry(f"/buckets/{b}/{vkey}")
        if not versioning.promote_latest(a, "/buckets", b, vkey):
            raise AssertionError("17m: promote_latest found no version")
        latest = vids_written[-1]
        plain[f"/buckets/{b}/{vkey}"] = plain.pop(f"/buckets/{b}/{versioning.VERSIONS_DIR}/"
                                                 f"{vkey}/{latest}")
        left = [versioning.entry_vid(x) for x in versioning.iter_versions(a, "/buckets", b, vkey)]
        if left != vids_written[-2::-1] or \
                versioning.entry_vid(a.find_entry(f"/buckets/{b}/{vkey}")) != latest:
            raise AssertionError(f"17m: the versions left are {left}, the current "
                                 f"{versioning.entry_vid(a.find_entry(f'/buckets/{b}/{vkey}'))}")
        write_s = time.perf_counter() - t0
        walls["write"] = write_s
        vols = set()
        for p in plain:
            vols |= {FileId.parse(c.fid).volume_id for c in a.find_entry(p).chunks}
        if len(vols) != 1:
            raise AssertionError(f"17m: the bucket's chunks spread over volumes {sorted(vols)}")
        (vid,) = vols
        (holder,) = hx.lookup(vid)

        # -- quotas ----------------------------------------------------------------
        t0 = time.perf_counter()
        quota_get = f"{b}: quota {stored_bytes * 2:,} bytes, usage {stored_bytes:,} (50.0%)"
        shell(f"s3.bucket.quota.set -name {b} -bytes {stored_bytes * 2}",
              f"quota for {b}: {stored_bytes * 2:,} bytes")
        shell(f"s3.bucket.quota.get -name {b}", quota_get)
        shell("s3.bucket.quota.enforce", f"{b}: ok ({stored_bytes:,} / {stored_bytes * 2:,})")
        if a.store.kv_get(f"quota-exceeded/{b}".encode()) not in (b"", None):
            raise AssertionError("17m: the exceeded flag is set under the quota")
        shell(f"s3.bucket.quota.set -name {b} -bytes {stored_bytes - 1}",
              f"quota for {b}: {stored_bytes - 1:,} bytes")
        shell("s3.bucket.quota.enforce",
              f"{b}: OVER quota ({stored_bytes:,} > {stored_bytes - 1:,}) — writes blocked")
        if a.store.kv_get(f"quota-exceeded/{b}".encode()) != b"1":
            raise AssertionError("17m: the exceeded flag is not set over the quota")
        walls["quota"] = time.perf_counter() - t0

        # -- seal the bucket's volume, data shard 0 gone, read through B -----------
        def namespace(f, top: str) -> list:
            out = []
            for x in f.store.list(top, limit=100_000):
                out.append((x.full_path, x.to_proto().SerializeToString(deterministic=True)))
                if x.is_directory:
                    out += namespace(f, x.full_path)
            return out

        t0 = time.perf_counter()
        ns = namespace(a, "/buckets")
        wait_until(lambda: namespace(fb, "/buckets") == ns, "B listing A's buckets", phase="17m")
        walls["converge"] = time.perf_counter() - t0
        dat = os.path.getsize(os.path.join(root, holder, f"{b}_{vid}.dat"))
        n_batches = len(list(batch_plan(dat, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)))
        before = {n: hx.kernels(n)["launches"] for n in hx.up}
        t0 = time.perf_counter()
        out = run_command(hx.fenv, f"ec.encode -volumeId {vid} -collection {b}")
        if not re.fullmatch(rf"ec\.encode volume {vid}: generation \d+ on {re.escape(hx.url[holder])}",
                            out):
            raise AssertionError(f"17m: ec.encode answered {out!r}")
        wait_until(lambda: hx.spread(vid) == dict.fromkeys(range(ctx.total), holder),
                   "the bucket volume's 14 shards listed at the holder", phase="17m")
        walls["encode"] = time.perf_counter() - t0
        enc = hx.launched(before)
        if enc != {"gf2_apply": n_batches, "gf2_apply_planes": 0}:
            raise AssertionError(f"17m: ec.encode launched {enc} for {n_batches} batches")
        launches["gf2_apply"] += n_batches
        with grpc.insecure_channel(hx.gaddr[holder]) as vch:
            rpc.volume_stub(vch).VolumeEcShardsUnmount(
                pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=[0]), timeout=30)
        wait_until(lambda: hx.alive() or 0 not in hx.ec_holders(hx.lead, vid),
                   "shard 0 of the bucket volume leaving the leader's listing", phase="17m")
        before = {n: hx.kernels(n)["launches"] for n in hx.up}
        loads0 = hx.kernels(holder)["interval_cache"]["loads"]
        lat, read_bytes = [], 0
        t0 = time.perf_counter()
        for p, body in plain.items():
            e = fb.find_entry(p)
            key = sse.decrypt_key_for_entry(e, ssec_key if sse.entry_sse_algo(e) == "SSE-C" else None,
                                            keyring)
            t1 = time.perf_counter()
            if key is None:
                got = fb.read_entry(e)
            else:
                got = sse.read_decrypted(lambda o, n, e=e: fb.read_entry(e, o, n), e, key, 0, -1)
            lat.append(time.perf_counter() - t1)
            read_bytes += len(got)
            off = int(rng.integers(0, len(body)))
            size = int(rng.integers(1, len(body) - off + 1))
            part = (fb.read_entry(e, off, size) if key is None else
                    sse.read_decrypted(lambda o, n, e=e: fb.read_entry(e, o, n), e, key, off, size))
            if hashlib.sha256(got).digest() != hashlib.sha256(body).digest() or \
                    part != body[off:off + size]:
                raise AssertionError(f"17m: {p} read through B differs from what was written")
        walls["read"] = time.perf_counter() - t0
        got = hx.launched(before)
        recon = hx.kernels(holder)["interval_cache"]["loads"] - loads0
        if got["gf2_apply_planes"] != recon or recon < 1 or got["gf2_apply"]:
            raise AssertionError(f"17m: the reads through B launched {got} for {recon} "
                                 "reconstructions")
        launches["gf2_apply_planes"] += recon

        # -- clean-up --------------------------------------------------------------
        t0 = time.perf_counter()
        up = new_entry(f"/buckets/{b}/.uploads/17m-stale", is_directory=True)
        up.attr.mtime = int(time.time()) - 2 * 86400
        a.create_entry(up)
        shell("s3.clean.uploads", f"{b}/17m-stale")
        if a.exists(up.full_path):
            raise AssertionError("17m: s3.clean.uploads left the stale upload")
        shell(f"s3.bucket.delete -name {b}", f"error: bucket {b} not empty (use -force)")
        shell(f"s3.bucket.delete -name {b} -force", f"deleted bucket {b}")
        shell("s3.bucket.list", "no buckets")
        wait_until(lambda: not hx.ec_holders(hx.lead, vid) and
                   b not in run_command(hx.fenv, "collection.list").split(),
                   "the master listing nothing of the bucket's collection", phase="17m")
        walls["clean_up"] = time.perf_counter() - t0
        step = {
            "objects": len(plain), "chunked_objects": len(S3_OBJECTS), "small_objects": S3_SMALL,
            "versions": len(S3_VERSIONS), "delete_marker": marker, "bytes": stored_bytes,
            "write_mb_per_s": stored_bytes / write_s / 1e6,
            "read_mb_per_s": read_bytes / sum(lat) / 1e6,
            "read_p50_ms": percentile_ms(lat, 50), "read_p99_ms": percentile_ms(lat, 99),
            "volume": vid, "holder": holder, "dat_size": dat, "encode_launches": n_batches,
            "reconstructions": recon, "walls": walls, "applied_by_b": agg.applied,
            "redials": CONNECT_RETRIES[0] - redials0, "seconds": time.perf_counter() - t_all}
    finally:
        urls.connection = plain_connection
        if env is not None:
            env.close()
        if agg is not None:
            agg.stop()
        for srv in servers:
            srv.stop(grace=None)
        for f in filers:
            f.close()
        for ml in logs:
            ml.close()
    return step, launches


def presign_v4(method: str, path: str, ak: str, sk: str, host: str, expires: int) -> str:
    """17m: a presigned URL's query, signed as an SDK signs it (this
    smoke's own signer, not the port's)."""
    import hmac
    from urllib.parse import quote, urlencode

    amz = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    scope = f"{amz[:8]}/us-east-1/s3/aws4_request"
    q = {"X-Amz-Algorithm": "AWS4-HMAC-SHA256", "X-Amz-Credential": f"{ak}/{scope}",
         "X-Amz-Date": amz, "X-Amz-Expires": str(expires), "X-Amz-SignedHeaders": "host"}
    qs = urlencode(sorted(q.items()), quote_via=lambda s, *a: quote(s, safe="-_.~"))
    creq = "\n".join([method, quote(path, safe="/-_.~"), qs, f"host:{host}\n", "host",
                      "UNSIGNED-PAYLOAD"])
    sts = "\n".join(["AWS4-HMAC-SHA256", amz, scope, hashlib.sha256(creq.encode()).hexdigest()])
    k = ("AWS4" + sk).encode()
    for part in (amz[:8], "us-east-1", "s3", "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return qs + "&X-Amz-Signature=" + hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()


def images_have_pil() -> bool:
    import importlib.util

    return importlib.util.find_spec("PIL") is not None


def seeded_images(rng) -> dict:
    """17j's seeded PNG and JPEG, {format: (bytes, mime)}, each of 200x160
    random pixels (PIL). Where the host has no PIL, seeded bodies behind
    each format's magic bytes: no decoder opens them, so the server serves
    them whole, as the reference does."""
    pixels = rng.integers(0, 256, (160, 200, 3), dtype=np.uint8)
    out = {}
    for fmt in ("PNG", "JPEG"):
        if images_have_pil():
            import io

            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(pixels, "RGB").save(buf, fmt)
            body = buf.getvalue()
        else:
            body = {"PNG": b"\x89PNG", "JPEG": b"\xff\xd8\xff"}[fmt] + pixels.tobytes()
        out[fmt] = (body, f"image/{fmt.lower()}")
    return out


TOOLS_DELETES = 5  # needles deleted in the scratch copy before `tools compact`


def tools_phase(src) -> dict:
    """The offline tools, each a child started by name (`python3 -m
    seaweedfs_tpu_torch.tools`), on 17j's scratch copy of its plain volume
    (`src`: the directory, the volume id and {needle id: body}): `fix`
    rebuilds an .idx byte-identical to the server's (the volume has no
    deletes, its ids ascend), `scan` lists every record with a good CRC,
    `export` writes a tar whose members are the needles, `python3 -m
    seaweedfs_tpu_torch.server scaffold -config security -output D` writes
    a TOML that the port's config loader reads (these four at once), and
    after TOOLS_DELETES deletes `compact` reclaims them and leaves a volume
    the port's `Volume` reads needle for needle."""
    import tarfile

    from seaweedfs_tpu_torch.storage.volume import Volume
    from seaweedfs_tpu_torch.utils import config

    d, vid, bodies = src
    base = os.path.join(d, f"{HA_FAST_COLLECTION}_{vid}")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    secs = {}

    def by_name(module: str, *args) -> str:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", module, *args], env=env, capture_output=True,
                           text=True, timeout=120)
        secs[args[0]] = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"tools: {module} {args[0]} exited {p.returncode}: "
                                 f"{p.stderr[-2000:]}")
        return p.stdout

    def tool(cmd: str, *args) -> str:
        return by_name("seaweedfs_tpu_torch.tools", cmd, "-dir", d, "-volumeId", str(vid),
                       "-collection", HA_FAST_COLLECTION, *args)

    with open(base + ".idx", "rb") as f:
        original = f.read()
    os.unlink(base + ".idx")
    tar = os.path.join(d, "export.tar")
    cfg_dir = os.path.join(d, "scaffold")
    os.makedirs(cfg_dir)
    # fix writes the .idx, scan and export read the .dat only: all at once
    with ThreadPoolExecutor(4) as ex:
        runs = [ex.submit(tool, "fix"), ex.submit(tool, "scan"), ex.submit(tool, "export", "-o", tar),
                ex.submit(by_name, "seaweedfs_tpu_torch.server", "scaffold", "-config", "security",
                          "-output", cfg_dir)]
        out, scanned, exported, scaffolded = (r.result() for r in runs)
    with open(base + ".idx", "rb") as f:
        rebuilt = f.read()
    if rebuilt != original or out != (f"rebuilt {base}.idx from {len(bodies)} records "
                                      f"({len(bodies)} live entries)\n"):
        raise AssertionError(f"tools: fix answered {out!r}; the .idx is "
                             f"{'the same' if rebuilt == original else 'different'}")
    lines = scanned.splitlines()
    puts = [ln for ln in lines[1:] if ln.startswith("PUT ") and not ln.endswith("CRC-BAD")]
    if not lines[0].startswith("superblock: version=3") or len(puts) != len(lines) - 1 != len(bodies):
        raise AssertionError(f"tools: scan listed {len(lines) - 1} records, {len(puts)} good "
                             f"puts, for {len(bodies)} needles")
    out = exported
    with tarfile.open(tar) as t:
        members = {m.name: t.extractfile(m).read() for m in t.getmembers()}
    os.unlink(tar)
    if out != f"exported {len(bodies)} files -> {tar}\n" or members != {
            f"{nid:x}": body for nid, body in bodies.items()}:
        raise AssertionError(f"tools: export answered {out!r}; its members are not the needles")
    gone = sorted(bodies)[:: max(len(bodies) // TOOLS_DELETES, 1)][:TOOLS_DELETES]
    v = Volume(d, vid, collection=HA_FAST_COLLECTION, create=False)
    for nid in gone:
        v.delete_needle(nid)
    v.close()
    size = os.path.getsize(base + ".dat")
    out = tool("compact")
    m = re.fullmatch(rf"compacted volume {vid}: reclaimed (\d+) bytes\n", out)
    v = Volume(d, vid, collection=HA_FAST_COLLECTION, create=False)
    try:
        kept = [nid for nid in bodies if nid not in gone]
        if m is None or int(m[1]) < sum(len(bodies[n]) for n in gone) or any(
                v.has_needle(nid) for nid in gone) or any(
                v.read_needle(nid).data != bodies[nid] for nid in kept):
            raise AssertionError(f"tools: compact answered {out!r}; the volume does not read back")
    finally:
        v.close()
    out = scaffolded
    cfg = config.load_config("security", [cfg_dir])
    if out != os.path.join(cfg_dir, "security.toml") + "\n" or cfg.get(
            "jwt.signing.expires_after_seconds") != 10 or cfg.get_str("https.default.cert") != "":
        raise AssertionError(f"tools: scaffold answered {out!r}; the loader read {cfg.data}")
    return {"needles": len(bodies), "dat_bytes": size, "deleted": len(gone),
            "compacted_bytes": os.path.getsize(base + ".dat"), "seconds": secs,
            "idx_byte_identical": True}


TLS_BYTES = 16 << 20  # phase 18: needles written over https (bodies of SEED + 23)
TLS_LOST = 0  # phase 18: the data shard unmounted before the degraded GETs


def tls_certs(d: str) -> tuple[str, str, str, str]:
    """(cert, key, ca, minted by) under `d`: the port's generate_self_signed
    where `cryptography` imports, else `openssl req` and `openssl x509`."""
    try:
        from seaweedfs_tpu_torch.utils.tls import generate_self_signed

        c = generate_self_signed(d)
        return c.cert_file, c.key_file, c.ca_file, "generate_self_signed"
    except ImportError:
        pass
    os.makedirs(d, exist_ok=True)
    p = {n: os.path.join(d, n) for n in ("ca.crt", "ca.key", "server.crt", "server.key",
                                          "server.csr", "san.cnf")}
    with open(p["san.cnf"], "w") as f:
        f.write("subjectAltName=DNS:localhost,IP:127.0.0.1\n")
    ec = ["-newkey", "ec", "-pkeyopt", "ec_paramgen_curve:prime256v1", "-nodes"]
    for cmd in (
        ["req", "-x509", *ec, "-keyout", p["ca.key"], "-out", p["ca.crt"], "-days", "1",
         "-subj", "/CN=seaweedfs-tpu smoke CA"],
        ["req", *ec, "-keyout", p["server.key"], "-out", p["server.csr"], "-subj", "/CN=localhost"],
        ["x509", "-req", "-in", p["server.csr"], "-CA", p["ca.crt"], "-CAkey", p["ca.key"],
         "-CAcreateserial", "-out", p["server.crt"], "-days", "1", "-extfile", p["san.cnf"]],
    ):
        subprocess.run(["openssl", *cmd], check=True, capture_output=True, timeout=60)
    return p["server.crt"], p["server.key"], p["ca.crt"], "openssl"


class TlsChild:
    """Phase 18's `python3 -m seaweedfs_tpu_torch.server server -tls.cert
    -tls.key -tls.ca` child (mutual TLS), started ahead of the phase so
    that its imports overlap the tools check; `stop` sends SIGTERM and
    returns its exit code (None where it was killed)."""

    def __init__(self, work: str):
        self.t0 = time.perf_counter()
        self.root = os.path.join(work, "tls")
        os.makedirs(os.path.join(self.root, "d"))
        self.cert, self.key, self.ca, self.minted = tls_certs(os.path.join(self.root, "certs"))
        self.mport, self.vport = server_port(), server_port()
        self.log = open(os.path.join(self.root, "server.log"), "wb")
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.server", "server", "-ip", "127.0.0.1",
             "-masterPort", str(self.mport), "-port", str(self.vport), "-dir",
             os.path.join(self.root, "d"), "-tls.cert", self.cert, "-tls.key", self.key,
             "-tls.ca", self.ca],
            cwd=self.root, env=env, stdout=self.log, stderr=subprocess.STDOUT)

    def stop(self) -> int | None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=CHILD_STOP_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=CHILD_STOP_S)
            rc = None
        self.log.close()
        return rc


def tls_phase(child: TlsChild, ctx) -> tuple[dict, dict]:
    """Phase 18: a TLS cluster. The `TlsChild` (mutual TLS) and this
    process switched to https with `enable_https(ca, cert, key)`: TLS_BYTES of
    seeded needles assigned and POSTed over https, the port shell's
    `ec.encode` (`gf2_apply` launches at the child == batches), data shard
    TLS_LOST unmounted and degraded GETs of every needle over it, over
    https, byte-exact (`gf2_apply_planes` launches == its interval-cache
    loads); a client without a certificate and a plaintext client are both
    refused. The scheme goes back to http in `finally`; the caller stops
    the child. Returns (result, launches)."""
    import ssl

    import grpc

    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.shell.commands import ShellEnv, run_command
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.types import NeedleValue, actual_offset
    from seaweedfs_tpu_torch.utils import urls

    t_phase = time.perf_counter()
    root, proc, mport, vport, ca = child.root, child.proc, child.mport, child.vport, child.ca
    murl, vurl = f"https://127.0.0.1:{mport}", f"https://127.0.0.1:{vport}"
    urls.enable_https(ca, cert_file=child.cert, key_file=child.key)
    senv = None
    steps: dict = {"minted_by": child.minted}

    def kernels() -> dict:
        code, _, body = http(f"{vurl}/debug/kernels")
        if code != 200:
            raise AssertionError(f"18: /debug/kernels answered {code}")
        return json.loads(body)

    def up(u: str) -> bool:
        if proc.poll() is not None:
            raise AssertionError(f"18: the TLS server exited with {proc.returncode}: " + open(
                os.path.join(root, "server.log"), "rb").read()[-2000:].decode(errors="replace"))
        try:
            with urls.urlopen(u, timeout=5) as r:
                return r.status == 200 and bool(json.loads(r.read()).get("DataNodes", [1]))
        except OSError:
            return False

    try:
        t0 = time.perf_counter()
        wait_until(lambda: up(f"{murl}/dir/status") and up(f"{vurl}/status"),
                   "the TLS server answering over https with its volume server registered",
                   timeout=120, phase="18")
        steps["start_s"] = time.perf_counter() - child.t0
        steps["start_wait_s"] = time.perf_counter() - t0
        # 1. needles over https
        written, vids, total = {}, set(), 0
        t0 = time.perf_counter()
        for _, _, body in needle_stream(np.random.default_rng(SEED + 23)):
            if total >= TLS_BYTES:
                break
            code, _, answer = http(f"{murl}/dir/assign?collection=tls")
            if code != 200:
                raise AssertionError(f"18: /dir/assign answered {code} {answer[:200]!r}")
            a = json.loads(answer)
            if a["url"] != f"127.0.0.1:{vport}":
                raise AssertionError(f"18: /dir/assign named {a['url']}")
            code, _, answer = http(f"{vurl}/{a['fid']}", "POST", body, {"Content-Type": UPLOAD_MIME})
            if code != 201:
                raise AssertionError(f"18: POST over https answered {code} {answer[:200]!r}")
            vids.add(FileId.parse(a["fid"]).volume_id)
            written[a["fid"]] = body
            total += len(body)
        write_s = time.perf_counter() - t0
        (vid,) = vids
        base = os.path.join(root, "d", f"tls_{vid}")
        dat_size = os.path.getsize(base + ".dat")
        n_batches = len(list(batch_plan(dat_size, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE,
                                        SMALL_BLOCK_SIZE)))
        # 2. the port shell's ec.encode
        before = kernels()["launches"]
        senv = ShellEnv(f"127.0.0.1:{mport}")
        t0 = time.perf_counter()
        out = run_command(senv, f"ec.encode -volumeId {vid} -collection tls")
        enc_s = time.perf_counter() - t0
        if not re.fullmatch(rf"ec\.encode volume {vid}: generation \d+ on 127\.0\.0\.1:{vport}", out):
            raise AssertionError(f"18: ec.encode answered {out!r}")
        now = kernels()["launches"]
        enc = {k: now[k] - before[k] for k in now}
        if enc != {"gf2_apply": n_batches, "gf2_apply_planes": 0}:
            raise AssertionError(f"18: ec.encode launched {enc} for {n_batches} batches")
        # 3. degraded GETs over https with data shard TLS_LOST unmounted
        with grpc.insecure_channel(f"127.0.0.1:{vport + 10000}") as ch:
            rpc.volume_stub(ch).VolumeEcShardsUnmount(
                pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=[TLS_LOST]), timeout=30)

        def listed() -> set:
            with grpc.insecure_channel(f"127.0.0.1:{mport + 10000}") as ch:
                resp = rpc.master_stub(ch).LookupEcVolume(
                    pb.LookupEcVolumeRequest(volume_id=vid), timeout=10)
            return {sl.shard_id for sl in resp.shard_locations}

        wait_until(lambda: TLS_LOST not in listed(), f"shard {TLS_LOST} leaving the master's listing",
                   phase="18")
        with open(base + ".ecx", "rb") as f:
            ecx = f.read()
        offsets = {}
        for i in range(0, len(ecx), 16):
            nv = NeedleValue.from_bytes(ecx[i : i + 16])
            offsets[nv.needle_id] = (actual_offset(nv.offset), nv.size)
        over = [fid for fid in written if any(
            sid == TLS_LOST for sid, _, _ in record_intervals(*offsets[FileId.parse(fid).needle_id],
                                                              dat_size))]
        before = kernels()
        t0 = time.perf_counter()
        for fid in over:
            code, _, got = http(f"{vurl}/{fid}")
            if code != 200 or got != written[fid]:
                raise AssertionError(f"18: degraded GET of {fid} over https answered {code}, "
                                     "not the written bytes")
        get_s = time.perf_counter() - t0
        after = kernels()
        reads = {k: after["launches"][k] - before["launches"][k] for k in after["launches"]}
        recon = after["interval_cache"]["loads"] - before["interval_cache"]["loads"]
        if reads["gf2_apply_planes"] != recon or recon < 1 or reads["gf2_apply"]:
            raise AssertionError(f"18: the degraded GETs launched {reads} for {recon} reconstructions")
        # 4. no certificate, no plaintext
        bare = ssl.create_default_context(cafile=ca)
        refused = {}
        for what, u, kw in (("no client certificate", f"{vurl}/status", {"context": bare}),
                            ("plaintext", f"http://127.0.0.1:{vport}/status", {})):
            try:
                with urllib.request.urlopen(u, timeout=10, **kw) as r:
                    raise AssertionError(f"18: a client with {what} got {r.status}")
            except OSError as e:
                refused[what] = type(e).__name__
        nbytes = sum(len(b) for b in written.values())
        steps.update({
            "needles": len(written), "bytes": nbytes, "volume": vid, "write_seconds": write_s,
            "write_mb_per_s": nbytes / write_s / 1e6, "encode_seconds": enc_s,
            "encode_launches": n_batches, "degraded_gets": len(over), "get_seconds": get_s,
            "get_mb_per_s": sum(len(written[f]) for f in over) / get_s / 1e6,
            "reconstructions": recon, "refused": refused})
    finally:
        urls.disable_https()
        if senv is not None:
            senv.close()
    steps["seconds"] = time.perf_counter() - t_phase
    return {"steps": steps, "card": card_line()}, {"gf2_apply": n_batches,
                                                    "gf2_apply_planes": recon}


S3GW_BUCKET = "smoke19"  # phase 19's bucket, and so its collection
S3GW_SEED = SEED + 24  # phase 19's bodies
S3GW_PUTS = ((3 << 20) + 4321, (3 << 20) + 65_537, (3 << 20) + 999_999)  # signed PUTs
S3GW_STREAM = (4 << 20) - 12_345  # the aws-chunked PUT, in 64 KiB chunks
S3GW_PARTS = (5 << 20, 5 << 20, 1 << 20)  # the multipart upload's parts
S3GW_SSE = (2 << 20) + 17  # the SSE-S3 and the SSE-C PUT, each
S3GW_FORM = (256 << 10) + 3  # the POST-policy upload
S3GW_SMALL = 8  # objects the filer inlines (under 512 bytes)
S3GW_VERSIONS = (200_000, 210_000, 220_000)  # one key written three times, then a marker
S3GW_LC = 3  # small objects under lc/, expired by the lifecycle rule
S3GW_MAX_VOLUMES = 20  # room for phase 20's collections beside 19's (the default is 8)
S3GW_START_S = 180.0  # the child's wait to serve S3 (its torch import included)
S3GW_KEYS = {"admin": ("AKSMOKE19ADMIN", "smoke19/admin-secret"),
             "reader": ("AKSMOKE19READ", "smoke19/reader-secret")}
TABLES_BUCKET = "smoke19t"  # phase 19b's table bucket, and so its collection
TABLES_SEED = SEED + 25  # phase 19b's data files
TABLES_FILES = 8  # data files, one snapshot each
TABLES_FILE = (4 << 20) + 54_321  # each spans two 4 MiB filer chunks
TABLES_ISSUER = "https://idp.smoke19b"  # the OIDC issuer the child trusts
TABLES_LDAP_USERS = {"uid=analyst,ou=people,dc=smoke": "analyst-pw"}
TABLES_LDAP_DN = "uid={username},ou=people,dc=smoke"


class S3GatewayChild:
    """Phase 19's `python3 -m seaweedfs_tpu_torch.server server -filer -s3`
    child: a master, a volume server (the default EC backend, cuda), a
    filer and the S3 gateway over it in one process, its identities from
    `-s3Config` (an admin, a user who may read and list, an STS role
    that may write under sts/), and for phase 19b an OIDC provider that
    trusts `oidc_pem` (RS256) with a `reader` role that may read and
    list, an LDAP provider binding at `ldap_port`, and an STS role an
    LDAP user may take to write under the table bucket's ldap/. Started
    ahead of the tools check and phase 18, so that its imports overlap
    them; a thread notes the seconds from its spawn to its first S3
    answer."""

    def __init__(self, work: str, ldap_port: int, oidc_pem: str):
        self.t0 = time.perf_counter()
        self.root = os.path.join(work, "s3gw")
        os.makedirs(os.path.join(self.root, "d"))
        self.conf = os.path.join(self.root, "identities.json")
        b = S3GW_BUCKET
        role = {"Version": "2012-10-17", "Statement": [
            {"Effect": "Allow", "Action": ["s3:PutObject", "s3:GetObject"],
             "Resource": [f"arn:aws:s3:::{b}/sts/*"]}]}
        with open(self.conf, "w") as f:
            json.dump({"identities": [
                {"name": "admin", "accessKey": S3GW_KEYS["admin"][0],
                 "secretKey": S3GW_KEYS["admin"][1], "actions": ["Admin"]},
                {"name": "reader", "accessKey": S3GW_KEYS["reader"][0],
                 "secretKey": S3GW_KEYS["reader"][1], "actions": ["Read", "List"]}],
                "roles": [{"name": "uploader", "policies": [role], "trusted": ["*"]},
                          {"name": "tablewriter", "trusted": ["ldap:analyst"], "policies": [
                              {"Version": "2012-10-17", "Statement": [
                                  {"Effect": "Allow",
                                   "Action": ["s3:PutObject", "s3:GetObject"],
                                   "Resource": [f"arn:aws:s3:::{TABLES_BUCKET}/ldap/*"]}]}]}],
                "oidc": {"issuer": TABLES_ISSUER, "audience": "seaweedfs",
                         "rs256_public_key_pem": oidc_pem,
                         "roles": {"reader": {"actions": ["Read", "List"]}}},
                "ldap": {"server": f"ldap://127.0.0.1:{ldap_port}",
                         "bind_dn_template": TABLES_LDAP_DN}}, f)
        self.mport, self.vport, self.fport, self.s3port = (server_port(), server_port(),
                                                           server_port(), server_port())
        self.log = open(os.path.join(self.root, "server.log"), "wb")
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.server", "server", "-ip", "127.0.0.1",
             "-masterPort", str(self.mport), "-port", str(self.vport), "-dir",
             os.path.join(self.root, "d"), "-max", str(S3GW_MAX_VOLUMES), "-filer", "-filerPort",
             str(self.fport), "-s3",
             "-s3Port", str(self.s3port), "-s3Config", self.conf],
            cwd=self.root, env=env, stdout=self.log, stderr=subprocess.STDOUT)
        self.serving: dict = {}
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    def _watch(self) -> None:
        deadline = self.t0 + S3GW_START_S
        while time.perf_counter() < deadline and self.proc.poll() is None:
            try:
                c = HTTPConnection("127.0.0.1", self.s3port, timeout=2)
                c.request("GET", "/")
                c.getresponse().read()
                c.close()
                self.serving["serving_s"] = time.perf_counter() - self.t0
                return
            except OSError:
                time.sleep(0.05)

    def log_tail(self) -> str:
        self.log.flush()
        with open(os.path.join(self.root, "server.log"), "rb") as f:
            return f.read()[-3000:].decode(errors="replace")

    stop = TlsChild.stop  # SIGTERM; the exit code, None where it was killed


class S3Client:
    """Phase 19's client: each request signed with the port's `s3/auth`
    (`sign_v4`) and sent over one keep-alive `RedialConnection` to the
    gateway. Answers are (status, lower-cased headers, body)."""

    def __init__(self, port: int):
        self.port, self.host = port, f"127.0.0.1:{port}"
        self.keys = {who: (ak, sk, "") for who, (ak, sk) in S3GW_KEYS.items()}
        self.conn = None
        self.requests = 0

    def call(self, method: str, path: str, query: str = "", body: bytes = b"",
             headers: dict | None = None, who: str | None = "admin", phash: str | None = None,
             mutate=None):
        from urllib.parse import quote

        from seaweedfs_tpu_torch.s3 import auth

        wire = quote(path, safe="/-_.~")
        hs = {"host": self.host, **(headers or {})}
        if who is not None:
            ak, sk, token = self.keys[who]
            if token:
                hs["x-amz-security-token"] = token
            hs = auth.sign_v4(method, wire, query, access_key=ak, secret_key=sk, headers=hs,
                              payload_hash=phash or hashlib.sha256(body).hexdigest())
        if mutate is not None:
            hs = mutate(hs)
        return self.send(method, wire + (f"?{query}" if query else ""), body, hs)

    def send(self, method: str, target: str, body: bytes, headers: dict):
        import http.client

        self.requests += 1
        for attempt in range(2):
            if self.conn is None:
                self.conn = RedialConnection("127.0.0.1", self.port, timeout=120)
            try:
                self.conn.request(method, target, body=body, headers=headers)
                r = self.conn.getresponse()
                data = r.read()
            except (http.client.RemoteDisconnected, BrokenPipeError, ConnectionResetError):
                # a keep-alive connection the server closed while idle:
                # nothing of this request was served
                self.conn.close()
                self.conn = None
                if attempt:
                    raise
                continue
            if r.will_close:
                self.conn.close()
                self.conn = None
            return r.status, {k.lower(): v for k, v in r.getheaders()}, data
        raise AssertionError("unreachable")

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None


def s3_error_code(body: bytes) -> str:
    import xml.etree.ElementTree as ET

    return ET.fromstring(body).findtext("Code") or ""


def xml_texts(body: bytes, tag: str) -> list:
    import xml.etree.ElementTree as ET

    return [el.text or "" for el in ET.fromstring(body).iter() if el.tag.split("}")[-1] == tag]


def s3_expect(phase: str, what: str, got, want_status: int, want_code: str | None = None):
    """`got`, an `S3Client` answer, if its status (and its S3 error code,
    where one is wanted) is the one wanted; else raises naming `phase`."""
    status, _, body = got
    code = s3_error_code(body) if want_code is not None and body.startswith(b"<") else None
    if status != want_status or (want_code is not None and code != want_code):
        raise AssertionError(f"{phase}: {what} answered {status} {body[:300]!r}, not "
                             f"{want_status} {want_code or ''}")
    return got


def kernels_at(vport: int, phase: str) -> dict:
    """A volume server's `/debug/kernels`: its process's launches and its
    interval-cache loads."""
    code, _, body = http(f"http://127.0.0.1:{vport}/debug/kernels")
    if code != 200:
        raise AssertionError(f"{phase}: /debug/kernels answered {code}")
    return json.loads(body)


def child_kernels(child: S3GatewayChild, phase: str) -> dict:
    """The child's `/debug/kernels`: its launches and interval-cache loads."""
    return kernels_at(child.vport, phase)


def seal_bucket(child: S3GatewayChild, senv, bucket: str, phase: str, walls: dict):
    """The port shell's `ec.encode` of `bucket`'s volumes at the child's
    master (`gf2_apply` launches at the child == the batches), then data
    shard 0 unmounted until the master lists it no more; `walls` gets
    "encode" and "unmount". Returns (volumes, batches, the child's
    `/debug/kernels` before the encode)."""
    return seal_collection(senv, child.mport, child.vport, os.path.join(child.root, "d"), bucket,
                           phase, walls)


def seal_collection(senv, mport: int, vport: int, d: str, collection: str, phase: str,
                    walls: dict):
    """`seal_bucket` for the volume server at `vport` (data directory `d`)
    under the master at `mport`: its volumes of `collection` ("" the
    default) that hold data."""
    import grpc

    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.pb import cluster_pb2 as pb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.shell.commands import run_command

    t0 = time.perf_counter()
    topo = senv.master.topology()
    vids = sorted({v.id for n in topo.nodes for v in n.volumes if v.collection == collection})
    prefix = f"{collection}_" if collection else ""
    vids = [vid for vid in vids if os.path.getsize(os.path.join(d, f"{prefix}{vid}.dat")) > 8]
    n_batches = sum(len(list(batch_plan(os.path.getsize(os.path.join(d, f"{prefix}{vid}.dat")),
                                        K, DEFAULT_BATCH, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE)))
                    for vid in vids)
    before = kernels_at(vport, phase)
    line = f"ec.encode -volumeId {','.join(map(str, vids))}"
    out = run_command(senv, line + (f" -collection {collection}" if collection else ""))
    for vid in vids:
        if not re.search(rf"ec\.encode volume {vid}: generation \d+ on 127\.0\.0\.1:{vport}",
                         out):
            raise AssertionError(f"{phase}: ec.encode answered {out!r}")
    now = kernels_at(vport, phase)["launches"]
    enc = {k: now[k] - before["launches"][k] for k in now}
    if enc != {"gf2_apply": n_batches, "gf2_apply_planes": 0}:
        raise AssertionError(f"{phase}: ec.encode launched {enc} for {n_batches} batches")
    walls["encode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with grpc.insecure_channel(f"127.0.0.1:{vport + 10000}") as ch:
        for vid in vids:
            rpc.volume_stub(ch).VolumeEcShardsUnmount(
                pb.EcShardsUnmountRequest(volume_id=vid, shard_ids=[0]), timeout=30)

    def shard0_listed() -> bool:
        with grpc.insecure_channel(f"127.0.0.1:{mport + 10000}") as ch:
            stub = rpc.master_stub(ch)
            return any(any(sl.shard_id == 0 for sl in stub.LookupEcVolume(
                pb.LookupEcVolumeRequest(volume_id=vid), timeout=10).shard_locations)
                       for vid in vids)

    wait_until(lambda: not shard0_listed(), "shard 0 leaving the master's listing", phase=phase)
    walls["unmount"] = time.perf_counter() - t0
    return vids, n_batches, before


def s3_gateway_phase(child: S3GatewayChild, ctx) -> tuple[dict, dict]:
    """Phase 19: the S3 gateway by name, on `S3GatewayChild`'s cluster.
    19.1 auth: the bucket created, an anonymous and a read-only PUT refused
    (AccessDenied), a tampered signature refused (SignatureDoesNotMatch),
    an STS AssumeRole credential writing under sts/; 19.2 about 32 MiB of
    objects into the bucket (so its collection): three signed PUTs, an
    aws-chunked PUT, a 5 + 5 + 1 MiB multipart upload completed by
    splicing, a CopyObject, an SSE-S3 and an SSE-C PUT, a POST-policy
    upload, small inlined objects and, with versioning Enabled, one key
    written three times and then given a delete marker; 19.3 before the
    seal, ListObjectsV2 paged by continuation tokens, HEADs, whole and
    ranged GETs, a 304, a presigned GET and a `?versionId` read; 19.4 the
    port shell's `ec.encode` of the bucket's volumes at the child's master
    (`gf2_apply` launches at the child == batches), data shard 0
    unmounted, every object read through the gateway whole and in a
    range, sha256-equal (SSE-C with its key), `gf2_apply_planes`
    launches == the holder's interval-cache loads; 19.5 a lifecycle rule
    expiring lc/ through the filer's RunLifecycle; 19.6 DeleteObjects of
    every version and marker, the directories the gateway leaves removed
    through the filer's HTTP API, the bucket deleted (204) and its
    collection gone from the master. Returns (result, launches)."""
    import base64
    import hmac
    from urllib.parse import quote

    import grpc

    from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.s3 import auth, chunked
    from seaweedfs_tpu_torch.shell.commands import ShellEnv

    t_phase = time.perf_counter()
    b, proc = S3GW_BUCKET, child.proc
    furl = f"http://127.0.0.1:{child.fport}"
    cli = S3Client(child.s3port)
    c = cli.call
    rng = np.random.default_rng(S3GW_SEED)
    walls: dict = {}
    redials0 = CONNECT_RETRIES[0]
    senv = None

    def check(*a):
        return s3_expect("19", *a)

    def alive():
        if proc.poll() is not None:
            raise AssertionError(f"19: the gateway's server exited with {proc.returncode}: "
                                 + child.log_tail())

    try:
        # -- 19.1. the child serving, auth -----------------------------------------
        t0 = time.perf_counter()
        child.watcher.join(timeout=max(0.0, S3GW_START_S - (time.perf_counter() - child.t0)))
        alive()
        if "serving_s" not in child.serving:
            raise AssertionError(f"19: the gateway did not answer within {S3GW_START_S} s: "
                                 + child.log_tail())
        walls["start_wait"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        check("the bucket's creation", c("PUT", f"/{b}"), 200)
        check("an anonymous PUT", c("PUT", f"/{b}/anon.bin", body=b"x", who=None), 403,
              "AccessDenied")
        check("a read-only user's PUT", c("PUT", f"/{b}/ro.bin", body=b"x", who="reader"), 403,
              "AccessDenied")

        def flip(hs: dict) -> dict:
            a = hs["Authorization"]
            hs["Authorization"] = a[:-1] + ("0" if a[-1] != "0" else "1")
            return hs

        check("a tampered signature", c("PUT", f"/{b}/t.bin", body=b"x", mutate=flip), 403,
              "SignatureDoesNotMatch")
        form = {"Content-Type": "application/x-www-form-urlencoded"}
        _, _, body = check("AssumeRole", c("POST", "/", body=(
            b"Action=AssumeRole&RoleArn=arn%3Aaws%3Aiam%3A%3A%3Arole%2Fuploader&"
            b"DurationSeconds=900"), headers=form), 200)
        cli.keys["sts"] = (xml_texts(body, "AccessKeyId")[0], xml_texts(body, "SecretAccessKey")[0],
                           xml_texts(body, "SessionToken")[0])
        walls["auth"] = time.perf_counter() - t0

        # -- 19.2. the objects ------------------------------------------------------
        plain: dict = {}  # key -> plaintext
        headers_of: dict = {}  # key -> the headers a GET needs (SSE-C)
        stored = 0
        t0 = time.perf_counter()
        sts_body = rng.bytes(100_000)
        check("the STS credential's PUT", c("PUT", f"/{b}/sts/by-role.bin", body=sts_body,
                                             who="sts"), 200)
        check("the STS credential's PUT outside its policy",
              c("PUT", f"/{b}/obj/x.bin", body=b"x", who="sts"), 403, "AccessDenied")
        plain["sts/by-role.bin"] = sts_body
        for i, n in enumerate(S3GW_PUTS):
            data = rng.bytes(n)
            _, hs, _ = check(f"PUT obj/put-{i}.bin", c("PUT", f"/{b}/obj/put-{i}.bin", body=data,
                                                       headers={"Content-Type": "x/smoke"}), 200)
            if hs.get("etag") != f'"{hashlib.md5(data).hexdigest()}"':
                raise AssertionError(f"19: PUT's ETag {hs.get('etag')}")
            plain[f"obj/put-{i}.bin"] = data
        # aws-chunked: the seed signature from the header, the chunk chain
        # signed by the port's encoder, verified by the gateway
        data = rng.bytes(S3GW_STREAM)
        ak, sk, _ = cli.keys["admin"]
        hs = auth.sign_v4("PUT", f"/{b}/obj/stream.bin", "", access_key=ak, secret_key=sk,
                          headers={"host": cli.host, "content-encoding": "aws-chunked",
                                   "x-amz-decoded-content-length": str(len(data))},
                          payload_hash="STREAMING-AWS4-HMAC-SHA256-PAYLOAD")
        amz = hs["x-amz-date"]
        sctx = auth.SigningContext(signing_key=auth.signing_key(sk, amz[:8], "us-east-1"),
                                   amz_date=amz, scope=f"{amz[:8]}/us-east-1/s3/aws4_request",
                                   seed_signature=hs["Authorization"].rsplit("Signature=", 1)[1])
        check("the aws-chunked PUT", cli.send("PUT", f"/{b}/obj/stream.bin",
                                              chunked.encode_aws_chunked(data, sctx, 64 << 10),
                                              hs), 200)
        plain["obj/stream.bin"] = data
        # multipart, completed by splicing the parts' chunk lists
        _, _, body = check("the multipart initiate", c("POST", f"/{b}/obj/multipart.bin",
                                                       "uploads"), 200)
        uid = xml_texts(body, "UploadId")[0]
        parts = [rng.bytes(n) for n in S3GW_PARTS]
        for i, part in enumerate(parts, 1):
            check(f"part {i}", c("PUT", f"/{b}/obj/multipart.bin", f"partNumber={i}&uploadId={uid}",
                                 body=part), 200)
        done = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{i}</PartNumber></Part>" for i in range(1, len(parts) + 1)) + \
            "</CompleteMultipartUpload>"
        _, _, body = check("the multipart completion", c("POST", f"/{b}/obj/multipart.bin",
                                                         f"uploadId={uid}", body=done.encode()), 200)
        want_etag = hashlib.md5(b"".join(hashlib.md5(p).digest() for p in parts)).hexdigest()
        if xml_texts(body, "ETag") != [f'"{want_etag}-{len(parts)}"']:
            raise AssertionError(f"19: the completed upload's ETag {xml_texts(body, 'ETag')}")
        plain["obj/multipart.bin"] = b"".join(parts)
        check("CopyObject", c("PUT", f"/{b}/obj/copy.bin",
                              headers={"x-amz-copy-source": f"/{b}/obj/put-0.bin"}), 200)
        plain["obj/copy.bin"] = plain["obj/put-0.bin"]
        data = rng.bytes(S3GW_SSE)
        _, hs, _ = check("the SSE-S3 PUT", c("PUT", f"/{b}/sse/s3.bin", body=data, headers={
            "x-amz-server-side-encryption": "AES256"}), 200)
        if hs.get("x-amz-server-side-encryption") != "AES256":
            raise AssertionError(f"19: the SSE-S3 PUT answered headers {hs}")
        plain["sse/s3.bin"] = data
        key = rng.bytes(32)
        ssec = {"x-amz-server-side-encryption-customer-algorithm": "AES256",
                "x-amz-server-side-encryption-customer-key": base64.b64encode(key).decode(),
                "x-amz-server-side-encryption-customer-key-MD5":
                    base64.b64encode(hashlib.md5(key).digest()).decode()}
        data = rng.bytes(S3GW_SSE)
        check("the SSE-C PUT", c("PUT", f"/{b}/sse/c.bin", body=data, headers=ssec), 200)
        plain["sse/c.bin"] = data
        headers_of["sse/c.bin"] = ssec
        # the POST-policy upload: a form signed by the admin
        data = rng.bytes(S3GW_FORM)
        amz = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        fields = {"key": "form/${filename}", "x-amz-algorithm": "AWS4-HMAC-SHA256",
                  "x-amz-credential": f"{ak}/{amz[:8]}/us-east-1/s3/aws4_request",
                  "x-amz-date": amz}
        policy = base64.b64encode(json.dumps({"expiration": "2099-01-01T00:00:00Z", "conditions": [
            {"bucket": b}, ["starts-with", "$key", "form/"],
            ["content-length-range", 1, S3GW_FORM],
            *[["eq", f"${k}", v] for k, v in fields.items() if k != "key"]]}).encode()).decode()
        fields["policy"] = policy
        fields["x-amz-signature"] = hmac.new(auth.signing_key(sk, amz[:8], "us-east-1"),
                                             policy.encode(), hashlib.sha256).hexdigest()
        bnd = "smoke19-form"
        form_body = b"".join(
            f'--{bnd}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
            for k, v in fields.items()) + (
            f'--{bnd}\r\nContent-Disposition: form-data; name="file"; filename="upload.bin"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n").encode() + data + \
            f"\r\n--{bnd}--\r\n".encode()
        check("the POST-policy upload", cli.send("POST", f"/{b}", form_body, {
            "host": cli.host, "Content-Type": f"multipart/form-data; boundary={bnd}"}), 204)
        plain["form/upload.bin"] = data
        for i in range(S3GW_SMALL):
            data = rng.bytes(int(rng.integers(1, 500)))
            check(f"small/s{i}.txt", c("PUT", f"/{b}/small/s{i}.txt", body=data), 200)
            plain[f"small/s{i}.txt"] = data
        for i in range(S3GW_LC):
            data = rng.bytes(int(rng.integers(1, 500)))
            check(f"lc/{i}", c("PUT", f"/{b}/lc/{i}", body=data), 200)
            plain[f"lc/{i}"] = data
        check("versioning Enabled", c("PUT", f"/{b}", "versioning", body=(
            b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>")), 200)
        versions = []  # (version id, body), oldest first
        for n in S3GW_VERSIONS:
            data = rng.bytes(n)
            _, hs, _ = check("a versioned PUT", c("PUT", f"/{b}/ver/k.bin", body=data), 200)
            versions.append((hs["x-amz-version-id"], data))
        _, hs, _ = check("the delete marker", c("DELETE", f"/{b}/ver/k.bin"), 204)
        if hs.get("x-amz-delete-marker") != "true":
            raise AssertionError(f"19: the versioned DELETE answered {hs}")
        marker = hs["x-amz-version-id"]
        check("a GET behind the delete marker", c("GET", f"/{b}/ver/k.bin"), 404, "NoSuchKey")
        write_s = time.perf_counter() - t0
        written = sum(len(v) for v in plain.values()) + sum(len(v) for _, v in versions)
        walls["write"] = write_s
        reads: dict = {k: v for k, v in plain.items() if not k.startswith("lc/")}
        reads.update({f"ver/k.bin?versionId={vid}": v for vid, v in versions})

        def get(k: str, rng_hdr: str | None = None):
            path, _, query = k.partition("?")
            hdr = dict(headers_of.get(path, {}))
            if rng_hdr:
                hdr["Range"] = rng_hdr
            return c("GET", f"/{b}/{path}", query, headers=hdr)

        # -- 19.3. listing and reads before the seal ------------------------------
        t0 = time.perf_counter()
        listed, pages, q = [], 0, "list-type=2&prefix=obj/&delimiter=/&max-keys=2"
        while True:
            _, _, body = check("ListObjectsV2", c("GET", f"/{b}", q), 200)
            pages += 1
            listed += xml_texts(body, "Key")
            tok = xml_texts(body, "NextContinuationToken")
            if not tok:
                break
            q = ("list-type=2&prefix=obj/&delimiter=/&max-keys=2&continuation-token="
                 + quote(tok[0], safe=""))
        if listed != sorted(k for k in plain if k.startswith("obj/")) or pages < 3:
            raise AssertionError(f"19: ListObjectsV2 paged {pages} times to {listed}")
        _, _, body = check("a delimited listing", c("GET", f"/{b}", "list-type=2&delimiter=/"), 200)
        prefixes = xml_texts(body, "Prefix")[1:]
        if prefixes != ["form/", "lc/", "obj/", "small/", "sse/", "sts/", "ver/"]:
            raise AssertionError(f"19: the delimited listing's prefixes are {prefixes}")
        for k, v in plain.items():
            _, hs, _ = check(f"HEAD {k}", c("HEAD", f"/{b}/{k}", headers=headers_of.get(k)), 200)
            if int(hs["content-length"]) != len(v):
                raise AssertionError(f"19: HEAD {k} says {hs['content-length']} bytes")
        pre = ["obj/put-0.bin", f"ver/k.bin?versionId={versions[0][0]}"] + [
            k for k in reads if k.startswith("small/")]
        lat_before = []
        for k in pre:
            t1 = time.perf_counter()
            _, _, got = check(f"GET {k}", get(k), 200)
            lat_before.append(time.perf_counter() - t1)
            if hashlib.sha256(got).digest() != hashlib.sha256(reads[k]).digest():
                raise AssertionError(f"19: GET {k} differs from what was written")
        v = plain["obj/put-1.bin"]
        _, hs, got = check("a ranged GET", get("obj/put-1.bin", "bytes=1000-300999"), 206)
        if got != v[1000:301000] or hs.get("content-range") != f"bytes 1000-300999/{len(v)}":
            raise AssertionError(f"19: the ranged GET gave {len(got)} bytes, {hs}")
        _, hs, _ = check("HEAD for the ETag", c("HEAD", f"/{b}/obj/put-0.bin"), 200)
        check("If-None-Match", c("GET", f"/{b}/obj/put-0.bin",
                                 headers={"If-None-Match": hs["etag"]}), 304)
        presigned = presign_v4("GET", f"/{b}/obj/put-0.bin", ak, sk, cli.host, 300)
        _, _, got = check("the presigned GET", cli.send("GET", f"/{b}/obj/put-0.bin?{presigned}",
                                                         b"", {"host": cli.host}), 200)
        if got != plain["obj/put-0.bin"]:
            raise AssertionError("19: the presigned GET gave other bytes")
        walls["reads_before_seal"] = time.perf_counter() - t0

        # -- 19.4. seal the bucket's volumes, data shard 0 gone --------------------
        senv = ShellEnv(f"127.0.0.1:{child.mport}")
        vids, n_batches, _ = seal_bucket(child, senv, b, "19", walls)
        before = child_kernels(child, "19")
        t0 = time.perf_counter()
        lat_after = []
        for k, v in reads.items():
            t1 = time.perf_counter()
            _, _, got = check(f"degraded GET {k}", get(k), 200)
            lat_after.append(time.perf_counter() - t1)
            lo = int(rng.integers(0, len(v)))
            hi = int(rng.integers(lo, len(v)))
            _, _, part = check(f"degraded ranged GET {k}", get(k, f"bytes={lo}-{hi}"), 206)
            if hashlib.sha256(got).digest() != hashlib.sha256(v).digest() or part != v[lo:hi + 1]:
                raise AssertionError(f"19: {k} read with shard 0 gone differs from what was written")
        walls["degraded_reads"] = time.perf_counter() - t0
        after = child_kernels(child, "19")
        got = {k: after["launches"][k] - before["launches"][k] for k in after["launches"]}
        recon = after["interval_cache"]["loads"] - before["interval_cache"]["loads"]
        if got["gf2_apply_planes"] != recon or recon < 1 or got["gf2_apply"]:
            raise AssertionError(f"19: the degraded GETs launched {got} for {recon} "
                                 "reconstructions")

        # -- 19.5. lifecycle ---------------------------------------------------------
        t0 = time.perf_counter()
        rule = (b"<LifecycleConfiguration><Rule><ID>lc</ID><Filter><Prefix>lc/</Prefix></Filter>"
                b"<Status>Enabled</Status><Expiration><Date>2020-01-01T00:00:00Z</Date>"
                b"</Expiration></Rule></LifecycleConfiguration>")
        check("PUT ?lifecycle", c("PUT", f"/{b}", "lifecycle", body=rule), 200)
        with grpc.insecure_channel(f"127.0.0.1:{child.fport + 10000}") as ch:
            lc = rpc.filer_stub(ch).RunLifecycle(fpb.LifecycleRunRequest(bucket=b), timeout=120)
        if (lc.expired, lc.noncurrent_expired, lc.aborted_uploads, lc.error) != (S3GW_LC, 0, 0, ""):
            raise AssertionError(f"19: RunLifecycle answered {lc}")
        for i in range(S3GW_LC):
            check(f"GET lc/{i} after its expiry", c("GET", f"/{b}/lc/{i}"), 404, "NoSuchKey")
        check("GET small/s0.txt after the lifecycle run", c("GET", f"/{b}/small/s0.txt"), 200)
        walls["lifecycle"] = time.perf_counter() - t0

        # -- 19.6. clean-up -----------------------------------------------------------
        t0 = time.perf_counter()
        _, _, body = check("ListObjectVersions", c("GET", f"/{b}", "versions"), 200)
        pairs = list(zip(xml_texts(body, "Key"), xml_texts(body, "VersionId")))
        if (f"ver/k.bin", marker) not in pairs or len(pairs) != len(plain) + len(versions) + 1 \
                + S3GW_LC:
            raise AssertionError(f"19: the bucket lists {len(pairs)} versions")
        doc = "<Delete>" + "".join(f"<Object><Key>{k}</Key><VersionId>{v}</VersionId></Object>"
                                   for k, v in pairs) + "</Delete>"
        _, _, body = check("DeleteObjects", c("POST", f"/{b}", "delete", body=doc.encode()), 200)
        if xml_texts(body, "Code") or len(xml_texts(body, "Key")) != len(pairs):
            raise AssertionError(f"19: DeleteObjects answered {body[:500]!r}")
        _, _, body = check("ListObjectVersions after DeleteObjects", c("GET", f"/{b}", "versions"),
                           200)
        if xml_texts(body, "Key"):
            raise AssertionError(f"19: versions left: {xml_texts(body, 'Key')}")
        check("DELETE of a bucket holding directories", c("DELETE", f"/{b}"), 409,
              "BucketNotEmpty")

        # the gateway removes objects, not the directories they lived in (as
        # the JAX gateway does): each left is checked empty of files, then
        # removed through the filer's HTTP API
        def files_under(path: str) -> list:
            code, _, body = http(f"{furl}{quote(path)}/?limit=1000")
            if code != 200:
                raise AssertionError(f"19: the filer listed {path} with {code}")
            out = []
            for e in json.loads(body)["Entries"] or []:
                out += files_under(e["FullPath"]) if e["IsDirectory"] else [e["FullPath"]]
            return out

        left = files_under(f"/buckets/{b}")
        if left:
            raise AssertionError(f"19: files left in the bucket: {left}")
        code, _, body = http(f"{furl}/buckets/{b}/?limit=1000")
        dirs = [e["FullPath"] for e in json.loads(body)["Entries"] or []]
        for p in dirs:
            code, _, _ = http(f"{furl}{quote(p)}?recursive=true", "DELETE")
            if code not in (200, 202, 204):
                raise AssertionError(f"19: the filer's recursive DELETE of {p} answered {code}")
        check("the bucket's DELETE", c("DELETE", f"/{b}"), 204)
        check("HEAD of the deleted bucket", c("HEAD", f"/{b}"), 404)
        wait_until(lambda: b not in senv.master.collections(),
                   "the master listing nothing of the bucket's collection", phase="19")
        walls["clean_up"] = time.perf_counter() - t0
        step = {
            "child_serving_s": child.serving["serving_s"], "bucket": b, "objects": len(plain),
            "versions": len(versions), "bytes": written, "write_seconds": write_s,
            "put_mb_per_s": written / write_s / 1e6, "get_before_seal": len(lat_before),
            "get_p50_ms_before_seal": percentile_ms(lat_before, 50),
            "get_p99_ms_before_seal": percentile_ms(lat_before, 99),
            "get_after_seal": len(lat_after),
            "get_p50_ms_after_seal": percentile_ms(lat_after, 50),
            "get_p99_ms_after_seal": percentile_ms(lat_after, 99),
            "listing_pages": pages, "volumes": vids, "encode_launches": n_batches,
            "reconstructions": recon, "lifecycle_expired": lc.expired,
            "directories_removed": dirs, "requests": cli.requests, "walls": walls,
            "redials": CONNECT_RETRIES[0] - redials0, "seconds": time.perf_counter() - t_phase}
    finally:
        cli.close()
        if senv is not None:
            senv.close()
    return {"steps": step, "card": card_line()}, {"gf2_apply": n_batches,
                                                  "gf2_apply_planes": recon}


def oidc_bearer(key, claims: dict) -> dict:
    """An `Authorization: Bearer` header: `claims` as an RS256 JWT signed
    with `key`, as an IdP signs it."""
    import base64

    from cryptography.hazmat.primitives.asymmetric import padding
    from cryptography.hazmat.primitives.hashes import SHA256

    def b64(raw: bytes) -> str:
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    header = json.dumps({"alg": "RS256", "typ": "JWT"}).encode()
    signing = f"{b64(header)}.{b64(json.dumps(claims).encode())}"
    sig = key.sign(signing.encode(), padding.PKCS1v15(), SHA256())
    return {"Authorization": f"Bearer {signing}.{b64(sig)}"}


def s3_tables_phase(child: S3GatewayChild, oidc_key) -> tuple[dict, dict]:
    """Phase 19b: S3 Tables, the Iceberg REST catalog, the IAM API, OIDC
    and LDAP on phase 19's gateway child, after phase 19. 1. the IAM API
    as the admin: CreateUser, CreateAccessKey, PutUserPolicy (Put/Get/List
    on the table bucket); 2. CreateTableBucket by the S3 Tables target, a
    namespace and a table with a real schema by Iceberg REST; 3. with the
    minted key, `TABLES_FILES` seeded data files SigV4-PUT under the
    table's data/, one add-snapshot + set-snapshot-ref commit each (each
    writes a new metadata file), a multi-table transaction over two more
    tables and a view; 4. AssumeRoleWithLdapIdentity as an LDAP user,
    whose temporary key PUTs under ldap/, and a wrong password refused;
    5. the port shell's `ec.encode` of the table bucket's collection
    (`gf2_apply` launches == batches); 6. data shard 0 unmounted: loadTable
    answers the last commit, every metadata file of the log and every
    data file GET with an OIDC bearer of role `reader` whole and in a
    range, sha256-equal to what was written; a forged and an expired
    bearer refused; 7. the maintenance route expiring old snapshots while
    the refs stay; 8. DeleteAccessKey (the key refused after), the
    tables, the view, the namespace and the table bucket deleted, the
    bucket's objects and the bucket removed and its collection gone.
    `gf2_apply_planes` launches == the holder's interval-cache loads from
    the seal to the end. Returns (result, launches)."""
    from urllib.parse import quote

    from seaweedfs_tpu_torch.shell.commands import ShellEnv

    t_phase = time.perf_counter()
    b, proc = TABLES_BUCKET, child.proc
    furl = f"http://127.0.0.1:{child.fport}"
    cli = S3Client(child.s3port)
    c = cli.call
    rng = np.random.default_rng(TABLES_SEED)
    walls: dict = {}
    redials0 = CONNECT_RETRIES[0]
    senv = None
    form = {"Content-Type": "application/x-www-form-urlencoded"}
    ib = f"/iceberg/v1/{b}"
    tbl = f"{ib}/namespaces/sales/tables"

    def check(*a):
        if proc.poll() is not None:
            raise AssertionError(f"19b: the gateway's server exited with {proc.returncode}: "
                                 + child.log_tail())
        return s3_expect("19b", *a)

    def cat(what: str, method: str, path: str, doc=None, want: int = 200, headers=None) -> dict:
        """One catalog request as the admin; its JSON answer."""
        body = b"" if doc is None else json.dumps(doc).encode()
        _, _, out = check(what, c(method, path, body=body, headers={
            "Content-Type": "application/json", **(headers or {})}), want)
        return json.loads(out) if out else {}

    def target(op: str, doc: dict, want: int = 200) -> dict:
        return cat(op, "POST", "/", doc, want, {"X-Amz-Target": f"S3Tables.{op}"})

    def iam(what: str, want: int = 200, **kv) -> bytes:
        from urllib.parse import urlencode

        return check(what, c("POST", "/", body=urlencode(kv).encode(), headers=form), want)[2]

    def key_refused(who: str, code: str) -> bool:
        # the gateway's identity store reloads the filer's KV every 2 s
        st, _, body = c("GET", "/", who=who)
        return st == 403 and s3_error_code(body) == code

    try:
        # -- 1. the IAM API -----------------------------------------------------------
        t0 = time.perf_counter()
        iam("CreateUser", Action="CreateUser", UserName="tables19")
        body = iam("CreateAccessKey", Action="CreateAccessKey", UserName="tables19")
        cli.keys["tables19"] = (xml_texts(body, "AccessKeyId")[0],
                                xml_texts(body, "SecretAccessKey")[0], "")
        policy = {"Version": "2012-10-17", "Statement": [
            {"Effect": "Allow", "Action": ["s3:PutObject", "s3:GetObject", "s3:ListBucket"],
             "Resource": [f"arn:aws:s3:::{b}", f"arn:aws:s3:::{b}/*"]}]}
        iam("PutUserPolicy", Action="PutUserPolicy", UserName="tables19", PolicyName="tables",
            PolicyDocument=json.dumps(policy))
        # the minted key known and its policy in force: a bucket listing is
        # denied to it, where the Admin a bare key starts with would pass
        wait_until(lambda: key_refused("tables19", "AccessDenied"),
                   "the minted key under its policy", timeout=10.0, phase="19b")
        walls["iam"] = time.perf_counter() - t0

        # -- 2. the catalog -------------------------------------------------------------
        t0 = time.perf_counter()
        arn = target("CreateTableBucket", {"name": b})["arn"]
        cat("the namespace", "POST", f"{ib}/namespaces",
            {"namespace": ["sales"], "properties": {"owner": "smoke"}})
        schema = {"type": "struct", "schema-id": 0, "fields": [
            {"id": 1, "name": "order_id", "required": True, "type": "long"},
            {"id": 2, "name": "customer", "required": True, "type": "string"},
            {"id": 3, "name": "amount", "required": False, "type": "decimal(12, 2)"},
            {"id": 4, "name": "placed_at", "required": True, "type": "timestamptz"},
            {"id": 5, "name": "lines", "required": False, "type": {
                "type": "list", "element-id": 6, "element-required": False, "element": {
                    "type": "struct", "fields": [
                        {"id": 7, "name": "sku", "required": True, "type": "string"},
                        {"id": 8, "name": "qty", "required": True, "type": "int"}]}}}]}
        made = cat("the table", "POST", tbl, {"name": "orders", "schema": schema,
                                              "properties": {"write.format.default": "parquet"}})
        metadata = {made["metadata-location"]: made["metadata"]}  # location -> document
        walls["catalog"] = time.perf_counter() - t0

        # -- 3. data files and a snapshot each -------------------------------------
        t0 = time.perf_counter()
        files: dict = {}  # key -> body
        last = made
        t_put = 0.0
        for i in range(TABLES_FILES):
            data = rng.bytes(TABLES_FILE)
            key = f"sales/orders/data/00000-{i}-smoke.parquet"
            t1 = time.perf_counter()
            check(f"PUT {key}", c("PUT", f"/{b}/{key}", body=data, who="tables19"), 200)
            t_put += time.perf_counter() - t1
            files[key] = data
            sid = 1000 + i
            last = cat(f"commit {i}", "POST", f"{tbl}/orders", {
                "requirements": [{"type": "assert-table-uuid",
                                  "uuid": made["metadata"]["table-uuid"]}],
                "updates": [
                    {"action": "add-snapshot", "snapshot": {
                        "snapshot-id": sid, "sequence-number": i + 1,
                        "timestamp-ms": int(time.time() * 1000) - (TABLES_FILES - i) * 86400_000,
                        "manifest-list": f"s3://{b}/sales/orders/metadata/snap-{sid}.avro",
                        "summary": {"operation": "append", "added-data-files": "1",
                                    "added-files-size": str(len(data))}}},
                    {"action": "set-snapshot-ref", "ref-name": "main", "snapshot-id": sid,
                     "type": "branch"}]})
            metadata[last["metadata-location"]] = last["metadata"]
        check("a PUT outside the key's policy", c("PUT", "/smoke19-other", who="tables19"), 403,
              "AccessDenied")
        if len(last["metadata"]["metadata-log"]) != TABLES_FILES:
            raise AssertionError(f"19b: the metadata log holds "
                                 f"{len(last['metadata']['metadata-log'])} files")
        for name in ("returns", "customers"):
            cat(f"the table {name}", "POST", tbl, {"name": name, "schema": schema})
        cat("the transaction", "POST", f"{ib}/transactions/commit", {"table-changes": [
            {"identifier": {"namespace": ["sales"], "name": n},
             "updates": [{"action": "set-properties", "updates": {"smoke": "19b"}}]}
            for n in ("returns", "customers")]}, want=204)
        view = cat("the view", "POST", f"{ib}/namespaces/sales/views", {
            "name": "daily", "schema": schema, "view-version": {
                "version-id": 1, "representations": [
                    {"type": "sql", "dialect": "spark",
                     "sql": "SELECT date(placed_at), sum(amount) FROM sales.orders GROUP BY 1"}]}})
        metadata[view["metadata-location"]] = view["metadata"]
        walls["data_and_commits"] = time.perf_counter() - t0
        written = sum(len(v) for v in files.values())

        # -- 4. LDAP STS ---------------------------------------------------------------------
        t0 = time.perf_counter()
        body = iam("AssumeRoleWithLdapIdentity", Action="AssumeRoleWithLdapIdentity",
                   LdapUsername="analyst", LdapPassword="analyst-pw",
                   RoleArn="arn:aws:iam:::role/tablewriter", DurationSeconds="900")
        cli.keys["ldap"] = (xml_texts(body, "AccessKeyId")[0],
                            xml_texts(body, "SecretAccessKey")[0], xml_texts(body, "SessionToken")[0])
        report = rng.bytes(70_001)
        check("the LDAP credential's PUT", c("PUT", f"/{b}/ldap/report.csv", body=report,
                                              who="ldap"), 200)
        files["ldap/report.csv"] = report
        check("the LDAP credential's PUT outside its role",
              c("PUT", f"/{b}/sales/orders/data/x", body=b"x", who="ldap"), 403, "AccessDenied")
        _, _, body = check("a wrong LDAP password", c("POST", "/", body=(
            b"Action=AssumeRoleWithLdapIdentity&LdapUsername=analyst&LdapPassword=wrong&"
            b"RoleName=tablewriter"), headers=form, who=None), 403, "AccessDenied")
        if b"resultCode 49" not in body:
            raise AssertionError(f"19b: the wrong password answered {body!r}")
        walls["ldap_sts"] = time.perf_counter() - t0

        # -- 5. seal the table bucket's collection -------------------------------------
        senv = ShellEnv(f"127.0.0.1:{child.mport}")
        vids, n_batches, before = seal_bucket(child, senv, b, "19b", walls)

        # -- 6. degraded reads -----------------------------------------------------------------
        t0 = time.perf_counter()
        loaded = cat("loadTable", "GET", f"{tbl}/orders")
        if (loaded["metadata-location"], loaded["metadata"]) != (last["metadata-location"],
                                                                 last["metadata"]):
            raise AssertionError(f"19b: loadTable answered {loaded['metadata-location']}, not "
                                 f"the last commit's {last['metadata-location']}")
        log = [e["metadata-file"] for e in loaded["metadata"]["metadata-log"]]
        log += [loaded["metadata-location"], view["metadata-location"]]
        wants = {loc.split(f"s3://{b}/", 1)[1]: json.dumps(metadata[loc], indent=2).encode()
                 for loc in log}
        wants.update(files)
        now_s = time.time()
        reader = oidc_bearer(oidc_key, {"iss": TABLES_ISSUER, "aud": "seaweedfs",
                                        "sub": "smoke-reader", "roles": ["reader"],
                                        "iat": now_s, "exp": now_s + 600})
        lat = []
        for key, want in wants.items():
            t1 = time.perf_counter()
            _, _, got = check(f"degraded GET {key}", c("GET", f"/{b}/{quote(key)}",
                                                       headers=reader, who=None), 200)
            lat.append(time.perf_counter() - t1)
            lo = int(rng.integers(0, len(want)))
            hi = int(rng.integers(lo, len(want)))
            _, _, part = check(f"degraded ranged GET {key}", c(
                "GET", f"/{b}/{quote(key)}", headers={**reader, "Range": f"bytes={lo}-{hi}"},
                who=None), 206)
            if hashlib.sha256(got).digest() != hashlib.sha256(want).digest() \
                    or part != want[lo:hi + 1]:
                raise AssertionError(f"19b: {key} read with shard 0 gone differs from what was "
                                     "written")
        check("a PUT with the reader's bearer", c("PUT", f"/{b}/x", body=b"x", headers=reader,
                                                  who=None), 403, "AccessDenied")
        forged = dict(reader)
        forged["Authorization"] = forged["Authorization"][:-6] + (
            "AAAAAA" if not forged["Authorization"].endswith("AAAAAA") else "BBBBBB")
        expired = oidc_bearer(oidc_key, {"iss": TABLES_ISSUER, "aud": "seaweedfs",
                                         "sub": "smoke-reader", "roles": ["reader"],
                                         "exp": now_s - 3600})
        refusals = {}
        for what, hdr in (("forged", forged), ("expired", expired)):
            _, _, body = check(f"the {what} bearer", c("GET", f"/{b}/{quote(next(iter(files)))}",
                                                       headers=hdr, who=None), 403,
                               "InvalidToken")
            refusals[what] = xml_texts(body, "Message")[0]
        walls["degraded_reads"] = time.perf_counter() - t0

        # -- 7. maintenance ------------------------------------------------------------------------
        t0 = time.perf_counter()
        keep_from = last["metadata"]["snapshots"][TABLES_FILES // 2]["timestamp-ms"]
        swept = cat("the maintenance route", "POST", f"{ib}/maintenance",
                    {"older-than-ms": keep_from})
        if swept["snapshots_expired"] != TABLES_FILES // 2 or swept["tables_updated"] != 1:
            raise AssertionError(f"19b: the maintenance route answered {swept}")
        md = cat("loadTable after maintenance", "GET", f"{tbl}/orders")["metadata"]
        left = [sn["snapshot-id"] for sn in md["snapshots"]]
        if left != list(range(1000 + TABLES_FILES // 2, 1000 + TABLES_FILES)) \
                or md["refs"]["main"]["snapshot-id"] != 1000 + TABLES_FILES - 1 \
                or md["current-snapshot-id"] != 1000 + TABLES_FILES - 1:
            raise AssertionError(f"19b: after maintenance the snapshots are {left}, refs "
                                 f"{md['refs']}")
        walls["maintenance"] = time.perf_counter() - t0

        # -- 8. teardown -----------------------------------------------------------------------------
        t0 = time.perf_counter()
        iam("DeleteAccessKey", Action="DeleteAccessKey", AccessKeyId=cli.keys["tables19"][0])
        wait_until(lambda: key_refused("tables19", "InvalidAccessKeyId"),
                   "the deleted key refused", timeout=10.0, phase="19b")
        for name in ("orders", "returns", "customers"):
            target("DeleteTable", {"tableBucketARN": arn, "namespace": "sales", "name": name},
                   want=204)
        cat("DROP VIEW", "DELETE", f"{ib}/namespaces/sales/views/daily", want=204)
        target("DeleteNamespace", {"tableBucketARN": arn, "namespace": "sales"}, want=204)
        target("DeleteTableBucket", {"tableBucketARN": arn}, want=204)
        if b in [x["name"] for x in target("ListTableBuckets", {})["tableBuckets"]]:
            raise AssertionError("19b: the table bucket is still listed")
        keys, q = [], "list-type=2"
        while True:
            _, _, body = check("ListObjectsV2", c("GET", f"/{b}", q), 200)
            keys += xml_texts(body, "Key")
            tok = xml_texts(body, "NextContinuationToken")
            if not tok:
                break
            q = "list-type=2&continuation-token=" + quote(tok[0], safe="")
        if set(wants) - set(keys):
            raise AssertionError(f"19b: the bucket lists {len(keys)} objects")
        doc = "<Delete>" + "".join(f"<Object><Key>{k}</Key></Object>" for k in keys) + "</Delete>"
        _, _, body = check("DeleteObjects", c("POST", f"/{b}", "delete", body=doc.encode()), 200)
        if xml_texts(body, "Code") or len(xml_texts(body, "Key")) != len(keys):
            raise AssertionError(f"19b: DeleteObjects answered {body[:500]!r}")
        code, _, body = http(f"{furl}/buckets/{b}/?limit=1000")
        for e in json.loads(body)["Entries"] or []:
            code, _, _ = http(f"{furl}{quote(e['FullPath'])}?recursive=true", "DELETE")
            if code not in (200, 202, 204):
                raise AssertionError(f"19b: the filer's recursive DELETE of {e['FullPath']} "
                                     f"answered {code}")
        check("the bucket's DELETE", c("DELETE", f"/{b}"), 204)
        wait_until(lambda: b not in senv.master.collections(),
                   "the master listing nothing of the table bucket's collection", phase="19b")
        walls["teardown"] = time.perf_counter() - t0
        after = child_kernels(child, "19b")
        got = {k: after["launches"][k] - before["launches"][k] for k in after["launches"]}
        recon = after["interval_cache"]["loads"] - before["interval_cache"]["loads"]
        if got != {"gf2_apply": n_batches, "gf2_apply_planes": recon} or recon < 1:
            raise AssertionError(f"19b: from the seal on the child launched {got} for "
                                 f"{n_batches} batches and {recon} reconstructions")
        step = {
            "bucket": b, "data_files": TABLES_FILES, "data_bytes": written,
            "put_seconds": t_put, "put_mb_per_s": written / t_put / 1e6,
            "metadata_files": len(log), "snapshots_committed": TABLES_FILES,
            "degraded_gets": len(lat), "get_p50_ms": percentile_ms(lat, 50),
            "get_p99_ms": percentile_ms(lat, 99), "volumes": vids,
            "encode_launches": n_batches, "reconstructions": recon,
            "snapshots_expired": swept["snapshots_expired"], "bearer_refusals": refusals,
            "requests": cli.requests, "walls": walls,
            "redials": CONNECT_RETRIES[0] - redials0, "seconds": time.perf_counter() - t_phase}
    finally:
        cli.close()
        if senv is not None:
            senv.close()
    return {"steps": step, "card": card_line()}, {"gf2_apply": n_batches,
                                                  "gf2_apply_planes": recon}


REMOTE_BUCKET = "remote-src"  # phase 19c's bucket at A, remote-mounted at B
REMOTE_SEED = SEED + 26  # phase 19c's bodies
REMOTE_LARGE = 12  # objects of 1-5 MiB, in the filer's 4 MiB chunks
REMOTE_SMALL = 1050  # inlined objects: the mount's listing pages past 1,000 keys
REMOTE_READ_SMALL = 50  # of them read through the mount
REMOTE_MIRROR = "mirror"  # the S3 sink's bucket at A
REMOTE_TREE = {  # /src at A's filer: what the replication children copy
    "a/big0.bin": (4 << 20) + 1234, "a/b/big1.bin": (5 << 20) - 77,
    "a/b/c/mid.bin": (1 << 20) + 5, "d/big2.bin": (4 << 20) + 99_999,
    **{f"e/f{i:02d}.bin": 60_000 + 7_919 * i for i in range(24)},
    **{f"e/g/s{i:02d}.txt": 50 + 13 * i for i in range(16)},
}
REMOTE_ICEBERG = "smoke19i"  # the iceberg task's table bucket
REPL_STOP_S = 10.0  # a replication child alive this long after SIGTERM fails the phase


class ClusterB:
    """Phase 19c's second cluster, in this process: a port `MasterServer`,
    one `VolumeServer` on the card (its gRPC on its port + 10000, as a
    launched server's) and a `FilerServer` serving HTTP and gRPC (its port
    + 10000, where the shell dials a filer). Started on a thread while
    phases 19 and 19b run; `ready` waits for it."""

    def __init__(self, work: str):
        self.root = os.path.join(work, "clusterb")
        self.d = os.path.join(self.root, "d")
        os.makedirs(self.d)
        self.master = self.vs = self.filer = self.fsrv = None
        self.error: BaseException | None = None
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._start, name="cluster-b", daemon=True)
        self.thread.start()

    def _start(self) -> None:
        try:
            from seaweedfs_tpu_torch.filer import Filer, MemoryStore
            from seaweedfs_tpu_torch.server.filer_server import FilerServer
            from seaweedfs_tpu_torch.server.master import MasterServer
            from seaweedfs_tpu_torch.server.volume_server import VolumeServer

            self.mport = server_port()
            self.master = MasterServer(ip="127.0.0.1", port=self.mport, vacuum_interval=3600)
            self.master.start()
            self.vport = server_port()
            self.vs = VolumeServer([self.d], master=f"127.0.0.1:{self.mport}", ip="127.0.0.1",
                                   port=self.vport, grpc_port=self.vport + 10000,
                                   ec_backend="cuda")
            self.vs.start()
            deadline = time.perf_counter() + 60
            while not self.master.topo.nodes and time.perf_counter() < deadline:
                time.sleep(0.02)
            self.filer = Filer(MemoryStore(), master=f"127.0.0.1:{self.mport}")
            self.fport = server_port()
            self.fsrv = FilerServer(self.filer, ip="127.0.0.1", port=self.fport,
                                    grpc_port=self.fport + 10000)
            self.fsrv.start()
            self.start_s = time.perf_counter() - self.t0
        except BaseException as e:  # noqa: BLE001 — raised again by ready()
            self.error = e

    def ready(self) -> None:
        self.thread.join(timeout=120)
        if self.error is not None:
            raise AssertionError(f"19c: cluster B did not start: {self.error!r}") from self.error
        if self.thread.is_alive() or not self.master.topo.nodes:
            raise AssertionError("19c: cluster B did not start within 120 s")

    def stop(self) -> None:
        self.thread.join(timeout=120)
        for part in (self.fsrv, self.vs, self.master):
            if part is not None:
                part.stop()
        if self.filer is not None:
            self.filer.close()


class ReplicationChild:
    """One `python3 -m seaweedfs_tpu_torch.replication` child of phase
    19c.5; a thread reads its output and notes the seconds from its spawn
    to its "initial" line."""

    def __init__(self, name: str, argv: list, cwd: str):
        self.name, self.t0, self.lines, self.initial_s = name, time.perf_counter(), [], None
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.replication", *argv], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())
            if self.initial_s is None and "initial" in line:
                self.initial_s = time.perf_counter() - self.t0

    def stop(self) -> tuple[int | None, float]:
        """SIGTERM: (the exit code, None where it was killed; the seconds
        it took to exit)."""
        t0 = time.perf_counter()
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=REPL_STOP_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=REPL_STOP_S)
            rc = None
        self.reader.join(timeout=5)
        return rc, time.perf_counter() - t0


def last_event_ns(furl: str, since: int) -> int:
    """The timestamp of the last event in a filer's meta log, from `since`."""
    while True:
        code, _, body = http(f"{furl}/~meta/tail?sinceNs={since}&limit=10000")
        if code != 200:
            raise AssertionError(f"19c: /~meta/tail answered {code}")
        doc = json.loads(body)
        if not doc["events"]:
            return since
        since = doc["lastTsNs"]


def remote_phase(child: S3GatewayChild, clb: ClusterB, work: str) -> tuple[dict, dict]:
    """Phase 19c: remote storage and replication, between phase 19's child
    (cluster A: its gateway is the "cloud") and `ClusterB`. 19c.1 through
    A's gateway, `REMOTE_BUCKET` of `REMOTE_LARGE` objects of 1-5 MiB and
    `REMOTE_SMALL` inlined ones; the port shell's `ec.encode` of its
    collection at A (launches == batches), data shard 0 unmounted; 19c.2
    the port shell at B: `remote.configure` (the gateway, the admin key),
    `remote.mount` (every object mapped, the listing paged), every large
    file and `REMOTE_READ_SMALL` small ones read through B's filer HTTP
    whole and in a range, sha256-equal, each through `read_remote` to A's
    degraded read; 19c.3 keys added, overwritten at another size and
    deleted through the gateway, `remote.meta.sync` counting them, the
    reads following; 19c.4 `remote.cache` of every large file; 19c.5
    three `python3 -m seaweedfs_tpu_torch.replication` children from A's
    filer `/src` (`REMOTE_TREE`) to B's filer, to `s3://<the gateway>/
    mirror/pfx` and to a local directory: each full copy sha256-equal, a
    tail of writes, an overwrite, a rename and deletes of a file and of a
    directory arriving at each sink (the lag from the last write), each
    child stopped by SIGTERM with exit code 0 and its state at the last
    event; then B's `ec.encode` (launches == batches) and data shard 0
    unmounted at B, every cached file and B's copy of /src read through
    B's filer sha256-equal; `remote.uncache` of one file (read through the
    remote again), `remote.unmount` (the entries gone, the object still at
    A) and `remote.mount.buckets`; 19c.6 a worker child with
    `-capabilities iceberg` at A's master, the shell's `task.submit -kind
    iceberg` done and the table left with its current snapshot alone.
    `gf2_apply_planes` launches at each cluster == its interval-cache
    loads from its seal on. Returns (result, launches of both clusters)."""
    from urllib.parse import quote

    from seaweedfs_tpu_torch.shell.commands import ShellEnv, run_command
    from seaweedfs_tpu_torch.utils import urls

    t_phase = time.perf_counter()
    rb, proc = REMOTE_BUCKET, child.proc
    ak, sk = S3GW_KEYS["admin"]
    afurl = f"http://127.0.0.1:{child.fport}"
    cli = S3Client(child.s3port)
    c = cli.call
    rng = np.random.default_rng(REMOTE_SEED)
    walls: dict = {}
    redials0 = CONNECT_RETRIES[0]
    senv_a = senv_b = None
    repl: dict = {}
    root = os.path.join(work, "remote")
    os.makedirs(root)
    wlog = open(os.path.join(root, "worker.log"), "wb")
    # the worker child imports torch while 19c.1-19c.5 run
    worker = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch.worker", "-master",
         f"127.0.0.1:{child.mport}", "-capabilities", "iceberg"], cwd=root,
        env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__))),
        stdout=wlog, stderr=subprocess.STDOUT)
    t_worker = time.perf_counter()
    plain_connection = urls.connection
    urls.connection = redial_connection  # B's remote reads dial A's gateway with the redial

    def check(*a):
        if proc.poll() is not None:
            raise AssertionError(f"19c: the gateway's server exited with {proc.returncode}: "
                                 + child.log_tail())
        return s3_expect("19c", *a)

    def shell(env, line: str, want: str | None = None, pattern: str | None = None) -> str:
        out = run_command(env, line)
        if (want is not None and out != want) or (pattern is not None
                                                  and not re.fullmatch(pattern, out)):
            raise AssertionError(f"19c: `{line.split(' -accessKey')[0]}` answered {out!r}")
        return out

    bfurl = None

    def read_b(path: str, rng_read=None, want: bytes | None = None) -> float:
        """One whole GET of `path` through B's filer, sha256-equal to
        `want`, and a ranged one; the whole GET's seconds."""
        t1 = time.perf_counter()
        code, _, got = http(f"{bfurl}{quote(path)}")
        dt = time.perf_counter() - t1
        if code != 200 or hashlib.sha256(got).digest() != hashlib.sha256(want).digest():
            raise AssertionError(f"19c: GET {path} through B answered {code}, {len(got)} bytes "
                                 f"not the {len(want)} written")
        lo = int(rng_read.integers(0, len(want)))
        hi = int(rng_read.integers(lo, len(want)))
        code, _, part = http(f"{bfurl}{quote(path)}", headers={"Range": f"bytes={lo}-{hi}"})
        if code != 206 or part != want[lo:hi + 1]:
            raise AssertionError(f"19c: ranged GET {path} through B answered {code}")
        return dt

    try:
        # -- 19c.1. the remote's bucket at A, sealed -----------------------------------
        t0 = time.perf_counter()
        check("the bucket", c("PUT", f"/{rb}"), 200)
        objects: dict = {}  # key -> body
        large = []
        for i in range(REMOTE_LARGE):
            key = f"large/{'xy'[i % 2]}/d{i % 3}/obj-{i:02d}.bin"
            objects[key] = rng.bytes(int(rng.integers(1 << 20, 5 << 20)))
            check(f"PUT {key}", c("PUT", f"/{rb}/{key}", body=objects[key]), 200)
            large.append(key)
        small = []
        for i in range(REMOTE_SMALL):
            key = f"small/{i % 10}/s{i:04d}.txt"
            objects[key] = rng.bytes(int(rng.integers(1, 400)))
            check(f"PUT {key}", c("PUT", f"/{rb}/{key}", body=objects[key]), 200)
            small.append(key)
        walls["puts"] = time.perf_counter() - t0
        senv_a = ShellEnv(f"127.0.0.1:{child.mport}")
        seal: dict = {}
        vids_a, batches_a, _ = seal_bucket(child, senv_a, rb, "19c", seal)
        walls["encode_a"], walls["unmount_a"] = seal["encode"], seal["unmount"]
        at_seal_a = child_kernels(child, "19c")

        # -- 19c.2. the remote mount at B -----------------------------------------------------
        t0 = time.perf_counter()
        clb.ready()
        walls["cluster_b_wait"] = time.perf_counter() - t0
        bfurl = f"http://127.0.0.1:{clb.fport}"
        senv_b = ShellEnv(f"127.0.0.1:{clb.mport}", f"127.0.0.1:{clb.fport}")
        t0 = time.perf_counter()
        shell(senv_b, f"remote.configure -name g -endpoint http://127.0.0.1:{child.s3port} "
                      f"-accessKey {ak} -secretKey {sk}", "configured=True")
        shell(senv_b, f"remote.mount -dir /mnt/g -remote g -bucket {rb}",
              f"mounted={len(objects)}")
        walls["mount"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        uncached = [read_b(f"/mnt/g/{k}", rng, objects[k]) for k in large]
        picked = [small[int(j)] for j in rng.choice(len(small), REMOTE_READ_SMALL, replace=False)]
        uncached_small = [read_b(f"/mnt/g/{k}", rng, objects[k]) for k in picked]
        walls["remote_reads"] = time.perf_counter() - t0

        # -- 19c.3. metadata sync -----------------------------------------------------------
        t0 = time.perf_counter()
        for i in range(3):
            key = f"new/n{i}.bin"
            objects[key] = rng.bytes(int(rng.integers(1000, 300_000)))
            check(f"PUT {key}", c("PUT", f"/{rb}/{key}", body=objects[key]), 200)
        for key in large[:2]:
            objects[key] = rng.bytes(len(objects[key]) + int(rng.integers(1, 1 << 20)))
            check(f"overwrite {key}", c("PUT", f"/{rb}/{key}", body=objects[key]), 200)
        gone = small[-2:]
        for key in gone:
            check(f"DELETE {key}", c("DELETE", f"/{rb}/{key}"), 204)
            del objects[key]
        shell(senv_b, "remote.meta.sync -dir /mnt/g", "added=3, updated=2, removed=2")
        for key in ["new/n0.bin", "new/n1.bin", "new/n2.bin", *large[:2]]:
            read_b(f"/mnt/g/{key}", rng, objects[key])
        for key in gone:
            code, _, _ = http(f"{bfurl}/mnt/g/{quote(key)}")
            if code != 404:
                raise AssertionError(f"19c: {key} deleted at A answered {code} through B")
        walls["meta_sync"] = time.perf_counter() - t0

        # -- 19c.4. remote.cache of every large file ----------------------------------------
        t0 = time.perf_counter()
        for key in large:
            n = -(-len(objects[key]) // (4 << 20))
            shell(senv_b, f"remote.cache -path /mnt/g/{key}", f"cached=True, chunks={n}")
        walls["cache"] = time.perf_counter() - t0

        # -- 19c.5. replication: three children from A's /src ---------------------------
        t0 = time.perf_counter()
        tree: dict = {}
        for rel, n in REMOTE_TREE.items():
            tree[rel] = rng.bytes(n)
            code, _, got = http(f"{afurl}/src/{rel}", "POST", tree[rel])
            if code != 201:
                raise AssertionError(f"19c: POST /src/{rel} at A answered {code} {got[:200]!r}")
        walls["src_writes"] = time.perf_counter() - t0
        local = os.path.join(root, "local")
        sinks = {"filer": f"127.0.0.1:{clb.fport}",
                 "s3": f"s3://127.0.0.1:{child.s3port}/{REMOTE_MIRROR}/pfx", "local": local}
        t0 = time.perf_counter()
        for name, to in sinks.items():
            repl[name] = ReplicationChild(name, [
                "-from", f"127.0.0.1:{child.fport}", "-to", to, "-path", "/src",
                "-state", os.path.join(root, f"{name}.state"), "-s3.accessKey", ak,
                "-s3.secretKey", sk], root)

        def at_sink(name: str, rel: str) -> bytes | None:
            """What sink `name` holds at `rel`, None where it holds nothing."""
            if name == "filer":
                code, _, got = http(f"{bfurl}/src/{quote(rel)}")
                return got if code == 200 else None
            if name == "s3":
                code, _, got = c("GET", f"/{REMOTE_MIRROR}/pfx/{rel}")
                return got if code == 200 else None
            try:
                with open(os.path.join(local, rel), "rb") as f:
                    return f.read()
            except (FileNotFoundError, IsADirectoryError):  # the child removes it meanwhile
                return None

        def alive(name: str) -> None:
            if repl[name].proc.poll() is not None:
                raise AssertionError(f"19c: the {name} child exited with "
                                     f"{repl[name].proc.returncode}: {repl[name].lines[-20:]}")

        def holds(name: str, want: dict, removed=()) -> bool:
            alive(name)
            return all(at_sink(name, r) == b for r, b in want.items()) and all(
                at_sink(name, r) is None for r in removed)

        # each child's "initial" line follows its full copy: the copy is then whole
        for name in sinks:
            wait_until(lambda n=name: alive(n) or repl[n].initial_s is not None,
                       f"the {name} child's initial copy", timeout=120, phase="19c")
            if not holds(name, tree):
                raise AssertionError(f"19c: the {name} child's full copy differs from /src")
        walls["replication_full_copy"] = time.perf_counter() - t0
        # the tail: a write, an overwrite, a rename, a file and a directory deleted
        t0 = time.perf_counter()
        since = last_event_ns(afurl, 0)
        final = dict(tree)
        final["h/new.bin"] = rng.bytes(300_000)
        final["a/big0.bin"] = rng.bytes(REMOTE_TREE["a/big0.bin"] - 4321)
        final["a/moved.bin"] = final.pop("a/b/c/mid.bin")
        del final["d/big2.bin"]
        removed = ["a/b/c/mid.bin", "d/big2.bin"] + [r for r in tree if r.startswith("e/g/")]
        for r in removed[2:]:
            del final[r]
        changed = {r: final[r] for r in ("h/new.bin", "a/big0.bin", "a/moved.bin")}
        for how, path, body in (("POST", "/src/h/new.bin", final["h/new.bin"]),
                                ("POST", "/src/a/big0.bin", final["a/big0.bin"]),
                                ("POST", "/src/a/moved.bin?mv.from=/src/a/b/c/mid.bin", b""),
                                ("DELETE", "/src/d/big2.bin", None),
                                ("DELETE", "/src/e/g?recursive=true", None)):
            code, _, got = http(f"{afurl}{path}", how, body)
            if code not in (200, 201, 204):
                raise AssertionError(f"19c: {how} {path} at A answered {code} {got[:200]!r}")
        t_last = time.perf_counter()
        lags = {}
        pending = set(sinks)
        while pending:
            for name in sorted(pending):
                if holds(name, changed, removed):
                    lags[name] = time.perf_counter() - t_last
                    pending.discard(name)
            if time.perf_counter() - t_last > 60:
                raise AssertionError(f"19c: the tail never reached {sorted(pending)}")
            time.sleep(0.02)
        for name in sinks:
            if not holds(name, final, removed):
                raise AssertionError(f"19c: the {name} child's copy differs from /src after "
                                     "the tail")
        walls["replication_tail"] = time.perf_counter() - t0
        # each child's state reaches A's last event, then SIGTERM
        t0 = time.perf_counter()
        last = last_event_ns(afurl, since)

        def state_of(name: str) -> int:
            try:
                with open(os.path.join(root, f"{name}.state")) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                return 0
            return int(doc.get("sinceNs", doc.get("watermark", 0)))

        for name in sinks:
            wait_until(lambda n=name: state_of(n) >= last, f"the {name} child's state at A's "
                       "last event", timeout=30, phase="19c")
        stops = {}
        for name in sinks:
            rc, secs = repl[name].stop()
            stops[name] = secs
            if rc != 0 or state_of(name) < last:
                raise AssertionError(f"19c: the {name} child exited with {rc} after {secs:.1f} s, "
                                     f"its state {state_of(name)} against {last}: "
                                     f"{repl[name].lines[-20:]}")
        walls["replication_stop"] = time.perf_counter() - t0

        # -- 19c.4 (cont.). B sealed: the cached files and B's /src read degraded ----------
        seal = {}
        vids_b, batches_b, _ = seal_collection(senv_b, clb.mport, clb.vport, clb.d, "", "19c", seal)
        walls["encode_b"], walls["unmount_b"] = seal["encode"], seal["unmount"]
        at_seal_b = kernels_at(clb.vport, "19c")
        t0 = time.perf_counter()
        cached = [read_b(f"/mnt/g/{k}", rng, objects[k]) for k in large]
        for rel, body in final.items():
            read_b(f"/src/{rel}", rng, body)
        walls["degraded_reads_b"] = time.perf_counter() - t0
        now_b = kernels_at(clb.vport, "19c")
        recon_b = now_b["interval_cache"]["loads"] - at_seal_b["interval_cache"]["loads"]
        got_b = {k: now_b["launches"][k] - at_seal_b["launches"][k] for k in now_b["launches"]}
        if got_b != {"gf2_apply": 0, "gf2_apply_planes": recon_b} or recon_b < 1:
            raise AssertionError(f"19c: B's degraded reads launched {got_b} for {recon_b} "
                                 "reconstructions")
        t0 = time.perf_counter()
        shell(senv_b, f"remote.uncache -path /mnt/g/{large[0]}", "uncached=True")
        read_b(f"/mnt/g/{large[0]}", rng, objects[large[0]])
        shell(senv_b, "remote.unmount -dir /mnt/g", "unmounted=True")
        code, _, _ = http(f"{bfurl}/mnt/g/{quote(large[0])}")
        if code != 404:
            raise AssertionError(f"19c: after remote.unmount a mounted file answered {code}")
        check("a HEAD at A after the unmount", c("HEAD", f"/{rb}/{large[0]}"), 200)
        shell(senv_b, "remote.mount.buckets -dir /gb -remote g -prefix remote-",
              f"mounted={{'{rb}': {len(objects)}}}, buckets=1")
        read_b(f"/gb/{rb}/{large[1]}", rng, objects[large[1]])
        walls["uncache_unmount"] = time.perf_counter() - t0

        # -- 19c.6. the worker's iceberg task ---------------------------------------------
        t0 = time.perf_counter()
        ib = f"/iceberg/v1/{REMOTE_ICEBERG}"

        def cat(what: str, method: str, path: str, doc=None, headers=None) -> dict:
            _, _, out = check(what, c(method, path, body=b"" if doc is None else
                                      json.dumps(doc).encode(),
                                      headers={"Content-Type": "application/json",
                                               **(headers or {})}), 200)
            return json.loads(out) if out else {}

        cat("CreateTableBucket", "POST", "/", {"name": REMOTE_ICEBERG},
            {"X-Amz-Target": "S3Tables.CreateTableBucket"})
        cat("the namespace", "POST", f"{ib}/namespaces", {"namespace": ["ice"]})
        cat("the table", "POST", f"{ib}/namespaces/ice/tables", {"name": "t", "schema": {
            "type": "struct", "schema-id": 0, "fields": [
                {"id": 1, "name": "id", "required": True, "type": "long"}]}})
        for sid in (1, 2, 3):
            cat(f"snapshot {sid}", "POST", f"{ib}/namespaces/ice/tables/t", {"updates": [
                {"action": "add-snapshot", "snapshot": {
                    "snapshot-id": sid, "sequence-number": sid,
                    "timestamp-ms": int(time.time() * 1000) - (4 - sid) * 86400_000,
                    "manifest-list": f"s3://{REMOTE_ICEBERG}/ice/t/metadata/snap-{sid}.avro",
                    "summary": {"operation": "append"}}},
                {"action": "set-snapshot-ref", "ref-name": "main", "snapshot-id": sid,
                 "type": "branch"}]})

        def worker_line() -> str | None:
            if worker.poll() is not None:
                raise AssertionError(f"19c: the worker child exited with {worker.returncode}")
            lines = run_command(senv_a, "worker.list").splitlines()
            return lines[0] if len(lines) == 1 and lines[0].startswith("worker-") else None

        wline = wait_value(worker_line, "the worker child listed at A's master", timeout=120,
                           phase="19c")
        worker_s = time.perf_counter() - t_worker
        if " caps=iceberg " not in wline:
            raise AssertionError(f"19c: worker.list answered {wline!r}")
        out = shell(senv_a, f"task.submit -kind iceberg -param s3=127.0.0.1:{child.s3port} "
                            f"-param bucket={REMOTE_ICEBERG} -param older_than_days=0 "
                            f"-param access_key={ak} -param secret_key={sk}",
                    pattern=r"task \w+ submitted")
        task_id = out.split()[1]

        def task_state() -> str | None:
            for ln in run_command(senv_a, "task.list").splitlines():
                if ln.startswith(f"{task_id} iceberg "):
                    st = ln.split()[3]
                    if st == "failed":
                        raise AssertionError(f"19c: the iceberg task failed: {ln}")
                    return ln if st == "done" else None
            return None

        task_line = wait_value(task_state, "the iceberg task done", timeout=60, phase="19c")
        md = cat("loadTable", "GET", f"{ib}/namespaces/ice/tables/t")["metadata"]
        if [sn["snapshot-id"] for sn in md["snapshots"]] != [3] or md["current-snapshot-id"] != 3:
            raise AssertionError(f"19c: after the iceberg task the snapshots are "
                                 f"{[sn['snapshot-id'] for sn in md['snapshots']]}")
        worker.send_signal(signal.SIGTERM)
        try:
            worker_rc = worker.wait(timeout=CHILD_STOP_S)
        except subprocess.TimeoutExpired:
            worker_rc = None
        if worker_rc != 0:
            raise AssertionError(f"19c: the worker child exited with {worker_rc} on SIGTERM")
        walls["iceberg"] = time.perf_counter() - t0

        now_a = child_kernels(child, "19c")
        recon_a = now_a["interval_cache"]["loads"] - at_seal_a["interval_cache"]["loads"]
        got_a = {k: now_a["launches"][k] - at_seal_a["launches"][k] for k in now_a["launches"]}
        if got_a != {"gf2_apply": 0, "gf2_apply_planes": recon_a} or recon_a < 1:
            raise AssertionError(f"19c: A's reads from the seal on launched {got_a} for {recon_a} "
                                 "reconstructions")
        step = {
            "bucket": rb, "objects_mounted": REMOTE_LARGE + REMOTE_SMALL,
            "object_bytes": sum(len(objects[k]) for k in large),
            "meta_sync": {"added": 3, "updated": 2, "removed": 2},
            "remote_read_large_p50_ms": percentile_ms(uncached, 50),
            "remote_read_large_p99_ms": percentile_ms(uncached, 99),
            "remote_read_small_p50_ms": percentile_ms(uncached_small, 50),
            "remote_read_small_p99_ms": percentile_ms(uncached_small, 99),
            "cached_read_p50_ms": percentile_ms(cached, 50),
            "cached_read_p99_ms": percentile_ms(cached, 99),
            "src_files": len(REMOTE_TREE), "src_bytes": sum(REMOTE_TREE.values()),
            "replication_lag_s": lags,
            "replication_initial_s": {n: r.initial_s for n, r in repl.items()},
            "replication_stop_s": stops, "worker_listed_s": worker_s, "iceberg_task": task_line,
            "cluster_b_start_s": clb.start_s, "volumes_a": vids_a, "volumes_b": vids_b,
            "launches_a": {"gf2_apply": batches_a, "gf2_apply_planes": recon_a},
            "launches_b": {"gf2_apply": batches_b, "gf2_apply_planes": recon_b},
            "requests": cli.requests, "walls": walls,
            "redials": CONNECT_RETRIES[0] - redials0, "seconds": time.perf_counter() - t_phase}
    finally:
        urls.connection = plain_connection
        cli.close()
        for r in repl.values():
            if r.proc.poll() is None:
                r.proc.kill()
                r.proc.wait(timeout=REPL_STOP_S)
        if worker.poll() is None:
            worker.kill()
            worker.wait(timeout=CHILD_STOP_S)
        wlog.close()
        for env in (senv_a, senv_b):
            if env is not None:
                env.close()
    return {"steps": step, "card": card_line()}, {
        "gf2_apply": batches_a + batches_b, "gf2_apply_planes": recon_a + recon_b}


# -- phase 20: the MQ broker by name ----------------------------------------------

MQ20_NS, MQ20_TOPIC = "bench", "omb"  # the durable-parity topic of 20a-20c
MQ20_PARTITIONS = 4
MQ20_RECORDS = 24_576  # 6,144 a partition: one sealed segment and 2,048 in parity alone
MQ20_SEGMENT = 4096  # records a sealed segment holds: the launcher's -segmentRecords default
MQ20_COMMIT_EVERY = 1024  # 20a's consumer group commits every this many records a partition
MQ20_SEED = SEED + 30
MQ20_TS0 = 1_700_000_000_000_000_000  # record i carries ts_ns MQ20_TS0 + i
MQ20_COLLECTION = "mqseg"  # the broker's segments, by fs.configure at /topics/
MQ20_HA_RECORDS = 4096  # 20d: published through the group's first broker
MQ20_AGENT_RECORDS = 1000  # 20e: one agent session
MQ20_FILES = 200  # 20e: written through the notifying filer child
MQ20_START_S = 120.0  # a child's wait to serve (a restart's torch import and replay included)
MQ20_SCHEMA = json.dumps({"enforce": True, "fields": [{"name": "id", "type": "int", "required": True}]})


def mq20_shell_steps(broker: str, counts: list[int], archived: int) -> list:
    """Phase 20b: the port shell's 8 `mq.*` against `broker`, in order,
    each (command line, the answer it must give); a line of None marks
    where smoke20b's 10 records go in (`mq20_publish_smoke20b`), its answer
    the refusal of the one record its schema refuses. `counts`:
    bench/omb's records by partition; `archived`: what `mq.topic.compact`
    archives, 2 where pyarrow imports and 0 where it does not, as the JAX
    broker answers (tests/test_torch_mq.py holds both packages to it)."""
    b = f"-broker {broker}"
    omb = "\n".join(f"partition {p}: offsets [0, {n}) ({n} records)" for p, n in enumerate(counts))
    return [
        (f"mq.topic.list {b}", f"{MQ20_NS}/{MQ20_TOPIC}  partitions={len(counts)}"),
        (f"mq.topic.describe -topic {MQ20_TOPIC} -namespace {MQ20_NS} {b}", omb),
        (f"mq.topic.configure -topic smoke20b -partitions 2 {b}",
         "configured default/smoke20b with 2 partitions"),
        (f"mq.schema.set -topic smoke20b -schema {shlex.quote(MQ20_SCHEMA)} {b}",
         "schema registered for smoke20b"),
        (f"mq.schema.get -topic smoke20b {b}", MQ20_SCHEMA),
        (None, "schema violation: field 'id' is not a int"),
        (f"mq.topic.describe -topic smoke20b {b}",
         "partition 0: offsets [0, 5) (5 records)\npartition 1: offsets [0, 5) (5 records)"),
        (f"mq.topic.compact -topic smoke20b {b}", f"archived {archived} segments of default/smoke20b"),
        (f"mq.topic.truncate -topic smoke20b -partition 1 -beforeOffset 3 {b}",
         "truncated 1 partition(s) of default/smoke20b"),
        (f"mq.topic.describe -topic smoke20b {b}",
         "partition 0: offsets [0, 5) (5 records)\npartition 1: offsets [3, 5) (2 records)"),
        (f"mq.topic.delete -topic smoke20b {b}", "deleted topic default/smoke20b"),
        (f"mq.topic.list {b}", f"{MQ20_NS}/{MQ20_TOPIC}  partitions={len(counts)}"),
    ]


def mq20_publish_smoke20b(client) -> str:
    """20b's records: {"id": i} on partition i % 2, then one whose id is
    not an int; returns the refusal."""
    for i in range(10):
        client.publish("smoke20b", json.dumps({"id": i}).encode(), partition=i % 2)
    try:
        client.publish("smoke20b", b'{"id": "x"}', partition=0)
    except RuntimeError as e:
        return str(e)
    raise AssertionError("20b: a record against smoke20b's schema was taken")


def mq20_run_shell(senv, broker: str, counts: list[int], archived: int, client) -> list:
    """Run `mq20_shell_steps` through `run_command`; raise on the first
    answer that differs. Returns the answers, the broker masked."""
    from seaweedfs_tpu_torch.shell.commands import run_command

    out = []
    for line, want in mq20_shell_steps(broker, counts, archived):
        got = mq20_publish_smoke20b(client) if line is None else run_command(senv, line)
        if got != want:
            raise AssertionError(f"20b: `{line}` answered {got!r}, not {want!r}")
        out.append(got.replace(broker, "<broker>"))
    return out


def mq20_source(n: int) -> tuple[bytes, bytes]:
    """Phase 20's keys and values, seeded: record i has key
    keys[16i:16i+16] and value values[1024i:1024i+1024]."""
    rng = np.random.default_rng(MQ20_SEED)
    return rng.bytes(MQ_KEY * n), rng.bytes(MQ_VALUE * n)


# -- 20f: the Kafka gateway on phase 20's broker child -----------------------------

KAFKA20_TOPIC = "k20"  # the durable-parity Kafka topic (namespace kafka) of 20f
KAFKA20_PARTITIONS = 2
KAFKA20_RECORDS = 12_288  # 6,144 a partition: one sealed segment and 2,048 in parity alone
KAFKA20_BATCH = 128  # the records of one produce request
KAFKA20_COHORT = 256  # acknowledged right before the SIGKILL, 128 a partition
KAFKA20_KILL_MS = 50.0  # the SIGKILL falls within this of the cohort's last ack
KAFKA20_GROUP = "kg"
KAFKA20_TS0_MS = 1_700_000_000_000  # record i carries timestamp_ms KAFKA20_TS0_MS + i
KAFKA20_GROUP_COMMIT_MS = "10"  # the broker child's SEAWEED_MQ_GROUP_COMMIT_MS


def kafka20_codecs() -> list[int]:
    """The batch codecs 20f's produce requests take in turn: gzip, snappy,
    lz4 and none, and zstd where the host has `zstandard`."""
    import importlib.util

    from seaweedfs_tpu_torch.mq.kafka import records as kr

    out = [kr.COMPRESSION_GZIP, kr.COMPRESSION_SNAPPY, kr.COMPRESSION_LZ4, kr.COMPRESSION_NONE]
    if importlib.util.find_spec("zstandard") is not None:
        out.append(kr.COMPRESSION_ZSTD)
    return out


def kafka20_record(keys: bytes, values: bytes, i: int):
    """Record i of 20f: phase 7b's key and value i (`mq_source`), its own
    timestamp; it goes to partition i % KAFKA20_PARTITIONS at offset
    i // KAFKA20_PARTITIONS."""
    from seaweedfs_tpu_torch.mq.kafka.records import Record

    return Record(key=keys[i * MQ_KEY:(i + 1) * MQ_KEY],
                  value=values[i * MQ_VALUE:(i + 1) * MQ_VALUE], timestamp_ms=KAFKA20_TS0_MS + i)


def kafka20_produce(kport: int, keys: bytes, values: bytes, first: int, count: int,
                    codecs: list[int], phase: str) -> dict:
    """Records first .. first+count-1 of 20f through the broker's Kafka
    gateway, in produce requests of KAFKA20_BATCH records with acks=-1,
    from one connection a partition, the codecs in turn. Every answer
    must be NONE at the offset expected: a KAFKA_STORAGE_ERROR (a failed
    group-commit window) fails the phase, with no retry. Returns the
    requests, the wall, each ack's latency and the last ack's time."""
    from seaweedfs_tpu_torch.mq.kafka.client import KafkaClient, KafkaError

    lat, acked_at, errors = [], [], []
    clients = [KafkaClient("127.0.0.1", kport, client_id=f"smoke20f-{p}")
               for p in range(KAFKA20_PARTITIONS)]

    def run(p: int) -> None:
        idx = list(range(first + p, first + count, KAFKA20_PARTITIONS))
        try:
            for b in range(0, len(idx), KAFKA20_BATCH):
                chunk = idx[b:b + KAFKA20_BATCH]
                codec = codecs[(b // KAFKA20_BATCH) % len(codecs)]
                t0 = time.perf_counter()
                base = clients[p].produce(KAFKA20_TOPIC, p, [kafka20_record(keys, values, i)
                                                             for i in chunk],
                                          acks=-1, compression=codec)
                t1 = time.perf_counter()
                if base != chunk[0] // KAFKA20_PARTITIONS:
                    raise AssertionError(f"{phase}: a produce of record {chunk[0]} answered "
                                         f"offset {base}")
                lat.append(t1 - t0)
                acked_at.append(t1)
        except KafkaError as e:
            errors.append(AssertionError(f"{phase}: a produce to partition {p} answered {e}"))
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(p,)) for p in range(KAFKA20_PARTITIONS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for c in clients:
        c.close()
    if errors:
        raise errors[0]
    return {"requests": len(lat), "seconds": wall, "lat": lat, "last_ack": max(acked_at)}


def kafka20_fetch_all(client, keys: bytes, values: bytes, per: int, phase: str) -> dict:
    """Every record of the topic's partitions fetched from offset 0
    through `client`, each byte-exact (key, value, timestamp) at its
    offset, up to `per` a partition and a high watermark of `per`."""
    fetches, t0 = 0, time.perf_counter()
    for p in range(KAFKA20_PARTITIONS):
        off = hw = 0
        while off < per:
            hw, recs = client.fetch(KAFKA20_TOPIC, p, off, max_wait_ms=0, max_bytes=4 << 20)
            fetches += 1
            if not recs:
                raise AssertionError(f"{phase}: partition {p} fetched nothing at {off} "
                                     f"(high watermark {hw})")
            for r in recs:
                want = kafka20_record(keys, values, off * KAFKA20_PARTITIONS + p)
                if (r.offset, r.key, r.value, r.timestamp_ms) != (
                        off, want.key, want.value, want.timestamp_ms):
                    raise AssertionError(f"{phase}: partition {p}'s record at {off} differs "
                                         f"(offset {r.offset})")
                off += 1
        if (off, hw) != (per, per):
            raise AssertionError(f"{phase}: partition {p} fetched {off} records, high watermark "
                                 f"{hw}, of {per}")
    seconds = time.perf_counter() - t0
    n = per * KAFKA20_PARTITIONS
    return {"records": n, "fetches": fetches, "seconds": seconds, "records_per_s": n / seconds}


def kafka20_group(kport: int, keys: bytes, values: bytes, per: int) -> dict:
    """20f's group: `kg` joins (its only member leads), assigns both
    partitions by range, syncs, fetches every record through the
    gateway, commits each partition's next offset, heartbeats and
    leaves."""
    from seaweedfs_tpu_torch.mq.kafka.client import KafkaClient, assign_range, parse_assignment

    t0 = time.perf_counter()
    c = KafkaClient("127.0.0.1", kport, client_id="smoke20f-kg")
    try:
        joined = c.join_group(KAFKA20_GROUP, topics=[KAFKA20_TOPIC])
        if joined["leader"] != joined["member_id"]:
            raise AssertionError(f"20f: group {KAFKA20_GROUP}'s only member does not lead")
        blob = c.sync_group(KAFKA20_GROUP, joined["generation"], joined["member_id"],
                            assign_range(joined["members"], {KAFKA20_TOPIC: KAFKA20_PARTITIONS}))
        parts = parse_assignment(blob).get(KAFKA20_TOPIC)
        if parts != list(range(KAFKA20_PARTITIONS)):
            raise AssertionError(f"20f: group {KAFKA20_GROUP} was assigned {parts}")
        fetched = kafka20_fetch_all(c, keys, values, per, "20f")
        errs = [c.commit_offset(KAFKA20_GROUP, KAFKA20_TOPIC, p, per) for p in parts]
        errs += [c.heartbeat(KAFKA20_GROUP, joined["generation"], joined["member_id"]),
                 c.leave_group(KAFKA20_GROUP, joined["member_id"])]
        if errs != [0] * (len(parts) + 2):
            raise AssertionError(f"20f: group {KAFKA20_GROUP}'s commits, heartbeat and leave "
                                 f"answered {errs}")
        committed = [c.fetch_offset(KAFKA20_GROUP, KAFKA20_TOPIC, p) for p in parts]
    finally:
        c.close()
    if committed != [per] * KAFKA20_PARTITIONS:
        raise AssertionError(f"20f: group {KAFKA20_GROUP} committed {committed}")
    return {"generation": joined["generation"], "fetched": fetched, "committed": committed,
            "seconds": time.perf_counter() - t0}


def torch_mapped(pid: int):
    """Whether process `pid` has torch's library mapped (None where
    /proc/<pid>/maps cannot be read)."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "libtorch" in f.read()
    except OSError:
        return None


class MqChild:
    """A port server by name (`python3 -m seaweedfs_tpu_torch.server
    <args>`) under `root`, its output in `<root>/<name>.log`; a thread
    polls `ready()` and notes the seconds from the spawn to the first
    true answer, and whether torch was mapped then."""

    def __init__(self, root: str, name: str, args: list, ready, env: dict | None = None):
        self.t0 = time.perf_counter()
        self.root, self.name = root, name
        self.log = open(os.path.join(root, f"{name}.log"), "ab")
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
                   **(env or {}))
        self.proc = subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch.server", *args],
                                     cwd=root, env=env, stdout=self.log, stderr=subprocess.STDOUT)
        self.serving: dict = {}
        self.watcher = threading.Thread(target=self._watch, args=(ready,), daemon=True)
        self.watcher.start()

    def _watch(self, ready) -> None:
        while time.perf_counter() < self.t0 + MQ20_START_S and self.proc.poll() is None:
            try:
                if ready():
                    self.serving["serving_s"] = time.perf_counter() - self.t0
                    self.serving["torch_mapped"] = torch_mapped(self.proc.pid)
                    return
            except (OSError, AssertionError):
                pass
            time.sleep(0.05)

    def wait(self, phase: str) -> dict:
        self.watcher.join(timeout=max(0.0, MQ20_START_S - (time.perf_counter() - self.t0)))
        if "serving_s" not in self.serving:
            raise AssertionError(f"{phase}: the {self.name} child did not serve within "
                                 f"{MQ20_START_S} s (exit {self.proc.poll()}): {self.log_tail()}")
        return self.serving

    def log_tail(self) -> str:
        self.log.flush()
        with open(os.path.join(self.root, f"{self.name}.log"), "rb") as f:
            return f.read()[-3000:].decode(errors="replace")

    def kill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=CHILD_STOP_S)
        self.log.close()

    stop = TlsChild.stop  # SIGTERM; the exit code, None where it was killed


def http_ready(port: int, path: str = "/"):
    """A ready() for MqChild: any HTTP answer at `path`."""
    def ready() -> bool:
        c = HTTPConnection("127.0.0.1", port, timeout=2)
        try:
            c.request("GET", path)
            c.getresponse().read()
            return True
        finally:
            c.close()
    return ready


def grpc_ready(addr: str):
    """A ready() for MqChild: a gRPC channel that connects."""
    import grpc

    def ready() -> bool:
        with grpc.insecure_channel(addr) as ch:
            try:
                grpc.channel_ready_future(ch).result(timeout=1)
                return True
            except grpc.FutureTimeoutError:
                return False
    return ready


class BrokerChild(MqChild):
    """Phase 20's `mq.broker` child over the filer at `fport`, with a
    parity directory, a status plane and the Kafka gateway, its durable
    produces acknowledged by the group commit (SEAWEED_MQ_GROUP_COMMIT_MS
    = KAFKA20_GROUP_COMMIT_MS; the native Publish path does not wait on
    it); `restart()` spawns it again by name with the same flags. Its
    temporary files (the fetch spool) go under its directory."""

    def __init__(self, work: str, fport: int, ports: tuple[int, int, int] | None = None):
        self.work, self.fport = work, fport
        self.dir = os.path.join(work, "mq20")
        os.makedirs(os.path.join(self.dir, "tmp"), exist_ok=True)
        self.port, self.sport, self.kport = ports or (server_port(), server_port(), server_port())
        self.addr = f"127.0.0.1:{self.port}"
        super().__init__(self.dir, "broker", [
            "mq.broker", "-ip", "127.0.0.1", "-port", str(self.port), "-filer",
            f"127.0.0.1:{fport}", "-parityDir", os.path.join(self.dir, "parity"),
            "-statusPort", str(self.sport), "-kafkaPort", str(self.kport)], self._ready,
            env={"SEAWEED_MQ_GROUP_COMMIT_MS": KAFKA20_GROUP_COMMIT_MS,
                 "TMPDIR": os.path.join(self.dir, "tmp")})

    def _ready(self) -> bool:
        http_ready(self.sport, "/status")()
        # torch at the moment it serves, from its own sys.modules
        self.serving["torch_at_serving"] = self.get("/debug/kernels", "20")["torch"]
        return True

    def get(self, path: str, phase: str):
        code, _, body = http(f"http://127.0.0.1:{self.sport}{path}")
        if code != 200:
            raise AssertionError(f"{phase}: the broker's {path} answered {code}")
        return json.loads(body)

    def restart(self) -> "BrokerChild":
        return BrokerChild(self.work, self.fport, (self.port, self.sport, self.kport))


def mq20_configure(broker: BrokerChild, out: dict) -> None:
    """20.0, on a thread started as the broker child spawns: wait for it
    to serve, then the first durable-parity ConfigureTopic, which loads
    torch inside the RPC; `out` gets its seconds or the error."""
    from seaweedfs_tpu_torch.mq import MqClient

    try:
        broker.wait("20.0")
        c = MqClient(broker.addr)
        t0 = time.perf_counter()
        try:
            c.configure_topic(MQ20_TOPIC, partitions=MQ20_PARTITIONS, namespace=MQ20_NS,
                              durable_parity=True)
        finally:
            c.close()
        out["configure_s"] = time.perf_counter() - t0
    except BaseException as e:  # noqa: BLE001 - raised by the phase
        out["error"] = e


def mq20_trio(root: str, keys: bytes, values: bytes) -> dict:
    """20d: three port `MqBrokerServer`s in this process, memory-only,
    each with its own parity directory, `peers` all three, pinged every
    0.2 s. Topic `ha` (4 partitions, durable parity on the card) takes
    MQ20_HA_RECORDS through the first broker, forwarded to each leader
    and replicated to each follower; with every stream drained, partition
    0's leader (asked at that moment) is stopped, its old follower must
    lead and serve every record of partition 0 byte-exact, and a publish
    through a survivor takes the next offset. Launches == the streams'
    parity dispatches (`stream_encode.dispatch_count`)."""
    from seaweedfs_tpu_torch.ec import net_plane, stream_encode
    from seaweedfs_tpu_torch.mq import MqBrokerServer, MqClient
    from seaweedfs_tpu_torch.ops import rs_kernels
    from seaweedfs_tpu_torch.pb import mq_pb2 as mq

    t_phase = time.perf_counter()
    launches0, dispatches0 = dict(rs_kernels.LAUNCHES), stream_encode.dispatch_count()
    ports = [net_plane.free_grpc_port() for _ in range(3)]
    peers = [f"127.0.0.1:{p}" for p in ports]
    brokers, clients = [], []
    try:
        for i, p in enumerate(ports):
            b = MqBrokerServer(ip="127.0.0.1", grpc_port=p, peers=peers,
                               parity_dir=os.path.join(root, f"ha{i}"))
            b.balancer.ping_interval = 0.2
            b.start()
            brokers.append(b)
        # every broker has had a ping round answered by both peers (its
        # channels connected) before the first publish: a first ping that
        # outlives its 0.75 s timeout drops a peer from the live set for a
        # round, a partition's leader moves, and the new leader takes the
        # next publish at its own log's end (in both packages)
        wait_until(lambda: all(len(b.balancer.loads()) == 3 for b in brokers),
                   "a ping round answered at every broker of the group", phase="20d")
        clients = [MqClient(a) for a in peers]
        clients[0].configure_topic("ha", partitions=MQ20_PARTITIONS)
        for b in brokers:
            st = b.broker.topic("default", "ha")
            if not st.durable_parity or sorted(st.parity) != list(range(MQ20_PARTITIONS)):
                raise AssertionError("20d: a broker of the group has no parity for topic ha")
        errors: list = []

        def publish(p: int) -> None:
            try:
                for i in range(p, MQ20_HA_RECORDS, MQ20_PARTITIONS):
                    r = clients[0].stub.Publish(mq.PublishRequest(
                        topic=mq.Topic(namespace="default", name="ha"), partition=p,
                        message=mq.DataMessage(key=keys[i * MQ_KEY:(i + 1) * MQ_KEY],
                                               value=values[i * MQ_VALUE:(i + 1) * MQ_VALUE],
                                               ts_ns=MQ20_TS0 + i)), timeout=30)
                    if r.error or r.offset != i // MQ20_PARTITIONS:
                        raise AssertionError(f"20d: publish {i} answered {r.error!r} at {r.offset}")
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=publish, args=(p,)) for p in range(MQ20_PARTITIONS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        publish_s = time.perf_counter() - t0
        wait_until(lambda: all(pp.pending_bytes() == 0 for b in brokers
                               for pp in b.broker.topic("default", "ha").parity.values()),
                   "every stream of the group drained", phase="20d")
        look = clients[0].stub.LookupTopicBrokers(mq.LookupTopicBrokersRequest(
            topic=mq.Topic(namespace="default", name="ha")), timeout=30)
        a0 = next(a for a in look.assignments if a.partition == 0)
        lead, fol = peers.index(a0.leader), peers.index(a0.follower)
        per = MQ20_HA_RECORDS // MQ20_PARTITIONS
        held = {i: len(brokers[i].broker.topic("default", "ha").logs[0].read_from(0, per + 1))
                for i in (lead, fol)}
        if held != {lead: per, fol: per}:
            raise AssertionError(f"20d: partition 0 held {held} by leader {lead} and follower {fol}")
        t0 = time.perf_counter()
        brokers[lead].stop()
        survivor = ({0, 1, 2} - {lead, fol}).pop()

        def promoted() -> bool:
            look = clients[survivor].stub.LookupTopicBrokers(mq.LookupTopicBrokersRequest(
                topic=mq.Topic(namespace="default", name="ha")), timeout=30)
            return next(a for a in look.assignments if a.partition == 0).leader == peers[fol]

        promote_s = wait_until(promoted, "the old follower leading partition 0", timeout=15,
                               phase="20d")
        got = list(clients[fol].subscribe("ha", 0, start_offset=0))
        for n, r in enumerate(got):
            i = n * MQ20_PARTITIONS
            if (r.offset, r.message.ts_ns, r.message.key, r.message.value) != (
                    n, MQ20_TS0 + i, keys[i * MQ_KEY:(i + 1) * MQ_KEY],
                    values[i * MQ_VALUE:(i + 1) * MQ_VALUE]):
                raise AssertionError(f"20d: the promoted follower's record {n} differs")
        if len(got) != per:
            raise AssertionError(f"20d: the promoted follower served {len(got)} of {per} records")
        after = clients[survivor].publish("ha", b"post-failover", partition=0)
        if after != (0, per):
            raise AssertionError(f"20d: a publish through a survivor answered {after}")
        failover_s = time.perf_counter() - t0
        for i, b in enumerate(brokers):
            if i != lead:
                b.stop()
    finally:
        for c in clients:
            c.close()
        for b in brokers:
            try:
                b.stop()
            except Exception:  # noqa: BLE001 - stopped already
                pass
    launches = {k: rs_kernels.LAUNCHES[k] - launches0[k] for k in launches0}
    dispatches = stream_encode.dispatch_count() - dispatches0
    if launches != {"gf2_apply": dispatches, "gf2_apply_planes": 0} or dispatches < 1:
        raise AssertionError(f"20d: the group launched {launches} for {dispatches} dispatches")
    return {"records": MQ20_HA_RECORDS, "publish_s": publish_s,
            "records_per_s": MQ20_HA_RECORDS / publish_s, "leader": lead, "follower": fol,
            "promote_s": promote_s, "failover_s": failover_s, "launches": launches,
            "dispatches": dispatches,
            "seconds": time.perf_counter() - t_phase}


def mq_broker_phase(child: S3GatewayChild, broker: BrokerChild, configured: dict,
                    configurer: threading.Thread, senv, work: str) -> tuple[dict, dict]:
    """Phase 20: the MQ broker by name on phase 19's child. 20.0 (begun
    behind phase 19): the `mq.broker` child over the child's filer, whose
    /topics/ go to collection MQ20_COLLECTION, serving without torch, and
    the first durable-parity ConfigureTopic. 20a: MQ20_RECORDS of phase
    7b's 1 KB records published by 4 threads with their own clients into
    bench/omb while group g1 follows every partition and commits; the
    parity lag sampled from /status. 20b: the shell's 8 mq.* answering
    `mq20_shell_steps`. 20c: every stream drained, the collection sealed
    by ec.encode at the child (launches == batches) and data shard 0
    unmounted, the broker SIGKILLed and spawned again by name: every
    record back byte-exact through Subscribe (the sealed segments through
    the filer with data shard 0 gone, planes launches at the child ==
    reconstructions; the tail replayed from the parity streams, launches
    in the broker == the durable stripes), g1's offsets back. 20d (while
    the broker restarts): `mq20_trio`. 20f (after 20b, its cohort and
    read-back inside 20c): the Kafka topic kafka/k20 through the broker's
    gateway, produced with acks held by the group commit, consumed by
    group kg, a final cohort acked right before the SIGKILL and every
    acked record fetched back after the restart. 20e: an `mq.agent` child by name
    (a session of MQ20_AGENT_RECORDS and an acked subscription) and a
    `filer -notify.mq` child by name, MQ20_FILES written through it, every
    event on default/filer-events. Every child SIGTERMed, exit 0 within
    CHILD_STOP_S. Returns (result, launches)."""
    import grpc

    from seaweedfs_tpu_torch.ec import load_stream_journal
    from seaweedfs_tpu_torch.mq import MqClient
    from seaweedfs_tpu_torch.mq.kafka.client import KafkaClient
    from seaweedfs_tpu_torch.mq.stream_parity import parity_context
    from seaweedfs_tpu_torch.pb import mq_pb2 as mq
    from seaweedfs_tpu_torch.pb import rpc

    t_phase = time.perf_counter()
    redials0 = CONNECT_RETRIES[0]
    walls, children, launches, dispatches = {}, {}, {}, {}
    root = broker.dir
    n = MQ20_RECORDS
    per = n // MQ20_PARTITIONS
    rec_bytes = mq_record_bytes()
    keys, values = mq20_source(n)
    keys20, values20 = mq_source(KAFKA20_RECORDS + KAFKA20_COHORT)
    agent = filer = None
    clients: list = []

    def record(i: int) -> tuple:
        return (MQ20_TS0 + i, keys[i * MQ_KEY:(i + 1) * MQ_KEY],
                values[i * MQ_VALUE:(i + 1) * MQ_VALUE])

    try:
        # -- 20.0. the child served without torch; the first parity topic --------------
        t0 = time.perf_counter()
        configurer.join(timeout=MQ20_START_S)
        if "error" in configured:
            raise AssertionError(f"20.0: {configured['error']!r}: {broker.log_tail()}")
        if "configure_s" not in configured:
            raise AssertionError(f"20.0: ConfigureTopic did not return: {broker.log_tail()}")
        served = broker.wait("20.0")
        if served["torch_at_serving"] or served["torch_mapped"]:
            raise AssertionError(f"20.0: the broker child had torch loaded when it served: {served}")
        if not broker.get("/debug/kernels", "20.0")["torch"]:
            raise AssertionError("20.0: a durable-parity topic attached with no torch loaded")
        children["broker_serving_s"] = served["serving_s"]
        children["broker_torch_at_serving"] = served["torch_at_serving"]
        children["configure_parity_topic_s"] = configured["configure_s"]
        walls["20.0 wait"] = time.perf_counter() - t0

        # -- 20a. publish and consume -------------------------------------------------
        t0 = time.perf_counter()
        t_send, t_recv = np.zeros(n), np.zeros(n)
        errors: list = []
        clients = [MqClient(broker.addr) for _ in range(2 * MQ20_PARTITIONS)]
        delivered = [0] * MQ20_PARTITIONS
        done_publishing = threading.Event()

        def publish(p: int) -> None:
            c = clients[p]
            try:
                for i in range(p, n, MQ20_PARTITIONS):
                    ts, key, value = record(i)
                    t_send[i] = time.perf_counter()
                    r = c.stub.Publish(mq.PublishRequest(
                        topic=mq.Topic(namespace=MQ20_NS, name=MQ20_TOPIC), partition=p,
                        message=mq.DataMessage(key=key, value=value, ts_ns=ts)), timeout=30)
                    if r.error or (r.partition, r.offset) != (p, i // MQ20_PARTITIONS):
                        raise AssertionError(f"20a: publish {i} answered {r.error!r} "
                                             f"at {r.partition}/{r.offset}")
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        def consume(p: int) -> None:
            c = clients[MQ20_PARTITIONS + p]
            try:
                for r in c.subscribe(MQ20_TOPIC, p, start_offset=0, namespace=MQ20_NS,
                                     consumer_group="g1", follow=True, timeout=300):
                    i = r.offset * MQ20_PARTITIONS + p
                    t_recv[i] = time.perf_counter()
                    if (r.partition, r.message.ts_ns, r.message.key, r.message.value) != (
                            p, *record(i)):
                        raise AssertionError(f"20a: record {i} delivered differs")
                    delivered[p] += 1
                    if (r.offset + 1) % MQ20_COMMIT_EVERY == 0:
                        c.commit(MQ20_TOPIC, p, "g1", r.offset + 1, namespace=MQ20_NS)
                    if delivered[p] == per:
                        return
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        lag_samples, pending_samples = [], []

        def sample() -> None:
            while not done_publishing.wait(0.1):
                try:
                    st = broker.get("/status", "20a")["parity"][f"{MQ20_NS}/{MQ20_TOPIC}"]
                except (AssertionError, KeyError):
                    continue
                lag_samples.append(max(v["parity_lag_ms"] for v in st.values()))
                pending_samples.append(sum(v["pending_bytes"] for v in st.values()))

        consumers = [threading.Thread(target=consume, args=(p,)) for p in range(MQ20_PARTITIONS)]
        publishers = [threading.Thread(target=publish, args=(p,)) for p in range(MQ20_PARTITIONS)]
        sampler = threading.Thread(target=sample, daemon=True)
        for t in consumers:
            t.start()
        sampler.start()
        t_pub = time.perf_counter()
        for t in publishers:
            t.start()
        for t in publishers:
            t.join()
        publish_s = time.perf_counter() - t_pub
        for t in consumers:
            t.join(timeout=120)
        done_publishing.set()
        sampler.join(timeout=10)
        if errors:
            raise errors[0]
        if delivered != [per] * MQ20_PARTITIONS:
            raise AssertionError(f"20a: group g1 got {delivered} of {per} a partition")
        lat = t_recv - t_send
        step_a = {
            "records": n, "record_bytes": rec_bytes, "publish_s": publish_s,
            "records_per_s": n / publish_s, "mb_per_s": n * rec_bytes / publish_s / 1e6,
            "publish_to_delivery_p50_ms": percentile_ms(lat.tolist(), 50),
            "publish_to_delivery_p99_ms": percentile_ms(lat.tolist(), 99),
            "parity_lag_samples": len(lag_samples),
            "parity_lag_p50_ms": float(np.percentile(lag_samples, 50)) if lag_samples else None,
            "parity_lag_max_ms": max(lag_samples) if lag_samples else None,
            "pending_bytes_max": max(pending_samples) if pending_samples else None}
        walls["20a"] = time.perf_counter() - t0

        # -- 20b. the shell's 8 mq.* ----------------------------------------------------
        t0 = time.perf_counter()
        import importlib.util

        archived = 2 if importlib.util.find_spec("pyarrow") else 0
        shell = mq20_run_shell(senv, broker.addr, [per] * MQ20_PARTITIONS, archived, clients[0])
        walls["20b"] = time.perf_counter() - t0

        # -- 20f. a durable-parity Kafka topic through the gateway, acks held -------------
        t0 = time.perf_counter()
        kc = KafkaClient("127.0.0.1", broker.kport, client_id="smoke20f")
        try:
            err = kc.create_topic(KAFKA20_TOPIC, partitions=KAFKA20_PARTITIONS)
        finally:
            kc.close()
        if err:
            raise AssertionError(f"20f: CreateTopics {KAFKA20_TOPIC} answered {err}")
        codecs = kafka20_codecs()
        if 4 not in codecs:
            print("20f: the host has no zstandard: codec 4 (zstd) skipped")
        windows0 = metric_value(http(f"http://127.0.0.1:{broker.sport}/metrics")[2].decode(),
                                 "sw_mq_group_commit_windows_total")
        bulk = kafka20_produce(broker.kport, keys20, values20, 0, KAFKA20_RECORDS, codecs, "20f")
        per20 = KAFKA20_RECORDS // KAFKA20_PARTITIONS
        group20 = kafka20_group(broker.kport, keys20, values20, per20)
        status = broker.get("/status", "20f")
        windows = metric_value(http(f"http://127.0.0.1:{broker.sport}/metrics")[2].decode(),
                                "sw_mq_group_commit_windows_total") - windows0
        if not 1 <= windows <= bulk["requests"]:
            raise AssertionError(f"20f: {windows} group-commit windows for {bulk['requests']} "
                                 "produce requests")
        pool = status.get("kafka_pool")
        if not pool or pool["kind"] != "pooled":
            raise AssertionError(f"20f: the broker's /status has no pooled kafka_pool: {pool}")
        rec20 = MQ_KEY + MQ_VALUE  # a record's key and value
        step_f = {
            "records": KAFKA20_RECORDS, "key_value_bytes": rec20, "codecs": codecs,
            "produce_requests": bulk["requests"], "produce_s": bulk["seconds"],
            "records_per_s": KAFKA20_RECORDS / bulk["seconds"],
            "mb_per_s": KAFKA20_RECORDS * rec20 / bulk["seconds"] / 1e6,
            "ack_p50_ms": percentile_ms(bulk["lat"], 50),
            "ack_p99_ms": percentile_ms(bulk["lat"], 99),
            "group_commit_windows": windows, "group": group20,
            "kafka_pool": {k: pool[k] for k in ("workers", "max_connections", "frames_served",
                                                "rejected_total")}}
        walls["20f"] = time.perf_counter() - t0

        # -- 20c. drained, sealed, killed, replayed -------------------------------------
        t0 = time.perf_counter()
        wait_until(lambda: all(v["pending_bytes"] == 0 for t in broker.get("/status", "20c")
                               ["parity"].values() for v in t.values()),
                   "every partition's parity drained", phase="20c")
        walls["drain"] = time.perf_counter() - t0
        committed = [clients[0].committed(MQ20_TOPIC, p, "g1", namespace=MQ20_NS)
                     for p in range(MQ20_PARTITIONS)]
        if committed != [per] * MQ20_PARTITIONS:
            raise AssertionError(f"20c: g1 committed {committed}")
        seal: dict = {}
        vids, batches, _ = seal_collection(senv, child.mport, child.vport,
                                           os.path.join(child.root, "d"), MQ20_COLLECTION, "20c",
                                           seal)
        walls.update({f"20c {k}": v for k, v in seal.items()})
        at_seal = child_kernels(child, "20c")
        # 20f's final cohort, acknowledged through the group commit with no
        # drain after it; the broker's launches read, then the SIGKILL
        t0 = time.perf_counter()
        cohort = kafka20_produce(broker.kport, keys20, values20, KAFKA20_RECORDS, KAFKA20_COHORT,
                                 codecs, "20f")
        k1 = broker.get("/debug/kernels", "20c")
        t_kill = time.perf_counter()
        broker.kill()
        ack_to_kill_ms = (t_kill - cohort["last_ack"]) * 1e3
        if ack_to_kill_ms > KAFKA20_KILL_MS:
            raise AssertionError(f"20f: the SIGKILL fell {ack_to_kill_ms:.1f} ms after the "
                                 f"cohort's last ack (at most {KAFKA20_KILL_MS})")
        step_f.update({"cohort": KAFKA20_COHORT, "cohort_s": cohort["seconds"],
                       "cohort_ack_p50_ms": percentile_ms(cohort["lat"], 50),
                       "ack_to_kill_ms": ack_to_kill_ms})
        walls["20f cohort"] = time.perf_counter() - t0
        # every launch of the broker's first run is one of its streams'
        # parity dispatches (its flushes, the group commit's among them)
        run1, dispatches["broker run 1"] = k1["launches"], k1["stream_dispatches"]
        launches["broker run 1"] = run1
        if run1 != {"gf2_apply": k1["stream_dispatches"], "gf2_apply_planes": 0} or (
                k1["stream_dispatches"] < 1):
            raise AssertionError(f"20c: the broker's first run launched {run1} for "
                                 f"{k1['stream_dispatches']} stream dispatches")
        # the durable stripes the restart replays, both topics' (k20's
        # after the cohort's acks)
        ctx = parity_context()
        stripes, stripes20 = 0, 0
        for ns, topic, parts in ((MQ20_NS, MQ20_TOPIC, MQ20_PARTITIONS),
                                 ("kafka", KAFKA20_TOPIC, KAFKA20_PARTITIONS)):
            for p in range(parts):
                d = os.path.join(root, "parity", ns, topic, f"{p:04d}")
                for g in gens_of(d):
                    j = load_stream_journal(os.path.join(d, f"gen-{g:08d}"))
                    n_stripes = -(-j.durable // (ctx.data_shards * j.block_size))
                    stripes += n_stripes
                    stripes20 += n_stripes if ns == "kafka" else 0
        step_f["durable_stripes"] = stripes20
        broker = broker.restart()
        aport = server_port()
        agent = MqChild(root, "agent", ["mq.agent", "-ip", "127.0.0.1", "-port", str(aport),
                                        "-broker", broker.addr], grpc_ready(f"127.0.0.1:{aport}"))

        # -- 20d. a group of three in this process, while the broker restarts -------------
        ha = mq20_trio(root, keys, values)
        launches["20d group (this process)"] = ha.pop("launches")
        dispatches["20d group (this process)"] = ha.pop("dispatches")

        # -- 20c (cont.). everything back -------------------------------------------------
        t0 = time.perf_counter()
        served = broker.wait("20c")
        children["broker_restart_serving_s"] = served["serving_s"]
        for c in clients:
            c.close()
        clients = [MqClient(broker.addr)]
        t_read = time.perf_counter()
        for p in range(MQ20_PARTITIONS):
            got = list(clients[0].subscribe(MQ20_TOPIC, p, start_offset=0, namespace=MQ20_NS,
                                            timeout=120))
            if len(got) != per:
                raise AssertionError(f"20c: partition {p} replayed {len(got)} of {per} records")
            for o, r in enumerate(got):
                i = o * MQ20_PARTITIONS + p
                if (r.offset, r.partition, r.message.ts_ns, r.message.key, r.message.value) != (
                        o, p, *record(i)):
                    raise AssertionError(f"20c: record {i} differs after the restart")
        read_s = time.perf_counter() - t_read
        # 20f: every acknowledged record of k20 back over the Kafka wire (the
        # sealed segments through the fetch spool, the tail replayed from
        # parity), and kg's offsets
        t1 = time.perf_counter()
        kc = KafkaClient("127.0.0.1", broker.kport, client_id="smoke20f-back")
        try:
            back = kafka20_fetch_all(kc, keys20, values20,
                                     per20 + KAFKA20_COHORT // KAFKA20_PARTITIONS, "20f")
            offsets = [kc.fetch_offset(KAFKA20_GROUP, KAFKA20_TOPIC, p)
                       for p in range(KAFKA20_PARTITIONS)]
        finally:
            kc.close()
        if offsets != [per20] * KAFKA20_PARTITIONS:
            raise AssertionError(f"20f: {KAFKA20_GROUP}'s offsets came back as {offsets}")
        step_f.update({"read_back": back, "committed_back": offsets})
        walls["20f back"] = time.perf_counter() - t1
        # each sealed segment again, cold, by its chunks' fids at the child:
        # the filer's chunk cache may hold chunks that 20a's consumers and
        # 20f's group loaded (the gateway stores a Kafka key or value with
        # a leading byte that tells null from empty)
        from seaweedfs_tpu_torch.mq.log_buffer import encode_record
        from seaweedfs_tpu_torch.shell.commands import run_command

        sealed = [(f"/topics/{MQ20_NS}/{MQ20_TOPIC}/{p:04d}/seg-00000000.log",
                   [encode_record(o, *record(o * MQ20_PARTITIONS + p))
                    for o in range(MQ20_SEGMENT)]) for p in range(MQ20_PARTITIONS)]
        for p in range(KAFKA20_PARTITIONS):
            recs = [kafka20_record(keys20, values20, o * KAFKA20_PARTITIONS + p)
                    for o in range(MQ20_SEGMENT)]
            sealed.append((f"/topics/kafka/{KAFKA20_TOPIC}/{p:04d}/seg-00000000.log",
                           [encode_record(o, r.timestamp_ms * 1_000_000, b"\x01" + r.key,
                                          b"\x01" + r.value) for o, r in enumerate(recs)]))
        chunks = 0
        for path, want in sealed:
            meta = json.loads(run_command(senv, f"fs.meta.cat {path}"))
            raw = b""
            for c in sorted(meta["chunks"], key=lambda c: int(c["offset"])):
                code, _, body = http(f"http://127.0.0.1:{child.vport}/{c['fid']}")
                if code != 200:
                    raise AssertionError(f"20c: GET {c['fid']} of {path} answered {code}")
                raw += body
                chunks += 1
            if raw != b"".join(want):
                raise AssertionError(f"20c: {path} read by its chunks differs from its records")
        committed = [clients[0].committed(MQ20_TOPIC, p, "g1", namespace=MQ20_NS)
                     for p in range(MQ20_PARTITIONS)]
        if committed != [per] * MQ20_PARTITIONS:
            raise AssertionError(f"20c: g1's offsets came back as {committed}")
        k2 = broker.get("/debug/kernels", "20c")
        run2 = k2["launches"]
        if run2 != {"gf2_apply": stripes, "gf2_apply_planes": 0} or k2["stream_dispatches"]:
            raise AssertionError(f"20c: the replay launched {run2} for {stripes} durable stripes "
                                 f"and {k2['stream_dispatches']} stream dispatches")
        launches["broker run 2 replay"] = run2
        now = child_kernels(child, "20c")
        recon = now["interval_cache"]["loads"] - at_seal["interval_cache"]["loads"]
        got_c = {k: now["launches"][k] - at_seal["launches"][k] for k in now["launches"]}
        if got_c != {"gf2_apply": 0, "gf2_apply_planes": recon} or recon < 1:
            raise AssertionError(f"20c: the child's reads from the seal on launched {got_c} for "
                                 f"{recon} reconstructions")
        launches["19's child"] = {"gf2_apply": batches, "gf2_apply_planes": recon}
        step_f["launches_in_the_broker"] = {"run 1 dispatches": k1["stream_dispatches"],
                                            "run 2 replay of k20": stripes20}
        step_c = {"volumes": vids, "batches": batches, "durable_stripes": stripes,
                  "segment_chunks_read_cold": chunks, "reconstructions": recon, "kill_to_read_s": time.perf_counter() - t_kill,
                  "read_s": read_s, "read_records_per_s": n / read_s, "committed": committed}
        walls["20c back"] = time.perf_counter() - t0

        # -- 20e. the agent and the notifier --------------------------------------------
        t0 = time.perf_counter()
        fport = server_port()
        filer = MqChild(root, "filer", ["filer", "-ip", "127.0.0.1", "-port", str(fport),
                                        "-master", f"127.0.0.1:{child.mport}", "-dir",
                                        os.path.join(root, "filerdb"), "-store", "memory",
                                        "-notify.mq", broker.addr], http_ready(fport))
        served = agent.wait("20e")
        children["agent_serving_s"], children["agent_torch_mapped"] = (
            served["serving_s"], served["torch_mapped"])
        with grpc.insecure_channel(f"127.0.0.1:{aport}") as ch:
            stub = rpc.Stub(ch, rpc.MQ_AGENT_SERVICE)
            sid = stub.StartPublishSession(mq.AgentStartPublishRequest(
                name="agent20", partition_count=1, publisher_name="smoke"), timeout=30).session_id
            t1 = time.perf_counter()
            acks = [(a.ack_sequence, a.error, a.offset) for a in stub.PublishRecord(
                (mq.AgentPublishRequest(session_id=sid if i == 0 else 0, key=record(i)[1],
                                        value=record(i)[2]) for i in range(MQ20_AGENT_RECORDS)),
                timeout=120)]
            agent_publish_s = time.perf_counter() - t1
            if acks != [(i + 1, "", i) for i in range(MQ20_AGENT_RECORDS)]:
                raise AssertionError(f"20e: the agent acked {acks[:3]}... ({len(acks)})")
            import queue as _queue

            reqs: _queue.Queue = _queue.Queue()
            reqs.put(mq.AgentSubscribeRequest(init=mq.AgentSubscribeInit(
                consumer_group="g20", name="agent20", partition=0, start_offset=0)))

            def req_iter():
                while (item := reqs.get()) is not None:
                    yield item

            got = []
            for resp in stub.SubscribeRecord(req_iter(), timeout=120):
                if resp.is_end_of_stream:
                    continue
                got.append((resp.offset, bytes(resp.key), bytes(resp.value)))
                if resp.offset == MQ20_AGENT_RECORDS - 1:
                    reqs.put(mq.AgentSubscribeRequest(ack_sequence=MQ20_AGENT_RECORDS))
                    reqs.put(None)
            if got != [(i, *record(i)[1:]) for i in range(MQ20_AGENT_RECORDS)]:
                raise AssertionError(f"20e: the agent's subscription gave {len(got)} records")
        wait_until(lambda: clients[0].committed("agent20", 0, "g20") == MQ20_AGENT_RECORDS,
                   "the agent's ack committed at the broker", phase="20e")
        walls["20e agent"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = filer.wait("20e")
        children["filer_serving_s"], children["filer_torch_mapped"] = (
            served["serving_s"], served["torch_mapped"])
        if served["torch_mapped"]:
            raise AssertionError("20e: the filer child with -notify.mq mapped torch")
        rng = np.random.default_rng(MQ20_SEED + 1)
        conn = RedialConnection("127.0.0.1", fport, timeout=60)
        try:
            for i in range(MQ20_FILES):
                conn.request("PUT", f"/mq20/f{i:03d}.bin", body=rng.bytes(int(rng.integers(1, 4096))))
                r = conn.getresponse()
                r.read()
                if r.status != 201:
                    raise AssertionError(f"20e: PUT /mq20/f{i:03d}.bin answered {r.status}")
        finally:
            conn.close()
        t_last = time.perf_counter()
        names, next_off = set(), [0] * MQ20_PARTITIONS

        def all_events() -> bool:
            for p in range(MQ20_PARTITIONS):
                for r in clients[0].subscribe("filer-events", p, start_offset=next_off[p]):
                    next_off[p] = r.offset + 1
                    ev = json.loads(r.message.value)
                    if ev["directory"] == "/mq20" and ev.get("newEntry"):
                        names.add(ev["newEntry"]["name"])
            return len(names) == MQ20_FILES

        lag = wait_until(all_events, "every file's event on default/filer-events", phase="20e")
        walls["20e notifier"] = time.perf_counter() - t0
        step_e = {"agent_records": MQ20_AGENT_RECORDS, "agent_publish_s": agent_publish_s,
                  "agent_records_per_s": MQ20_AGENT_RECORDS / agent_publish_s,
                  "files": MQ20_FILES, "events": sum(next_off),
                  "last_write_to_last_event_s": lag, "write_s": t_last - t0}
        # past the replay, every launch of the restarted broker is one of
        # its streams' dispatches (20e's topics)
        k3 = broker.get("/debug/kernels", "20e")
        final, dispatches["broker run 2"] = k3["launches"], k3["stream_dispatches"]
        if final != {"gf2_apply": stripes + k3["stream_dispatches"], "gf2_apply_planes": 0}:
            raise AssertionError(f"20e: the restarted broker launched {final} for {stripes} "
                                 f"replayed stripes and {k3['stream_dispatches']} stream dispatches")
        launches["broker run 2"] = final
        for c in clients:
            c.close()
        clients = []
        rcs = {"filer": filer.stop(), "agent": agent.stop(), "broker": broker.stop()}
        filer = agent = broker = None
        if rcs != {"filer": 0, "agent": 0, "broker": 0}:
            raise AssertionError(f"20: the children's exits on SIGTERM: {rcs}")
    finally:
        for c in clients:
            c.close()
        for ch in (filer, agent, broker):
            if ch is not None and ch.proc.poll() is None:
                ch.stop()
    total = {k: sum(v[k] for name, v in launches.items() if name != "broker run 2 replay")
             for k in ("gf2_apply", "gf2_apply_planes")}
    result = {"steps": {"20a publish": step_a, "20b shell": shell, "20c replay": step_c,
                        "20d group": ha, "20e agent and notifier": step_e,
                        "20f kafka": step_f},
              "children": children, "launches": launches, "stream_dispatches": dispatches,
              "walls": walls,
              "redials": CONNECT_RETRIES[0] - redials0, "seconds": time.perf_counter() - t_phase,
              "card": card_line()}
    return result, total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from seaweedfs_tpu_torch.ec import (
        BitrotProtection,
        ECContext,
        TorchBackend,
        ec_encode_volume,
        native_io,
        rebuild_ec_files,
    )
    from seaweedfs_tpu_torch.ec.context import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE
    from seaweedfs_tpu_torch.ec.encoder import DEFAULT_BATCH, batch_plan
    from seaweedfs_tpu_torch.ops import _build, gf256, rs_kernels

    kind = torch.cuda.get_device_name(0)
    build()
    print("host packages: " + json.dumps(host_packages()))

    # -- 2, 2b. both entry points vs plain version vs oracle, and timings ------
    rng = np.random.default_rng(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows, prows = kernel_phases(rng, flush)
    del flush
    torch.cuda.empty_cache()
    ctx = ECContext(K, M)
    encode_coeffs = gf256.parity_rows(K, M)

    work = tempfile.mkdtemp(prefix="smoke-", dir=str(_build.BUILD_DIR))
    try:
        # -- 3-5. encode, then rebuild, of a 1 GiB volume ------------------------
        base = os.path.join(work, "1")
        t0 = time.perf_counter()
        vol_rng_state = rng.bit_generator.state  # phase 13 writes the same needles
        records = write_volume(base, rng)
        dat_size = os.path.getsize(base + ".dat")
        print(f"volume: {dat_size} bytes, {len(records)} needles, "
              f"written in {time.perf_counter() - t0:.3f} s")

        backend = TorchBackend(ctx)
        plan = list(batch_plan(dat_size, K, DEFAULT_BATCH, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE))
        n_batches = len(plan)
        rs_kernels.reset_launches()
        native_io.reset_counts()
        t0 = time.perf_counter()
        ec_encode_volume(base, ctx, backend=backend)
        enc_s = time.perf_counter() - t0
        enc_launches = rs_kernels.LAUNCHES["gf2_apply"]
        enc_plane = dict(native_io.COUNTS, pin_skips=backend.pin_skips)
        if enc_launches != n_batches:
            raise AssertionError(f"encode launched {enc_launches} kernels for {n_batches} batches")
        # only the native reader counts read_batch and only FusedShardSink
        # counts sink_append: equal to the batches, they carried them all
        if not (enc_plane["read_batch"] == enc_plane["sink_append"] == enc_plane["pin_skips"] == n_batches):
            raise AssertionError(f"encode's {n_batches} batches did not all take the native plane "
                                 f"and a page-locked landing matrix: {enc_plane}")
        widths = len({w for *_, w in plan})
        if enc_plane["pool_alloc"] > IN_FLIGHT * widths:
            raise AssertionError(f"the landing pool grew past {IN_FLIGHT} matrices per width: {enc_plane}")
        prot = BitrotProtection.load(base + ".ecsum")
        for i in range(ctx.total):
            bad = prot.verify_shard_file(base + ctx.to_ext(i), i)
            if bad:
                raise AssertionError(f"shard {i} fails .ecsum at blocks {bad}")
        # sampled oracle check: the data shards stripe the .dat, and the
        # parity shards hold its RS parity, at three random rows
        shard_size = prot.shard_sizes[0]
        n_rows = shard_size // SMALL_BLOCK_SIZE
        with open(base + ".dat", "rb") as dat:
            for row in rng.choice(n_rows, size=3, replace=False):
                col = int(rng.integers(0, SMALL_BLOCK_SIZE - (1 << 16) + 1))
                data = np.zeros((K, 1 << 16), np.uint8)
                for i in range(K):
                    dat.seek(int(row) * K * SMALL_BLOCK_SIZE + i * SMALL_BLOCK_SIZE + col)
                    got = np.frombuffer(dat.read(1 << 16), np.uint8)
                    data[i, : len(got)] = got
                shard_off = int(row) * SMALL_BLOCK_SIZE + col
                want = np.concatenate([data, gf256.matrix_apply(encode_coeffs, data)])
                for i in range(ctx.total):
                    with open(base + ctx.to_ext(i), "rb") as f:
                        f.seek(shard_off)
                        if f.read(1 << 16) != want[i].tobytes():
                            raise AssertionError(f"shard {i} row {row} differs from the oracle")
        enc_stages = dict(backend.stage_seconds)
        print(f"encode: {dat_size} bytes in {enc_s:.3f} s = {dat_size / enc_s / 1e9:.3f} GB/s; "
              f"{n_batches} batches, {enc_launches} launches; all 14 shards verify; "
              f"stage seconds {json.dumps(enc_stages)}; native plane {json.dumps(enc_plane)}")

        digests = {i: sha256(base + ctx.to_ext(i)) for i in range(ctx.total)}
        # phases 9, 10, 15 and 16's inputs: the same .dat and .idx
        for d in ("trace", "sched", os.path.join("cluster", "a"), os.path.join("admin", "a")):
            os.makedirs(os.path.join(work, d))
            for ext in (".dat", ".idx"):
                os.link(base + ext, os.path.join(work, d, "1" + ext))
        py_plane = python_plane_encode(work, base, ctx, digests, prot)
        print("encode, native plane against Python plane (SEAWEED_EC_NATIVE=0) on the same .dat: "
              "14 shards sha256-identical, block and leaf CRC lists equal: " + json.dumps({
                  "native": {"seconds": enc_s, "stage_seconds": enc_stages},
                  "python": py_plane,
              }))
        cpu_enc = cpu_encode(work, base, ctx, digests, prot, n_batches)
        for i in LOST:
            os.unlink(base + ctx.to_ext(i))
        backend = TorchBackend(ctx)
        rs_kernels.reset_launches()
        native_io.reset_counts()
        t0 = time.perf_counter()
        rebuilt = rebuild_ec_files(base, backend=backend)
        reb_s = time.perf_counter() - t0
        reb_launches = rs_kernels.LAUNCHES["gf2_apply"]
        reb_plane = dict(native_io.COUNTS, pin_skips=backend.pin_skips)
        reb_batches = -(-shard_size // DEFAULT_BATCH)
        if not (reb_plane["read_batch"] == reb_plane["sink_append"] == reb_plane["pin_skips"]
                == reb_batches) or reb_plane["pool_alloc"] > 2 * IN_FLIGHT:
            raise AssertionError(f"rebuild's {reb_batches} batches did not all take the native "
                                 f"plane and a page-locked landing matrix: {reb_plane}")
        if rebuilt != list(LOST):
            raise AssertionError(f"rebuild regenerated {rebuilt}, expected {list(LOST)}")
        for i in LOST:
            if sha256(base + ctx.to_ext(i)) != digests[i]:
                raise AssertionError(f"rebuilt shard {i} differs from the original")
        t0 = time.perf_counter()
        peer_copies(work, base, ctx, digests)  # phase 11's inputs, every shard as encoded
        print(f"phase 11's inputs copied: {time.perf_counter() - t0:.3f} s")
        if reb_launches < 1:
            raise AssertionError("rebuild never launched the kernel")
        reb_stages = dict(backend.stage_seconds)
        cpu_reb = cpu_rebuild(work, base, ctx, digests)
        src_bytes = K * shard_size
        print(f"rebuild: shards {list(LOST)} from {src_bytes} source bytes in {reb_s:.3f} s = "
              f"{src_bytes / reb_s / 1e9:.3f} GB/s; {reb_launches} launches; sha256 identical; "
              f"stage seconds {json.dumps(dict(backend.stage_seconds))}; "
              f"native plane {json.dumps(reb_plane)}")

        # -- 6. degraded needle reads ----------------------------------------------
        shutil.copy(base + ctx.to_ext(ROTTEN), base + ctx.to_ext(ROTTEN) + ".orig")
        read, read_launches, deleted = read_phase(work, base, ctx, records, dat_size, rng)
        print(f"degraded reads (shard {DEGRADED} unmounted, all bit-exact): {json.dumps(read)}")
        os.replace(base + ctx.to_ext(ROTTEN) + ".orig", base + ctx.to_ext(ROTTEN))
        cpu_read = cpu_reads(work, base, ctx, records, dat_size)

        # -- 6b. scrub, leaf repair, crash windows, quarantine -------------------------
        scrub, scrub_launches = scrub_phase(work, base, ctx, records, dat_size, digests)
        print(f"scrub and leaf repair (every check exact): {json.dumps(scrub)}")

        # -- 7. ec.decode ---------------------------------------------------------------
        cpu_dec_base = same_inputs(base, os.path.join(work, "cpu-decode"),
                                   [i for i in range(ctx.total) if i != DEGRADED])
        decode, dec_launches = decode_phase(base, ctx, digests[DEGRADED], deleted)
        print(f"decode ({N_DELETED} deleted, shard {DEGRADED} regenerated; .dat, .idx and "
              f"shard identical): {json.dumps(decode)}")
        cpu_dec = cpu_decode(cpu_dec_base, base, ctx)

        # -- 8. the native CPU backend against the card, same host, same bytes ---------
        print("native CPU backend against the card on the same host and bytes (every output "
              "identical; no launch during a CpuBackend run; CPU stage tables are host wall "
              "time, the card's h2d/kernel/d2h CUDA events): " + json.dumps({
                  "host": host_info(),
                  "encode": versus(enc_s, enc_stages, cpu_enc),
                  "rebuild": versus(reb_s, reb_stages, cpu_reb),
                  "degraded_reads": {
                      **versus(read["cold_seconds"], {**read["read_stage_seconds"],
                                                      **read["backend_stage_seconds"]},
                               {"seconds": cpu_read["cold_seconds"],
                                "stage_seconds": {**cpu_read["read_stage_seconds"],
                                                  **cpu_read["backend_stage_seconds"]}}),
                      "reads": cpu_read["degraded_reads"],
                      "card_p50_ms": read["cold_p50_ms"], "card_p99_ms": read["cold_p99_ms"],
                      "cpu_p50_ms": cpu_read["cold_p50_ms"], "cpu_p99_ms": cpu_read["cold_p99_ms"],
                  },
                  "decode": versus(decode["seconds"], decode["stage_seconds"], cpu_dec),
              }))
        print(f"card: {card_line()}")

        # -- 7a, 7b. streaming EC and the MQ durable-parity partition -----------------
        t0 = time.perf_counter()
        stream, stream_launches = stream_phase(work, base + ".dat.orig", ctx)
        print("stream encode (14 shards sha256-identical to the batch encode, CRC lists equal, "
              f"launches == chunks + tail stripes): {json.dumps(stream)}")
        mq, mq_launches = mq_phase(work)
        print("MQ durable-parity partition (every record recovered byte-exact, no parity "
              "rewritten, recovery launches == stripes; each crash window recovered dense "
              f"past the child's last flush): {json.dumps(mq)}")
        print(f"phase 7 (7a and 7b): {time.perf_counter() - t0:.3f} s")

        # -- 9. the flight recorder, armed ---------------------------------------------
        t0 = time.perf_counter()
        traced, trace_launches = trace_phase(work, base, ctx, records, dat_size, digests, prot,
                                             n_batches, mq["solo_flush"])
        print("flight recorder armed (every output sha256-identical to its disarmed counterpart, "
              "one root per op, span invariants hold, device stages == launches, labeled as the "
              "JAX call sites label them, "
              f"overlap efficiency in [0, 1], registry renders, .heat read back): {json.dumps(traced)}")
        print(f"phase 9: {time.perf_counter() - t0:.3f} s")

        # -- 10. the device scheduler and the CPU failover -------------------------------
        t0 = time.perf_counter()
        _, sched_launches = sched_phase(work, base, ctx, records, dat_size, digests, n_batches, enc_s)
        print(f"phase 10: {time.perf_counter() - t0:.3f} s")

        # -- 11. peer-fetch rebuild over the shard net plane -------------------------------
        t0 = time.perf_counter()
        peer, peer_launches = peer_phase(work, ctx, digests, reb_batches)
        print("peer-fetch rebuild (11a native plane, 11b Python plane: shards 3 and 11 rebuilt "
              "and shard 4's two rotten leaves repaired from peers, sha256-identical, the rotten "
              "holder excluded, launches == rebuild batches + leaf ranges; 11c two peers stopped: "
              f"refused, local files unchanged): {json.dumps(peer)}")
        print(f"phase 11: {time.perf_counter() - t0:.3f} s")

        # -- 12. remote stream shards ---------------------------------------------------
        t0 = time.perf_counter()
        remote, remote_launches = remote_stream_phase(work, mq)
        print("remote stream shards (phase 7b's partition and traffic with a mounted root and a "
              "net-plane root: shards of every generation on both, remote copies sha256-identical "
              "at close, generation 0 pruned from both roots, every unpruned record recovered "
              "byte-exact, delete leaves both roots empty, launches == parity deltas, every pushed "
              f"byte on the native plane): {json.dumps(remote)}")
        print(f"phase 12: {time.perf_counter() - t0:.3f} s")

        # -- 13. the Store ------------------------------------------------------------
        t0 = time.perf_counter()
        stored, store_launches = store_phase(work, ctx, vol_rng_state)
        print("Store (phase 3's needles written through Store.write_needle, read back bit-exact, "
              "5 deleted, remounted, encoded on the card, every shard verified; degraded reads with "
              f"shard {DEGRADED} unmounted bit-exact through gf2_apply_planes; a ScrubDaemon pass "
              f"leaf-repaired shard {STORE_ROT_SHARD} through gf2_apply): {json.dumps(stored)}")
        print(f"phase 13: {time.perf_counter() - t0:.3f} s")

        # -- 14. the volume server ------------------------------------------------------
        t0 = time.perf_counter()
        served, server_launches = server_phase(work, ctx, vol_rng_state)
        print("volume server (14a phase 3's needles POSTed over HTTP and the first 256 MiB written "
              "over the net plane, read back bit-exact, records equal; 14b encoded on the card, "
              f"every shard verified; 14c degraded GETs with shard {DEGRADED} unmounted bit-exact, "
              "launches == reconstructions, no 503 under 8 clients; 14d deletes, fan-out refusals, "
              f"status surfaces, a hand-built needle-read frame): {json.dumps(served)}")
        print(f"phase 14: {time.perf_counter() - t0:.3f} s; loopback connects "
              f"dialled again: {CONNECT_RETRIES[0]}")

        # -- 15. the cluster half: four port servers under a port master ---------------
        t0 = time.perf_counter()
        cluster, cluster_launches = cluster_phase(work, ctx, digests, records, n_batches, reb_batches,
                                                  vol_rng_state)
        print("cluster half (four port servers under a port master, every EC step over gRPC: "
              "15b generate, launches == batches, shards sha256-identical to phase 4's; 15c shards "
              "spread over the net plane and CopyFile, identical; 15d degraded GETs with siblings "
              "remote bit-exact, launches == reconstructions; 15e peer-fetch rebuild of shards 3 "
              "and 11, launches == batches, handed off sha256-identical and advertised; 15f "
              "replicated POSTs, records equal, plane and gRPC legs; 15g EC deletes on every "
              "holder; 15h scrub and status; 15i decode to the original .dat): "
              f"{json.dumps(cluster)}")
        print(f"phase 15: {time.perf_counter() - t0:.3f} s; loopback connects "
              f"dialled again: {CONNECT_RETRIES[0]}")

        # -- 16. the admin RPCs of plain volumes and the launcher ------------------
        t0 = time.perf_counter()
        _, admin_launches = admin_phase(work, ctx, records, vol_rng_state)
        print(f"phase 16: {time.perf_counter() - t0:.3f} s; loopback connects "
              f"dialled again: {CONNECT_RETRIES[0]}")

        # -- 17. a cluster of the port alone, every process started by name ------------
        t0 = time.perf_counter()
        (ha, ha_launches, shell_launches, fleet_launches, last_launches, filer_launches,
         server_filer_launches, s3_launches, tools_src) = ha_phase(work, ctx, vol_rng_state)
        print("cluster of the port by name (three masters as one raft group, four volume servers "
              "on two racks; 17b phase 3's needles through /dir/assign and POST into one grown "
              "volume of about 1 GiB, read back; 17c `001` writes read back from both holders; "
              "17d the port shell's ec.encode, generate launches == batches, and ec.balance, "
              "every shard once on both racks, sha256-equal; 17e the leader killed, a new one "
              "elected, 14 shards listed there, a never-used volume id assigned; 17f a holder of "
              "a data shard stopped, degraded GETs byte-equal, launches == reconstructions; 17g "
              "the shell's ec.check.replication, ec.rebuild -fromPeers (launches == batches, "
              "sha256-equal), ec.scrub, ec.decode (the .dat and .idx back) and upload/download; "
              "17h a worker child, the leader's auto-EC scanner's ec_encode task, launches == "
              "batches, shards verified, needles read back; 17i a quarantined shard, degraded "
              "GETs, launches == reconstructions, the fleet scrub's peer-fetch ec_rebuild task, "
              "launches == batches, sha256-equal, the next scrub clean): "
              f"{json.dumps(ha)}")
        print(f"phase 17: {time.perf_counter() - t0:.3f} s; loopback connects "
              f"dialled again: {CONNECT_RETRIES[0]}")
        print("17j the servers' last parts (?locate names the holder's live sidecar socket, "
              "read_fid_fast gives the GET's bytes and CRC, Operations.read served by the "
              "sidecar, a path outside its root refused; /debug/pprof stacks and a 1 s profile "
              "at the leader and a holder; thumbnails of a seeded PNG and JPEG over a degraded "
              "read equal images.resized with its ETag and type, planes launches == "
              "reconstructions; the telemetry collector holds the leader's report): " + json.dumps(
                  {k: v for k, v in ha["steps"].items() if k.startswith("17j")}) + f"; card: "
              f"{card_line()}")
        print("17k the filer (two port Filers in this process, A on an SSTableStore and B on a "
              "SqliteStore, each with a MetaLog and a FilerGrpcService, B's MetaAggregator "
              "following A; small files inlined, 1-12 MiB files in 4 MiB chunks and one manifest "
              "file written through A; gRPC lookup, list, rename, hard link, KV, LockRange and "
              "DeleteEntry on A, the deleted needles 404; B lists A's namespace; the shell's "
              "ec.encode seals the collection, launches == batches; data shard 0 unmounted, "
              "every file read through B with its chunk cache cold sha256-equal, planes launches "
              "== reconstructions; SubscribeMetadata from 0 gives every event A logged): "
              + json.dumps(ha["steps"]["17k filer"]) + f"; card: {card_line()}")
        print("17l the filer server (a `filer` child by name, -store sstable, -notify.webhook at a "
              "sink in this process; through its HTTP plane a multipart PUT, a chunked-TE PUT, a "
              "TUS upload in three PATCHes, raw PUTs, inlined files, mv.from and a recursive "
              "DELETE whose needles 404; the shell's ec.encode, launches == batches; data shard 0 "
              "unmounted, every file read back through the child whole and in ranges sha256-"
              "equal, planes launches == reconstructions; the webhook's events == /~meta/tail's; "
              "fs.ls, fs.du, fs.verify, volume.fsck and cluster.lock.ring in this process answer "
              "what was written, a lease through DlmClient at the child): "
              + json.dumps(ha["steps"]["17l filer server"]) + f"; card: {card_line()}")
        print("17m S3's libraries (the shell's s3.configure, s3.accesskey.create, s3.policy.put/"
              ".get, s3.user.list and s3.bucket.create against a port filer pair in this process; "
              "the minted keys read back through FilerIdentityStore: sign_v4 passes verify_v4, a "
              "tampered byte and a stale X-Amz-Date fail with the JAX codes, a presigned URL "
              "verifies, the attached policy allows and denies, an assume_role credential works "
              "until its expiry; objects written into the bucket's collection under SSE-S3, SSE-C, "
              "aws-chunked and versioning; s3.bucket.quota.set/.get/.enforce; the shell's "
              "ec.encode, launches == batches; data shard 0 unmounted, every object read back "
              "through B whole and in a range, decrypted, sha256-equal, planes launches == "
              "reconstructions; s3.clean.uploads and s3.bucket.delete -force, the collection "
              "gone): " + json.dumps(ha["steps"]["17m s3"]) + f"; card: {card_line()}")

        # -- the offline tools on 17j's scratch copy, while phase 18's TLS server
        # child starts --------------------------------------------------------------
        # (and phase 19's S3 gateway child, whose imports overlap both) ------------
        t0 = time.perf_counter()
        tls_child, s3_child, s3_rc, ldap_srv, clb = TlsChild(work), None, None, None, None
        mq_broker = mq_senv = None
        try:
            # phase 19b's identity providers: the LDAP stand-in in this
            # process, and the key whose public half the child's OIDC
            # provider trusts
            from cryptography.hazmat.primitives import serialization
            from cryptography.hazmat.primitives.asymmetric import rsa

            from seaweedfs_tpu_torch.iam.ldap import MiniLdapServer

            ldap_srv = MiniLdapServer(dict(TABLES_LDAP_USERS))
            oidc_key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
            oidc_pem = oidc_key.public_key().public_bytes(
                serialization.Encoding.PEM,
                serialization.PublicFormat.SubjectPublicKeyInfo).decode()
            s3_child = S3GatewayChild(work, ldap_srv.port, oidc_pem)
            clb = ClusterB(work)  # phase 19c's second cluster, started behind the tools
            tools = tools_phase(tools_src)
            print("offline tools by name (fix: .idx byte-identical; scan: every record; export: "
                  "the needles; scaffold: a TOML the loader reads; compact: the deletes "
                  f"reclaimed, every needle read back): {json.dumps(tools)}")
            print(f"tools: {time.perf_counter() - t0:.3f} s; card: {card_line()}")

            # -- 18. a TLS cluster --------------------------------------------------
            t0 = time.perf_counter()
            tls, tls_launches = tls_phase(tls_child, ctx)
            rc, tls_child = tls_child.stop(), None
            if rc != 0:
                raise AssertionError(f"18: the TLS server did not stop cleanly ({rc})")
            print("TLS cluster (a server child with -tls.cert/-tls.key/-tls.ca, this process on "
                  "https with a client certificate: needles POSTed over https, the shell's "
                  "ec.encode launches == batches, degraded GETs over https byte-exact with planes "
                  "launches == reconstructions, a certless and a plaintext client refused): "
                  + json.dumps(tls))
            print(f"phase 18: {time.perf_counter() - t0:.3f} s; card: {card_line()}")

            # -- 19. the S3 gateway by name ----------------------------------------
            t0 = time.perf_counter()
            s3gw, s3gw_launches = s3_gateway_phase(s3_child, ctx)
            t19 = time.perf_counter() - t0

            # -- 20.0, behind 19b and 19c: /topics/ to its own collection at
            # the child's filer, the broker child by name, and on a thread
            # the first durable-parity topic (torch loads in that RPC)
            from seaweedfs_tpu_torch.shell.commands import ShellEnv, run_command

            mq_senv = ShellEnv(f"127.0.0.1:{s3_child.mport}", f"127.0.0.1:{s3_child.fport}")
            line = f"fs.configure -locationPrefix /topics/ -collection {MQ20_COLLECTION}"
            if not run_command(mq_senv, line).startswith("configured /topics/"):
                raise AssertionError(f"20.0: `{line}` failed")
            mq_broker = BrokerChild(work, s3_child.fport)
            mq_configured: dict = {}
            mq_configurer = threading.Thread(target=mq20_configure, args=(mq_broker, mq_configured),
                                             daemon=True)
            mq_configurer.start()

            # -- 19b. S3 Tables, the IAM API, OIDC and LDAP on the same child -----
            t0 = time.perf_counter()
            tables, tables_launches = s3_tables_phase(s3_child, oidc_key)
            t19b = time.perf_counter() - t0

            # -- 19c. remote storage and replication between the child and B ----
            t0 = time.perf_counter()
            remote, remote19c_launches = remote_phase(s3_child, clb, work)
            t19c = time.perf_counter() - t0

            # -- 20. the MQ broker by name on the same child ----------------------
            t0 = time.perf_counter()
            mq20, mq20_launches = mq_broker_phase(s3_child, mq_broker, mq_configured,
                                                  mq_configurer, mq_senv, work)
            mq_broker = None
            t20 = time.perf_counter() - t0
        finally:
            if mq_broker is not None and mq_broker.proc.poll() is None:
                mq_broker.stop()
            if mq_senv is not None:
                mq_senv.close()
            if tls_child is not None:
                tls_child.stop()
            if s3_child is not None:
                s3_rc = s3_child.stop()
            if ldap_srv is not None:
                ldap_srv.close()
            if clb is not None:
                clb.stop()
        if s3_rc != 0:
            raise AssertionError(f"19: the gateway's server did not stop cleanly ({s3_rc})")
        print("S3 gateway by name (a `server -filer -s3 -s3Config` child: SigV4 refusals with the "
              "JAX codes and an STS credential; signed, aws-chunked, multipart, copied, SSE-S3, "
              "SSE-C, POST-policy, inlined and versioned objects; listings paged by continuation "
              "token, HEADs, ranges, a 304, a presigned GET, a versionId read; the shell's "
              "ec.encode of the bucket's collection, launches == batches; data shard 0 unmounted, "
              "every object read through the gateway whole and in a range sha256-equal, planes "
              "launches == reconstructions; a lifecycle rule expiring its prefix through "
              "RunLifecycle; DeleteObjects of every version, the bucket deleted and its "
              "collection gone): " + json.dumps(s3gw))
        print(f"phase 19: {t19:.3f} s; card: {card_line()}")
        print("19b S3 Tables and the Iceberg REST catalog, the IAM API, OIDC and LDAP (on phase "
              "19's child: CreateUser, CreateAccessKey and PutUserPolicy through the IAM API; "
              "CreateTableBucket, a namespace and a table; data files SigV4-PUT with the minted "
              "key, one snapshot commit each, a multi-table transaction and a view; an "
              "AssumeRoleWithLdapIdentity credential writing under ldap/, a wrong password "
              "refused; the shell's ec.encode of the table bucket's collection, launches == "
              "batches; data shard 0 unmounted, loadTable the last commit, every metadata and "
              "data file read with an OIDC bearer whole and in a range sha256-equal, a forged "
              "and an expired bearer refused, planes launches == reconstructions; snapshots "
              "expired by the maintenance route while the refs stay; DeleteAccessKey, the "
              "catalog torn down and the collection gone): " + json.dumps(tables))
        print(f"phase 19b: {t19b:.3f} s; card: {card_line()}")
        print("19c remote storage and replication (phase 19's child as cluster A, whose gateway "
              "is the cloud, and cluster B in this process: a bucket of large and 1,050 small "
              "objects sealed at A, launches == batches, data shard 0 unmounted; the port "
              "shell's remote.configure and remote.mount at B, every object mapped, reads "
              "through B's filer whole and in ranges sha256-equal through A's degraded "
              "gateway; remote.meta.sync counting the keys added, overwritten and deleted; "
              "remote.cache, remote.uncache, remote.unmount and remote.mount.buckets; three "
              "replication children from A's /src to B's filer, an S3 bucket at A and a local "
              "directory, each copy and tail sha256-equal, each child exiting 0 on SIGTERM "
              "with its state at A's last event; B sealed, launches == batches, data shard 0 "
              "unmounted, the cached files and B's /src read sha256-equal; planes launches == "
              "reconstructions at each cluster; a worker child's iceberg task done, the table "
              "left with its current snapshot): " + json.dumps(remote))
        print(f"phase 19c: {t19c:.3f} s; card: {card_line()}")
        print("20 the MQ broker by name (an `mq.broker` child over phase 19's filer, /topics/ in "
              "collection mqseg, serving with no torch loaded; the first durable-parity topic, "
              "bench/omb of 4 partitions, loading torch inside ConfigureTopic; 24,576 records of "
              "1 KB published by 4 threads while group g1 follows and commits, every delivery "
              "byte-exact; the shell's 8 mq.* line for line; every stream drained, the "
              "collection sealed by ec.encode at the child, launches == batches, data shard 0 "
              "unmounted, the broker SIGKILLed and spawned again by name: every record back "
              "dense and byte-exact, the sealed segments through the filer with planes "
              "launches == reconstructions at the child, the tail replayed from parity with "
              "launches == durable stripes in the broker, g1's offsets back; a group of three "
              "brokers in this process, partition 0's leader stopped and its follower serving "
              "every record, launches == dispatches; an mq.agent child's session and acked "
              "subscription; a `filer -notify.mq` child with no torch, every file's event on "
              "default/filer-events; the Kafka topic kafka/k20 produced through the broker's "
              "gateway with acks held by the group commit under 5 codecs, group kg's fetches "
              "and commits, a final cohort acked and the broker SIGKILLed within 50 ms, every "
              "acked record fetched back byte-exact after the restart; each child exiting 0 on "
              "SIGTERM): " + json.dumps(mq20))
        print(f"phase 20: {t20:.3f} s; card: {card_line()}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    main_row = rows["encode 10x1MiB m=4"]
    read_row = prows["degraded read 10x1MiB m=1"]
    kernels = []
    for name, replaces, by_phase, row, all_rows in (
        ("gf2_apply", "seaweedfs_tpu/ops/rs_pallas.py:55",
         {"4 encode": enc_launches, "5 rebuild": reb_launches, "6b scrub": scrub_launches,
          "7a stream": stream_launches, "7b partition": mq_launches,
          "9 flight recorder": trace_launches["gf2_apply"], "10 scheduler": sched_launches["gf2_apply"],
          "11 peer rebuild": peer_launches, "12 remote stream": remote_launches,
          "13 store": store_launches["gf2_apply"], "14 server": server_launches["gf2_apply"],
          "15 cluster": cluster_launches["gf2_apply"], "16 admin": admin_launches["gf2_apply"],
          "17 cluster by name": ha_launches["gf2_apply"],
          "17g shell": shell_launches["gf2_apply"],
          "17h-17i worker fleet": fleet_launches["gf2_apply"],
          "17j thumbnails": last_launches["gf2_apply"], "17k filer": filer_launches["gf2_apply"],
          "17l filer server": server_filer_launches["gf2_apply"],
          "17m s3": s3_launches["gf2_apply"],
          "18 tls": tls_launches["gf2_apply"],
          "19 s3 gateway": s3gw_launches["gf2_apply"],
          "19b s3 tables": tables_launches["gf2_apply"],
          "19c remote": remote19c_launches["gf2_apply"],
          "20 mq broker": mq20_launches["gf2_apply"]},
         main_row, rows),
        ("gf2_apply_planes", "seaweedfs_tpu/ops/rs_pallas.py:257",
         {"6 reads": read_launches, "7 decode": dec_launches,
          "9 flight recorder": trace_launches["gf2_apply_planes"],
          "10 scheduler": sched_launches["gf2_apply_planes"],
          "13 store": store_launches["gf2_apply_planes"],
          "14 server": server_launches["gf2_apply_planes"],
          "15 cluster": cluster_launches["gf2_apply_planes"],
          "16 admin": admin_launches["gf2_apply_planes"],
          "17 cluster by name": ha_launches["gf2_apply_planes"],
          "17g shell": shell_launches["gf2_apply_planes"],
          "17h-17i worker fleet": fleet_launches["gf2_apply_planes"],
          "17j thumbnails": last_launches["gf2_apply_planes"],
          "17k filer": filer_launches["gf2_apply_planes"],
          "17l filer server": server_filer_launches["gf2_apply_planes"],
          "17m s3": s3_launches["gf2_apply_planes"],
          "18 tls": tls_launches["gf2_apply_planes"],
          "19 s3 gateway": s3gw_launches["gf2_apply_planes"],
          "19b s3 tables": tables_launches["gf2_apply_planes"],
          "19c remote": remote19c_launches["gf2_apply_planes"],
          "20 mq broker": mq20_launches["gf2_apply_planes"]},
         read_row, prows),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/csrc/gf2_apply.cu",
            "replaces": replaces,
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": max(r["max_abs_err"] for r in all_rows.values()),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "cpu_ms": row["cpu_ms"],
            "shapes": {label: {k: r[k] for k in ("ms", "cpu_ms", "bound_ms", "plain_ms", "library_ms")}
                       for label, r in all_rows.items()},
        })
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    # one card driven, whatever else the host shows
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
