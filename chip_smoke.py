#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py [--layers 9] [--seed 0]

Daemons pull checkpoints into device memory through the port's device
sink: back to source (``file://`` and, in phase 11, ``http://``), as a
seed peer does for every task, and then from peers, as the P2P path does.
The cut-through relay and the PEX gossip plane are on (the daemon's
defaults) in every P2P phase: phases 6 and 9 print each daemon's relayed
serves and bytes, and phases 6, 9, 10 and 11 the PEX advisory primes and
parent hits of this process's leechers. Every seed rations its
announcements through super-seeding and announces only landed pieces, so
a chain's first relaying hop is the seed's first child.

1. device   — the card's name, count, power limit; no CUDA card is an error
2. sink     — a seeded buffer written into ``DeviceIngest`` as shuffled
              pieces; the host-to-device copy rate from pinned and from
              pageable memory, and the pinning time
3. manifest — the Llama-3-8B tensor layout (widths as published, depth cut
              to ``--layers``) in a safetensors-style file, pulled with a
              shard manifest: every tensor must land on the card as bf16
              with its published shape and the origin's bytes
4. file     — the same file pulled whole as uint8 shards, then with no
              device sink, then with neither sink nor digest (what the
              device leg and the finalize digest each add)
5. prefetch — eight seeded 256 MiB shards through ``ShardPrefetcher``
6. p2p      — the same file through the P2P path: a scheduler and a seed
              daemon (back-source, no sink) in a spawned child process that
              never touches CUDA; in this process leecher A pulls with the
              manifest and leecher B, started when A holds about half of
              its pieces, pulls whole-file, both with back-source disabled
              and a device sink on the card. Every tensor and byte must
              equal the origin's, every byte must come from peers, the
              origin must be read exactly once (a counting ``file://``
              source in the child), and B must take pieces from A
7. trainer  — the learned-scheduler loop: a scheduler (``algorithm="ml"``,
              records kept) rules over a staged cluster until its records
              ring holds 50,000 rows (decisions and piece outcomes, 64:512
              as in BENCH_pr19's datagen) and its topology store a
              1024-host, 8192-link snapshot; the announcer uploads both to
              a trainer on the card, which fits the MLP (600 epochs) and
              the GNN (60 epochs). A refit must give the same bytes; the
              MLP blob binds into the scheduler's evaluator, which then
              rules with the model (garbage and NaN blobs are refused);
              ``ModelInfer`` answers with the bound version; and MLPs
              fitted on the card on BENCH_pr19's datagen rows
              (``tests/data/pr19_datagen_rows.jsonl``, seeds 0-15) must
              beat the heuristic's replay regret of 0.1379 on average
8. deploy   — the port deployed from its launchers (``python -m
              dragonfly2_tpu_torch.tools.<name>``): a manager (sqlite in the
              workdir), a seed daemon that registers with it, a trainer
              attached to it and fitting on the card, and a scheduler
              (``--algorithm ml``, records kept) that finds the seed through
              it. The origin is the Llama-3-8B layout's last tensors,
              ``lm_head.weight`` and ``model.norm.weight`` (bf16, widths as
              published, 1,050,681,344 tensor bytes). Leecher A, in this
              process, knows only the manager and pulls with a manifest
              device sink on the card; leecher B, a launcher process that
              also knows only the manager, serves a ``dfget`` CLI pull. A's
              tensors and ``dfget``'s file must equal the origin, only the
              seed may read the origin, the scheduler's uploads must reach
              the trainer, whose fit the registry lists and the scheduler
              binds, and every process must exit cleanly on SIGTERM. The
              daemons' RTT probers report to the scheduler: its topology
              snapshot must reach 4 measured links among the seed, A and
              B, its upload must carry them, and the registry must list a
              ``topology_gnn`` the trainer fitted on the card from them
9. sharded  — run after phase 6, on its origin file: the checkpoint as two
              pipeline stages (the embedding and the first half of the
              layers; the rest), each pulled by two replicas. A scheduler
              and a seed run in a spawned child as in phase 6; four
              leecher daemons in this process, one pod, back-source
              disabled, each with a manifest sink on the card and
              ``UrlMeta.shards`` naming its stage's tensors, start
              together. Each must land exactly its stage's tensors with
              the origin's bytes, dtypes and shapes; each stage's pair
              must be assigned disjoint shares covering the stage; the
              origin must be read once, by the seed, and no leecher may
              read it; storage must stay warm partials holding only needed
              pieces; no swap piece may fall back to the tree; and each
              leecher's tree and swap bytes must add up to its stage.
              Then one stage-0 replica restarts: a fresh daemon on its
              workdir reloads and re-verifies its warm partial and pulls
              its stage again, landing every tensor on the card from disk
              with no byte from the origin or a peer
10. nt       — run after phase 8, on its origin: a scheduler with
              ``algorithm="nt"`` (records kept) in this process, a seed in
              a spawned child, two leechers here whose RTT probers report
              before they pull with manifest sinks on the card. Every
              candidate of a ruling between probed hosts must carry
              ``substituted: {locality: rtt}`` and the store's RTT, the
              tensors must equal the origin, and the origin must be read
              once, by the seed. Then one ruling's cost over phase 7's
              1,024-host topology with a GNN imputer fitted on the card
11. chain    — run after phase 10, on phase 8's origin, served over HTTP by
              a standard-library server in a spawned child (``Range``,
              paced to 250 MB/s per response, one redirect checked). A
              scheduler (``relay_fanout=1``, one upload slot per host,
              records kept) here, a seed in a child pulling the
              ``http://`` URL as one stream, and leechers L1, L2, L3 here
              (manifest sinks on the card, back-source disabled), each
              started once its predecessor has its first offer. Run with
              the relay on, then off. Every tensor must equal the origin;
              the origin must send each byte once, to the seed; some
              leecher must take pieces from another; L3's
              ``/debug/flight/<task>`` must show ``hbm_done`` for every
              piece; every leecher's flight summary must reach the
              scheduler's records. With the relay on, L1 must complete a
              relayed serve, L2 and L3 must report relayed pieces, and a
              child's first byte of some piece must come before its
              parent's ``wire_done`` of it
12. crash    — run after phase 11, on phase 8's origin, served unpaced by
              phase 11's HTTP server in a child. A scheduler S1 and a seed
              in children, every daemon announcing every 1 s and
              gossiping every 1 s (cut from 30 s and 5 s). L1 (here,
              manifest sink on the card, back-source disabled) pulls
              through S1, and its swarm index must name the seed complete
              within two gossip rounds. S1 is SIGKILLed; L2, knowing only
              S1 and L1's upload address as its PEX bootstrap, must be
              served on the pex rung (flight rungs ``["pex"]``, parent
              hits counted, ``/debug/pex`` listing two holders). S2
              starts on S1's port with a new epoch: within three announce
              intervals the seed, L1 and L2 re-announce and are adopted
              (holders, ``recovery`` ledger rows), and L2's PEX ticker
              revives S1's demoted address; S2's recovery adoption must
              have ingested the re-announces' pulses (each of the seed,
              L1 and L2 has a series in its fleet pulse). The origin
              stops; L3 pulls through S2 with rungs ``["p2p"]``. Every
              tensor must equal the origin's, no leecher may read the
              origin, and the origin must send each byte once, to the seed

13. dfbench — the port's ``dfbench`` points at the reference's full sizes,
              the host-only points in spawned workers beside the card's
              work: ``--pr19`` with its two seeded MLP fits on the card
              (the port's datagen rows must equal
              ``tests/data/pr19_datagen_rows.jsonl``, the fits give one blob,
              the learned legs repeat their digests, and MLPs fitted on the
              card on those rows, seeds 0-15, must beat the heuristic's
              regret of 0.1379 on average); ``--pr9`` at pods of 64, 128
              and 256; ``--pr14`` at 4x4, 8x8 and 16x16, with the port's
              filter and with the reference's; ``--pr12`` (a byzantine
              holder, quarantine on and off); ``--pr13`` (federation at 4,
              8 and 16 pods of 64 daemons, and a pod seed killed);
              ``--pr17`` (a scheduler crash, legs of 64 and 512 daemons)
              with the reference's filter, equal to its file but for the
              wall-clock ``time_to_first_ruling_ms``, and with the port's,
              its gates and schedule digest; ``--pr10``, ``--pr8``,
              ``--pr6`` (podscope's pod numbers; ``--pr9`` reads its trees
              through podscope too), ``--pr5``, ``--pr4``, the baseline,
              ``--pr18`` (the nine fleet-pulse legs: none, stall and
              byzantine at 128, 1,000 and 10,000 daemons, with its digest
              and gates, and ``fleetpulse_pure``: the 64-daemon storm's
              rulings with pulses ingested equal those without), equal to
              its file but for each leg's ``ingest_per_sec``; ``--pr11``
              (a critical pull against a bulk herd, QoS on and off); and
              ``--ctrl``, the control-plane storm at 64, 1,000, 5,000
              and 10,000 daemons, whose ``ruling_digests``,
              ``schedule_digest`` and purity gates must equal
              ``BENCH_pr16.json`` (its rulings/s, phase latencies and
              state bytes are printed). Every digest and gate must equal
              the committed ``BENCH_*.json``; the port's swap-partner
              exemption may move only pr14's 4x4 and 8x8 sharded
              schedules (ROADMAP known difference 13)
14. observe  — run after phase 13, on phase 8's origin: a manager, a seed daemon
              (``--debug-endpoints``, ``--tracing-jsonl``), a trainer and
              a scheduler (``--tracing-jsonl``) from the launchers, the
              three services with ``--debug-port -1``; the scheduler's
              ruling profiler is armed over ``/debug/ctrl?arm=1``; a
              leecher here, tracing on, pulls into a manifest sink on the
              card with back-source disabled. Every tensor must equal the
              origin; one trace id must cover the leecher's ``peertask``,
              the scheduler's ``sched.register`` / ``sched.offer``, the
              ``piece.download`` spans, the seed's ``upload.serve`` and
              ``hbm.ingest``; every debug route must answer 200 with the
              reference's keys, ``/debug/ctrl`` showing a ``find`` ruling
              with ``filter`` and ``emit`` phases; the flight summary must
              carry ``slo_budgets_ms`` / ``slo_breaches``. Then the mesh:
              ``graft_entry.dryrun_multichip(1)`` runs both models' sharded
              step on a one-rank NCCL mesh, whose losses must equal the
              single-device step's, and ``train_decision_model`` with the
              mesh default on one card must report one device and repeat
              phase 7's seed-7 blob
15. superseed — run after phase 14, on phase 8's origin, served over HTTP
              by phase 11's server in a child, paced to 250 MB/s. A
              scheduler here, its config loaded from a file in the
              reference's key format (``cluster_id: 2``, default upload
              limits); a seed in a child, its file setting
              ``upload.rate_limit_bps`` (200 MB/s, below the origin's
              pace), ``upload.concurrent_limit``,
              ``download.piece_parallelism`` and ``piece_timeout_s``; it
              rations its announcements through super-seeding. Leechers
              L1-L4 here, started together (manifest sinks on the card,
              back-source disabled). Every tensor must equal the origin;
              the origin must send each byte once, to the seed; no packet
              of the seed's piece-sync streams may carry ``relay_nums``;
              the seed's uplink ratio must stay below the star's 4.0, its
              serve rate over its serving window within the limit plus the
              bucket's burst, and the limit must have held some serve.
              Then ranged requests for ``model.norm.weight`` and a 64 MiB
              slice of ``lm_head.weight`` must be answered by L1 from disk
              (``peer_id`` ``"reused"``, no byte from the origin or a
              peer), and a fresh daemon L5 with
              ``download.prefetch_whole_file`` answers a ranged request
              whose repeat, once the whole file is in, is reused. It
              prints the leechers' times, the seed's share of each
              leecher's pieces, the reveals by cause (fanout offer,
              rotation, starvation ping), the chain depth and
              ``pieces_by_parent``. Every daemon announces each second
              (cut from 30 s, as the line states), so the scheduler's
              fleet pulse ingests their pulses during the fan-out. After
              the fan-out, before the ranged requests, the readers of
              the observability plane run, each timed: podscope sweeps
              the seed's and L1-L4's upload ports (its tree must hang
              each leecher off its heaviest parent in
              ``pieces_by_parent``, its depth follow from that tree, its
              amplification be 1.0, each leecher's incoming edges carry
              its ``traffic_p2p`` and the seed uplink be the seed with
              its ``df_upload_bytes_total``); ``dfdiag --pod --json``
              gives the same report; the scheduler's records hold one
              ``kind=edge`` row per (leecher, parent) of the leecher's
              flight; its fleet pulse holds a series for each of the
              five hosts, their pulse ``seq`` rising, and ``dfdiag
              --fleet`` exits as its active episodes say; dfsched over
              the records stitches at least 95 % of the piece rows to a
              decision
16. poison   — run after phase 15, on phase 8's origin over HTTP (250
              MB/s) from phase 11's server in a child. Children: a
              scheduler S1 with the reference's defaults (the quarantine
              registry on) plus a state store snapshotting every 0.5 s
              and records, the seed, and a poisoner P that pulls the file
              clean through S1 and then arms ``upload.serve@<its
              host>=corrupt:n=-1``. L1-L4 here, started together
              (manifest sinks on the card, back-source disabled; every
              daemon announcing and gossiping each second, cut from 30 s
              and 5 s). Every tensor must equal the file; P must be
              quarantined (or on probation) at S1 with 2 or more
              reporters and at most 6 corrupt verdicts per leecher; each
              leecher's ``/debug/verdicts`` must name P shunned or, for a
              leecher the pod-wide exclusion spared, deprioritized, with
              at least one shunning it; the leechers' pulses and S1's
              fleet-pulse series must carry corrupt verdicts; podscope's
              quarantine view must name P; S1's records must hold the
              ``quarantine`` rows. S1 is SIGKILLed once its snapshot holds
              P; S2 starts on its port over the same directory and the
              origin stops: S2's provenance must say recovered, with the
              ``recovery`` row, P must be non-healthy at S2 before any new
              evidence, and a fresh leecher L5 must be ready on the card
              through S2 with no origin byte and no piece from P. It
              prints the wasted corrupt pieces per leecher, the time to
              quarantine, S2's restore-to-first-ruling time and L5's
              time-to-ready
17. pods     — run after phase 16, on phase 8's origin over HTTP: a
              scheduler here with ``federation_enabled``, a seed (no pod)
              in a child, and two pods of two daemons each, one child
              process per pod with ``DF_POD_ID`` set (manifest sinks on
              the card, back-source disabled, started together). Each pod
              must elect one pod seed (``federation`` decision rows), no
              member but a pod seed may take a piece from the other pod,
              the members read no origin byte, every tensor must equal
              the file, and the origin must send each byte once, to the
              seed. It prints each pod's makespan
18. qos      — run after phase 17, on phase 8's origin over HTTP (250
              MB/s per response) from phase 11's server in a child. A
              manager here holds three tenants (``serving`` critical,
              ``batch`` bulk, ``capped`` with ``max_running`` 1); a
              scheduler here refreshes them from it every 3 s (its
              keepalive cut from 30 s to 0.5 s); a seed in a child whose
              uplink (``upload.rate_limit_bps`` 400 MB/s, 4 upload slots,
              2 for bulk) is the shared bottleneck; and Lq here, its
              governor's gate cut to one bulk task and one queued (3 s
              wait, 1 s retry hint) and its shaper splitting 600 MB/s by
              class, its content store off (every copy is one content,
              which it would otherwise place from its own disk). First a
              critical pull of tenant ``serving`` alone
              into a manifest sink on the card; then four bulk pulls of
              tenant ``batch`` on distinct task URLs and, once one is in
              flight, the critical pull again. Both critical pulls'
              tensors must equal the file; the governor must admit them
              without a queue or a shed, queue bulk work and shed some
              with RESOURCE_EXHAUSTED and the configured retry hint, and
              every bulk pull, retried after its hint, must complete;
              the seed's ``df_qos_upload_active{cls="bulk"}``, sampled
              every 5 ms, must never exceed its bulk limit; a second
              concurrent register of tenant ``capped`` must be refused
              with the row's retry hint and one count in
              ``df_qos_quota_shed_total``, and a classless register of
              ``batch`` must take the class ``bulk`` from the tenant row;
              ``GET /debug/qos`` and ``dfdiag --qos --json`` on Lq must
              agree; Lq's pulse, and the scheduler's fleet-pulse series of
              it, must carry the governor's state and sheds. It prints the
              critical pull's time to device-ready alone and under the
              herd and their ratio, the herd's throughput, the queued and
              shed counts and the scheduler's ``preempt`` rows
19. objstore — dataset shards written through dfstore and the object
              gateway, then prefetched over P2P into the card between
              training steps: eight seeded 256 MiB shards (2 GiB, phase
              5's). An S3 stand-in (``S3StandIn``, standard library) in a
              child keeps objects on disk, recomputes every request's
              SigV4 signature from a fixed key pair and counts the bytes
              of each PUT and GET. A second child runs a scheduler
              (``algorithm="plugin:gwfirst"``, records kept) whose
              evaluator plugin scores the gateway's host 10.0 and any
              other 1.0, and the seed daemon G with the object gateway:
              bucket ``datasets`` on the stand-in (backend kind ``s3``,
              write-back) and ``generated`` on the ``seeded`` scheme of
              a source plugin in G's ``plugin_dir``. Each shard is put
              by ``python -m dragonfly2_tpu_torch.tools.dfstore put`` as
              its own process, which must exit 0 only once the stand-in
              holds the object; the stand-in must receive every dataset
              byte once. Leecher L, in this process (back-source
              disabled, device sink on the card), iterates
              ``ShardPrefetcher(depth=2)`` over G's ``s3+http://`` URLs
              with ``UrlMeta(tag="objstore")``; each shard must equal the
              bytes put and feeds one training step on the card (a bf16
              matmul over its bytes and an SGD update). The stand-in must
              send 0 GET bytes meanwhile, and every ruling of L's tasks
              must carry ``substituted: {"total": "plugin"}`` with the
              plugin's totals and choose its best. ``dfstore get`` of a
              ``generated`` object streams through G's ``stream_task``
              and must equal the plugin's bytes, twice, the second from
              the completed task (the plugin read once); ``dfstore rm``
              then ``stat`` must find the object gone from the gateway
              and the stand-in. It prints the put and prefetch rates,
              the consumer's wait per shard against the step time, the
              stand-in's byte counts and the plugin's rulings
20. mirror   — run after phase 19, on phase 8's origin: a containerd-shaped
              pull of an OCI image through the daemons' registry mirror
              proxy into the card. The image is a config blob and two
              layers: phase 8's file (the model layer) and a seeded
              256 MiB runtime layer (BASELINE config 3's multi-GB vLLM
              image cut to about 1.3 GB). A registry stand-in
              (``RegistryStandIn``, standard library) in a child speaks
              TLS with a leaf from the port's ``CertIssuer`` under a CA
              of its own, requires a bearer token, answers the v2 routes
              (``/v2/``, manifests, blobs with HEAD and ``Range``) and
              counts the body bytes it serves per digest and its
              manifest hits. A second child runs a scheduler and daemons
              A and B (``proxy.hijack``) and C (``proxy.registry_mirror``
              on the stand-in, ``proxy.sni_port`` -1), each trusting the
              stand-in's CA through ``download.source_ca``. The client
              here, on ``http.client``, checks the API, fetches the
              manifest with ``Accept``, then the config and the layers,
              streaming each layer into a pinned host buffer that is
              copied to the card on a side stream. Four pulls: through
              A's CONNECT (the stand-in must then have sent each blob's
              bytes exactly once), through B's CONNECT (no further blob
              byte from the stand-in, and every piece of B's from a
              peer), through C's mirror rewrite over plain HTTP with
              relative paths (likewise), and through C's SNI port with a
              registry name in the ClientHello and the stand-in's address
              as ``Host`` (replayed from C's storage). Every blob's
              sha256 must equal its digest, the model layer's tensors on
              the card must equal phase 8's, the manifest hits must equal
              the pulls (manifests relay direct), and the leaves' SANs
              must name the CONNECT host and the SNI name. It checks the
              ``openssl`` binary first, and prints each pull's wall time
              and rate, the stand-in's bytes per digest after each pull,
              the proxy's counters by route, each leaf's first mint time
              and the loop lag the health plane saw during the SNI
              handshake

Before phase 3 the native storage library (``dfnative.cc``, built with
g++ at first use) must load: the pulls land crc32c piece digests, and the
host line reports its crc32c rate beside zlib's crc32.

Each phase prints its lines. The port ports no kernel (the JAX package has
no Pallas kernel; its device work is ``jax.device_put``, copy-engine work
here, and the trainer's XLA ops, torch ops here), so the kernel line lists
none. The last line is the JSON verdict; any failed check exits non-zero
before it.
"""

from __future__ import annotations

import os

# deterministic cuBLAS (the trainer's fits) needs this before the first
# cuBLAS call of the process
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse
import asyncio
import concurrent.futures
import contextlib
import dataclasses
import datetime
import hashlib
import http.client
import io
import json
import math
import multiprocessing
import random
import re
import shutil
import signal
import socket
import ssl
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import zlib

import numpy as np
import torch

from dragonfly2_tpu_torch import graft_entry, source
from dragonfly2_tpu_torch.common import phasetimer, podscope, tracing
from dragonfly2_tpu_torch.common.debug_http import start_debug_server
from dragonfly2_tpu_torch.common.errors import Code, DFError
from dragonfly2_tpu_torch.common.httpd import HTTPError
from dragonfly2_tpu_torch.common.metrics import REGISTRY
from dragonfly2_tpu_torch.common.piece import compute_piece_size
from dragonfly2_tpu_torch.daemon.config import (DaemonConfig,
                                                ObjectStorageConfig,
                                                QosSection, SchedulerConfig,
                                                TracingConfig)
from dragonfly2_tpu_torch.daemon import pulse as pulse_mod
from dragonfly2_tpu_torch.daemon.daemon import Daemon
from dragonfly2_tpu_torch.idl.messages import (DeviceSink, DownloadRequest,
                                               Host, HostType,
                                               ModelInferRequest, PieceInfo,
                                               PieceResult,
                                               RegisterPeerTaskRequest,
                                               ShardInfo, ShardManifest,
                                               TopologyInfo, UrlMeta)
from dragonfly2_tpu_torch.manager.server import Manager, ManagerConfig
from dragonfly2_tpu_torch.rpc.client import Channel, ServiceClient
from dragonfly2_tpu_torch.scheduler.config import SchedulerConfig as \
    SchedCfg
from dragonfly2_tpu_torch.scheduler.config import SeedPeerAddr
from dragonfly2_tpu_torch.scheduler.decision_ledger import (
    replay_decisions, replay_regret, stitch_outcomes)
from dragonfly2_tpu_torch.scheduler.records import MAX_BUFFERED_ROWS
from dragonfly2_tpu_torch.scheduler.resource import PeerState
from dragonfly2_tpu_torch.scheduler.server import Scheduler
from dragonfly2_tpu_torch.source.file_client import FileSourceClient
from dragonfly2_tpu_torch.storage import native
from dragonfly2_tpu_torch.tools import dfbench, dfdiag, dfsched
from dragonfly2_tpu_torch.tools.scheduler import add_scheduler_routes
from dragonfly2_tpu_torch.tpu.data import ShardPrefetcher
from dragonfly2_tpu_torch.tpu.hbm_sink import DeviceIngest
from dragonfly2_tpu_torch.trainer import (features, models, params_io,
                                          pipeline, serving, training)
from dragonfly2_tpu_torch.trainer.server import Trainer, TrainerConfig
from dragonfly2_tpu_torch.trainer.service import TRAINER_SERVICE

# meta-llama/Meta-Llama-3-8B config.json
LLAMA3_8B = {"hidden": 4096, "intermediate": 14336, "kv_heads": 8,
             "head_dim": 128, "vocab": 128256, "layers": 32}
SAFETENSORS_DTYPES = {"BF16": "bfloat16", "F16": "float16",
                      "F32": "float32", "I8": "int8", "U8": "uint8",
                      "I32": "int32"}
PREFETCH_SHARDS = 8
PREFETCH_SHARD_BYTES = 256 << 20
KERNELS_NOTE = ("the JAX package has no Pallas kernel; its device work on "
                "this path is jax.device_put, which the port does as "
                "pinned-memory copies on a CUDA stream (copy engines), and "
                "the trainer's XLA ops (bf16-operand matmuls, GELU, "
                "gathers, segment sums, AdamW), which the port runs as "
                "torch ops")

# phase 7: one full records ring (scheduler/records.py), decision to
# piece-outcome rows as in BENCH_pr19's datagen, and the GNN's largest
# buckets (trainer/features.py _NODE_BUCKETS, _EDGE_BUCKETS)
RING_ROWS = MAX_BUFFERED_ROWS
DECISION_ROWS, OUTCOME_ROWS = 64, 512
GNN_HOSTS = features._NODE_BUCKETS[-1]
GNN_LINKS = features._EDGE_BUCKETS[-1]
RING_EPOCHS = pipeline.DEFAULT_EPOCHS
GNN_EPOCHS = 60                          # training.train_gnn's default
HEURISTIC_REGRET = 0.1379                # BENCH_pr19.json regret.heuristic
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "data", "pr19_datagen_rows.jsonl")
PROFILE_STEPS = 200
BIND_RULINGS = 256
REGRET_SEEDS = range(16)

# phase 8: the launchers' processes run from this checkout; the scheduler
# uploads its records and polls the registry on a few seconds' cadence, so
# the loop closes inside the phase
ROOT = os.path.dirname(os.path.abspath(__file__))
DEPLOY_UPLOAD_S = 5.0
DEPLOY_REFRESH_S = 2.0
DEPLOY_BOOT_S = 120.0
DEPLOY_LOOP_S = 120.0
DEPLOY_STOP_S = 10.0
# the trainer fits the GNN from 4 topology rows or more
# (trainer/service.py); about two probe rounds (20 s each) bound the wait
DEPLOY_PROBE_LINKS = 4
DEPLOY_PROBE_S = 50.0


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(phase: str, record: dict) -> None:
    print(f"{phase}: {json.dumps(record)}", flush=True)


def seeded_bytes(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` seeded random bytes (drawn as uint64 words: several times
    faster than ``Generator.bytes``)."""
    words = rng.integers(0, np.iinfo(np.uint64).max, size=-(-n // 8),
                         dtype=np.uint64, endpoint=True)
    return words.view(np.uint8)[:n]


def llama_layout(layers: int) -> list[tuple[str, list[int]]]:
    """Tensor names and shapes of Llama-3-8B in the published (Hugging
    Face) layout: the embedding and ``layers`` decoder layers, plus the
    final norm and ``lm_head`` when all 32 layers are asked for."""
    h, i = LLAMA3_8B["hidden"], LLAMA3_8B["intermediate"]
    kv = LLAMA3_8B["kv_heads"] * LLAMA3_8B["head_dim"]
    out = [("model.embed_tokens.weight", [LLAMA3_8B["vocab"], h])]
    for n in range(layers):
        p = f"model.layers.{n}."
        out += [(p + "self_attn.q_proj.weight", [h, h]),
                (p + "self_attn.k_proj.weight", [kv, h]),
                (p + "self_attn.v_proj.weight", [kv, h]),
                (p + "self_attn.o_proj.weight", [h, h]),
                (p + "mlp.gate_proj.weight", [i, h]),
                (p + "mlp.up_proj.weight", [i, h]),
                (p + "mlp.down_proj.weight", [h, i]),
                (p + "input_layernorm.weight", [h]),
                (p + "post_attention_layernorm.weight", [h])]
    if layers == LLAMA3_8B["layers"]:        # the whole model
        out += [("model.norm.weight", [h]),
                ("lm_head.weight", [LLAMA3_8B["vocab"], h])]
    return out


def safetensors_header(layout: list[tuple[str, list[int]]]
                       ) -> tuple[bytes, int]:
    """(8-byte length + JSON header padded to 8 bytes, tensor bytes)."""
    entries, off = {}, 0
    for name, shape in layout:
        nbytes = int(np.prod(shape)) * 2
        entries[name] = {"dtype": "BF16", "shape": shape,
                         "data_offsets": [off, off + nbytes]}
        off += nbytes
    raw = json.dumps(entries, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    return struct.pack("<Q", len(raw)) + raw, off


def manifest_from_file(path: str) -> ShardManifest:
    """The shard manifest a user builds from a safetensors header."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
    base = 8 + n
    return ShardManifest(shards=[
        ShardInfo(name=name, range_start=base + e["data_offsets"][0],
                  range_size=e["data_offsets"][1] - e["data_offsets"][0],
                  dtype=SAFETENSORS_DTYPES[e["dtype"]], shape=e["shape"])
        for name, e in header.items() if name != "__metadata__"])


def check_crc32c(md, who: str) -> None:
    """Every piece the pull landed carries a crc32c digest (the native
    library's), as the reference's do when its library is built."""
    bad = sorted(n for n, p in md.pieces.items()
                 if not p.digest.startswith("crc32c:"))
    check(bool(md.pieces) and not bad,
          f"{who}: pieces without a crc32c digest: {bad[:8]}")


def hbm_counters() -> dict:
    """The sink's cumulative ``df_hbm_*`` counters and histogram."""
    transfers = REGISTRY.counter("df_hbm_transfers_total",
                                 labels=("result",))
    _, seconds, n = REGISTRY.histogram("df_hbm_transfer_seconds").snapshot()
    return {
        "df_hbm_staged_bytes_total":
            REGISTRY.counter("df_hbm_staged_bytes_total").value(),
        "df_hbm_transfers_total_ok": transfers.value("ok"),
        "df_hbm_transfers_total_fail": transfers.value("fail"),
        "df_hbm_transfer_seconds_count": n,
        "df_hbm_transfer_seconds_sum": seconds,
    }


def hbm_metrics(before: dict) -> dict:
    """This phase's ``df_hbm_*`` increments (counters, histogram) and the
    gauges as read after it."""
    out = {k: v - before[k] for k, v in hbm_counters().items()}
    out["df_hbm_transfer_queue_depth"] = REGISTRY.gauge(
        "df_hbm_transfer_queue_depth").value()
    out["df_hbm_done_fraction"] = REGISTRY.gauge(
        "df_hbm_done_fraction").value()
    return out


def timed_upload(src: torch.Tensor, device: torch.device
                 ) -> tuple[float, torch.Tensor]:
    """One host-to-device copy of the whole buffer, timed to completion
    with CUDA events (after a 1 MiB warm-up copy); returns (GB/s, copy)."""
    dst = torch.empty(src.numel(), dtype=torch.uint8, device=device)
    dst[:1 << 20].copy_(src[:1 << 20])
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    return src.numel() / 1e9 / (start.elapsed_time(end) / 1e3), dst


def overlap_efficiency(spans: list[tuple[float, float]],
                       t_dl_end: float) -> float:
    """Fraction of device-copy time that ran before the download's last
    byte landed (1.0 = every copy hidden behind the download)."""
    total = sum(e - s for s, e in spans)
    if total <= 0:
        return 0.0
    return sum(max(0.0, min(e, t_dl_end) - s) for s, e in spans) / total


async def pull(daemon: Daemon, url: str, meta: UrlMeta, sink: DeviceSink,
               manifest: ShardManifest | None = None) -> dict:
    """One task through the daemon's file-task path; returns the sink's
    result and the run's timings."""
    t0 = time.monotonic()
    task_id = None
    async for resp in daemon.ptm.start_file_task(DownloadRequest(
            url=url, url_meta=meta, device_sink=sink, timeout_s=1200.0,
            shard_manifest=manifest)):
        task_id = resp.task_id or task_id
    t_dl_end = time.monotonic()
    conductor = daemon.ptm.conductor(task_id)
    ingest = conductor.device_ingest
    check(ingest is not None, f"{url}: device sink was not live")
    out = await asyncio.to_thread(ingest.result, 1200.0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return {"task_id": task_id, "out": out, "wall": wall,
            "download_s": t_dl_end - t0,
            "overlap": overlap_efficiency(list(ingest.transfer_spans),
                                          t_dl_end),
            "transfers": len(ingest.transfer_spans),
            "pin_s": ingest.pin_seconds,
            "piece_size": conductor.piece_size,
            "pieces": conductor.total_pieces}


def phase_device() -> str:
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        print("chip_smoke: no CUDA device found; this smoke runs only on a "
              "CUDA card", file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("phase 1 device", {"name": name,
                            "count": torch.cuda.device_count(),
                            "torch": torch.__version__,
                            "cuda": torch.version.cuda})
    print(smi, flush=True)
    return name


def phase_sink(buf: np.ndarray, seed: int, device: torch.device
               ) -> torch.Tensor:
    """Returns the input on the card (uploaded from pageable memory), the
    reference later phases compare against."""
    n = buf.size
    before = hbm_counters()
    piece = compute_piece_size(n)
    order = np.random.default_rng(seed + 1).permutation(-(-n // piece))
    t0 = time.monotonic()
    ingest = DeviceIngest(n, devices=[device])
    t_built = time.monotonic()
    view = memoryview(buf)
    for p in order:
        ingest.write(int(p) * piece, view[int(p) * piece:(int(p) + 1) * piece])
    t_written = time.monotonic()
    (out,) = ingest.result(timeout=600)
    torch.cuda.synchronize(device)
    t_done = time.monotonic()
    check(out.device == device, "sink result is not on the card")
    pinned_gbps, _ = timed_upload(ingest.host, device)
    del ingest, _
    pageable_gbps, ref = timed_upload(torch.from_numpy(buf), device)
    check(torch.equal(out, ref), "sink bytes differ from the input")
    del out
    emit("phase 2 sink", {
        "bytes": n, "pieces": len(order), "piece_size": piece,
        "pin_s": t_built - t0, "write_s": t_written - t_built,
        "result_s": t_done - t_written,
        "h2d_pinned_gbps": pinned_gbps, "h2d_pageable_gbps": pageable_gbps,
        "bytes_equal": True,
        **hbm_metrics(before)})
    return ref


async def phase_daemon(workdir: str, path: str, digest: str,
                       header: bytes, ref: torch.Tensor,
                       layout: list[tuple[str, list[int]]],
                       device: torch.device) -> None:
    daemon = Daemon(DaemonConfig(workdir=os.path.join(workdir, "daemon"),
                                 hostname="chip-smoke"))
    await daemon.start()
    url = "file://" + path
    size = os.path.getsize(path)
    try:
        # manifest mode: one typed, shaped tensor per named tensor
        before = hbm_counters()
        manifest = manifest_from_file(path)
        run = await pull(daemon, url, UrlMeta(digest=digest),
                         DeviceSink(enabled=True), manifest)
        tensors = run["out"]
        check(len(tensors) == len(layout),
              f"{len(tensors)} tensors, want {len(layout)}")
        base = len(header)
        shapes = dict(layout)
        for info in manifest.shards:
            t = tensors[info.name]
            check(t.device == device, f"{info.name} on {t.device}")
            check(t.dtype == torch.bfloat16, f"{info.name} is {t.dtype}")
            check(list(t.shape) == shapes[info.name],
                  f"{info.name} shape {list(t.shape)}")
            lo = info.range_start - base
            check(torch.equal(t.reshape(-1).view(torch.uint8),
                              ref[lo:lo + info.range_size]),
                  f"{info.name} bytes differ from the origin")
        emit("phase 3 manifest", {
            "file_bytes": size, "tensors_verified": len(tensors),
            "tensors": len(layout), "device": str(device),
            "dtype": "bfloat16", "wall_s": run["wall"],
            "download_s": run["download_s"],
            "gbps": size / 1e9 / run["wall"],
            "ingest_overlap_efficiency": run["overlap"],
            "transfers": run["transfers"], "pin_s": run["pin_s"],
            "piece_size": run["piece_size"], "pieces": run["pieces"],
            **hbm_metrics(before)})
        task_id = run["task_id"]
        check_crc32c(daemon.storage_mgr.get(task_id).md, "phase 3")
        del tensors, run
        await daemon.ptm.delete_task(task_id)

        # whole-file mode: uint8 shards, the auto pipeline_shards rule
        before = hbm_counters()
        run = await pull(daemon, url, UrlMeta(digest=digest),
                         DeviceSink(enabled=True))
        arrays = run["out"]
        check(all(a.device == device for a in arrays),
              "a whole-file shard is not on the card")
        flat = torch.cat(arrays)
        hdr = torch.frombuffer(bytearray(header), dtype=torch.uint8)
        check(torch.equal(flat[:base].cpu(), hdr), "header bytes differ")
        check(torch.equal(flat[base:size], ref), "tensor bytes differ")
        check(not flat[size:].any().item(), "pad bytes are not zero")
        emit("phase 4 file", {
            "file_bytes": size, "bytes_equal": True,
            "device_shards": len(arrays), "wall_s": run["wall"],
            "download_s": run["download_s"],
            "gbps": size / 1e9 / run["wall"],
            "ingest_overlap_efficiency": run["overlap"],
            "transfers": run["transfers"], "pin_s": run["pin_s"],
            "piece_size": run["piece_size"], "pieces": run["pieces"],
            **hbm_metrics(before)})
        task_id = run["task_id"]
        check_crc32c(daemon.storage_mgr.get(task_id).md, "phase 4")
        del arrays, flat, run
        torch.cuda.empty_cache()
        await daemon.ptm.delete_task(task_id)

        # the same pull with no device sink (what the device leg adds), and
        # with neither sink nor digest (what the finalize sha256 adds)
        for what, meta in (("no sink", UrlMeta(digest=digest)),
                           ("no sink, no digest", UrlMeta())):
            t0 = time.monotonic()
            async for resp in daemon.ptm.start_file_task(DownloadRequest(
                    url=url, url_meta=meta, timeout_s=1200.0)):
                task_id = resp.task_id or task_id
            wall = time.monotonic() - t0
            emit(f"phase 4 file, {what}", {"file_bytes": size, "wall_s": wall,
                                           "gbps": size / 1e9 / wall})
            await daemon.ptm.delete_task(task_id)
    finally:
        await daemon.stop()


def phase_prefetch(workdir: str, seed: int, device: torch.device) -> None:
    rng = np.random.default_rng(seed + 2)
    urls, refs = [], []
    for i in range(PREFETCH_SHARDS):
        data = seeded_bytes(rng, PREFETCH_SHARD_BYTES)
        path = os.path.join(workdir, f"shard-{i:05d}.tar")
        with open(path, "wb") as f:
            f.write(memoryview(data))
            os.fsync(f.fileno())
        urls.append("file://" + path)
        refs.append(torch.from_numpy(data).to(device))
    boot: dict = {}
    ready = threading.Event()
    stop = threading.Event()

    def daemon_thread() -> None:
        async def main() -> None:
            daemon = Daemon(DaemonConfig(
                workdir=os.path.join(workdir, "prefetch-daemon"),
                hostname="chip-smoke-pf"))
            await daemon.start()
            boot["daemon"] = daemon
            boot["loop"] = asyncio.get_running_loop()
            ready.set()
            try:
                while not stop.is_set():
                    await asyncio.sleep(0.05)
            finally:
                await daemon.stop()

        asyncio.run(main())

    t = threading.Thread(target=daemon_thread, name="smoke-daemon",
                         daemon=True)
    t.start()
    try:
        check(ready.wait(timeout=120), "prefetch daemon did not start")
        before = hbm_counters()
        pf = ShardPrefetcher(boot["daemon"], urls, depth=2,
                             loop=boot["loop"])
        t0 = time.monotonic()
        got = 0
        for i, arrays in enumerate(pf):
            check(all(a.device == device for a in arrays),
                  f"shard {i} is not on the card")
            flat = torch.cat(arrays)
            check(torch.equal(flat[:PREFETCH_SHARD_BYTES], refs[i]),
                  f"shard {i} bytes differ (or arrived out of order)")
            got += 1
        elapsed = time.monotonic() - t0
        check(got == PREFETCH_SHARDS, f"{got} shards, want {PREFETCH_SHARDS}")
        left = boot["daemon"].ptm.storage_mgr.tasks()
        check(not left, f"{len(left)} shard tasks left in storage")
    finally:
        stop.set()
        t.join(timeout=120)
        for url in urls:
            os.unlink(url[len("file://"):])
    emit("phase 5 prefetch", {
        "shards": got, "shard_bytes": PREFETCH_SHARD_BYTES, "depth": 2,
        "in_order_bytes_equal": True, "elapsed_s": elapsed,
        "shards_per_s": got / elapsed,
        "gbps": got * PREFETCH_SHARD_BYTES / 1e9 / elapsed,
        **hbm_metrics(before)})


# ---------------------------------------------------------------- phase 6

def relay_stats(d: Daemon) -> dict:
    """What this daemon's upload server relayed: serves by result (``ok``
    is a complete streamed range) and bytes by source (live span or
    storage)."""
    return {"relay_serves": dict(d.upload_server.relay_serves),
            "relay_bytes": dict(d.upload_server.relay_bytes)}


def pex_counts() -> dict:
    """This process's PEX counters (its leechers'; a child keeps its
    own): advisory packets primed onto scheduler sessions, pieces served
    by parents the gossip plane found, demoted schedulers revived."""
    return {"df_pex_prime_total":
            REGISTRY.counter("df_pex_prime_total").value(),
            "df_pex_parent_hits_total":
            REGISTRY.counter("df_pex_parent_hits_total").value(),
            "df_pex_sched_revived_total":
            REGISTRY.counter("df_pex_sched_revived_total").value()}


def pex_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in pex_counts().items()}


class CountingFileClient(FileSourceClient):
    """``file://`` origin that counts the bytes it serves."""

    def __init__(self) -> None:
        self.bytes_read = 0

    async def download(self, req):
        resp = await super().download(req)
        inner = resp.chunks

        async def counted():
            async for chunk in inner:
                self.bytes_read += len(chunk)
                yield chunk
        resp.chunks = counted()
        return resp


def p2p_child(workdir: str, conn) -> None:
    """Phase 6's scheduler and seed daemon, in a spawned process that never
    touches CUDA: it sends the scheduler's address, serves until the
    parent asks, then sends the origin bytes read, the seed's back-source
    time and the scheduler's rulings."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""     # before any CUDA call
    asyncio.run(_p2p_child(workdir, conn))


async def _p2p_child(workdir: str, conn) -> None:
    origin = CountingFileClient()
    source.register_client("file", origin)
    seed = Daemon(DaemonConfig(workdir=os.path.join(workdir, "seed"),
                               hostname="smoke-seed", is_seed=True,
                               listen_ip="127.0.0.1", host_ip="127.0.0.1",
                               device="cpu"))
    await seed.start()
    sched = Scheduler(SchedCfg(listen_ip="127.0.0.1", seed_peers=[
        SeedPeerAddr(host_id=seed.host_info().id, ip="127.0.0.1",
                     rpc_port=seed.rpc.port,
                     download_port=seed.upload_server.port)]))
    await sched.start()
    seed_s: dict = {}
    served = REGISTRY.counter("df_upload_bytes_total")

    async def watch_seed() -> None:
        """The seed's pull: when its last piece landed, when it finished
        (the finalize sha256 between them)."""
        while not seed.ptm._conductors:
            await asyncio.sleep(0.01)
        (c,) = seed.ptm._conductors.values()
        q = c.subscribe()
        try:
            while True:
                event = await q.get()
                now = time.time() - c.start_ms / 1000
                if event["type"] == "piece" \
                        and event["completed"] == event["total"]:
                    seed_s["landed"] = now
                elif event["type"] == "done":
                    seed_s["done"] = now
                    return
        finally:
            c.unsubscribe(q)

    watcher = asyncio.get_running_loop().create_task(watch_seed())
    try:
        conn.send({"scheduler": sched.address})
        await asyncio.to_thread(conn.recv)      # the parent is done
        conn.send({"origin_bytes_read": origin.bytes_read,
                   "seed_back_source_s": seed_s.get("done"),
                   "seed_landed_s": seed_s.get("landed"),
                   "seed_upload_bytes": served.value(),
                   "seed_relay_serves": dict(seed.upload_server.relay_serves),
                   "seed_relay_bytes": dict(seed.upload_server.relay_bytes),
                   "seed_state": [c.state for c in
                                  seed.ptm._conductors.values()],
                   "rulings": sched.service.rulings,
                   "excluded": {
                       reason: REGISTRY.counter(
                           "df_sched_filter_excluded_total",
                           labels=("reason",)).value(reason)
                       for reason in ("stream-gone", "blocklist",
                                      "no-slots", "bad-node", "cycle")}})
    finally:
        watcher.cancel()
        await seed.stop()
        await sched.stop()


async def _leecher_pull(daemon: Daemon, url: str, meta: UrlMeta,
                        manifest: ShardManifest | None, box: dict) -> dict:
    """One leecher's pull with back-source disabled; ``box`` exposes the
    conductor while the pull runs."""
    t0 = time.monotonic()
    task_id = None
    t_landed = None
    async for resp in daemon.ptm.start_file_task(DownloadRequest(
            url=url, url_meta=meta, device_sink=DeviceSink(enabled=True),
            disable_back_source=True, timeout_s=1200.0,
            shard_manifest=manifest)):
        task_id = resp.task_id or task_id
        if "conductor" not in box and task_id:
            box["conductor"] = daemon.ptm.conductor(task_id)
        if (t_landed is None and not resp.done
                and resp.completed_length == resp.content_length):
            t_landed = time.monotonic()     # the last piece landed
    t_dl_end = time.monotonic()
    conductor = daemon.ptm.conductor(task_id)
    ingest = conductor.device_ingest
    check(ingest is not None, f"{daemon.hostname}: device sink was not live")
    out = await asyncio.to_thread(ingest.result, 1200.0)
    # off the loop: other daemons of this process may still be pulling
    # (a CPU sink, phase 17's pods rehearsed without a card, has none)
    if torch.cuda.is_available():
        await asyncio.to_thread(torch.cuda.synchronize)
    wall = time.monotonic() - t0
    spans = list(ingest.transfer_spans)
    return {"out": out, "conductor": conductor, "wall": wall, "t0": t0,
            "download_s": t_dl_end - t0,
            "landed_s": (t_landed or t_dl_end) - t0,
            "overlap": overlap_efficiency(spans, t_dl_end),
            "copy_s": sum(e - b for b, e in spans),
            "transfers": len(spans)}


async def _leechers(workdir: str, sched_addr: str, url: str, digest: str,
                    manifest: ShardManifest) -> tuple[dict, dict]:
    def daemon(name: str) -> Daemon:
        return Daemon(DaemonConfig(
            workdir=os.path.join(workdir, name), hostname=f"smoke-{name}",
            listen_ip="127.0.0.1", host_ip="127.0.0.1",
            scheduler=SchedulerConfig(addresses=[sched_addr])))

    a, b = daemon("leecher-a"), daemon("leecher-b")
    await a.start()
    await b.start()
    try:
        meta = UrlMeta(digest=digest)
        box_a: dict = {}
        pull_a = asyncio.get_running_loop().create_task(
            _leecher_pull(a, url, meta, manifest, box_a))
        # B starts once A holds about half of its pieces
        while True:
            c = box_a.get("conductor")
            if pull_a.done() or (c is not None and c.total_pieces > 0
                                 and 2 * len(c.ready) >= c.total_pieces):
                break
            await asyncio.sleep(0.01)
        b_start_pieces = len(c.ready) if c is not None else -1
        served0 = REGISTRY.counter("df_upload_bytes_total").value()
        run_b = await _leecher_pull(b, url, meta, None, {})
        run_a = await pull_a
        run_b["a_pieces_at_start"] = b_start_pieces
        run_a["upload_bytes"] = \
            REGISTRY.counter("df_upload_bytes_total").value() - served0
        run_a["peer_id"] = run_a["conductor"].peer_id
        run_a.update(relay_stats(a))
        run_b.update(relay_stats(b))
        return run_a, run_b
    finally:
        await a.stop()
        await b.stop()


def phase_p2p(workdir: str, path: str, digest: str, header: bytes,
              ref: torch.Tensor, layout: list[tuple[str, list[int]]],
              device: torch.device) -> None:
    size = os.path.getsize(path)
    # the seed's copy and the two leechers' copies beside the origin
    free = shutil.disk_usage(workdir).free
    need = 3 * size + (1 << 30)
    check(free >= need, f"phase 6 needs {need} bytes of free disk for the "
                        f"seed's and two leechers' copies, {free} free")
    manifest = manifest_from_file(path)
    before = hbm_counters()
    pex0 = pex_counts()
    ctx = multiprocessing.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe()
    child = ctx.Process(target=p2p_child, name="smoke-p2p-child",
                        args=(os.path.join(workdir, "p2p"), child_conn))
    child.start()
    try:
        check(parent_conn.poll(300), "phase 6 child did not start")
        sched_addr = parent_conn.recv()["scheduler"]
        run_a, run_b = asyncio.run(_leechers(
            os.path.join(workdir, "p2p"), sched_addr, "file://" + path,
            digest, manifest))
        parent_conn.send("stop")
        check(parent_conn.poll(300), "phase 6 child did not report")
        stats = parent_conn.recv()
    finally:
        child.join(timeout=120)
        if child.is_alive():
            child.terminate()
            child.join(timeout=30)
    check(child.exitcode == 0, f"phase 6 child exited {child.exitcode}")
    # leecher A: every named tensor on the card, bf16, the origin's bytes
    tensors = run_a["out"]
    base = len(header)
    shapes = dict(layout)
    check(len(tensors) == len(layout),
          f"A: {len(tensors)} tensors, want {len(layout)}")
    for info in manifest.shards:
        t = tensors[info.name]
        check(t.device == device and t.dtype == torch.bfloat16
              and list(t.shape) == shapes[info.name],
              f"A: {info.name} is {t.dtype} {list(t.shape)} on {t.device}")
        lo = info.range_start - base
        check(torch.equal(t.reshape(-1).view(torch.uint8),
                          ref[lo:lo + info.range_size]),
              f"A: {info.name} bytes differ from the origin")
    # leecher B: the whole file on the card
    arrays = run_b["out"]
    check(all(x.device == device for x in arrays), "B: a shard is off card")
    flat = torch.cat(arrays)
    hdr = torch.frombuffer(bytearray(header), dtype=torch.uint8)
    check(torch.equal(flat[:base].cpu(), hdr), "B: header bytes differ")
    check(torch.equal(flat[base:size], ref), "B: tensor bytes differ")
    del tensors, arrays, flat
    lines = {}
    for name, run in (("A", run_a), ("B", run_b)):
        c = run["conductor"]
        check(c.traffic_p2p == size and c.traffic_source == 0,
              f"{name}: traffic_p2p {c.traffic_p2p}, traffic_source "
              f"{c.traffic_source}, file {size}")
        check_crc32c(c.storage.md, f"phase 6 {name}")
        lines[name] = {
            "mode": "manifest" if name == "A" else "file",
            "started_s": run["t0"] - run_a["t0"],
            "time_to_ready_s": run["wall"], "download_s": run["download_s"],
            "landed_s": run["landed_s"],
            "finalize_s": run["download_s"] - run["landed_s"],
            "gbps": size / 1e9 / run["wall"],
            "pieces_per_parent": dict(c.pieces_by_parent),
            "ingest_overlap_efficiency": run["overlap"],
            "copy_s": run["copy_s"], "transfers": run["transfers"],
            "traffic_p2p": c.traffic_p2p,
            "traffic_source": c.traffic_source,
            "relay_serves": run["relay_serves"],
            "relay_bytes": run["relay_bytes"],
            "piece_size": c.piece_size, "pieces": c.total_pieces}
    from_a = run_b["conductor"].pieces_by_parent.get(run_a["peer_id"], 0)
    check(from_a > 0, "B took no piece from A")
    check(stats["origin_bytes_read"] == size,
          f"origin read {stats['origin_bytes_read']} bytes, file {size}")
    for name in ("A", "B"):
        emit(f"phase 6 p2p, leecher {name}", lines[name])
    emit("phase 6 p2p, seed and scheduler", {
        "file_bytes": size, "seed_back_source_s": stats["seed_back_source_s"],
        "seed_landed_s": stats["seed_landed_s"],
        "seed_upload_bytes": stats["seed_upload_bytes"],
        "seed_relay_serves": stats["seed_relay_serves"],
        "seed_relay_bytes": stats["seed_relay_bytes"],
        "leecher_upload_bytes": run_a["upload_bytes"],
        "origin_bytes_read": stats["origin_bytes_read"],
        "rulings": stats["rulings"], "b_pieces_from_a": from_a,
        "a_pieces_when_b_started": run_b["a_pieces_at_start"],
        "pex": pex_delta(pex0), **hbm_metrics(before)})


# ---------------------------------------------------------------- phase 9

SHARDED_POD = "smoke-pod"


def pipeline_stages(layout: list[tuple[str, list[int]]]
                    ) -> list[list[str]]:
    """Two pipeline stages of the layout: the embedding and the first half
    of the decoder layers; the rest (and the final norm and head when the
    layout has them)."""
    layers = sum(1 for name, _ in layout
                 if name.endswith(".input_layernorm.weight"))
    split = layers // 2

    def stage(name: str) -> int:
        if name == "model.embed_tokens.weight":
            return 0
        if name.startswith("model.layers."):
            return int(int(name.split(".")[2]) >= split)
        return 1
    stages: list[list[str]] = [[], []]
    for name, _ in layout:
        stages[stage(name)].append(name)
    return stages


def shard_class_bytes(conductor) -> dict:
    """Bytes of the leecher's tracked shards landed per supply class,
    from its own pieces (``df_shard_bytes_total`` sums every leecher of
    the process)."""
    tracker = conductor.shard_tracker
    out = {"tree": 0, "swap": 0}
    for num in conductor.ready:
        meta = conductor.storage.md.pieces[num]
        cls = "swap" if num in conductor.swap_piece_nums else "tree"
        out[cls] += tracker.shard_bytes_in(meta.start, meta.start + meta.size)
    return out


async def _replicas(workdir: str, sched_addr: str, url: str,
                    manifest: ShardManifest,
                    stages: list[list[str]]) -> dict[str, dict]:
    names = {"A0": 0, "A1": 0, "B0": 1, "B1": 1}
    daemons = {n: Daemon(DaemonConfig(
        workdir=os.path.join(workdir, n), hostname=f"smoke-{n.lower()}",
        listen_ip="127.0.0.1", host_ip="127.0.0.1",
        scheduler=SchedulerConfig(addresses=[sched_addr])))
        for n in names}
    for d in daemons.values():
        # one pod (what DF_POD_ID names for a daemon process of its own)
        d.topology = dataclasses.replace(d.topology, pod=SHARDED_POD)
        await d.start()
    lags: list[float] = []

    async def watch_loop() -> None:
        """The event loop's lag: the four daemons share it."""
        while True:
            t = time.monotonic()
            await asyncio.sleep(0.01)
            lags.append(time.monotonic() - t - 0.01)

    watcher = asyncio.get_running_loop().create_task(watch_loop())
    try:
        runs = await asyncio.gather(*(
            _leecher_pull(daemons[n], url,
                          UrlMeta(shards=",".join(stages[st])), manifest, {})
            for n, st in names.items()))
        return {n: {**run, "stage": names[n], **relay_stats(daemons[n])}
                for n, run in zip(names, runs)}, lags
    finally:
        watcher.cancel()
        for d in daemons.values():
            await d.stop()


async def _restart_replica(workdir: str, sched_addr: str, url: str,
                           manifest: ShardManifest,
                           stage: list[str]) -> dict:
    """Replica A0 again, after the pod stopped: a fresh daemon on its
    workdir reloads its warm partial at construction, re-verifies it at
    start, and pulls its stage with a manifest sink on the card."""
    t0 = time.monotonic()
    d = Daemon(DaemonConfig(
        workdir=os.path.join(workdir, "A0"), hostname="smoke-a0",
        listen_ip="127.0.0.1", host_ip="127.0.0.1",
        scheduler=SchedulerConfig(addresses=[sched_addr])))
    d.topology = dataclasses.replace(d.topology, pod=SHARDED_POD)
    await d.start()
    started_s = time.monotonic() - t0
    try:
        run = await _leecher_pull(d, url, UrlMeta(shards=",".join(stage)),
                                  manifest, {})
        return {**run, "reload_to_ready_s": time.monotonic() - t0,
                "reload_and_verify_s": started_s,
                "reloaded_tasks": d.storage_mgr.reloaded_tasks,
                "reload": dict(d.reload_stats)}
    finally:
        await d.stop()


def phase_sharded(workdir: str, path: str, header: bytes, ref: torch.Tensor,
                  layout: list[tuple[str, list[int]]],
                  device: torch.device) -> None:
    size = os.path.getsize(path)
    # the seed's whole copy and four warm partials (each stage twice)
    free = shutil.disk_usage(workdir).free
    need = 3 * size + (1 << 30)
    check(free >= need, f"phase 9 needs {need} bytes of free disk for the "
                        f"seed's copy and four partials, {free} free")
    manifest = manifest_from_file(path)
    shards = {s.name: s for s in manifest.shards}
    stages = pipeline_stages(layout)
    check(all(stages), "phase 9 needs a layout with two stages")
    stage_bytes = [sum(shards[n].range_size for n in st) for st in stages]
    shard_bytes = REGISTRY.counter("df_shard_bytes_total", labels=("src",))
    fallbacks = REGISTRY.counter("df_shard_fallback_total")
    p2p_pieces = REGISTRY.counter("df_p2p_piece_total", labels=("result",))
    before = {"tree": shard_bytes.value("tree"),
              "swap": shard_bytes.value("swap"),
              **{k: p2p_pieces.value(k) for k in ("ok", "busy", "fail")},
              "fallback": fallbacks.value(),
              "upload": REGISTRY.counter("df_upload_bytes_total").value()}
    pex0 = pex_counts()
    ctx = multiprocessing.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe()
    child = ctx.Process(target=p2p_child, name="smoke-sharded-child",
                        args=(os.path.join(workdir, "sharded"), child_conn))
    child.start()
    try:
        check(parent_conn.poll(300), "phase 9 child did not start")
        sched_addr = parent_conn.recv()["scheduler"]
        runs, lags = asyncio.run(_replicas(
            os.path.join(workdir, "sharded"), sched_addr, "file://" + path,
            manifest, stages))
        # the pod's counts, before the restart adds its placements
        pod_counts = {k: shard_bytes.value(k) - before[k]
                      for k in ("tree", "swap")}
        restart = asyncio.run(_restart_replica(
            os.path.join(workdir, "sharded"), sched_addr, "file://" + path,
            manifest, stages[0]))
        parent_conn.send("stop")
        check(parent_conn.poll(300), "phase 9 child did not report")
        stats = parent_conn.recv()
    finally:
        child.join(timeout=120)
        if child.is_alive():
            child.terminate()
            child.join(timeout=30)
    check(child.exitcode == 0, f"phase 9 child exited {child.exitcode}")
    base = len(header)
    shapes = dict(layout)
    lines = {}
    assigned: dict[int, list[list[str]]] = {0: [], 1: []}
    for name, run in runs.items():
        st, c = run["stage"], run["conductor"]
        want = stages[st]
        tensors = run["out"]
        check(list(tensors) == want,
              f"{name}: {len(tensors)} tensors, want its stage's "
              f"{len(want)}")
        for tname in want:
            info, t = shards[tname], tensors[tname]
            check(t.device == device and t.dtype == torch.bfloat16
                  and list(t.shape) == shapes[tname],
                  f"{name}: {tname} is {t.dtype} {list(t.shape)} on "
                  f"{t.device}")
            lo = info.range_start - base
            check(torch.equal(t.reshape(-1).view(torch.uint8),
                              ref[lo:lo + info.range_size]),
                  f"{name}: {tname} bytes differ from the origin")
        check(c.affinity_shards is not None
              and set(c.affinity_shards) <= set(want),
              f"{name}: assigned_shards {c.affinity_shards} not a subset "
              f"of its request")
        assigned[st].append(list(c.affinity_shards))
        check(c.traffic_source == 0,
              f"{name}: read {c.traffic_source} bytes from the origin")
        md = c.storage.md
        check(not md.done, f"{name}: a subset's storage was marked done")
        check_crc32c(md, f"phase 9 {name}")
        check(set(md.pieces) <= c.needed_pieces,
              f"{name}: storage holds pieces outside its needed set")
        by_class = shard_class_bytes(c)
        check(by_class["tree"] + by_class["swap"] == stage_bytes[st],
              f"{name}: tree {by_class['tree']} + swap {by_class['swap']} "
              f"!= stage bytes {stage_bytes[st]}")
        ingest = c.device_ingest
        seed_pieces = sum(v for k, v in c.pieces_by_parent.items()
                          if k.endswith("seed"))
        lines[name] = {
            "stage": st, "tensors": len(tensors),
            "stage_bytes": stage_bytes[st],
            "started_s": run["t0"] - min(r["t0"] for r in runs.values()),
            "time_to_ready_s": run["wall"], "download_s": run["download_s"],
            "assigned_shards": len(c.affinity_shards),
            "assigned_at_register":
                len(c._session.result.assigned_shards or ()),
            "requested_shards": len(want),
            "tree_bytes": by_class["tree"], "swap_bytes": by_class["swap"],
            "pieces_from_seed": seed_pieces,
            "pieces_from_replicas": sum(c.pieces_by_parent.values())
            - seed_pieces,
            "needed_pieces": len(c.needed_pieces),
            "swap_pieces": len(c.swap_piece_nums),
            "fallbacks": len(c.fallback_pieces),
            "pin_s": ingest.pin_seconds, "pinned_bytes": ingest.pinned_bytes,
            "staged_bytes": ingest.host.numel(),
            "ingest_overlap_efficiency": run["overlap"],
            "traffic_p2p": c.traffic_p2p,
            "traffic_source": c.traffic_source,
            "relay_serves": run["relay_serves"],
            "relay_bytes": run["relay_bytes"]}
        del tensors
    # the restarted replica: its stage from its own disk, verified
    c = restart["conductor"]
    check(list(restart["out"]) == stages[0],
          f"restart: {len(restart['out'])} tensors, want stage 0's "
          f"{len(stages[0])}")
    for tname in stages[0]:
        info, t = shards[tname], restart["out"][tname]
        lo = info.range_start - base
        check(t.device == device and torch.equal(
            t.reshape(-1).view(torch.uint8), ref[lo:lo + info.range_size]),
              f"restart: {tname} differs from the origin")
    check(restart["reloaded_tasks"] >= 1
          and restart["reload"]["pieces_ok"] >= len(c.needed_pieces)
          and restart["reload"]["pieces_dropped"] == 0,
          f"restart: reload {restart['reloaded_tasks']} tasks, "
          f"{restart['reload']}")
    check((c.traffic_p2p, c.traffic_source) == (0, 0)
          and c.traffic_placed >= stage_bytes[0],
          f"restart: p2p {c.traffic_p2p}, source {c.traffic_source}, "
          f"placed {c.traffic_placed}")
    emit("phase 9 sharded, restart", {
        "replica": "A0", "reloaded_tasks": restart["reloaded_tasks"],
        **restart["reload"], "traffic_p2p": c.traffic_p2p,
        "traffic_source": c.traffic_source,
        "traffic_placed": c.traffic_placed,
        "tensors": len(restart["out"]),
        "reload_and_verify_s": restart["reload_and_verify_s"],
        "reload_to_ready_s": restart["reload_to_ready_s"],
        "pull_s": restart["wall"]})
    del restart
    fell_back = fallbacks.value() - before["fallback"]
    metric = pod_counts
    fetches = {k: p2p_pieces.value(k) - before[k]
               for k in ("ok", "busy", "fail")}
    ends = [r["t0"] + r["wall"] for r in runs.values()]
    for name in runs:
        emit(f"phase 9 sharded, leecher {name}", lines[name])
    emit("phase 9 sharded, pod", {
        "file_bytes": size, "stage_bytes": stage_bytes,
        "makespan_s": max(ends) - min(r["t0"] for r in runs.values()),
        "seed_upload_bytes": stats["seed_upload_bytes"],
        "seed_uplink_ratio": stats["seed_upload_bytes"] / size,
        "seed_relay_serves": stats["seed_relay_serves"],
        "seed_relay_bytes": stats["seed_relay_bytes"],
        "replica_upload_bytes":
            REGISTRY.counter("df_upload_bytes_total").value()
            - before["upload"],
        "origin_bytes_read": stats["origin_bytes_read"],
        "seed_back_source_s": stats["seed_back_source_s"],
        "seed_landed_s": stats["seed_landed_s"],
        "df_shard_bytes_total": metric,
        "df_shard_fallback_total": fell_back,
        "df_p2p_piece_total": fetches,
        "loop_lag_max_s": max(lags, default=0.0),
        "loop_lag_over_100ms_s": sum(x for x in lags if x > 0.1),
        "rulings": stats["rulings"],
        "parents_excluded": stats["excluded"], "pex": pex_delta(pex0),
        "free_disk_bytes": free})
    for st, pair in assigned.items():
        check(len(pair) == 2 and not set(pair[0]) & set(pair[1])
              and sorted(pair[0] + pair[1]) == sorted(stages[st]),
              f"stage {st}: the pair's assignments are not disjoint shares "
              f"covering the stage: {pair}")
    check(stats["origin_bytes_read"] == size,
          f"origin read {stats['origin_bytes_read']} bytes, file {size}")
    check(fell_back == 0, f"{fell_back} swap pieces fell back to the tree")
    check(metric["tree"] + metric["swap"] == 2 * sum(stage_bytes),
          f"df_shard_bytes_total moved {metric}, want twice the tensors")


# ---------------------------------------------------------------- phase 7

def _staged_cluster(sched: Scheduler, rng: np.random.Generator) -> dict:
    """A seeded cluster in the scheduler's resource model: 64 hosts on 8
    slices in 2 zones (4 of them seeds), 32 tasks of 64 pieces with 16
    running peers each. Returns the hidden truth the piece costs are drawn
    from: each host's upload bandwidth (bytes/s)."""
    hosts = []
    for i in range(64):
        slice_no = i // 8
        msg = Host(id=f"smoke-host-{i:02d}", ip=f"10.0.{slice_no}.{i}",
                   hostname=f"h{i}", port=9000, download_port=8000,
                   type=HostType.STRONG_SEED if i % 16 == 0
                   else HostType.NORMAL,
                   topology=TopologyInfo(
                       slice_name=f"slice-{slice_no}", worker_index=i % 8,
                       ici_coords=(i % 8 // 4, i % 4), num_chips=4,
                       zone=f"zone-{slice_no % 2}"),
                   concurrent_upload_limit=int(rng.choice([4, 8, 16])))
        hosts.append(sched.resource.store_host(msg))
    tasks = []
    for t in range(32):
        task = sched.resource.get_or_create_task(f"{t:064x}",
                                                 f"file:///blob-{t}")
        task.set_content_info(64 * (4 << 20), 4 << 20, 64)
        for k, h in enumerate(rng.choice(64, 16, replace=False)):
            peer = sched.resource.get_or_create_peer(
                f"smoke-peer-{t:02d}-{k:02d}", task, hosts[int(h)])
            peer.transit(PeerState.RUNNING)
            peer.finished_pieces.update(int(n) for n in rng.choice(
                64, int(rng.integers(1, 65)), replace=False))
        tasks.append(task)
    return {"tasks": tasks,
            "bw": {h.id: 10 ** rng.uniform(7.5, 9.5) for h in hosts}}


def _piece_cost_ms(truth: dict, child, parent,
                   rng: np.random.Generator) -> float:
    """The hidden link model: the parent's bandwidth, shared by its
    uploads, times a locality factor, with log-normal noise."""
    a, b = child.host.msg.topology, parent.host.msg.topology
    link = (1.0 if a.slice_name == b.slice_name
            else 0.5 if a.zone == b.zone else 0.2)
    bw = truth["bw"][parent.host.id] * link / (
        1 + parent.host.concurrent_upload_count)
    return float((4 << 20) / bw * 1e3 * rng.lognormal(0.0, 0.3))


def fill_ring(sched: Scheduler, seed: int) -> dict:
    """Rule over the staged cluster until the records ring holds
    ``RING_ROWS`` rows: every ruling is a real ``find_parents`` (its
    decision row reaches the records through the decision ledger), and the
    pieces fetched under it are reported to the records' ``on_piece``."""
    rng = np.random.default_rng(seed)
    truth = _staged_cluster(sched, rng)
    records = sched.service.records
    n_dec = RING_ROWS * DECISION_ROWS // (DECISION_ROWS + OUTCOME_ROWS)
    per, extra = divmod(RING_ROWS - n_dec, n_dec)
    for d in range(n_dec):
        task = truth["tasks"][d % len(truth["tasks"])]
        peers = list(task.peers.values())
        child = peers[int(rng.integers(len(peers)))]
        for p in peers:       # upload load moves between rulings
            p.host.concurrent_upload_count = int(rng.integers(
                0, p.host.upload_limit))
        parents = sched.scheduling.find_parents(child)
        check(len(parents) > 0, f"ruling {d} offered no parent")
        for _ in range(per + (d < extra)):
            parent = parents[int(rng.integers(min(3, len(parents))))]
            num = int(rng.integers(64))
            records.on_piece(child, PieceResult(
                task_id=task.id, src_peer_id=child.id,
                dst_peer_id=parent.id, success=True,
                piece_info=PieceInfo(
                    piece_num=num, range_start=num * (4 << 20),
                    range_size=4 << 20,
                    download_cost_ms=_piece_cost_ms(truth, child, parent,
                                                    rng))))
            parent.host.observe_upload(True)
            child.finished_pieces.add(num)
    rows = records.drain()
    records.requeue(rows)          # a copy of the ring, left in place
    return {"rows": rows, "decisions": n_dec, "pieces": len(rows) - n_dec,
            "truth": truth}


def fill_topology(sched: Scheduler, seed: int) -> None:
    """``GNN_LINKS`` probed links among ``GNN_HOSTS`` hosts (slices of 32):
    tens of microseconds inside a slice, DCN-class RTTs across."""
    rng = np.random.default_rng(seed + 1)
    pairs: set = set()
    for h in range(GNN_HOSTS):           # every host in the graph
        pairs.add((h, (h + 1) % GNN_HOSTS))
    while len(pairs) < GNN_LINKS:
        a, b = (int(v) for v in rng.integers(0, GNN_HOSTS, 2))
        if a != b:
            pairs.add((a, b))
    for a, b in sorted(pairs):
        rtt = (rng.uniform(10, 40) if a // 32 == b // 32
               else 10 ** rng.uniform(2.3, 3.7))
        sched.topo.record(f"pod-host-{a:04d}", f"pod-host-{b:04d}", int(rtt))


def profile_mlp_steps(rows: list[dict], device: torch.device) -> dict:
    """``PROFILE_STEPS`` steps of the MLP fit (512-row batches of the ring's
    folds), timed alone and then under ``torch.profiler``: the host time
    per step, the device's busy share, the kernels per step and the
    kernels that took the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    folds, _ = pipeline.training_rows(rows)
    data = features.records_to_arrays(folds)
    x = torch.from_numpy(data["x"]).to(device)
    y = torch.from_numpy(data["y"]).to(device)
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, len(data["y"]), (PROFILE_STEPS, 512))).to(device)
    with training.fit_numerics():
        model = models.init_mlp(torch.Generator().manual_seed(0)).to(device)
        step = models.make_train_step(models.mlp_loss,
                                      models.make_optimizer(model))

        def steps() -> float:
            torch.cuda.synchronize(device)
            t0 = time.monotonic()
            for s in range(PROFILE_STEPS):
                step(model, {"x": x.index_select(0, idx[s]),
                             "y": y.index_select(0, idx[s])})
            torch.cuda.synchronize(device)
            return time.monotonic() - t0

        steps()                                          # warm-up
        wall = steps()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_profiled = steps()
    # device events, less the user-annotation ranges (the optimizer's
    # step is one) that span the kernels they cover
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0) \
            + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": PROFILE_STEPS,
            "host_ms_per_step": wall / PROFILE_STEPS * 1e3,
            "host_ms_per_step_profiled": wall_profiled / PROFILE_STEPS * 1e3,
            "device_busy_ms_per_step": busy_us / 1e3 / PROFILE_STEPS,
            "device_idle_share": (1 - busy_us / 1e6 / wall_profiled)
            if busy_us else None,
            "kernels_per_step": len(kernels) / PROFILE_STEPS,
            "top_kernels_ms_per_step": {k: v / 1e3 / PROFILE_STEPS
                                        for k, v in top}}


def _nan_blob(blob: bytes) -> bytes:
    params, meta = params_io.deserialize_params(blob)
    params["layers"][1]["w"][0, 0] = np.nan
    return params_io.serialize_params(params, meta)


async def _trainer_loop(workdir: str, seed: int, device: torch.device
                        ) -> dict:
    trainer = Trainer(TrainerConfig(
        listen_ip="127.0.0.1", data_dir=os.path.join(workdir, "spool"),
        device=str(device)))
    await trainer.start()
    sched = Scheduler(SchedCfg(listen_ip="127.0.0.1", algorithm="ml",
                               trainer_address=trainer.address),
                      rng=random.Random(seed))
    await sched.start()
    channel = Channel(trainer.address)
    out: dict = {}
    try:
        t0 = time.monotonic()
        ring = fill_ring(sched, seed)
        fill_topology(sched, seed)
        topo_rows = sched.topo.snapshot_rows()
        out["fill_s"] = time.monotonic() - t0
        check(len(ring["rows"]) == RING_ROWS
              and sched.service.records.piece_row_count() == ring["pieces"],
              f"ring holds {len(ring['rows'])} rows, want {RING_ROWS}")
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.monotonic()
        check(await sched.announcer.upload_once(), "nothing was uploaded")
        out["upload_s"] = time.monotonic() - t0
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        out["upload"] = sched.announcer.last_upload
        out["ring"] = ring
        out["topo_rows"] = topo_rows
        out["mlp"] = trainer.service.latest[features.MLP_MODEL_NAME]
        out["gnn"] = trainer.service.latest[features.GNN_MODEL_NAME]
        check(out["upload"]["model_version"] == out["mlp"][1]["version"],
              "Train answered with another version than the MLP's")

        # bind the fitted MLP, rule with it, refuse bad blobs
        ann, ev = sched.announcer, sched.scheduling.evaluator
        check(await ann.bind_model(out["mlp"][0]), "the MLP blob did not bind")
        rng = np.random.default_rng(seed + 2)
        tasks = ring["truth"]["tasks"]
        for r in range(BIND_RULINGS):
            peers = list(tasks[r % len(tasks)].peers.values())
            sched.scheduling.find_parents(peers[int(rng.integers(len(peers)))])
        # each ruling's row carries the model's total and the heuristic's
        # (base_total): how often the model's top pick is another parent
        rows = sched.ledger.snapshot(limit=BIND_RULINGS)["decisions"]
        out["top_pick_differs"] = sum(
            r["candidates"][0] is not max(
                r["candidates"], key=lambda c: c.get("base_total", c["total"]))
            for r in rows if r["candidates"])
        out["health"] = ev.health()
        check(out["health"]["scored"] > 0
              and out["health"]["fallbacks"] == 0,
              f"the bound model did not rule: {out['health']}")
        out["rulings"] = len(rows)
        good = out["mlp"][1]["version"]
        garbage = np.random.default_rng(seed + 3).bytes(4096)
        for name, blob in (("garbage", garbage),
                           ("nan", _nan_blob(out["mlp"][0]))):
            check(not await ann.bind_model(blob), f"{name} blob was bound")
            check(params_io.version_of(blob) in ann.refused,
                  f"{name} blob refusal not journaled")
        check(ev.health()["version"] == good,
              "a refused blob replaced the serving model")
        out["refused"] = dict(ann.refused)
        probe = [list(map(float, r["features"]))
                 for r in ring["rows"][:64] if r.get("kind") == "piece"]
        resp = await ServiceClient(channel, TRAINER_SERVICE).unary(
            "ModelInfer", ModelInferRequest(features=probe))
        check(resp.model_version == good
              and resp.outputs == ev.infer(probe),
              "ModelInfer disagrees with the bound model")
        out["model_infer_rows"] = len(probe)
    finally:
        await channel.close()
        await sched.stop()
        await trainer.stop()
    return out


def phase_trainer(workdir: str, seed: int, device: torch.device) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    loop = asyncio.run(_trainer_loop(workdir, seed, device))
    ring, upload = loop["ring"], loop["upload"]
    mlp_blob, mlp = loop["mlp"]
    gnn_blob, gnn = loop["gnn"]
    mlp_steps = mlp["epochs"] * max(1, mlp["rows"] // min(512, mlp["rows"]))
    emit("phase 7 trainer, ring upload", {
        "rows": len(ring["rows"]), "decision_rows": ring["decisions"],
        "piece_rows": ring["pieces"],
        "topology_rows": upload["topology_rows"],
        "compressed_bytes": upload["compressed_bytes"],
        "fill_s": loop["fill_s"], "upload_and_fit_s": loop["upload_s"],
        "peak_device_bytes": loop["peak_bytes"], "card": smi})
    # determinism: the same rows and seed, fitted again on the card
    t0 = time.monotonic()
    refit = pipeline.train_decision_model(ring["rows"], device=device)
    refit_s = time.monotonic() - t0
    regnn = training.train_gnn(loop["topo_rows"], device=device)
    check(refit is not None and refit[0] == mlp_blob,
          f"MLP refit version {refit[1]['version'] if refit else None} != "
          f"{mlp['version']}: the fit is not deterministic on the card")
    check(regnn is not None and regnn[0] == gnn_blob,
          f"GNN refit version {regnn[1]['version'] if regnn else None} != "
          f"{gnn['version']}: the segment sums are not deterministic (K1)")
    emit("phase 7 trainer, mlp fit", {
        "fold_rows": mlp["rows"], "supervision": mlp["supervision"],
        "record_rows": mlp["record_rows"], "epochs": mlp["epochs"],
        "steps": mlp_steps, "fit_s": mlp["train_seconds"],
        "steps_per_s": mlp_steps / mlp["train_seconds"],
        "first_epoch_loss": mlp["first_epoch_loss"],
        "final_loss": mlp["final_loss"], "version": mlp["version"],
        "refit_version": refit[1]["version"], "refit_s": refit_s})
    emit("phase 7 trainer, gnn fit", {
        "nodes": gnn["nodes"], "edges": gnn["edges"], "epochs": gnn["epochs"],
        "steps": gnn["epochs"], "fit_s": gnn["train_seconds"],
        "steps_per_s": gnn["epochs"] / gnn["train_seconds"],
        "first_epoch_loss": gnn["first_epoch_loss"],
        "final_loss": gnn["final_loss"], "version": gnn["version"],
        "refit_version": regnn[1]["version"],
        "refit_s": regnn[1]["train_seconds"]})
    check(mlp["final_loss"] < mlp["first_epoch_loss"]
          and gnn["final_loss"] < gnn["first_epoch_loss"],
          "a fit did not lower its loss")
    emit("phase 7 trainer, mlp step profile",
         profile_mlp_steps(ring["rows"], device))
    emit("phase 7 trainer, bind and rule", {
        "health": loop["health"], "rulings": loop["rulings"],
        "top_pick_differs_from_heuristic": loop["top_pick_differs"],
        "refused": loop["refused"],
        "model_infer_rows": loop["model_infer_rows"]})
    # learned vs heuristic on BENCH_pr19's datagen rows. One fit's replay
    # regret moves with the last bit of the arithmetic: the fit is chaotic
    # on these 170 unnormalized rows (on the CPU, changing the seed-7
    # initial weights by one ulp gave regrets from 0.039 to 0.145), so the
    # claim is held on the recipe's mean over REGRET_SEEDS fits. Seed 7,
    # BENCH_pr19's, is one of them and is printed on its own.
    with open(FIXTURE) as f:
        rows = [json.loads(line) for line in f]
    fits = {}
    for s in REGRET_SEEDS:
        fitted = pipeline.train_decision_model(rows, seed=s, device=device)
        check(fitted is not None, f"seed {s}: the fixture fit gave no model")
        infer = serving.make_mlp_infer(fitted[0])
        fits[s] = (fitted, infer, replay_regret(
            rows, ("default", "ml"), infer)["evaluators"])
    (blob, metrics), infer, regret = fits[7]
    FIT_BLOBS["fixture_seed_7"] = blob
    again = pipeline.train_decision_model(rows, seed=7, device=device)
    check(again[0] == blob, "the fixture fit is not deterministic on the "
                            "card")
    replay = replay_decisions(rows, ("default", "ml"), infer)
    check(replay["logged_choice_agreement"]["default"] == 1.0,
          "the heuristic replay does not reproduce the logged choices")
    heuristic = regret["default"]["mean_regret"]
    check(round(heuristic, 4) == HEURISTIC_REGRET,
          f"heuristic regret {heuristic} != {HEURISTIC_REGRET} (BENCH_pr19)")
    learned = {s: r["ml"]["mean_regret"] for s, (_, _, r) in fits.items()}
    mean = sum(learned.values()) / len(learned)
    check(mean < heuristic,
          f"mean learned regret {mean} over seeds {list(learned)} does not "
          f"beat the heuristic's {heuristic}")
    emit("phase 7 trainer, learned vs heuristic", {
        "fold_rows": metrics["rows"], "seed_7": {
            "version": metrics["version"], "fit_s": metrics["train_seconds"],
            "final_loss": metrics["final_loss"],
            "regret": {k: v["mean_regret"] for k, v in regret.items()},
            "best_pick_rate": {k: v["best_pick_rate"]
                               for k, v in regret.items()},
            "logged_choice_agreement": replay["logged_choice_agreement"],
            "flip_rate":
                replay["pairs"]["default_vs_ml"]["choice_flip_rate"]},
        "heuristic_regret": heuristic,
        "learned_regret_by_seed": learned,
        "learned_regret_mean": mean,
        "seeds_beating_heuristic": sum(v < heuristic
                                       for v in learned.values()),
        "phase_s": time.monotonic() - t_phase})
    print(smi, flush=True)


# ---------------------------------------------------------------- phase 8

def deploy_layout() -> list[tuple[str, list[int]]]:
    """The Llama-3-8B layout's last tensors, the bulk of the published
    checkpoint's last file."""
    h = LLAMA3_8B["hidden"]
    return [("lm_head.weight", [LLAMA3_8B["vocab"], h]),
            ("model.norm.weight", [h])]


def log_time(line: str) -> float:
    """Unix time of a service log line (``common/logging`` format)."""
    return datetime.datetime.strptime(
        line[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()


class Launched:
    """One launcher process of phase 8; its stdout and stderr go to a log
    file the phase reads lines from."""

    def __init__(self, workdir: str, name: str, module: str,
                 args: list[str]):
        self.name = name
        self.log_path = os.path.join(workdir, f"{name}.log")
        self._log = open(self.log_path, "w")
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"dragonfly2_tpu_torch.tools.{module}",
             *args], stdout=self._log, stderr=subprocess.STDOUT, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1"))
        self.up_s = None

    def text(self) -> str:
        with open(self.log_path, errors="replace") as f:
            return f.read()

    def lines(self, needle: str) -> list[str]:
        return [ln for ln in self.text().splitlines() if needle in ln]

    def wait_line(self, needle: str, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        while True:
            found = self.lines(needle)
            if found:
                return found[0]
            check(self.proc.poll() is None,
                  f"{self.name} exited {self.proc.returncode} before "
                  f"{needle!r}: {self.text()[-2000:]}")
            check(time.monotonic() < deadline,
                  f"{self.name}: no {needle!r} in {timeout:.0f} s: "
                  f"{self.text()[-2000:]}")
            time.sleep(0.1)

    def wait_up(self, needle: str) -> str:
        line = self.wait_line(needle, DEPLOY_BOOT_S)
        self.up_s = time.monotonic() - self.t0
        return line

    def stop(self) -> int | None:
        """SIGTERM; the return code, or None when it outlived the limit
        (then it is killed)."""
        try:
            if self.proc.poll() is None:
                self.proc.send_signal(signal.SIGTERM)
            try:
                return self.proc.wait(timeout=DEPLOY_STOP_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
                return None
        finally:
            self._log.close()


def rest_get(port: int, route: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=10) as r:
        return json.loads(r.read())


def write_json(path: str, obj: dict) -> str:
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def uploaded_topology_rows(sched: "Launched") -> int:
    """The largest topology snapshot the scheduler's announcer uploaded
    (each upload carries the whole snapshot when it changed)."""
    return max((int(m.group(1)) for ln in sched.lines("records uploaded:")
                if (m := re.search(r"\+ (\d+) topology rows", ln))),
               default=0)


async def _deploy_leecher_a(workdir: str, mgr_addr: str, sched_addr: str,
                            url: str, digest: str, manifest: ShardManifest,
                            sched: "Launched") -> dict:
    """Leecher A: knows only the manager; pulls with a manifest sink, then
    stays up (its prober reporting) until the scheduler has uploaded a
    topology snapshot of ``DEPLOY_PROBE_LINKS`` links or more."""
    a = Daemon(DaemonConfig(
        workdir=os.path.join(workdir, "leecher-a"), hostname="deploy-a",
        listen_ip="127.0.0.1", host_ip="127.0.0.1",
        manager_addresses=[mgr_addr]))
    await a.start()
    try:
        check(a.scheduler is not None
              and a.scheduler.addresses == [sched_addr],
              f"A found {a.scheduler and a.scheduler.addresses} through "
              f"the manager, want [{sched_addr}]")
        run = await _leecher_pull(a, url, UrlMeta(digest=digest), manifest,
                                  {})
        c = run["conductor"]
        run["traffic"] = (c.traffic_p2p, c.traffic_source)
        check_crc32c(c.storage.md, "phase 8 A")
        t0 = time.monotonic()
        while uploaded_topology_rows(sched) < DEPLOY_PROBE_LINKS:
            check(time.monotonic() - t0 < DEPLOY_PROBE_S,
                  f"the scheduler uploaded {uploaded_topology_rows(sched)} "
                  f"topology rows in {DEPLOY_PROBE_S:.0f} s, want "
                  f"{DEPLOY_PROBE_LINKS}: {sched.lines('records uploaded')}")
            await asyncio.sleep(0.5)
        run["probe_wait_s"] = time.monotonic() - t0
        run["probe_rounds_a"] = a.prober.rounds
        return run
    finally:
        await a.stop()


def _task_success(line: str) -> tuple[int, int]:
    """(p2p, src) bytes of a conductor's ``task success`` log line."""
    m = re.search(r"\(p2p=(\d+) src=(\d+)\)", line)
    check(m is not None, f"unparsed: {line}")
    return int(m.group(1)), int(m.group(2))


def phase_deploy(workdir: str, seed: int, device: torch.device) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    d = os.path.join(workdir, "deploy")
    os.makedirs(d)
    layout = deploy_layout()
    header, nbytes = safetensors_header(layout)
    size = len(header) + nbytes
    # the origin, the seed's copy, A's, B's and dfget's output
    free = shutil.disk_usage(d).free
    need = 5 * size + (1 << 30)
    check(free >= need, f"phase 8 needs {need} bytes of free disk, {free} "
                        f"free")
    buf = seeded_bytes(np.random.default_rng(seed + 8), nbytes)
    path = os.path.join(d, "model-00004-of-00004.safetensors")
    sha = hashlib.sha256(header)
    sha.update(buf)
    with open(path, "wb") as f:
        f.write(header)
        f.write(memoryview(buf))
        os.fsync(f.fileno())
    ref = torch.from_numpy(buf).to(device)
    del buf
    url, digest = "file://" + path, "sha256:" + sha.hexdigest()
    manifest = manifest_from_file(path)
    procs: list[Launched] = []
    rcs: dict = {}
    out: dict = {}
    try:
        mgr = Launched(d, "manager", "manager", [
            "--listen-ip", "127.0.0.1", "--db", os.path.join(d, "m.db"),
            "--workdir", os.path.join(d, "manager")])
        procs.append(mgr)
        m = re.search(r"grpc=(\S+) rest=:?(\d+)", mgr.wait_up("manager up:"))
        mgr_addr, rest = m.group(1), int(m.group(2))
        seed_d = Launched(d, "seed", "daemon", ["--config", write_json(
            os.path.join(d, "seed.json"), {
                "workdir": os.path.join(d, "seed"), "hostname": "deploy-seed",
                "is_seed": True, "host_ip": "127.0.0.1",
                "listen_ip": "127.0.0.1", "manager_addresses": [mgr_addr]})])
        procs.append(seed_d)
        seed_line = seed_d.wait_up("daemon up:")
        seed_rpc = int(re.search(r"rpc=(\d+)", seed_line).group(1))
        trainer = Launched(d, "trainer", "trainer", [
            "--listen-ip", "127.0.0.1", "--manager", mgr_addr,
            "--data-dir", os.path.join(d, "trainer")])
        procs.append(trainer)
        trainer_addr = trainer.wait_up("trainer up:").split()[-1]
        sched = Launched(d, "scheduler", "scheduler", [
            "--config", write_json(os.path.join(d, "scheduler.json"), {
                "listen_ip": "127.0.0.1", "advertise_ip": "127.0.0.1",
                "train_upload_interval_s": DEPLOY_UPLOAD_S,
                "model_refresh_interval_s": DEPLOY_REFRESH_S}),
            "--manager", mgr_addr, "--algorithm", "ml",
            "--trainer", trainer_addr,
            "--records-dir", os.path.join(d, "records")])
        procs.append(sched)
        sched_addr = sched.wait_up("scheduler up:").split()[-1]
        sched_port = int(sched_addr.rsplit(":", 1)[1])
        check(" seeds=1)" in sched.wait_line("scheduler up on", 10),
              "the scheduler did not adopt the seed from the manager")

        # registration, as the manager's REST lists it
        scheds = rest_get(rest, "/api/v1/schedulers")
        seeds = rest_get(rest, "/api/v1/seed-peers")
        check([(s["port"], s["state"]) for s in scheds]
              == [(sched_port, "active")], f"REST schedulers: {scheds}")
        check([(s["port"], s["state"]) for s in seeds]
              == [(seed_rpc, "active")], f"REST seed peers: {seeds}")

        # leecher B, a launcher process, serves the dfget CLI below; it is
        # up before A pulls, so the probers of the seed, A and B overlap
        sock = os.path.join(d, "b.sock")
        leech_b = Launched(d, "leecher-b", "daemon", ["--config", write_json(
            os.path.join(d, "leecher-b.json"), {
                "workdir": os.path.join(d, "leecher-b"),
                "hostname": "deploy-b", "host_ip": "127.0.0.1",
                "listen_ip": "127.0.0.1", "unix_sock": sock,
                "manager_addresses": [mgr_addr]})])
        procs.append(leech_b)
        b_line = leech_b.wait_up("daemon up:")

        # leecher A in this process: discovery through the manager only
        run_a = asyncio.run(_deploy_leecher_a(d, mgr_addr, sched_addr, url,
                                              digest, manifest, sched))
        tensors, base, shapes = run_a["out"], len(header), dict(layout)
        check(len(tensors) == len(layout),
              f"A: {len(tensors)} tensors, want {len(layout)}")
        for info in manifest.shards:
            t = tensors[info.name]
            check(t.device == device and t.dtype == torch.bfloat16
                  and list(t.shape) == shapes[info.name],
                  f"A: {info.name} is {t.dtype} {list(t.shape)} on "
                  f"{t.device}")
            lo = info.range_start - base
            check(torch.equal(t.reshape(-1).view(torch.uint8),
                              ref[lo:lo + info.range_size]),
                  f"A: {info.name} bytes differ from the origin")
        del tensors, run_a["out"]
        check(run_a["traffic"] == (size, 0),
              f"A: (traffic_p2p, traffic_source) {run_a['traffic']}, "
              f"file {size}")

        # leecher B: the dfget CLI's daemon, started before A's pull
        check(f"schedulers=['{sched_addr}']" in b_line,
              f"B did not find the scheduler through the manager: {b_line}")
        target = os.path.join(d, "out.safetensors")
        t0 = time.monotonic()
        got = subprocess.run(
            [sys.executable, "-m", "dragonfly2_tpu_torch.tools.dfget", url,
             "-O", target, "--daemon-sock", sock, "--digest", digest,
             "--quiet"], cwd=ROOT, capture_output=True, text=True,
            timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
        dfget_s = time.monotonic() - t0
        check(got.returncode == 0, f"dfget exited {got.returncode}: "
                                   f"{got.stderr[-2000:]}")
        h = hashlib.sha256()
        with open(target, "rb") as f:
            while chunk := f.read(1 << 24):
                h.update(chunk)
        check(h.hexdigest() == sha.hexdigest(),
              "dfget's output differs from the origin")
        os.unlink(target)
        b_traffic = _task_success(leech_b.wait_line("task success:", 30))
        check(b_traffic == (size, 0),
              f"B: (p2p, src) {b_traffic}, file {size}")
        # only the seed read the origin, once and whole
        check(len(seed_d.lines("back-source:")) == 1
              and [_task_success(ln) for ln in seed_d.lines("task success:")]
              == [(0, size)],
              f"the seed's origin reads: {seed_d.lines('task success:')}")
        check(not leech_b.lines("back-source:"), "B read the origin")

        # the learned loop: upload -> fit on the card -> registry -> bind.
        # It has closed when the registry's newest version is bound and
        # an upload made after both pulls was answered, or none came while
        # one could have: the upload loop sleeps an interval after each
        # answered upload, and an answer waits for the fit
        t_pulls = time.time()
        deadline = time.monotonic() + DEPLOY_LOOP_S
        while True:
            models = rest_get(rest, "/api/v1/models?name=bandwidth_mlp")
            late = [log_time(ln)
                    for ln in trainer.lines("dataset upload from")
                    if log_time(ln) > t_pulls]
            answered = bool(late) and any(
                log_time(ln) >= late[0]
                for ln in sched.lines("records uploaded:"))
            fit_s = max((e["metrics"]["train_seconds"] for e in models),
                        default=0.0)
            quiet = time.time() > t_pulls + 2 * DEPLOY_UPLOAD_S + 2 * fit_s
            if models and (answered or (quiet and not late)):
                latest = max(models, key=lambda e: e["id"])
                if sched.lines(f"ml evaluator now serving bandwidth_mlp@"
                               f"{latest['version']} "):
                    break
            check(time.monotonic() < deadline,
                  f"no published model bound in {DEPLOY_LOOP_S:.0f} s: "
                  f"registry {models}; scheduler "
                  f"{sched.lines('now serving')}; trainer "
                  f"{trainer.text()[-1500:]}")
            time.sleep(0.5)
        received = [log_time(ln)
                    for ln in trainer.lines("dataset upload from")]
        fits = []
        for e in sorted(models, key=lambda e: e["id"]):
            (reg,) = mgr.lines(f"model registered: bandwidth_mlp@"
                               f"{e['version']} ")
            before = [t for t in received if t <= log_time(reg)]
            check(bool(before), f"{e['version']}: no upload before it")
            bound = sched.lines(f"ml evaluator now serving bandwidth_mlp@"
                                f"{e['version']} ")
            fits.append({
                "version": e["version"], "fold_rows": e["metrics"]["rows"],
                "record_rows": e["metrics"].get("record_rows"),
                "supervision": e["metrics"].get("supervision"),
                "train_seconds": e["metrics"]["train_seconds"],
                "upload_to_publish_s": log_time(reg) - before[-1],
                "publish_to_bind_s": (log_time(bound[0]) - log_time(reg)
                                      if bound else None),
                "blob_bytes": e["size"]})
        out = {"bound_version": latest["version"],
               "uploads_received": len(received), "fits": fits}
        # the probes' rows reached the trainer, which fitted the GNN on
        # the card and published it
        deadline = time.monotonic() + DEPLOY_LOOP_S
        while not (gnns := rest_get(rest, f"/api/v1/models?name="
                                          f"{features.GNN_MODEL_NAME}")):
            check(time.monotonic() < deadline,
                  f"no topology_gnn in the registry in {DEPLOY_LOOP_S:.0f} "
                  f"s; trainer {trainer.lines('gnn fit')}")
            time.sleep(0.5)
        check(any(" on cuda" in ln for ln in trainer.lines("gnn fit:")),
              f"the GNN was not fitted on the card: "
              f"{trainer.lines('gnn fit:')}")
        out.update({
            "probe_wait_s": run_a["probe_wait_s"],
            "probe_rounds_a": run_a["probe_rounds_a"],
            "topology_rows_uploaded": uploaded_topology_rows(sched),
            "topology_gnn": [{
                "version": e["version"], "edges": e["metrics"]["edges"],
                "nodes": e["metrics"]["nodes"],
                "train_seconds": e["metrics"]["train_seconds"]}
                for e in gnns]})
        for p in (sched, seed_d, leech_b):
            check("manager attach failed" not in p.text(),
                  f"{p.name} logged a failed manager attach")
    finally:
        for p in reversed(procs):
            rcs[p.name] = p.stop()
    check(all(rc == 0 for rc in rcs.values()),
          f"return codes after SIGTERM: {rcs}")
    emit("phase 8 deploy", {
        "file_bytes": size, "tensors": len(layout),
        "start_s": {p.name: p.up_s for p in procs},
        "a_time_to_ready_s": run_a["wall"],
        "a_download_s": run_a["download_s"],
        "a_gbps": size / 1e9 / run_a["wall"],
        "a_pieces_per_parent": dict(run_a["conductor"].pieces_by_parent),
        "dfget_s": dfget_s, "dfget_gbps": size / 1e9 / dfget_s,
        **out, "return_codes": rcs,
        "phase_s": time.monotonic() - t_phase, "card": smi})


# ---------------------------------------------------------------- phase 10

NT_PROBE_S = 50.0            # about two probe rounds (20 s each)
NT_TASK_PEERS = 16           # the cost ruling's task: peers on graph hosts


def nt_seed_child(workdir: str, conn) -> None:
    """Phase 10's seed daemon, in a spawned process that never touches
    CUDA: it sends its host, serves until the parent asks, then sends the
    origin bytes it read."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""     # before any CUDA call
    asyncio.run(_nt_seed_child(workdir, conn))


async def _nt_seed_child(workdir: str, conn) -> None:
    origin = CountingFileClient()
    source.register_client("file", origin)
    seed = Daemon(DaemonConfig(workdir=os.path.join(workdir, "seed"),
                               hostname="nt-seed", is_seed=True,
                               listen_ip="127.0.0.1", host_ip="127.0.0.1",
                               device="cpu"))
    await seed.start()
    try:
        conn.send({"host": seed.host_info()})
        await asyncio.to_thread(conn.recv)      # the parent is done
        conn.send({"origin_bytes_read": origin.bytes_read})
    finally:
        await seed.stop()


def _pair_rtts(rows: list[dict]) -> dict:
    return {(r["src"], r["dst"]): r["avg_rtt_us"] for r in rows}


async def _nt_pod(workdir: str, seed_host: Host, url: str,
                  manifest: ShardManifest) -> dict:
    """An ``nt`` scheduler and two leechers in this process; the leechers'
    probers report (the seed, A and B pairwise) before both pull."""
    sched = Scheduler(SchedCfg(
        listen_ip="127.0.0.1", algorithm="nt",
        records_dir=os.path.join(workdir, "records"),
        seed_peers=[SeedPeerAddr(host_id=seed_host.id, ip=seed_host.ip,
                                 rpc_port=seed_host.port,
                                 download_port=seed_host.download_port)]))
    await sched.start()
    # the seed's own announce (the daemon announcer is not ported): its
    # host is a probe target before any task triggers it
    sched.resource.store_host(seed_host)
    daemons = [Daemon(DaemonConfig(
        workdir=os.path.join(workdir, n), hostname=f"nt-{n}",
        listen_ip="127.0.0.1", host_ip="127.0.0.1",
        scheduler=SchedulerConfig(addresses=[sched.address])))
        for n in ("a", "b")]
    try:
        t0 = time.monotonic()
        for d in daemons:
            await d.start()
        ids = [seed_host.id] + [d.host_info().id for d in daemons]
        pairs = [(ids[0], ids[1]), (ids[0], ids[2]), (ids[1], ids[2])]
        while any(sched.topo.avg_rtt_us(a, b) is None for a, b in pairs):
            check(time.monotonic() - t0 < NT_PROBE_S,
                  f"probes covered {sched.topo.snapshot_rows()} in "
                  f"{NT_PROBE_S:.0f} s, want the pairs {pairs}")
            await asyncio.sleep(0.1)
        probe_s = time.monotonic() - t0
        before = sched.topo.snapshot_rows()
        runs = await asyncio.gather(*(
            _leecher_pull(d, url, UrlMeta(), manifest, {}) for d in daemons))
        return {"runs": runs, "probe_s": probe_s, "ids": ids,
                "rows_before": before,
                "rows_after": sched.topo.snapshot_rows(),
                "rounds": [d.prober.rounds for d in daemons],
                "decisions": sched.ledger.snapshot(limit=4096)["decisions"]}
    finally:
        for d in daemons:
            await d.stop()
        await sched.stop()


def nt_ruling_cost(seed: int, device: torch.device) -> dict:
    """One ``nt`` ruling over phase 7's 1,024-host, 8,192-link topology
    with a ``topology_gnn`` imputer fitted on ``device`` from it bound:
    the first ruling imputes every unprobed pair among the graph's hosts
    (one forward); the next, inside the imputations' TTL, reads them."""
    sched = Scheduler(SchedCfg(listen_ip="127.0.0.1", algorithm="nt"))
    fill_topology(sched, seed)
    rows = sched.topo.snapshot_rows()
    fitted = training.train_gnn(rows, device=device)
    check(fitted is not None, "the GNN did not fit on the phase 7 rows")
    blob, metrics = fitted
    sched.topo.bind_imputer(serving.make_gnn_impute(blob))
    rng = np.random.default_rng(seed + 10)
    task = sched.resource.get_or_create_task("f" * 64, "file:///nt-cost")
    task.set_content_info(64 * (4 << 20), 4 << 20, 64)
    peers = []
    for k, h in enumerate(rng.choice(GNN_HOSTS, NT_TASK_PEERS,
                                     replace=False)):
        host = sched.resource.store_host(Host(
            id=f"pod-host-{int(h):04d}", ip=f"10.1.{int(h) // 250}."
            f"{int(h) % 250}", hostname=f"p{int(h)}", port=9000,
            download_port=8000, type=HostType.NORMAL,
            topology=TopologyInfo(slice_name=f"slice-{int(h) // 32}")))
        peer = sched.resource.get_or_create_peer(f"nt-peer-{k:02d}", task,
                                                 host)
        peer.transit(PeerState.RUNNING)
        peer.finished_pieces.update(int(n) for n in rng.choice(
            64, int(rng.integers(1, 65)), replace=False))
        peers.append(peer)
    rows_seen: list[dict] = []
    sched.scheduling.decision_sink = rows_seen.append
    times = []
    for child in peers[:2]:
        t0 = time.perf_counter()
        parents = sched.scheduling.find_parents(child)
        times.append(time.perf_counter() - t0)
        check(len(parents) > 0, "the nt ruling offered no parent")
    cands = [c for r in rows_seen for c in r["candidates"]]
    check(all(c.get("substituted") == {"locality": "rtt"} for c in cands),
          "a candidate's locality was not the measured or imputed RTT")
    return {"hosts": GNN_HOSTS, "links": len(rows),
            "imputed_pairs": len(sched.topo._imputed),
            "gnn_train_seconds": metrics["train_seconds"],
            "candidates": len(cands),
            "cold_ruling_ms": times[0] * 1e3,
            "warm_ruling_ms": times[1] * 1e3}


def phase_nt(workdir: str, seed: int, device: torch.device) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    path = os.path.join(workdir, "deploy", "model-00004-of-00004.safetensors")
    layout = deploy_layout()
    header, _ = safetensors_header(layout)
    size = os.path.getsize(path)
    manifest = manifest_from_file(path)
    with open(path, "rb") as f:
        f.seek(len(header))
        ref = torch.frombuffer(bytearray(f.read()), dtype=torch.uint8).to(
            device)
    d = os.path.join(workdir, "nt")
    pex0 = pex_counts()
    ctx = multiprocessing.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe()
    child = ctx.Process(target=nt_seed_child, name="smoke-nt-child",
                        args=(d, child_conn))
    child.start()
    try:
        check(parent_conn.poll(300), "phase 10 child did not start")
        seed_host = parent_conn.recv()["host"]
        pod = asyncio.run(_nt_pod(d, seed_host, "file://" + path, manifest))
        parent_conn.send("stop")
        check(parent_conn.poll(300), "phase 10 child did not report")
        stats = parent_conn.recv()
    finally:
        child.join(timeout=120)
        if child.is_alive():
            child.terminate()
            child.join(timeout=30)
    check(child.exitcode == 0, f"phase 10 child exited {child.exitcode}")
    base, shapes = len(header), dict(layout)
    lines = {}
    for name, run in zip(("A", "B"), pod["runs"]):
        c, tensors = run["conductor"], run["out"]
        for info in manifest.shards:
            t = tensors[info.name]
            lo = info.range_start - base
            check(t.device == device and t.dtype == torch.bfloat16
                  and list(t.shape) == shapes[info.name]
                  and torch.equal(t.reshape(-1).view(torch.uint8),
                                  ref[lo:lo + info.range_size]),
                  f"{name}: {info.name} differs from the origin")
        check(c.traffic_source == 0 and c.traffic_p2p == size,
              f"{name}: p2p {c.traffic_p2p}, source {c.traffic_source}")
        check_crc32c(c.storage.md, f"phase 10 {name}")
        lines[name] = {"time_to_ready_s": run["wall"],
                       "pieces_per_parent": dict(c.pieces_by_parent)}
        del tensors, run["out"]
    check(stats["origin_bytes_read"] == size,
          f"origin read {stats['origin_bytes_read']} bytes, file {size}")
    # every candidate of a ruling between probed hosts was scored on the
    # store's measured RTT (the value before or after the pulls, when a
    # probe report landed during them)
    measured = [_pair_rtts(pod["rows_before"]), _pair_rtts(pod["rows_after"])]

    def rtt(store, a, b):
        return store.get((a, b), store.get((b, a)))
    substituted = 0
    for row in pod["decisions"]:
        check(row["evaluator"] == "RTTEvaluator",
              f"a ruling by {row['evaluator']}")
        for cand in row["candidates"]:
            want = {rtt(m, row["host_id"], cand["host_id"])
                    for m in measured} - {None}
            if not want:
                check("substituted" not in cand,
                      f"an unprobed pair scored on an RTT: {cand}")
                continue
            check(cand.get("substituted") == {"locality": "rtt"}
                  and cand.get("rtt_us") in want,
                  f"candidate {cand['host_id']} of {row['host_id']}: "
                  f"{cand.get('substituted')} rtt_us "
                  f"{cand.get('rtt_us')}, the store's {want}")
            substituted += 1
    check(substituted > 0, "no ruling scored a probed pair")
    cost = nt_ruling_cost(seed, device)
    emit("phase 10 nt", {
        "file_bytes": size, "probe_s": pod["probe_s"],
        "probe_rounds": pod["rounds"],
        "rtt_us": {f"{a}->{b}": v for (a, b), v in
                   _pair_rtts(pod["rows_after"]).items()},
        "rulings": len(pod["decisions"]),
        "candidates_on_rtt": substituted,
        "origin_bytes_read": stats["origin_bytes_read"],
        "leechers": lines, "pex": pex_delta(pex0), "ruling_cost": cost,
        "phase_s": time.monotonic() - t_phase, "card": smi})


# ---------------------------------------------------------------- phase 11

CHAIN_PACE_BPS = 250_000_000     # one object-store stream's rate
CHAIN = ("l1", "l2", "l3")
CHAIN_OFFER_S = 60.0             # a leecher's wait for its first offer
CHECK_HEADER = "X-Smoke-Check"   # origin requests outside the tally
# one upload slot per host at the scheduler (``seed_upload_limit``,
# ``peer_upload_limit``): a parent feeding a child is offered to no other,
# an uplink-bound chain origin -> seed -> L1 -> L2 -> L3
CHAIN_UPLOAD_LIMIT = 1


def http_origin_child(path: str, pace_bps: int, conn) -> None:
    """Phase 11's origin, in a spawned process: a standard-library
    ``ThreadingHTTPServer`` serving ``path`` (HTTP/1.1, ``HEAD``, single
    ``Range`` requests, ``Accept-Ranges: bytes``), each response paced to
    ``pace_bps`` (0: unpaced); ``/redirect/<name>`` answers 302 to
    ``/<name>``. It
    counts the body bytes it sends per client connection (requests carrying
    ``X-Smoke-Check`` apart), the ranges, when its first body byte
    left (CLOCK_MONOTONIC, which every process of the host shares), and
    each response's first and last body byte and its length. Each
    "report" from the parent is answered with the counts, which then
    restart; "stop" ends it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    name = os.path.basename(path)
    size = os.path.getsize(path)
    fd = os.open(path, os.O_RDONLY)
    lock = threading.Lock()
    tally: dict = {}

    def reset() -> dict:
        old = dict(tally)
        tally.update(body_bytes=0, check_bytes=0, ranges=[], per_client={},
                     first_byte_at=None, requests=0, responses=[])
        return old

    reset()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args) -> None:
            pass

        def _serve(self, head_only: bool) -> None:
            with lock:
                tally["requests"] += 1
            target = self.path.split("?", 1)[0]
            if target == f"/redirect/{name}":
                self.send_response(302)
                self.send_header("Location", f"/{name}")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            if target != f"/{name}":
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            start, end, status = 0, size, 200
            m = re.match(r"bytes=(\d+)-(\d*)$", self.headers.get("Range", ""))
            if m:
                start = int(m.group(1))
                end = min(size, int(m.group(2)) + 1 if m.group(2) else size)
                status = 206
            self.send_response(status)
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("Content-Length", str(end - start))
            if status == 206:
                self.send_header("Content-Range",
                                 f"bytes {start}-{end - 1}/{size}")
            self.end_headers()
            if head_only:
                return
            checked = CHECK_HEADER in self.headers
            client = "%s:%d" % self.client_address
            t0 = time.monotonic()
            sent = 0
            with lock:
                if not checked:
                    tally["ranges"].append((start, end))
                    if tally["first_byte_at"] is None:
                        tally["first_byte_at"] = t0
            while sent < end - start:
                chunk = os.pread(fd, min(1 << 20, end - start - sent),
                                 start + sent)
                self.wfile.write(chunk)
                sent += len(chunk)
                with lock:
                    if checked:
                        tally["check_bytes"] += len(chunk)
                    else:
                        tally["body_bytes"] += len(chunk)
                        tally["per_client"][client] = \
                            tally["per_client"].get(client, 0) + len(chunk)
                ahead = (sent / pace_bps - (time.monotonic() - t0)
                         if pace_bps else 0.0)
                if ahead > 0:
                    time.sleep(ahead)
            if not checked:
                with lock:
                    tally["responses"].append((t0, time.monotonic(), sent))

        def do_GET(self) -> None:
            self._serve(head_only=False)

        def do_HEAD(self) -> None:
            self._serve(head_only=True)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn.send({"port": server.server_address[1]})
        while conn.recv() == "report":
            with lock:
                conn.send(reset())
    finally:
        server.shutdown()
        server.server_close()
        os.close(fd)


def chain_seed_child(workdir: str, relay: bool, conn) -> None:
    """Phase 11's seed daemon, in a spawned process that never touches
    CUDA: it sends its host, serves until the parent asks, then sends its
    pull's origin bytes and timings and what its upload server served."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    asyncio.run(_chain_seed_child(workdir, relay, conn))


async def _chain_seed_child(workdir: str, relay: bool, conn) -> None:
    from dragonfly2_tpu_torch.daemon.config import DownloadConfig
    # one origin stream (no parallel piece groups): the seed's pieces land
    # in order at the object store's per-stream rate, as in the
    # reference's chain test
    seed = Daemon(DaemonConfig(workdir=os.path.join(workdir, "seed"),
                               hostname="chain-seed", is_seed=True,
                               listen_ip="127.0.0.1", host_ip="127.0.0.1",
                               device="cpu",
                               download=DownloadConfig(
                                   relay_enabled=relay,
                                   back_source_group_min_bytes=1 << 62)))
    await seed.start()
    try:
        conn.send({"host": seed.host_info()})
        await asyncio.to_thread(conn.recv)      # the parent is done
        (c,) = seed.ptm._conductors.values()
        # the pull's end and its last landing, on its flight's clock
        ends: dict = {}
        for t, st, *_ in c.flight.events:
            if st in ("done", "wire_done"):
                ends[st] = max(ends.get(st, 0.0), t)
        conn.send({
            "peer_id": c.peer_id, "state": c.state, "m0": c.flight._m0,
            "traffic_source": c.traffic_source,
            "back_source_s": ends.get("done", 0.0) / 1000.0,
            "landed_s": ends.get("wire_done", 0.0) / 1000.0,
            "relay_serves": dict(seed.upload_server.relay_serves),
            "relay_bytes": dict(seed.upload_server.relay_bytes),
            "upload_bytes": REGISTRY.counter("df_upload_bytes_total").value()})
    finally:
        await seed.stop()


async def _http_json(port: int, target: str) -> tuple[int, dict]:
    """GET a JSON route of a daemon's upload server."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"GET {target} HTTP/1.1\r\nHost: smoke\r\n\r\n"
                     .encode())
        head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
        length = int(re.search(r"(?i)content-length:\s*(\d+)", head)
                     .group(1))
        return (int(head.split(" ")[1]),
                json.loads(await reader.readexactly(length)))
    finally:
        writer.close()


async def _origin_redirect_check(base: str, name: str, size: int,
                                 want: bytes) -> None:
    """The HTTP client's redirect rule on the card host: a probe and a
    ranged GET through ``/redirect/`` (outside the origin's tally)."""
    from dragonfly2_tpu_torch.common.piece import Range
    from dragonfly2_tpu_torch.source import SourceRequest, close_clients
    hdr = {CHECK_HEADER: "1"}
    url = f"{base}/redirect/{name}"
    try:
        n = await source.content_length(SourceRequest(url=url, header=hdr))
        check(n == size, f"redirected probe: length {n}, file {size}")
        resp = await source.download(SourceRequest(
            url=url, header=hdr, range=Range(0, len(want))))
        got = await resp.read_all()
        check(resp.status == 206 and got == want,
              f"redirected range: status {resp.status}, {len(got)} bytes")
    finally:
        await close_clients()


async def _chain_pod(workdir: str, seed_host: Host, url: str,
                     manifest: ShardManifest, relay: bool) -> dict:
    """A scheduler (``relay_fanout=1``, records kept) and leechers L1-L3 in
    this process, each started once its predecessor has its first offer;
    the seed runs in a child. The scheduler's DAG is sampled while they
    pull (a finished peer's in-edges are dropped)."""
    from dragonfly2_tpu_torch.daemon.config import DownloadConfig
    sched = Scheduler(SchedCfg(
        listen_ip="127.0.0.1", relay_fanout=1,
        peer_upload_limit=CHAIN_UPLOAD_LIMIT,
        seed_upload_limit=CHAIN_UPLOAD_LIMIT,
        records_dir=os.path.join(workdir, "records"),
        seed_peers=[SeedPeerAddr(host_id=seed_host.id, ip=seed_host.ip,
                                 rpc_port=seed_host.port,
                                 download_port=seed_host.download_port)]))
    await sched.start()
    sched.resource.store_host(seed_host)
    daemons = {n: Daemon(DaemonConfig(
        workdir=os.path.join(workdir, n), hostname=f"chain-{n}",
        listen_ip="127.0.0.1", host_ip="127.0.0.1",
        download=DownloadConfig(relay_enabled=relay),
        scheduler=SchedulerConfig(addresses=[sched.address])))
        for n in CHAIN}
    dag: dict[str, set] = {}

    async def watch_dag() -> None:
        while True:
            for task in list(sched.resource.tasks.values()):
                for pid, peer in list(task.peers.items()):
                    ups = dag.setdefault(peer.host.msg.hostname, set())
                    for up in task.dag.parents(pid):
                        if up in task.peers:
                            ups.add(task.peers[up].host.msg.hostname)
            await asyncio.sleep(0.02)

    watcher = asyncio.get_running_loop().create_task(watch_dag())
    try:
        for d in daemons.values():
            await d.start()
        task_id = daemons["l1"].ptm._task_id(url, UrlMeta())
        pulls = []
        for n in CHAIN:
            pulls.append(asyncio.get_running_loop().create_task(
                _leecher_pull(daemons[n], url, UrlMeta(), manifest, {})))
            t0 = time.monotonic()
            while True:        # the next starts at this one's first offer
                c = daemons[n].ptm.conductor(task_id)
                engine = c._p2p_engine if c is not None else None
                if engine is not None and engine._current_parents:
                    break
                check(not pulls[-1].done()
                      and time.monotonic() - t0 < CHAIN_OFFER_S,
                      f"{n}: no offer in {time.monotonic() - t0:.1f} s")
                await asyncio.sleep(0.005)
        runs = dict(zip(CHAIN, await asyncio.gather(*pulls)))
        peers = {n: r["conductor"].peer_id for n, r in runs.items()}
        status, flight_l3 = await _http_json(
            daemons["l3"].upload_server.port, f"/debug/flight/{task_id}")
        check(status == 200, f"L3 /debug/flight answered {status}")
        # every leecher's PeerResult (its flight summary) lands after its
        # result(): wait for the three
        rows: list[dict] = []
        t0 = time.monotonic()
        while True:
            rows += sched.service.records.drain()
            flown = {r["peer_id"] for r in rows if r["kind"] == "flight"}
            if set(peers.values()) <= flown or time.monotonic() - t0 > 10:
                break
            await asyncio.sleep(0.1)
        for n, d in daemons.items():
            runs[n].update(relay_stats(d))
            runs[n]["flight"] = d.flight_recorder.get(task_id)
        return {"runs": runs, "peers": peers, "rows": rows,
                "dag": {k: sorted(v) for k, v in dag.items()},
                "flight_l3": flight_l3}
    finally:
        watcher.cancel()
        for d in daemons.values():
            await d.stop()
        await sched.stop()


def _first(flight, stage: str, parent: str | None = None) -> dict:
    """First ``stage`` event per piece (from ``parent`` only, when
    given), on the monotonic clock."""
    out: dict = {}
    for t_ms, st, piece, p, _b, _d in list(flight.events):
        if st == stage and piece >= 0 and parent in (None, p):
            out.setdefault(piece, flight._m0 + t_ms / 1000.0)
    return out


def chain_run(workdir: str, url: str, manifest: ShardManifest, relay: bool,
              origin_conn, size: int, ref: torch.Tensor, base: int,
              shapes: dict, device: torch.device) -> dict:
    """One chain pull (relay on or off) and its checks; returns its
    line."""
    pex0 = pex_counts()
    ctx = multiprocessing.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe()
    child = ctx.Process(target=chain_seed_child, name="smoke-chain-seed",
                        args=(workdir, relay, child_conn))
    child.start()
    try:
        check(parent_conn.poll(300), "phase 11 seed did not start")
        seed_host = parent_conn.recv()["host"]
        try:
            pod = asyncio.run(_chain_pod(workdir, seed_host, url, manifest,
                                         relay))
        finally:
            parent_conn.send("stop")    # the seed ends either way
        check(parent_conn.poll(300), "phase 11 seed did not report")
        seed = parent_conn.recv()
    finally:
        child.join(timeout=120)
        if child.is_alive():
            child.terminate()
            child.join(timeout=30)
    check(child.exitcode == 0, f"phase 11 seed exited {child.exitcode}")
    origin_conn.send("report")
    origin = origin_conn.recv()
    what = "relay" if relay else "store-and-forward"
    runs, peers = pod["runs"], pod["peers"]
    names = {pid: n for n, pid in peers.items()}
    names[seed["peer_id"]] = "seed"
    leechers = {}
    for n in CHAIN:
        run = runs[n]
        c, tensors = run["conductor"], run["out"]
        for info in manifest.shards:
            t = tensors[info.name]
            lo = info.range_start - base
            check(t.device == device and t.dtype == torch.bfloat16
                  and list(t.shape) == shapes[info.name]
                  and torch.equal(t.reshape(-1).view(torch.uint8),
                                  ref[lo:lo + info.range_size]),
                  f"{what} {n}: {info.name} differs from the origin")
        check(c.traffic_source == 0 and c.traffic_p2p == size,
              f"{what} {n}: p2p {c.traffic_p2p}, source {c.traffic_source}")
        check_crc32c(c.storage.md, f"phase 11 {n}")
        per_parent = run["flight"].summarize()["per_parent"]
        leechers[n] = {
            "time_to_ready_s": run["wall"],
            "started_s": run["t0"] - runs["l1"]["t0"],
            "parents_in_dag": pod["dag"].get(f"chain-{n}", []),
            "pieces_from": {names.get(p, p): k
                            for p, k in c.pieces_by_parent.items()},
            "bytes_from": {names.get(p, p): v["bytes"]
                           for p, v in per_parent.items()},
            "relay_serves": run["relay_serves"],
            "relay_bytes": run["relay_bytes"]}
        del tensors, run["out"]
    # the origin sent each byte once, and only to the seed: its tally is
    # the file, its ranges do not overlap, the seed took the file from it
    # and no leecher took a byte from it
    spans = sorted(origin["ranges"])
    covered = 0
    for lo, hi in spans:
        check(lo == covered, f"{what}: origin ranges overlap or leave a "
                             f"hole at {covered}: {spans[:8]}")
        covered = hi
    check(covered == size and origin["body_bytes"] == size
          and seed["traffic_source"] == size,
          f"{what}: origin sent {origin['body_bytes']} bytes over "
          f"{covered}, seed took {seed['traffic_source']}, file {size}")
    # a chain: some leecher took pieces from another leecher. Hops from
    # the origin: the seed 1, a leecher one more than its deepest parent
    hops = {n: [p for p in leechers[n]["pieces_from"] if p in CHAIN]
            for n in CHAIN}
    check(any(hops.values()), f"{what}: no leecher took a piece from "
                              f"another: {leechers}")
    depth = {"seed": 1}
    for n in CHAIN:              # parents start before their children
        depth[n] = 1 + max(depth.get(p, 1)
                           for p in leechers[n]["pieces_from"])
    # L3's flight over HTTP: an hbm_done for every piece
    total = runs["l3"]["conductor"].total_pieces
    hbm = {e["piece"] for e in pod["flight_l3"]["events"]
           if e["stage"] == "hbm_done"}
    check(hbm == set(range(total)),
          f"{what}: L3's flight has hbm_done for {len(hbm)} of {total} "
          f"pieces")
    # every leecher's flight summary reached the scheduler's records
    flown = {r["peer_id"] for r in pod["rows"] if r["kind"] == "flight"}
    check(set(peers.values()) <= flown,
          f"{what}: flight rows for {len(flown & set(peers.values()))} of "
          f"3 leechers")
    relayed_rows = {}
    for n in CHAIN:
        relayed_rows[n] = sum(1 for r in pod["rows"]
                              if r["kind"] == "piece" and r.get("relayed")
                              and r["peer_id"] == peers[n])
    overlaps = {}
    for child_n, parent_n in (("l2", "l1"), ("l3", "l2")):
        first = _first(runs[child_n]["flight"], "first_byte",
                       parent=peers[parent_n])
        done = _first(runs[parent_n]["flight"], "wire_done")
        overlaps[f"{child_n}<{parent_n}"] = sum(
            1 for p, t in first.items() if p in done and t < done[p])
    if relay:
        check(runs["l1"]["relay_serves"].get("ok", 0) > 0,
              f"relay: L1 completed no relayed serve: "
              f"{runs['l1']['relay_serves']}")
        check(relayed_rows["l2"] > 0 and relayed_rows["l3"] > 0,
              f"relay: relayed piece rows per leecher {relayed_rows}")
        check(sum(overlaps.values()) > 0,
              f"relay: no child's first byte came before its parent's "
              f"wire_done: {overlaps}")
    ends = [r["t0"] + r["wall"] for r in runs.values()]
    # where each daemon's tail went, on the origin's first-byte clock:
    # its last landing, its flight's done, and (leechers) result()
    t0 = origin["first_byte_at"]
    timeline = {"seed": {"landed": seed["m0"] + seed["landed_s"] - t0,
                         "done": seed["m0"] + seed["back_source_s"] - t0}}
    for n in CHAIN:
        f = runs[n]["flight"]
        landed = [f._m0 + t / 1000.0 - t0 for t, st, *_ in f.events
                  if st == "wire_done"]
        done = [f._m0 + t / 1000.0 - t0 for t, st, *_ in f.events
                if st == "done"]
        timeline[n] = {"first_landed": min(landed), "landed": max(landed),
                       "done": max(done),
                       "ready": runs[n]["t0"] + runs[n]["wall"] - t0}
    return {"mode": what, "file_bytes": size,
            "makespan_s": max(ends) - t0, "timeline_s": timeline,
            "seed_back_source_s": seed["back_source_s"],
            "seed_landed_s": seed["landed_s"],
            "seed_relay_serves": seed["relay_serves"],
            "seed_relay_bytes": seed["relay_bytes"],
            "seed_upload_bytes": seed["upload_bytes"],
            "origin_bytes_sent": origin["body_bytes"],
            "origin_connections": len(origin["per_client"]),
            "origin_requests": origin["requests"],
            "chain_depth": max(depth.values()), "hops_from_origin": depth,
            "relayed_piece_rows": relayed_rows,
            "first_byte_before_parent_wire_done": overlaps,
            "pex": pex_delta(pex0), "leechers": leechers}


def phase_chain(workdir: str, device: torch.device) -> None:
    """Phase 11: origin -> seed -> L1 -> L2 -> L3 from an HTTP origin,
    with the relay on and then off (store-and-forward)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    path = os.path.join(workdir, "deploy", "model-00004-of-00004.safetensors")
    name = os.path.basename(path)
    layout = deploy_layout()
    header, _ = safetensors_header(layout)
    size = os.path.getsize(path)
    free = shutil.disk_usage(workdir).free
    need = 4 * size + (1 << 30)
    check(free >= need, f"phase 11 needs {need} bytes of free disk for the "
                        f"seed's and three leechers' copies, {free} free")
    manifest = manifest_from_file(path)
    with open(path, "rb") as f:
        head = f.read(4096)
        f.seek(len(header))
        ref = torch.frombuffer(bytearray(f.read()), dtype=torch.uint8).to(
            device)
    ctx = multiprocessing.get_context("spawn")
    origin_conn, child_conn = ctx.Pipe()
    origin = ctx.Process(target=http_origin_child, name="smoke-origin",
                         args=(path, CHAIN_PACE_BPS, child_conn))
    origin.start()
    lines = {}
    try:
        check(origin_conn.poll(120), "phase 11 origin did not start")
        base = f"http://127.0.0.1:{origin_conn.recv()['port']}"
        asyncio.run(_origin_redirect_check(base, name, size, head))
        for relay in (True, False):
            d = os.path.join(workdir, "chain-" + ("on" if relay else "off"))
            lines[relay] = chain_run(d, f"{base}/{name}", manifest, relay,
                                     origin_conn, size, ref, len(header),
                                     dict(layout), device)
            shutil.rmtree(d, ignore_errors=True)
        origin_conn.send("stop")
    finally:
        origin.join(timeout=30)
        if origin.is_alive():
            origin.terminate()
            origin.join(timeout=30)
    del ref
    for relay in (True, False):
        emit(f"phase 11 chain, {lines[relay]['mode']}", lines[relay])
    on, off = lines[True], lines[False]
    emit("phase 11 chain", {
        "origin_pace_bytes_per_s": CHAIN_PACE_BPS,
        "makespan_s": {"relay": on["makespan_s"],
                       "store_and_forward": off["makespan_s"],
                       "difference": off["makespan_s"] - on["makespan_s"]},
        "time_to_ready_s": {n: {"relay": on["leechers"][n]["time_to_ready_s"],
                                "store_and_forward":
                                    off["leechers"][n]["time_to_ready_s"]}
                            for n in CHAIN},
        "seed_back_source_s": {"relay": on["seed_back_source_s"],
                               "store_and_forward":
                                   off["seed_back_source_s"]},
        "phase_s": time.monotonic() - t_phase, "card": smi})


# ---------------------------------------------------------------- phase 12

# the two cadences cut from the defaults (30 s and 5 s) so the phase fits
CRASH_ANNOUNCE_S = 1.0
CRASH_PEX_S = 1.0
CRASH_WAIT_S = 30.0          # bound on each wait for gossip or announces


def crash_daemon_cfg(workdir: str, name: str, sched_addr: str,
                     **kw) -> DaemonConfig:
    """Phase 12's daemons: one scheduler address, the cut cadences."""
    cfg = DaemonConfig(workdir=os.path.join(workdir, name),
                       hostname=f"crash-{name}", listen_ip="127.0.0.1",
                       host_ip="127.0.0.1",
                       scheduler=SchedulerConfig(addresses=[sched_addr]),
                       **kw)
    cfg.announce_interval_s = CRASH_ANNOUNCE_S
    cfg.pex.interval_s = CRASH_PEX_S
    return cfg


def crash_sched_child(port: int, seed_host: Host, conn) -> None:
    """Scheduler S1 of phase 12, in a spawned process the parent ends with
    SIGKILL: no LeaveHost, no clean close."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    asyncio.run(_crash_sched_child(port, seed_host, conn))


async def _crash_sched_child(port: int, seed_host: Host, conn) -> None:
    sched = Scheduler(SchedCfg(
        listen_ip="127.0.0.1", port=port, seed_peers=[SeedPeerAddr(
            host_id=seed_host.id, ip=seed_host.ip, rpc_port=seed_host.port,
            download_port=seed_host.download_port)]))
    await sched.start()
    conn.send({"epoch": sched.service.epoch, "started": time.time()})
    await asyncio.to_thread(conn.recv)          # never answered


def crash_seed_child(workdir: str, sched_addr: str, conn) -> None:
    """Phase 12's seed daemon, in a spawned process that never touches
    CUDA; it announces to the scheduler and gossips like the leechers.
    It sends its host, serves until the parent asks, then sends its
    pull's origin bytes."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    asyncio.run(_crash_seed_child(workdir, sched_addr, conn))


async def _crash_seed_child(workdir: str, sched_addr: str, conn) -> None:
    seed = Daemon(crash_daemon_cfg(workdir, "seed", sched_addr,
                                   is_seed=True, device="cpu"))
    await seed.start()
    try:
        conn.send({"host": seed.host_info()})
        await asyncio.to_thread(conn.recv)      # the parent is done
        conductors = list(seed.ptm._conductors.values())
        conn.send({"traffic_source": sum(c.traffic_source
                                         for c in conductors),
                   "states": [c.state for c in conductors],
                   "pex_rounds": seed.pex.rounds})
    finally:
        await seed.stop()


def _holders(sched: Scheduler, task_id: str) -> set:
    """Hosts the scheduler holds as complete holders of ``task_id``."""
    task = sched.resource.tasks.get(task_id)
    if task is None:
        return set()
    return {p.host.id for p in task.peers.values()
            if p.state == PeerState.SUCCEEDED}


async def _until(what: str, cond, limit: float = CRASH_WAIT_S) -> float:
    """Wait for ``cond()``; returns the seconds it took."""
    t0 = time.monotonic()
    while not cond():
        check(time.monotonic() - t0 < limit,
              f"phase 12: {what} not within {limit:.0f} s")
        await asyncio.sleep(0.02)
    return time.monotonic() - t0


async def _crash_pod(workdir: str, url: str, manifest: ShardManifest,
                     sched_port: int, seed_host: Host, s1, s1_info: dict,
                     origin_conn) -> dict:
    """L1 pulls through S1; S1 is killed; L2 is served on the pex rung;
    S2 starts on S1's port and the swarm re-announces to it; the origin
    stops and L3 is served P2P by the adopted holders."""
    addr = f"127.0.0.1:{sched_port}"
    meta = UrlMeta()
    out: dict = {}
    l1 = Daemon(crash_daemon_cfg(workdir, "l1", addr))
    l2 = l3 = s2 = None
    await l1.start()
    try:
        task_id = l1.ptm._task_id(url, meta)
        out["l1"] = await _leecher_pull(l1, url, meta, manifest, {})
        # the scheduler named the seed as L1's parent (peer_observer): the
        # gossip rounds that follow index it as a complete holder
        out["l1_seed_indexed_s"] = await _until(
            "L1's swarm index naming the seed complete",
            lambda: any(e.host_id == seed_host.id and e.done
                        for e in l1.pex.index.parents_for(task_id)),
            limit=2 * 1.4 * CRASH_PEX_S + 1.0)

        os.kill(s1.pid, signal.SIGKILL)
        s1.join(timeout=30)
        check(not s1.is_alive(), "phase 12: S1 survived SIGKILL")
        out["s1_exit"] = s1.exitcode

        hits0 = pex_counts()
        cfg = crash_daemon_cfg(workdir, "l2", addr)
        cfg.pex.bootstrap = [f"127.0.0.1:{l1.upload_server.port}"]
        l2 = Daemon(cfg)
        await l2.start()
        # the pex rung serves only what the swarm index knows: L2's own
        # ticker learns L1's holdings from its bootstrap neighbour first
        out["l2_gossip_s"] = await _until(
            "L2's first gossip round",
            lambda: bool(l2.pex.index.parents_for(task_id)))
        out["l2"] = await _leecher_pull(l2, url, meta, manifest, {})
        out["l2_pex"] = pex_delta(hits0)
        await _until("L2's index naming two holders",
                     lambda: len(l2.pex.index.parents_for(task_id)) >= 2)
        status, snap = await _http_json(l2.upload_server.port, "/debug/pex")
        out["l2_debug_pex"] = (status, snap)

        # the restart: a cold boot with a new epoch on S1's port
        while int(time.time()) <= s1_info["epoch"]:
            await asyncio.sleep(0.05)
        adopted = REGISTRY.counter("df_sched_recovery_announces_total",
                                   labels=("result",))
        adopted0 = adopted.value("adopted")
        s2 = Scheduler(SchedCfg(
            listen_ip="127.0.0.1", port=sched_port, seed_peers=[SeedPeerAddr(
                host_id=seed_host.id, ip=seed_host.ip,
                rpc_port=seed_host.port,
                download_port=seed_host.download_port)]))
        # the re-announces' pulses: AnnounceContent hands its pulse to
        # ingest without an interval, AnnounceHost with one
        content_pulses: list = []
        fleet_ingest = s2.fleetpulse.ingest

        def ingest(host_id, pulse, **kw):
            if "interval_s" not in kw:
                content_pulses.append(host_id)
            return fleet_ingest(host_id, pulse, **kw)
        s2.fleetpulse.ingest = ingest
        t_start = time.monotonic()
        await s2.start()
        want = {seed_host.id, l1.host_info().id, l2.host_info().id}
        out["reannounce_s"] = await _until(
            "the re-announces of the seed, L1 and L2",
            lambda: _holders(s2, task_id) >= want)
        out["reannounce_from_start_s"] = time.monotonic() - t_start
        out["s2_epoch"] = s2.service.epoch
        out["s2_holders"] = sorted(_holders(s2, task_id))
        out["s2_task_state"] = s2.resource.tasks[task_id].state.value
        out["adopted"] = adopted.value("adopted") - adopted0
        out["recovery_rows"] = [r for r in s2.ledger._ring
                                if r.get("decision_kind") == "recovery"]
        out["s2_content_pulses"] = sorted(content_pulses)
        out["s2_fleet_series"] = {
            hid: [smp["seq"] for smp in series.ring]
            for hid, series in s2.fleetpulse._series.items()}
        out["s2_fleet_ingested"] = s2.fleetpulse.ingested
        out["revived_s"] = await _until(
            "L2's ticker reviving S1's demoted address",
            lambda: pex_delta(hits0)["df_pex_sched_revived_total"] >= 1)
        out["revived"] = pex_delta(hits0)["df_pex_sched_revived_total"]

        origin_conn.send("report")
        out["origin"] = origin_conn.recv()
        origin_conn.send("stop")
        hits0 = pex_counts()
        l3 = Daemon(crash_daemon_cfg(workdir, "l3", addr))
        await l3.start()
        out["l3"] = await _leecher_pull(l3, url, meta, manifest, {})
        out["l3_pex"] = pex_delta(hits0)
        for n, d in (("l1", l1), ("l2", l2), ("l3", l3)):
            out[n]["flight"] = d.flight_recorder.get(task_id).summarize()
            out[n]["host_id"] = d.host_info().id
        return out
    finally:
        for d in (l3, l2, l1):
            if d is not None:
                await d.stop()
        if s2 is not None:
            await s2.stop()


def phase_crash(workdir: str, device: torch.device) -> None:
    """Phase 12: a scheduler crash mid-rollout, on phase 8's origin."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    path = os.path.join(workdir, "deploy", "model-00004-of-00004.safetensors")
    name = os.path.basename(path)
    layout = deploy_layout()
    header, _ = safetensors_header(layout)
    size = os.path.getsize(path)
    free = shutil.disk_usage(workdir).free
    need = 4 * size + (1 << 30)
    check(free >= need, f"phase 12 needs {need} bytes of free disk for the "
                        f"seed's and three leechers' copies, {free} free")
    manifest = manifest_from_file(path)
    with open(path, "rb") as f:
        f.seek(len(header))
        ref = torch.frombuffer(bytearray(f.read()), dtype=torch.uint8).to(
            device)
    d = os.path.join(workdir, "crash")
    with socket.socket() as sock:          # S1's port, known to the seed
        sock.bind(("127.0.0.1", 0))
        sched_port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    origin_conn, o_child = ctx.Pipe()
    seed_conn, sd_child = ctx.Pipe()
    s1_conn, s1_child = ctx.Pipe()
    origin = ctx.Process(target=http_origin_child, name="smoke-crash-origin",
                         args=(path, 0, o_child))
    seed = ctx.Process(target=crash_seed_child, name="smoke-crash-seed",
                       args=(d, f"127.0.0.1:{sched_port}", sd_child))
    s1 = None
    origin.start()
    seed.start()
    try:
        check(origin_conn.poll(120), "phase 12 origin did not start")
        url = f"http://127.0.0.1:{origin_conn.recv()['port']}/{name}"
        check(seed_conn.poll(300), "phase 12 seed did not start")
        seed_host = seed_conn.recv()["host"]
        s1 = ctx.Process(target=crash_sched_child, name="smoke-crash-s1",
                         args=(sched_port, seed_host, s1_child))
        s1.start()
        check(s1_conn.poll(300), "phase 12 S1 did not start")
        s1_info = s1_conn.recv()
        pod = asyncio.run(_crash_pod(d, url, manifest, sched_port,
                                     seed_host, s1, s1_info, origin_conn))
        seed_conn.send("stop")
        check(seed_conn.poll(300), "phase 12 seed did not report")
        seed_stats = seed_conn.recv()
    finally:
        if s1 is not None and s1.is_alive():
            s1.kill()                  # the phase failed before the crash
        for conn in (seed_conn, origin_conn):
            try:
                conn.send("stop")      # a no-op for a child already gone
            except OSError:
                pass
        for proc in (s1, seed, origin):
            if proc is None:
                continue
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=30)
    check(seed.exitcode == 0, f"phase 12 seed exited {seed.exitcode}")
    base, shapes = len(header), dict(layout)
    lines = {}
    for n in ("l1", "l2", "l3"):
        run = pod[n]
        c, tensors = run["conductor"], run["out"]
        for info in manifest.shards:
            t = tensors[info.name]
            lo = info.range_start - base
            check(t.device == device and t.dtype == torch.bfloat16
                  and list(t.shape) == shapes[info.name]
                  and torch.equal(t.reshape(-1).view(torch.uint8),
                                  ref[lo:lo + info.range_size]),
                  f"phase 12 {n}: {info.name} differs from the origin")
        check(c.traffic_source == 0 and c.traffic_p2p == size,
              f"phase 12 {n}: p2p {c.traffic_p2p}, source "
              f"{c.traffic_source}")
        check_crc32c(c.storage.md, f"phase 12 {n}")
        lines[n] = {"time_to_ready_s": run["wall"],
                    "rungs": run["flight"]["rungs"],
                    "served_rung": run["flight"]["served_rung"],
                    "pieces_per_parent": dict(c.pieces_by_parent)}
        del tensors, run["out"]
    del ref
    shutil.rmtree(d, ignore_errors=True)
    check(pod["l1"]["flight"]["rungs"] == ["p2p"],
          f"phase 12 L1 rungs {pod['l1']['flight']['rungs']}")
    check(pod["l2"]["flight"]["rungs"] == ["pex"]
          and pod["l2"]["flight"]["served_rung"] == "pex",
          f"phase 12 L2 rungs {pod['l2']['flight']['rungs']}, served "
          f"{pod['l2']['flight']['served_rung']}")
    check(pod["l2_pex"]["df_pex_parent_hits_total"] > 0,
          f"phase 12 L2: no PEX parent hit {pod['l2_pex']}")
    status, snap = pod["l2_debug_pex"]
    task_id = pod["l1"]["conductor"].task_id
    listed = snap.get("swarm", {}).get("tasks", {}).get(task_id, [])
    check(status == 200 and len(listed) >= 2,
          f"phase 12 L2 /debug/pex: status {status}, {len(listed)} holders")
    want = sorted({seed_host.id, pod["l1"]["host_id"], pod["l2"]["host_id"]})
    check(pod["s2_holders"] == want and pod["s2_task_state"] == "succeeded",
          f"phase 12 S2 holders {pod['s2_holders']} "
          f"({pod['s2_task_state']}), want {want}")
    check(pod["adopted"] >= 3, f"phase 12 S2 adopted {pod['adopted']} "
                               f"re-announces, want the seed, L1 and L2")
    check({r["host_id"] for r in pod["recovery_rows"]} >= set(want),
          f"phase 12 S2 recovery rows {pod['recovery_rows']}")
    # S2's recovery adoption ingested the re-announces' pulses: each of
    # the seed, L1 and L2 has a series in its fleet pulse
    check(set(pod["s2_content_pulses"]) >= set(want)
          and set(pod["s2_fleet_series"]) >= set(want),
          f"phase 12 S2 fleet pulse: content pulses from "
          f"{pod['s2_content_pulses']}, series {sorted(pod['s2_fleet_series'])}"
          f", want {want}")
    check(pod["reannounce_s"] <= 3 * CRASH_ANNOUNCE_S,
          f"phase 12 re-announces took {pod['reannounce_s']:.2f} s, more "
          f"than three announce intervals")
    check(pod["revived"] >= 1, "phase 12: L2 revived no demoted scheduler")
    check(pod["l3"]["flight"]["rungs"] == ["p2p"],
          f"phase 12 L3 rungs {pod['l3']['flight']['rungs']}")
    # the origin sent each byte once, and only to the seed
    origin_t = pod["origin"]
    spans = sorted(origin_t["ranges"])
    covered = 0
    for lo, hi in spans:
        check(lo == covered, f"phase 12 origin ranges overlap or leave a "
                             f"hole at {covered}: {spans[:8]}")
        covered = hi
    check(covered == size and origin_t["body_bytes"] == size
          and seed_stats["traffic_source"] == size,
          f"phase 12 origin sent {origin_t['body_bytes']} bytes over "
          f"{covered}, seed took {seed_stats['traffic_source']}, file "
          f"{size}")
    emit("phase 12 crash", {
        "file_bytes": size, "announce_interval_s": CRASH_ANNOUNCE_S,
        "pex_interval_s": CRASH_PEX_S,
        "time_to_ready_s": {n: lines[n]["time_to_ready_s"]
                            for n in ("l1", "l2", "l3")},
        "leechers": lines,
        "l1_seed_indexed_s": pod["l1_seed_indexed_s"],
        "l2_gossip_wait_s": pod["l2_gossip_s"],
        "l2_pex": pod["l2_pex"], "l3_pex": pod["l3_pex"],
        "l2_debug_pex_holders": len(listed),
        "s1_exit": pod["s1_exit"], "s1_epoch": s1_info["epoch"],
        "s2_epoch": pod["s2_epoch"],
        "s2_start_to_last_reannounce_s": pod["reannounce_s"],
        "s2_adopted_announces": pod["adopted"],
        "s2_recovery_rows": len(pod["recovery_rows"]),
        "s2_holders": pod["s2_holders"],
        "s2_content_pulses": len(pod["s2_content_pulses"]),
        "s2_fleet_ingested": pod["s2_fleet_ingested"],
        "s2_fleet_series": {hid: len(seqs) for hid, seqs
                            in pod["s2_fleet_series"].items()},
        "df_pex_sched_revived_total": pod["revived"],
        "revived_after_s2_s": pod["revived_s"],
        "origin_bytes_sent": origin_t["body_bytes"],
        "seed_traffic_source": seed_stats["traffic_source"],
        "phase_s": time.monotonic() - t_phase, "card": smi})


# --------------------------------------------------------------- phase 13

# the dfbench points run on the host in worker processes while the card
# fits --pr19's MLPs, the longest first; pr14's and pr17's second runs
# rule with the reference's filter
DFBENCH_POINTS = ("ctrl", "pr13", "pr9", "pr18", "pr17",
                  "pr17_reference_filter", "pr14", "pr14_reference_filter",
                  "pr12", "pr11", "pr4", "pr10", "pr8", "pr6", "pr5",
                  "baseline")
# what --ctrl must equal in BENCH_pr16.json (its latencies, rates and
# state bytes are this host's measurements, printed, not compared)
CTRL_EQUAL_KEYS = ("bench", "seed", "fleets", "pieces", "schedule_digest",
                   "profiler_pure", "ctrl_profiler_pure", "ruling_digests")
# the one wall-clock key of --pr17 (per leg, and the legs' rollup)
RECOVERY_WALL_CLOCK = "time_to_first_ruling_ms"
RECOVERY_GATES = ("snapshot_fault_survived", "origin_amplification_bounded",
              "poisoner_quarantined_across_restart", "affinity_sticky")
DFBENCH_WORKERS = 5
# the keys BENCH_pr6.json predates (the reference's bench_summary grew
# them later) and the values a fan-out without relaying, content-store
# placements or pods gives them
PR6_LATER_KEYS = {"relay": None, "placed_bytes": 0, "cross_pod_bytes": 0}


def dfbench_args(device: str = "cpu") -> argparse.Namespace:
    """``dfbench``'s default shape: seed 7, 8 daemons, 64 pieces of 4 MiB."""
    return argparse.Namespace(seed=7, daemons=8, pieces=64,
                              piece_size=4 << 20, parallelism=4, smoke=False,
                              device=device)


def bench_file(name: str) -> dict:
    with open(os.path.join(ROOT, f"BENCH_{name}.json")) as f:
        return json.load(f)


def dfbench_point(name: str) -> tuple[dict, float]:
    """One host-only dfbench point at its full size, in a worker process:
    (result, wall seconds)."""
    args = dfbench_args()
    t0 = time.monotonic()
    if name == "baseline":
        result = dfbench.run_bench(**dfbench._bench_kw(args))
    elif name == "pr14_reference_filter":
        result = dfbench._run_pr14(args, partner_exemption=False)
    elif name == "pr17_reference_filter":
        result = dfbench._run_pr17(args, partner_exemption=False)
    else:
        result = dfbench.POINTS[name](args)
    return result, time.monotonic() - t0


def _jsonable(obj):
    return json.loads(json.dumps(obj))


def check_dfbench_point(name: str, got: dict) -> dict:
    """Hold one point against its committed BENCH file; returns what the
    phase line prints for it."""
    got = _jsonable(got)
    if name == "baseline":
        want = bench_file("pr3")
        check(got["schedule_digest"] == want["schedule_digest"],
              f"baseline schedule_digest {got['schedule_digest']} != "
              f"BENCH_pr3's")
        check({k: got[k] for k in want} == want,
              "the baseline differs from BENCH_pr3.json")
        return {"schedule_digest": got["schedule_digest"]}
    if name == "pr14":
        want = bench_file("pr14")
        flags = ("sharded_beats_naive_2x", "tree_bounded",
                 "sharded_tracks_shard_bytes", "naive_tracks_content_bytes")
        check(all(got[k] is True for k in flags),
              f"pr14 gates: {({k: got[k] for k in flags})}")
        # the port's swap-partner exemption (ROADMAP known difference 13)
        # moves the sharded schedules at 4x4 and 8x8 only
        moved = sorted(
            f"{sc}/{size}" for sc in dfbench.ROLLOUT_SCENARIOS
            for size in got["sizes"]
            if got["scenarios"][sc][size]["schedule_digest"]
            != want["scenarios"][sc][size]["schedule_digest"])
        check(moved == ["roll_sharded/4x4", "roll_sharded/8x8"]
              and got["kill"] == want["kill"],
              f"pr14 schedules moved beyond the partner ruling: {moved}")
        return {"rollout_digest": got["rollout_digest"],
                "moved_by_swap_partner_exemption": moved,
                "speedup": got["speedup"],
                **{k: got[k] for k in flags}}
    if name == "ctrl":
        want = bench_file("pr16")
        check({k: got[k] for k in CTRL_EQUAL_KEYS}
              == {k: want[k] for k in CTRL_EQUAL_KEYS},
              f"ctrl differs from BENCH_pr16.json: "
              f"{({k: got[k] for k in CTRL_EQUAL_KEYS})}")
        check(all(got["scenarios"][k]["rulings"]
                  == want["scenarios"][k]["rulings"] for k in want["scenarios"]),
              "ctrl ruling counts differ from BENCH_pr16.json")
        return {"ruling_digests": got["ruling_digests"],
                "profiler_pure": got["profiler_pure"],
                "ctrl_profiler_pure": got["ctrl_profiler_pure"],
                "rulings": {k: v["rulings"]
                            for k, v in got["scenarios"].items()},
                "rulings_per_sec": got["rulings_per_sec"],
                "wall_ms": {k: v["wall_ms"]
                            for k, v in got["scenarios"].items()},
                "queue_wait_p99_ms": {
                    k: v["profile"]["queue_wait_ms"]["p99_ms"]
                    for k, v in got["scenarios"].items()},
                "phase_p50_ms": got["phase_p50_ms"],
                "phase_p99_ms": got["phase_p99_ms"],
                "state_bytes_per_peer": got["state_bytes_per_peer"],
                "overhead": got["overhead"]}
    if name == "pr18":
        want = bench_file("pr18")
        rates = {}
        for leg, row in got["legs"].items():
            rates[leg] = row.pop("ingest_per_sec")
            want["legs"][leg].pop("ingest_per_sec")
        check(got == want and got["fleetpulse_pure"] is True,
              "pr18 differs from BENCH_pr18.json (fleetpulse_pure "
              f"{got['fleetpulse_pure']})")
        return {"fleetpulse_pure": got["fleetpulse_pure"],
                "pulse_digest": got["pulse_digest"],
                "legs": sorted(got["legs"]),
                "ingest_per_sec": rates,
                "bytes_per_announce": got["bytes_per_announce"],
                **{k: got[k] for k in ("detected_kinds",
                                       "detection_latency_intervals",
                                       "silent_detection_intervals",
                                       "detection_bounded",
                                       "zero_false_positives")}}
    if name in ("pr17", "pr17_reference_filter"):
        check(all(got[k] is True for k in RECOVERY_GATES),
              f"{name} gates: {({k: got[k] for k in RECOVERY_GATES})}")
        wall = got.pop(RECOVERY_WALL_CLOCK)
        for leg in got["legs"].values():
            leg.pop(RECOVERY_WALL_CLOCK)
        want = bench_file("pr17")
        want.pop(RECOVERY_WALL_CLOCK)
        for leg in want["legs"].values():
            leg.pop(RECOVERY_WALL_CLOCK)
        if name == "pr17_reference_filter":
            # ruled with the reference's filter, everything but the one
            # wall-clock key equals the committed file
            check(got == want, "pr17 with the reference's filter differs "
                               "from BENCH_pr17.json")
        else:
            # the port's swap-partner exemption (known difference 13)
            # moves the storm's rulings: the schedule gate and the
            # shape of the result hold
            check(got["schedule_digest"] == want["schedule_digest"]
                  and got.keys() == want.keys(),
                  "pr17 with the port's filter: schedule digest or keys "
                  "differ from BENCH_pr17.json")
        return {"recovery_digest": got["recovery_digest"],
                RECOVERY_WALL_CLOCK: wall,
                "poisoner_reoffers": got["poisoner_reoffers"],
                "origin_hits_after_restart":
                    got["origin_hits_after_restart"],
                "shard_stickiness": got["shard_stickiness"],
                **{k: got[k] for k in RECOVERY_GATES}}
    if name == "pr6":
        for sc in got["scenarios"].values():
            later = {k: sc["podscope"].pop(k) for k in PR6_LATER_KEYS}
            check(later == PR6_LATER_KEYS,
                  f"pr6 keys BENCH_pr6.json predates: {later}")
    want = bench_file("pr14" if name == "pr14_reference_filter" else name)
    check(got == want, f"{name} differs from BENCH_"
                       f"{name.split('_')[0]}.json")
    if name == "pr6":
        return {k: got[k] for k in ("tree_depth", "amplification",
                                    "pod_makespan_ms")}
    if name == "pr12":
        check(got["quarantine_pure"] and got["quarantine_bounds_waste"],
              "pr12 gates failed")
        return {k: got[k] for k in ("byzantine_digest", "quarantine_pure",
                                    "quarantine_bounds_waste",
                                    "time_to_quarantine_ms",
                                    "wasted_ratio", "makespan_ms")}
    if name == "pr13":
        flags = ("origin_bounded", "sublinear_in_pods", "hier_beats_naive")
        check(all(got[k] is True for k in flags)
              and got["member_origin_bytes"] == 0, "pr13 gates failed")
        return {"federation_digest": got["federation_digest"],
                "makespan_ms": got["makespan_ms"],
                "origin_copies": got["origin_copies"],
                "seed_kill": got["seed_kill"],
                **{k: got[k] for k in flags}}
    if name == "pr9":
        check(got["relay_beats_pull"] and got["sublinear"],
              "pr9 gates failed")
        return {k: got[k] for k in ("cold_makespan_ms", "tree_depth",
                                    "relay_beats_pull", "sublinear")}
    keys = {"pr14_reference_filter": ("rollout_digest",),
            "pr11": ("qos_digest", "fg_p99_ratio_qos", "fg_p99_ratio_no_qos",
                     "fg_holds_slo", "bulk_degrades", "bulk_queued",
                     "bulk_shed", "fg_starved"),
            "pr4": ("p2p_served_ratio",),
            "pr10": ("churn_digest", "alias_pull_zero_transfer",
                     "warm_restart_zero_origin", "disk_bounded"),
            "pr8": ("decision_digest", "ledger_pure"),
            "pr5": ("schedule_digest", "landing")}[name]
    return {k: got[k] for k in keys}


def phase_dfbench(device: torch.device) -> None:
    """Phase 13: the port's dfbench points at the reference's full sizes.
    The host-only points run in spawned workers while this process runs
    --pr19, whose MLP fits are the phase's device work."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            DFBENCH_WORKERS, mp_context=ctx) as pool:
        futures = {name: pool.submit(dfbench_point, name)
                   for name in DFBENCH_POINTS}
        # --pr19 on the card: datagen, two seeded fits, the replay, two
        # learned legs
        t0 = time.monotonic()
        pr19 = dfbench._run_pr19(dfbench_args(str(device)))
        pr19_s = time.monotonic() - t0
        want = bench_file("pr19")
        for k in ("schedule_digest", "learned_schedule_digest",
                  "learned_decision_digest"):
            check(pr19[k] == want[k], f"pr19 {k} {pr19[k]} != BENCH_pr19's")
        flags = ("ml_disarmed_pure", "outcomes_pure", "trained_deterministic",
                 "learned_deterministic")
        check(all(pr19[k] is True for k in flags),
              f"pr19 gates: {({k: pr19[k] for k in flags})}")
        check(all(pr19["model"][k] == want["model"][k]
                  for k in ("rows", "supervision", "feature_dim",
                            "schema_version")),
              f"pr19 model {pr19['model']} != BENCH_pr19's")
        check(pr19["fit"]["device"] == str(device),
              f"pr19 fitted on {pr19['fit']['device']}")
        emit("phase 13 dfbench, pr19", {
            "wall_s": pr19_s, "fit_device": pr19["fit"]["device"],
            "fit_s": pr19["fit"]["seconds"],
            "model_version": pr19["model"]["version"],
            "regret": pr19["regret"], "card": smi,
            **{k: pr19[k] for k in flags}})
        # the port's own datagen rows are the fixture, and the learned
        # recipe beats the heuristic on them on average (one fit's regret
        # is noise: ROADMAP known difference 5)
        rows = _jsonable(dfbench.datagen_rows(dfbench_args()))
        with open(FIXTURE) as f:
            fixture = [json.loads(line) for line in f]
        check(rows == fixture, "the port's datagen rows differ from "
                               "tests/data/pr19_datagen_rows.jsonl")
        t0 = time.monotonic()
        learned, fit_s = {}, []
        for s in REGRET_SEEDS:
            fitted = pipeline.train_decision_model(rows, seed=s,
                                                   device=device)
            check(fitted is not None, f"seed {s}: no model from the rows")
            fit_s.append(fitted[1]["train_seconds"])
            regret = replay_regret(rows, ("default", "ml"),
                                   serving.make_mlp_infer(fitted[0]))
            ev = regret["evaluators"]
            check(round(ev["default"]["mean_regret"], 4) == HEURISTIC_REGRET,
                  f"heuristic regret {ev['default']['mean_regret']}")
            learned[s] = ev["ml"]["mean_regret"]
        mean = sum(learned.values()) / len(learned)
        check(mean < HEURISTIC_REGRET,
              f"mean learned regret {mean} over seeds {list(learned)} does "
              f"not beat the heuristic's {HEURISTIC_REGRET}")
        emit("phase 13 dfbench, learned vs heuristic", {
            "datagen_rows": len(rows), "rows_equal_fixture": True,
            "learned_regret_by_seed": learned, "learned_regret_mean": mean,
            "seeds_beating_heuristic": sum(v < HEURISTIC_REGRET
                                           for v in learned.values()),
            "fits_s": time.monotonic() - t0, "fit_s_each": fit_s})
        for name in DFBENCH_POINTS:
            result, wall_s = futures[name].result()
            emit(f"phase 13 dfbench, {name}", {
                "wall_s": wall_s, **check_dfbench_point(name, result)})
    emit("phase 13 dfbench", {"phase_s": time.monotonic() - t_phase,
                              "card": smi})


# ---------------------------------------------------------------- phase 14

OBSERVE_PROFILE_S = 1            # /debug/profile?seconds= on each port
OBSERVE_OVERHEAD_CALLS = 200_000
# the reference's JSON keys of each route (``common/health.py``,
# ``common/faultgate.py``, ``scheduler/{cluster_view,ctrl_debug,
# decision_ledger}.py``)
HEALTH_KEYS = {"status", "active", "loop", "watchdog", "slo", "events",
               "flight_recorders"}
FAULTS_KEYS = {"armed", "scripts"}
CLUSTER_KEYS = {"since", "hosts", "bytes_p2p", "bytes_source",
                "back_to_source_ratio", "stragglers", "decisions",
                "snapshot_ttl_s", "staleness_s"}
DECISIONS_KEYS = {"stats", "decisions"}
CTRL_KEYS = {"armed", "since", "rulings", "phases", "compute_ms",
             "unattributed_ms", "queue_wait_ms", "state_bytes",
             "state_staleness_s", "state_ttl_s"}
TRACE_CHAIN = ("sched.register", "sched.offer", "piece.download",
               "upload.serve", "hbm.ingest")
# phase 7's seed-7 fixture blob, which phase 14's fit must repeat
FIT_BLOBS: dict = {}


def http_get(port: int, target: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{target}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def get_json(port: int, target: str, keys: set | None = None) -> dict:
    status, body = http_get(port, target)
    check(status == 200, f":{port}{target} answered {status}: {body[:300]}")
    out = json.loads(body)
    if keys is not None:
        check(keys <= set(out), f":{port}{target} lacks the keys "
                                f"{sorted(keys - set(out))}")
    return out


def check_debug_port(name: str, port: int) -> dict:
    """``/debug/stacks``, ``/debug/profile`` and ``/metrics`` answer 200 on
    a launcher's ``--debug-port``, and ``/debug/health`` with its keys."""
    out = {}
    for target, needle in (("/debug/stacks", b"--- asyncio tasks ---"),
                           (f"/debug/profile?seconds={OBSERVE_PROFILE_S}",
                            b"function calls"),
                           ("/metrics", b"df_loop_lag_seconds")):
        t0 = time.monotonic()
        status, body = http_get(port, target)
        check(status == 200 and needle in body,
              f"{name} :{port}{target} answered {status}: {body[:300]}")
        out[target.split("?")[0]] = round(time.monotonic() - t0, 3)
    get_json(port, "/debug/health", HEALTH_KEYS)
    return out


def read_spans(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def disarmed_phase_ns() -> float:
    """ns per call of a disarmed ``phasetimer.phase`` (the profiler's
    overhead contract), on this process's host thread."""
    check(not phasetimer.ARMED, "the profiler is armed in this process")
    t0 = time.perf_counter()
    for _ in range(OBSERVE_OVERHEAD_CALLS):
        with phasetimer.phase("filter"):
            pass
    return (time.perf_counter() - t0) / OBSERVE_OVERHEAD_CALLS * 1e9


async def _observe_leecher(workdir: str, mgr_addr: str, sched_addr: str,
                           url: str, digest: str, manifest: ShardManifest,
                           trace_path: str) -> dict:
    """The leecher, tracing on: pulls with a manifest sink on the card and
    back-source disabled, then reads its own ``/debug/health`` and the
    flight's summary."""
    leech = Daemon(DaemonConfig(
        workdir=os.path.join(workdir, "leecher"), hostname="observe-l",
        listen_ip="127.0.0.1", host_ip="127.0.0.1",
        manager_addresses=[mgr_addr],
        tracing=TracingConfig(enabled=True, jsonl_path=trace_path)))
    await leech.start()
    try:
        found = leech.scheduler and leech.scheduler.addresses
        check(found == [sched_addr], f"the leecher found {found} through "
                                     f"the manager, want [{sched_addr}]")
        run = await _leecher_pull(leech, url, UrlMeta(digest=digest),
                                  manifest, {})
        c = run["conductor"]
        run["traffic"] = (c.traffic_p2p, c.traffic_source)
        port = leech.upload_server.port
        run["health"] = await asyncio.to_thread(
            get_json, port, "/debug/health", HEALTH_KEYS)
        run["summary"] = await asyncio.to_thread(
            get_json, port, f"/debug/flight/{c.task_id}?summary=1")
        return run
    finally:
        tracing.TRACER.flush()
        await leech.stop()


def observe_pod(workdir: str, device: torch.device) -> dict:
    """Phase 14 (a): a manager, a seed, a trainer and a scheduler from the
    launchers with their debug surfaces and tracing on, and a leecher in
    this process pulling phase 8's origin into the card."""
    path = os.path.join(workdir, "deploy", "model-00004-of-00004.safetensors")
    check(os.path.exists(path), f"phase 8's origin is gone: {path}")
    layout = deploy_layout()
    header, nbytes = safetensors_header(layout)
    size = len(header) + nbytes
    d = os.path.join(workdir, "observe")
    os.makedirs(d)
    need = 3 * size + (1 << 30)
    free = shutil.disk_usage(d).free
    check(free >= need, f"phase 14 needs {need} bytes of free disk, {free} "
                        f"free")
    with open(path, "rb") as f:
        sha = hashlib.sha256(f.read(len(header)))
        raw = np.fromfile(f, dtype=np.uint8)
    sha.update(raw)
    ref = torch.from_numpy(raw).to(device)
    del raw
    url, digest = "file://" + path, "sha256:" + sha.hexdigest()
    manifest = manifest_from_file(path)
    traces = {k: os.path.join(d, f"{k}-traces.jsonl")
              for k in ("leecher", "seed", "scheduler")}
    procs: list[Launched] = []
    rcs: dict = {}
    try:
        mgr = Launched(d, "manager", "manager", [
            "--listen-ip", "127.0.0.1", "--db", os.path.join(d, "m.db"),
            "--workdir", os.path.join(d, "manager"), "--debug-port", "-1"])
        procs.append(mgr)
        mgr_dbg = int(mgr.wait_up("debug on :").rsplit(":", 1)[1])
        mgr_addr = re.search(r"grpc=(\S+)",
                             mgr.wait_up("manager up:")).group(1)
        seed_d = Launched(d, "seed", "daemon", [
            "--config", write_json(os.path.join(d, "seed.json"), {
                "workdir": os.path.join(d, "seed"),
                "hostname": "observe-seed", "is_seed": True,
                "host_ip": "127.0.0.1", "listen_ip": "127.0.0.1",
                "manager_addresses": [mgr_addr]}),
            "--debug-endpoints", "--tracing-jsonl", traces["seed"]])
        procs.append(seed_d)
        seed_d.wait_up("daemon up:")
        seed_up = int(seed_d.wait_line("upload server on", 10)
                      .rsplit(":", 1)[1])
        trainer = Launched(d, "trainer", "trainer", [
            "--listen-ip", "127.0.0.1", "--manager", mgr_addr,
            "--data-dir", os.path.join(d, "trainer"), "--debug-port", "-1"])
        procs.append(trainer)
        trainer_dbg = int(trainer.wait_up("debug on :").rsplit(":", 1)[1])
        trainer_addr = trainer.wait_up("trainer up:").split()[-1]
        sched = Launched(d, "scheduler", "scheduler", [
            "--config", write_json(os.path.join(d, "scheduler.json"), {
                "listen_ip": "127.0.0.1", "advertise_ip": "127.0.0.1"}),
            "--manager", mgr_addr, "--trainer", trainer_addr,
            "--debug-port", "-1", "--tracing-jsonl", traces["scheduler"]])
        procs.append(sched)
        sched_dbg = int(sched.wait_up("debug on :").rsplit(":", 1)[1])
        sched_addr = sched.wait_up("scheduler up:").split()[-1]
        check(" seeds=1)" in sched.wait_line("scheduler up on", 10),
              "the scheduler did not adopt the seed from the manager")
        # the ruling profiler, armed live before the pull
        armed = get_json(sched_dbg, "/debug/ctrl?arm=1", CTRL_KEYS)
        check(armed["armed"] is True, f"/debug/ctrl?arm=1: {armed}")

        run = asyncio.run(_observe_leecher(d, mgr_addr, sched_addr, url,
                                           digest, manifest,
                                           traces["leecher"]))
        tensors, base, shapes = run["out"], len(header), dict(layout)
        check(len(tensors) == len(layout),
              f"{len(tensors)} tensors, want {len(layout)}")
        for info in manifest.shards:
            t = tensors[info.name]
            check(t.device == device and t.dtype == torch.bfloat16
                  and list(t.shape) == shapes[info.name],
                  f"{info.name} is {t.dtype} {list(t.shape)} on {t.device}")
            lo = info.range_start - base
            check(torch.equal(t.reshape(-1).view(torch.uint8),
                              ref[lo:lo + info.range_size]),
                  f"{info.name} bytes differ from the origin")
        del tensors, run["out"], ref
        check(run["traffic"] == (size, 0),
              f"(traffic_p2p, traffic_source) {run['traffic']}, file {size}")
        summary = run["summary"]
        check("slo_breaches" in summary and summary.get("slo_budgets_ms"),
              f"the flight summary lacks the SLO keys: {sorted(summary)}")

        routes = {name: check_debug_port(name, port) for name, port in (
            ("manager", mgr_dbg), ("trainer", trainer_dbg),
            ("scheduler", sched_dbg))}
        seed_health = get_json(seed_up, "/debug/health", HEALTH_KEYS)
        faults = get_json(seed_up, "/debug/faults", FAULTS_KEYS)
        check(faults == {"armed": False, "scripts": []},
              f"seed /debug/faults: {faults}")
        cluster = get_json(sched_dbg, "/debug/cluster", CLUSTER_KEYS)
        check(cluster["bytes_p2p"] >= size and cluster["bytes_source"] == 0,
              f"/debug/cluster bytes: {cluster['bytes_p2p']} p2p, "
              f"{cluster['bytes_source']} source")
        decisions = get_json(sched_dbg, "/debug/decisions", DECISIONS_KEYS)
        check(decisions["stats"]["by_kind"].get("find", 0) >= 1,
              f"/debug/decisions: {decisions['stats']}")
        ctrl = get_json(sched_dbg, "/debug/ctrl", CTRL_KEYS)
        find = ctrl["rulings"]["by_kind"].get("find", {})
        check(find.get("count", 0) >= 1
              and {"filter", "emit"} <= set(ctrl["phases"]),
              f"/debug/ctrl: rulings {ctrl['rulings']['by_kind']}, phases "
              f"{sorted(ctrl['phases'])}")
        get_json(sched_dbg, "/debug/ctrl?arm=0", CTRL_KEYS)
    finally:
        for p in reversed(procs):
            rcs[p.name] = p.stop()
    check(all(rc == 0 for rc in rcs.values()),
          f"return codes after SIGTERM: {rcs}")
    spans = {k: read_spans(v) for k, v in traces.items()}
    roots = [r for r in spans["leecher"] if r["name"] == "peertask"]
    check(len(roots) == 1, f"{len(roots)} peertask spans, want 1")
    trace_id = roots[0]["trace_id"]
    joined = {name: [r for rows in spans.values() for r in rows
                     if r["name"] == name and r["trace_id"] == trace_id]
              for name in TRACE_CHAIN}
    check(all(joined.values()),
          f"spans of trace {trace_id} by name: "
          f"{ {n: len(v) for n, v in joined.items()} }")
    return {"file_bytes": size, "time_to_ready_s": run["wall"],
            "gbps": size / 1e9 / run["wall"],
            "spans": {k: len(v) for k, v in spans.items()},
            "trace_id": trace_id,
            "trace_spans": {n: len(v) for n, v in joined.items()},
            "upload_serve_spans_by_seed": len(joined["upload.serve"]),
            "slo_budgets_ms": summary["slo_budgets_ms"],
            "slo_breaches": summary["slo_breaches"],
            "leecher_loop_max_lag_s": run["health"]["loop"]["max_lag_s"],
            "seed_loop_max_lag_s": seed_health["loop"]["max_lag_s"],
            "ctrl_find": find, "ctrl_queue_wait_ms": ctrl["queue_wait_ms"],
            "ctrl_state_bytes": ctrl["state_bytes"],
            "route_s": routes, "return_codes": rcs}


def observe_mesh(device: torch.device) -> dict:
    """Phase 14 (b): the sharded step on the card's one-rank NCCL mesh
    against the single-device step, and ``train_mlp``'s mesh default on
    one card against phase 7's blob."""
    dev_arg = None if device.type == "cuda" else "cpu"
    t0 = time.monotonic()
    out = graft_entry.dryrun_multichip(1, device=dev_arg or "cuda")
    dryrun_s = time.monotonic() - t0
    check(out["mesh"] == {"dp": 1, "tp": 1}, f"mesh {out['mesh']}")
    losses = {"mlp": models.mlp_loss, "gnn": models.gnn_loss}
    single = {}
    with training.fit_numerics():
        for name, (tree, batch) in graft_entry.dryrun_inputs().items():
            model = models.params_from_numpy(tree).to(device)
            step = models.make_train_step(losses[name],
                                          models.make_optimizer(model))
            single[name] = float(step(model,
                                      models.batch_to_device(batch, device)))
    diffs = {}
    for name in losses:
        diffs[name] = abs(out[name]["loss"] - single[name])
        check(diffs[name] <= 1e-6 * abs(single[name]),
              f"{name}: sharded loss {out[name]['loss']} != single-device "
              f"{single[name]}")
    with open(FIXTURE) as f:
        rows = [json.loads(line) for line in f]
    fitted = pipeline.train_decision_model(rows, seed=7, use_mesh=True,
                                           device=dev_arg)
    check(fitted is not None and fitted[1]["devices"] == 1,
          f"train_mlp on one card: {fitted and fitted[1]['devices']} devices")
    if "fixture_seed_7" in FIT_BLOBS:
        check(fitted[0] == FIT_BLOBS["fixture_seed_7"],
              "the one-card mesh default did not give phase 7's blob")
    return {"mesh": out["mesh"], "dryrun_s": dryrun_s,
            "sharded_loss": {n: out[n]["loss"] for n in losses},
            "single_loss": single, "loss_abs_diff": diffs,
            "sharded_step_ms": {n: out[n]["step_ms"] for n in losses},
            "fit_devices": fitted[1]["devices"],
            "fit_version": fitted[1]["version"],
            "fit_equals_phase_7": "fixture_seed_7" in FIT_BLOBS}


def phase_observe(workdir: str, device: torch.device) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    old = tracing.TRACER
    tracing.TRACER = tracing.Tracer()
    tracing.configure = tracing.TRACER.configure
    try:
        pod = observe_pod(workdir, device)
    finally:
        # later work in this process inherits no tracer
        tracing.TRACER.flush()
        tracing.TRACER = old
        tracing.configure = old.configure
    phase_ns = disarmed_phase_ns()
    mesh = observe_mesh(device)
    emit("phase 14 observe and mesh", {
        **pod, "disarmed_phase_ns_per_call": phase_ns, **mesh,
        "phase_s": time.monotonic() - t_phase, "card": smi})


# --------------------------------------------------------------- phase 15

SUPERSEED = ("l1", "l2", "l3", "l4")
# the seed's upload rate: below the origin's 250 MB/s pace, so the limiter
# binds while the seed feeds its first child and the others pull from the
# seed's children instead
SUPERSEED_RATE_BPS = 200_000_000
SUPERSEED_UPLOAD_SLOTS = 4            # no one-slot limit: all four fit
SUPERSEED_SLICE_BYTES = 64 << 20      # the ranged request's lm_head slice
SUPERSEED_WAIT_S = 120.0              # bound on the prefetch's wait
# every daemon announces (and pulses) each second, cut from the default
# 30 s so the scheduler's fleet pulse holds a series of each during the
# fan-out
SUPERSEED_ANNOUNCE_S = 1.0
SUPERSEED_READ_WAIT_S = 30.0          # bound on the results' and rows' wait
# the daemons' and the scheduler's files, in the reference's key format
SUPERSEED_SEED_YAML = """\
is_seed: true
hostname: superseed-seed
host_ip: 127.0.0.1
listen_ip: 127.0.0.1
workdir: {workdir}
announce_interval_s: {announce}
scheduler:
  addresses:
    - {sched}
upload:
  rate_limit_bps: {rate}
  concurrent_limit: {slots}
download:
  piece_parallelism: 6
  piece_timeout_s: 30
  back_source_group_min_bytes: 4611686018427387904
"""
SUPERSEED_SCHED_YAML = """\
listen_ip: 127.0.0.1
port: {port}
cluster_id: 2
records_dir: {records}
"""
SUPERSEED_L5_YAML = """\
hostname: superseed-l5
host_ip: 127.0.0.1
listen_ip: 127.0.0.1
workdir: {workdir}
announce_interval_s: {announce}
scheduler:
  addresses:
    - {sched}
download:
  prefetch_whole_file: true
"""


def superseed_seed_child(workdir: str, yaml_path: str, conn) -> None:
    """Phase 15's seed, in a spawned process that never touches CUDA: its
    config is loaded from ``yaml_path`` (the reference's key format). The
    policy's reveals are tallied by cause from its state (the owners of
    each piece before and after each step). It sends its host, answers
    ``"count"`` with its upload byte count, serves until the parent says
    ``"stop"``, then sends what it served."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    asyncio.run(_superseed_seed_child(workdir, yaml_path, conn))


def _tally_reveals(policy_cls, reveals: dict) -> None:
    """Wrap the policy's steps to add each step's new (piece, child)
    assignments to ``reveals`` under its cause."""
    def owners(policy) -> int:
        return sum(len(o) for o in policy.assigned.values())

    def wrap(name, cause):
        real = getattr(policy_cls, name)

        def step(self, *args, **kw):
            before = owners(self)
            out = real(self, *args, **kw)
            c = cause(args, kw) if callable(cause) else cause
            reveals[c] = reveals.get(c, 0) + owners(self) - before
            return out
        setattr(policy_cls, name, step)

    # a rotation tick calls _offer with a target; a landing or a new child
    # calls it without (the fanout offer)
    wrap("_offer", lambda args, kw: "rotation" if (
        len(args) > 1 and args[1] is not None
        or kw.get("target") is not None) else "fanout")
    wrap("reveal_to", "starvation_ping")


async def _superseed_seed_child(workdir: str, yaml_path: str, conn) -> None:
    from dragonfly2_tpu_torch.common.config import load_config
    from dragonfly2_tpu_torch.daemon import rpcserver
    reveals: dict = {}
    _tally_reveals(rpcserver._SuperSeed, reveals)
    cfg = load_config(DaemonConfig, yaml_path, {"device": "cpu"})
    seed = Daemon(cfg)
    await seed.start()
    try:
        conn.send({"host": seed.host_info(),
                   "config": {"rate_limit_bps": cfg.upload.rate_limit_bps,
                              "concurrent_limit": cfg.upload.concurrent_limit,
                              "piece_parallelism":
                                  cfg.download.piece_parallelism,
                              "piece_timeout_s": cfg.download.piece_timeout_s,
                              "limiter_rate": seed.upload_server.limiter.rate,
                              "limiter_burst":
                                  seed.upload_server.limiter.burst,
                              "upload_slots":
                                  seed.upload_server.concurrent_limit}})
        uploaded = REGISTRY.counter("df_upload_bytes_total")
        while await asyncio.to_thread(conn.recv) == "count":
            conn.send({"upload_bytes": uploaded.value()})
        (c,) = [c for c in seed.ptm._conductors.values()
                if not c.url_meta.range]
        serves = [(t, nbytes, serve_ms, wait_ms)
                  for t, _p, _a, _n, nbytes, serve_ms, wait_ms, *_ in
                  c.flight.serves]
        conn.send({
            "peer_id": c.peer_id, "state": c.state,
            "traffic_source": c.traffic_source, "serves": serves,
            "reveals": dict(reveals),
            "relay_serves": dict(seed.upload_server.relay_serves),
            "upload_bytes": REGISTRY.counter("df_upload_bytes_total").value()})
    finally:
        await seed.stop()


def _record_sync_packets(seen: list):
    """Record (parent peer id, relay_nums, piece nums) of every piece-sync
    packet this process's leechers read; returns the undo."""
    from dragonfly2_tpu_torch.daemon import piece_engine
    real = piece_engine._Synchronizer._on_packet

    async def on_packet(self, packet):
        seen.append((self.parent.peer_id, packet.relay_nums,
                     [p.piece_num for p in packet.piece_infos or []]))
        return await real(self, packet)

    piece_engine._Synchronizer._on_packet = on_packet
    return lambda: setattr(piece_engine._Synchronizer, "_on_packet", real)


async def _ranged_get(daemon: Daemon, url: str, rng: tuple[int, int],
                      out: str) -> dict:
    """One ranged request through the daemon's local API; its frames'
    peer ids, its bytes and the daemon's conductors before and after."""
    before = len(daemon.ptm._conductors)
    t0 = time.monotonic()
    peers = []
    ch = Channel(f"unix:{daemon.unix_sock}")
    try:
        async for resp in ServiceClient(ch, "df.daemon.Daemon").unary_stream(
                "Download", DownloadRequest(
                    url=url, output=out, timeout_s=600.0,
                    url_meta=UrlMeta(range=f"bytes={rng[0]}-"
                                           f"{rng[0] + rng[1] - 1}"))):
            peers.append(resp.peer_id)
    finally:
        await ch.close()
    return {"peer_ids": sorted(set(peers)), "wall_s": time.monotonic() - t0,
            "new_conductors": len(daemon.ptm._conductors) - before}


def run_cli(main, argv: list[str]) -> tuple[int, str, float]:
    """A command-line tool's ``main`` in this process: (exit code, its
    standard output, wall seconds). Its logs stay on standard error."""
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue(), time.monotonic() - t0


async def _read_superseed_pod(sched: Scheduler, debug_port: int,
                              addrs: dict, seed_conn) -> dict:
    """The readers of the observability plane over the finished fan-out,
    each timed: podscope's sweep of the seed's and the leechers' upload
    ports, ``dfdiag --pod`` and ``dfdiag --fleet`` on the scheduler's
    debug routes, the scheduler's records (its ``kind=edge`` rows, dfsched
    over its file) and the fleet pulse's series. ``collect_pod`` and the
    tools block in ``urllib`` while the daemons serve on this loop: they
    run in threads."""
    records = sched.service.records
    out: dict = {}
    # the leechers' PeerResults (flight and edge rows) trail their pulls
    t0 = time.monotonic()
    while sum(r["kind"] == "flight" for r in records._peer_rows) \
            < len(SUPERSEED):
        check(time.monotonic() - t0 < SUPERSEED_READ_WAIT_S,
              "phase 15: the leechers' flight rows did not reach the "
              "scheduler's records")
        await asyncio.sleep(0.05)
    out["results_wait_s"] = time.monotonic() - t0
    seed_conn.send("count")
    out["seed_upload_bytes"] = (await asyncio.to_thread(
        seed_conn.recv))["upload_bytes"]
    t0 = time.monotonic()
    snaps = await asyncio.to_thread(podscope.collect_pod, list(addrs))
    out["sweep_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["report"] = podscope.aggregate(snaps)
    out["aggregate_s"] = time.monotonic() - t0
    out["dfdiag_pod"] = await asyncio.to_thread(
        run_cli, dfdiag.main, ["--pod", ",".join(addrs), "--json"])
    sch = f"127.0.0.1:{debug_port}"
    out["dfdiag_fleet"] = await asyncio.to_thread(
        run_cli, dfdiag.main, ["--fleet", "--scheduler", sch, "--json"])
    out["fleet_series"] = {
        hid: [smp["seq"] for smp in series.ring]
        for hid, series in sched.fleetpulse._series.items()}
    out["fleet_ingested"] = sched.fleetpulse.ingested
    out["edge_rows"] = [r for r in records._peer_rows
                        if r["kind"] == "edge"]
    # dfsched reads the records file: wait for its batches to land
    t0 = time.monotonic()
    while records._pending or (records._flush_task is not None
                               and not records._flush_task.done()):
        check(time.monotonic() - t0 < SUPERSEED_READ_WAIT_S,
              "phase 15: the records file was not flushed")
        await asyncio.sleep(0.05)
    out["dfsched_stats"] = await asyncio.to_thread(
        run_cli, dfsched.main, ["--records", records.records_dir,
                                "--stats"])
    t0 = time.monotonic()
    out["coverage"] = stitch_outcomes(
        dfsched.load_rows(records.records_dir))["coverage"]
    out["stitch_s"] = time.monotonic() - t0
    return out


async def _superseed_pod(workdir: str, seed_host: Host, url: str,
                         manifest: ShardManifest, origin_conn, seed_conn,
                         sched_port: int, ranges: dict) -> dict:
    """A scheduler (cluster 2, default upload limits, records kept) and
    leechers L1-L4 here, started together; then the readers of the
    observability plane; then L1's ranged reuse and L5's prefetch."""
    from dragonfly2_tpu_torch.common.config import load_config
    sched_yaml = os.path.join(workdir, "scheduler.yaml")
    with open(sched_yaml, "w") as f:
        f.write(SUPERSEED_SCHED_YAML.format(
            port=sched_port, records=os.path.join(workdir, "records")))
    sched = Scheduler(load_config(SchedCfg, sched_yaml, {"seed_peers": [{
        "host_id": seed_host.id, "ip": seed_host.ip,
        "rpc_port": seed_host.port,
        "download_port": seed_host.download_port}]}))
    await sched.start()
    sched.resource.store_host(seed_host)
    # the scheduler's debug routes, mounted as its launcher mounts them
    debug = await start_debug_server(
        "127.0.0.1", 0,
        extra_routes=lambda router: add_scheduler_routes(router, sched))
    # the seed's first announce to land replays what it holds: wait for
    # it before the rollout starts, as a seed is up before a rollout in a
    # deployment (landing after the seed's pull began, it replays partial
    # holdings and the scheduler adopts a second, "-recov-" peer on the
    # seed's host, which leechers then pull from)
    t0 = time.monotonic()
    while seed_host.id not in sched.fleetpulse._series:
        check(time.monotonic() - t0 < SUPERSEED_READ_WAIT_S,
              "phase 15: the seed's first announce did not arrive")
        await asyncio.sleep(0.02)
    daemons = {n: Daemon(DaemonConfig(
        workdir=os.path.join(workdir, n), hostname=f"superseed-{n}",
        listen_ip="127.0.0.1", host_ip="127.0.0.1",
        announce_interval_s=SUPERSEED_ANNOUNCE_S,
        scheduler=SchedulerConfig(addresses=[sched.address])))
        for n in SUPERSEED}
    l5 = None
    seen: list = []
    undo = _record_sync_packets(seen)
    out: dict = {"cluster_id": sched.cfg.cluster_id, "packets": seen}
    try:
        for d in daemons.values():
            await d.start()
        pulls = [_leecher_pull(daemons[n], url, UrlMeta(), manifest, {})
                 for n in SUPERSEED]
        runs = dict(zip(SUPERSEED, await asyncio.gather(*pulls)))
        out["runs"] = runs
        out["peers"] = {n: r["conductor"].peer_id for n, r in runs.items()}
        out["hosts"] = {n: d.host_info().id for n, d in daemons.items()}
        out["addrs"] = {f"127.0.0.1:{d.upload_server.port}": n
                        for n, d in daemons.items()}
        addrs = {f"{seed_host.ip}:{seed_host.download_port}": "seed",
                 **out["addrs"]}
        out["readers"] = await _read_superseed_pod(sched, debug.port, addrs,
                                                   seed_conn)
        for n in SUPERSEED:
            runs[n]["per_parent"] = runs[n]["conductor"].flight.summarize()[
                "per_parent"]
        # the main pull's origin tally, before the ranged requests
        origin_conn.send("report")
        out["origin"] = await asyncio.to_thread(origin_conn.recv)
        # L1 holds the whole file: ranges of it are read from its disk
        l1 = daemons["l1"]
        reuse = {}
        for name, rng in ranges.items():
            reuse[name] = await _ranged_get(
                l1, url, rng, os.path.join(workdir, f"l1-{name}.bin"))
        origin_conn.send("report")
        out["l1_reuse"] = reuse
        out["l1_reuse_origin"] = await asyncio.to_thread(origin_conn.recv)
        # L5: prefetch_whole_file; its first range starts the whole file
        l5_yaml = os.path.join(workdir, "l5.yaml")
        with open(l5_yaml, "w") as f:
            f.write(SUPERSEED_L5_YAML.format(
                workdir=os.path.join(workdir, "l5"), sched=sched.address,
                announce=SUPERSEED_ANNOUNCE_S))
        l5 = Daemon(load_config(DaemonConfig, l5_yaml))
        await l5.start()
        rng = ranges["lm_head_slice"]
        first = await _ranged_get(l5, url, rng,
                                  os.path.join(workdir, "l5-first.bin"))
        parent = l5.ptm._task_id(url, UrlMeta())
        t0 = time.monotonic()
        while l5.storage_mgr.find_completed_task(parent) is None:
            check(time.monotonic() - t0 < SUPERSEED_WAIT_S,
                  f"phase 15 L5: the whole-file prefetch did not finish in "
                  f"{SUPERSEED_WAIT_S:.0f} s")
            await asyncio.sleep(0.05)
        prefetch_s = time.monotonic() - t0
        origin_conn.send("report")
        first_origin = await asyncio.to_thread(origin_conn.recv)
        repeat = await _ranged_get(l5, url, rng,
                                   os.path.join(workdir, "l5-repeat.bin"))
        origin_conn.send("report")
        out["l5"] = {"prefetch_enabled": l5.ptm.prefetch_whole_file,
                     "first": first, "repeat": repeat,
                     "prefetch_wait_s": prefetch_s,
                     "first_origin_bytes": first_origin["body_bytes"],
                     "repeat_origin": await asyncio.to_thread(
                         origin_conn.recv)}
        for n, d in daemons.items():
            runs[n]["flight"] = d.flight_recorder.get(
                runs[n]["conductor"].task_id)
            runs[n].update(relay_stats(d))
        return out
    finally:
        undo()
        for d in list(daemons.values()) + ([l5] if l5 is not None else []):
            await d.stop()
        await debug.stop()
        await sched.stop()


def check_superseed_readers(pod: dict, seed_stats: dict, seed_host: Host,
                            size: int, chain_depth: int) -> dict:
    """Hold the readers' account of phase 15's fan-out to what the phase
    measured itself; returns what the phase line prints of it."""
    rd = pod["readers"]
    seed_addr = f"{seed_host.ip}:{seed_host.download_port}"
    names = {seed_addr: "seed", **pod["addrs"]}
    runs = pod["runs"]
    report = rd["report"]
    (task_id,) = {r["conductor"].task_id for r in runs.values()}
    check(list(report["tasks"]) == [task_id] and not report["unreachable"],
          f"phase 15 podscope: tasks {list(report['tasks'])}, unreachable "
          f"{report['unreachable']}")
    task = report["tasks"][task_id]
    # the tree: each leecher hangs off the parent that gave it the most
    # pieces (pieces_by_parent; a tie admits either), and the depth
    # follows from it as podscope counts it (origin 0, seed 1)
    tree = {names[dst]: names.get(src, src)
            for dst, src in task["tree"].items()}
    peer_name = {p: n for n, p in pod["peers"].items()}
    peer_name[seed_stats["peer_id"]] = "seed"
    for n in SUPERSEED:
        by = {peer_name.get(p, p): k for p, k in
              runs[n]["conductor"].pieces_by_parent.items()}
        top = max(by.values())
        check(tree.get(n) in {p for p, k in by.items() if k == top},
              f"phase 15 podscope: {n} hangs off {tree.get(n)}, its "
              f"pieces came from {by}")
    check(tree.get("seed") == "origin",
          f"phase 15 podscope: the seed hangs off {tree.get('seed')}")

    def tree_depth(n: str, seen: frozenset = frozenset()) -> int:
        if n == "origin":
            return 0
        if n in seen:
            return 1
        return tree_depth(tree[n], seen | {n}) + 1 if n in tree else 1
    own = max(tree_depth(n) for n in ("seed", *SUPERSEED))
    check(task["depth"] == own and own <= chain_depth,
          f"phase 15 podscope depth {task['depth']}, the phase's tree "
          f"{own}, its longest chain {chain_depth}")
    check(task["amplification"] == 1.0 and task["origin_bytes"] == size
          and task["content_length"] == size,
          f"phase 15 podscope: amplification {task['amplification']}, "
          f"origin bytes {task['origin_bytes']}, content "
          f"{task['content_length']}")
    check(task["daemons"] == task["complete"] == 1 + len(SUPERSEED),
          f"phase 15 podscope: {task['complete']}/{task['daemons']} "
          f"complete")
    edge_in = {n: 0 for n in SUPERSEED}
    for e in task["edges"]:
        if names.get(e["dst"]) in edge_in:
            edge_in[names[e["dst"]]] += e["bytes"]
    for n in SUPERSEED:
        check(edge_in[n] == runs[n]["conductor"].traffic_p2p,
              f"phase 15 podscope: {n}'s incoming edges carry "
              f"{edge_in[n]} bytes, its traffic_p2p "
              f"{runs[n]['conductor'].traffic_p2p}")
    su = task["seed_uplink"] or {}
    check(su.get("node") == seed_addr
          and su.get("bytes") == rd["seed_upload_bytes"],
          f"phase 15 podscope: seed uplink {su}, the seed uploaded "
          f"{rd['seed_upload_bytes']} bytes")
    # dfdiag --pod gives the same report, and exits on its breaches
    rc, text, pod_s = rd["dfdiag_pod"]
    via_cli = json.loads(text)
    check(_jsonable(via_cli["tasks"]) == _jsonable(report["tasks"])
          and rc == (3 if via_cli["breaches"] else 0),
          f"phase 15 dfdiag --pod: exit {rc}, breaches "
          f"{via_cli['breaches']}, tasks equal "
          f"{_jsonable(via_cli['tasks']) == _jsonable(report['tasks'])}")
    # one kind=edge row per (leecher, parent) of its flight summary
    for n in SUPERSEED:
        got = sorted((r["src_peer_id"], r["bytes"]) for r in rd["edge_rows"]
                     if r["dst_peer_id"] == pod["peers"][n])
        want = sorted((p or "origin", v["bytes"])
                      for p, v in runs[n]["per_parent"].items())
        check(got == want, f"phase 15 records: {n}'s edge rows {got}, its "
                           f"flight's parents {want}")
    # a series per host, its pulse seq rising; dfdiag's exit follows the
    # snapshot's active episodes
    hosts = {"seed": seed_host.id, **pod["hosts"]}
    series = rd["fleet_series"]
    for n, hid in hosts.items():
        seqs = series.get(hid, [])
        check(len(seqs) >= 2 and all(a < b for a, b in zip(seqs, seqs[1:])),
              f"phase 15 fleet pulse: {n}'s series {seqs}")
    rc, text, fleet_s = rd["dfdiag_fleet"]
    fleet = json.loads(text)
    check(rd["fleet_ingested"] > 0 and fleet["daemons"] >= len(hosts)
          and rc == (3 if fleet["active"] else 0),
          f"phase 15 dfdiag --fleet: exit {rc}, active {fleet['active']}, "
          f"daemons {fleet['daemons']}, ingested {fleet['ingested']}")
    rc, stats_text, dfsched_s = rd["dfsched_stats"]
    cov = rd["coverage"]
    check(rc == 0 and cov["piece_rows"] > 0 and cov["ratio"] >= 0.95,
          f"phase 15 dfsched: exit {rc}, coverage {cov}")
    summary = podscope.bench_summary(task)
    return {
        "podscope": {
            "depth": task["depth"], "amplification": task["amplification"],
            "makespan_ms": task["makespan_ms"], "edges": len(task["edges"]),
            "edge_bandwidth_bps": summary["edge_bandwidth_bps"],
            "edge_wire_ms": summary["edge_wire_ms"],
            "tree": tree, "seed_uplink": {**su, "node": "seed"},
            "incoming_edge_bytes": edge_in,
            "bottleneck": task["bottleneck"] and {
                **task["bottleneck"],
                "src": names.get(task["bottleneck"]["src"],
                                 task["bottleneck"]["src"]),
                "dst": names.get(task["bottleneck"]["dst"],
                                 task["bottleneck"]["dst"])},
            "relay": task["relay"],
            "breaches": report["breaches"], "verdict": report["verdict"]},
        "fleet_pulse": {
            "daemons": fleet["daemons"], "ingested": fleet["ingested"],
            "samples": fleet["samples"],
            "series": {n: len(series[hid]) for n, hid in hosts.items()},
            "seq_last": {n: series[hid][-1] for n, hid in hosts.items()},
            "active": fleet["active"], "dfdiag_exit": rc,
            "anomalies": [(a["anomaly"], a["host_id"], a["signal"],
                           a["value"]) for a in fleet["recent_anomalies"]],
            "lag_max_ms": fleet["fleet"]["loop_lag_max_ms"]},
        "records": {"edge_rows": len(rd["edge_rows"]),
                    "dfsched_coverage": cov,
                    "dfsched_stats": stats_text.strip().splitlines()},
        "reader_s": {"results_wait": rd["results_wait_s"],
                     "podscope_sweep": rd["sweep_s"],
                     "podscope_aggregate": rd["aggregate_s"],
                     "dfdiag_pod": pod_s, "dfdiag_fleet": fleet_s,
                     "dfsched_stats": dfsched_s,
                     "stitch_outcomes": rd["stitch_s"]},
    }


def phase_superseed(workdir: str, device: torch.device) -> None:
    """Phase 15: a super-seeded fan-out of phase 8's origin over HTTP into
    four leechers' device memory, then ranged reuse from disk."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    path = os.path.join(workdir, "deploy", "model-00004-of-00004.safetensors")
    name = os.path.basename(path)
    layout = deploy_layout()
    header, _ = safetensors_header(layout)
    size = os.path.getsize(path)
    d = os.path.join(workdir, "superseed")
    os.makedirs(d, exist_ok=True)
    free = shutil.disk_usage(workdir).free
    need = 6 * size + (1 << 30)
    check(free >= need, f"phase 15 needs {need} bytes of free disk for the "
                        f"seed's and five leechers' copies, {free} free")
    manifest = manifest_from_file(path)
    shard = {s.name: s for s in manifest.shards}
    norm, head = shard["model.norm.weight"], shard["lm_head.weight"]
    ranges = {"norm": (norm.range_start, norm.range_size),
              "lm_head_slice": (head.range_start + head.range_size // 2,
                                SUPERSEED_SLICE_BYTES)}
    with open(path, "rb") as f:
        f.seek(len(header))
        ref = torch.frombuffer(bytearray(f.read()), dtype=torch.uint8).to(
            device)
    with socket.socket() as sock:          # the scheduler's port, known
        sock.bind(("127.0.0.1", 0))        # to the seed, which announces
        sched_port = sock.getsockname()[1]
    seed_yaml = os.path.join(d, "seed.yaml")
    with open(seed_yaml, "w") as f:
        f.write(SUPERSEED_SEED_YAML.format(
            workdir=os.path.join(d, "seed"), rate=SUPERSEED_RATE_BPS,
            slots=SUPERSEED_UPLOAD_SLOTS, announce=SUPERSEED_ANNOUNCE_S,
            sched=f"127.0.0.1:{sched_port}"))
    ctx = multiprocessing.get_context("spawn")
    origin_conn, o_child = ctx.Pipe()
    seed_conn, s_child = ctx.Pipe()
    origin = ctx.Process(target=http_origin_child,
                         name="smoke-superseed-origin",
                         args=(path, CHAIN_PACE_BPS, o_child))
    seed = ctx.Process(target=superseed_seed_child,
                       name="smoke-superseed-seed",
                       args=(d, seed_yaml, s_child))
    origin.start()
    seed.start()
    try:
        check(origin_conn.poll(120), "phase 15 origin did not start")
        url = f"http://127.0.0.1:{origin_conn.recv()['port']}/{name}"
        check(seed_conn.poll(300), "phase 15 seed did not start")
        hello = seed_conn.recv()
        seed_host, seed_cfg = hello["host"], hello["config"]
        pod = asyncio.run(_superseed_pod(d, seed_host, url, manifest,
                                         origin_conn, seed_conn, sched_port,
                                         ranges))
        seed_conn.send("stop")
        check(seed_conn.poll(300), "phase 15 seed did not report")
        seed_stats = seed_conn.recv()
    finally:
        for conn in (seed_conn, origin_conn):
            try:
                conn.send("stop")      # a no-op for a child already gone
            except OSError:
                pass
        for proc in (seed, origin):
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=30)
    check(seed.exitcode == 0, f"phase 15 seed exited {seed.exitcode}")
    base, shapes = len(header), dict(layout)
    runs, peers = pod["runs"], pod["peers"]
    names = {pid: n for n, pid in peers.items()}
    names[seed_stats["peer_id"]] = "seed"
    leechers = {}
    for n in SUPERSEED:
        run = runs[n]
        c, tensors = run["conductor"], run["out"]
        for info in manifest.shards:
            t = tensors[info.name]
            lo = info.range_start - base
            check(t.device == device and t.dtype == torch.bfloat16
                  and list(t.shape) == shapes[info.name]
                  and torch.equal(t.reshape(-1).view(torch.uint8),
                                  ref[lo:lo + info.range_size]),
                  f"phase 15 {n}: {info.name} differs from the origin")
        check(c.traffic_source == 0 and c.traffic_p2p == size,
              f"phase 15 {n}: p2p {c.traffic_p2p}, source "
              f"{c.traffic_source}")
        check_crc32c(c.storage.md, f"phase 15 {n}")
        total = sum(c.pieces_by_parent.values())
        from_seed = c.pieces_by_parent.get(seed_stats["peer_id"], 0)
        leechers[n] = {
            "time_to_ready_s": run["wall"],
            "pieces_from": {names.get(p, p): k
                            for p, k in c.pieces_by_parent.items()},
            "seed_share": from_seed / total if total else 0.0,
            "relay_serves": run["relay_serves"]}
        del tensors, run["out"]
    # the origin sent each byte once, and only to the seed
    origin_t = pod["origin"]
    spans = sorted(origin_t["ranges"])
    covered = 0
    for lo, hi in spans:
        check(lo == covered, f"phase 15 origin ranges overlap or leave a "
                             f"hole at {covered}: {spans[:8]}")
        covered = hi
    check(covered == size and origin_t["body_bytes"] == size
          and seed_stats["traffic_source"] == size,
          f"phase 15 origin sent {origin_t['body_bytes']} bytes over "
          f"{covered}, seed took {seed_stats['traffic_source']}, file "
          f"{size}")
    # the seed announced landed pieces only: no relay_nums on its streams
    seed_packets = [(nums, pieces) for p, nums, pieces in pod["packets"]
                    if p == seed_stats["peer_id"]]
    check(seed_packets and all(nums is None for nums, _ in seed_packets),
          f"phase 15: {sum(1 for nums, _ in seed_packets if nums)} of "
          f"{len(seed_packets)} seed packets carry relay_nums")
    ahead_from_leechers = sum(1 for p, nums, _ in pod["packets"]
                              if nums and p != seed_stats["peer_id"])
    ratio = seed_stats["upload_bytes"] / size
    check(ratio < len(SUPERSEED),
          f"phase 15: seed uplink ratio {ratio:.3f}, a star's is "
          f"{len(SUPERSEED)}")
    # the serve rate over the seed's serving window: at most the limit
    # plus the bucket's burst (serve rows end at t, took serve_ms)
    serves = seed_stats["serves"]
    check(serves, "phase 15: the seed journaled no serve")
    w0 = min(t - s_ms for t, _, s_ms, _ in serves) / 1000.0
    w1 = max(t for t, _, _, _ in serves) / 1000.0
    served = sum(b for _, b, _, _ in serves)
    allowed = seed_cfg["limiter_rate"] * (w1 - w0) + seed_cfg["limiter_burst"]
    check(served <= allowed,
          f"phase 15: the seed served {served} bytes in {w1 - w0:.3f} s, "
          f"more than the limit allows ({allowed:.0f})")
    waits = sum(w for _, _, _, w in serves)
    check(waits > 0, "phase 15: the seed's rate limit never held a serve")
    # L1's ranged requests, read from its disk
    for rname, (lo, length) in ranges.items():
        got = pod["l1_reuse"][rname]
        with open(os.path.join(d, f"l1-{rname}.bin"), "rb") as f:
            data = f.read()
        want = ref[lo - base:lo - base + length].cpu().numpy().tobytes()
        check(got["peer_ids"] == ["reused"] and got["new_conductors"] == 0
              and data == want,
              f"phase 15 L1 range {rname}: peer ids {got['peer_ids']}, "
              f"{got['new_conductors']} new pulls, bytes "
              f"{'equal' if data == want else 'differ'}")
    check(pod["l1_reuse_origin"]["body_bytes"] == 0,
          f"phase 15 L1 ranges: origin sent "
          f"{pod['l1_reuse_origin']['body_bytes']} bytes")
    l5 = pod["l5"]
    lo, length = ranges["lm_head_slice"]
    want = ref[lo - base:lo - base + length].cpu().numpy().tobytes()
    for step in ("first", "repeat"):
        with open(os.path.join(d, f"l5-{step}.bin"), "rb") as f:
            check(f.read() == want, f"phase 15 L5 {step} range differs")
    check(l5["prefetch_enabled"] and l5["first"]["peer_ids"] != ["reused"],
          f"phase 15 L5 first range: {l5['first']}")
    check(l5["repeat"]["peer_ids"] == ["reused"]
          and l5["repeat"]["new_conductors"] == 0
          and l5["repeat_origin"]["body_bytes"] == 0,
          f"phase 15 L5 repeat: {l5['repeat']}, origin "
          f"{l5['repeat_origin']['body_bytes']} bytes")
    del ref
    # hops from the origin: the seed 1, a leecher one more than its parent
    # on the longest path from the seed that visits no daemon twice (two
    # leechers may each have taken pieces from the other)
    def hops(n: str, seen: tuple) -> int:
        ups = [p for p in leechers[n]["pieces_from"]
               if p in SUPERSEED and p not in seen]
        return 1 + max([hops(p, seen + (p,)) for p in ups] or [1])
    depth = {"seed": 1, **{n: hops(n, (n,)) for n in SUPERSEED}}
    readers = check_superseed_readers(pod, seed_stats, seed_host, size,
                                      max(depth.values()))
    shutil.rmtree(d, ignore_errors=True)
    ends = [r["t0"] + r["wall"] for r in runs.values()]
    t0 = origin_t["first_byte_at"]
    emit("phase 15 superseed", {
        "file_bytes": size, "origin_pace_bytes_per_s": CHAIN_PACE_BPS,
        "scheduler_cluster_id": pod["cluster_id"],
        "seed_config": seed_cfg,
        "time_to_ready_s": {n: leechers[n]["time_to_ready_s"]
                            for n in SUPERSEED},
        "makespan_s": max(ends) - t0,
        "seed_uplink_ratio": ratio,
        "seed_serve_window_s": w1 - w0,
        "seed_served_bytes": served,
        "seed_serve_rate_bytes_per_s": served / max(w1 - w0, 1e-9),
        "seed_limiter_wait_ms": waits,
        "seed_share_of_pieces": {n: leechers[n]["seed_share"]
                                 for n in SUPERSEED},
        "largest_seed_share": max(v["seed_share"]
                                  for v in leechers.values()),
        "reveals_by_cause": seed_stats["reveals"],
        "seed_packets": len(seed_packets),
        "leecher_packets_announcing_ahead": ahead_from_leechers,
        "chain_depth": max(depth.values()), "hops_from_origin": depth,
        "pieces_by_parent": {n: leechers[n]["pieces_from"]
                             for n in SUPERSEED},
        "relay_serves": {n: leechers[n]["relay_serves"] for n in SUPERSEED},
        "seed_relay_serves": seed_stats["relay_serves"],
        "l1_ranged_reuse_s": {k: v["wall_s"]
                              for k, v in pod["l1_reuse"].items()},
        "l5_first_range_s": l5["first"]["wall_s"],
        "l5_first_range_origin_bytes": l5["first_origin_bytes"],
        "l5_prefetch_wait_s": l5["prefetch_wait_s"],
        "l5_repeat_range_s": l5["repeat"]["wall_s"],
        "announce_interval_s": SUPERSEED_ANNOUNCE_S,
        "announce_interval_cut_from_s": 30.0, **readers,
        "phase_s": time.monotonic() - t_phase, "card": smi})


# ---------------------------------------------------------------- phase 16

POISON = ("l1", "l2", "l3", "l4")
# every daemon announces and gossips each second (cut from 30 s and 5 s,
# as the line states), and S1 snapshots its state every 0.5 s when dirty
POISON_ANNOUNCE_S = 1.0
POISON_PEX_S = 1.0
POISON_SNAPSHOT_S = 0.5
POISON_WAIT_S = 30.0          # bound on each wait for a verdict or a row
# the reference's bound on the registry's evidence: corrupt verdicts per
# child (the local shun at 2, plus the transfers in flight at the flip)
POISON_EVIDENCE_PER_CHILD = 6


def poison_daemon_cfg(workdir: str, name: str, sched_addr: str,
                      **kw) -> DaemonConfig:
    """Phase 16's daemons: one scheduler address, the cut cadences."""
    cfg = DaemonConfig(workdir=os.path.join(workdir, name),
                       hostname=f"poison-{name}", listen_ip="127.0.0.1",
                       host_ip="127.0.0.1",
                       scheduler=SchedulerConfig(addresses=[sched_addr]),
                       **kw)
    cfg.announce_interval_s = POISON_ANNOUNCE_S
    cfg.pex.interval_s = POISON_PEX_S
    return cfg


def poison_sched_cfg(port: int, seed_host: Host, state_dir: str,
                     records_dir: str = "") -> SchedCfg:
    """S1 and S2: the reference's defaults (the quarantine registry on),
    plus a state store under ``state_dir`` and, for S1, records."""
    return SchedCfg(
        listen_ip="127.0.0.1", port=port, records_dir=records_dir,
        statestore_dir=state_dir, statestore_interval_s=POISON_SNAPSHOT_S,
        statestore_handoff=False,
        seed_peers=[SeedPeerAddr(host_id=seed_host.id, ip=seed_host.ip,
                                 rpc_port=seed_host.port,
                                 download_port=seed_host.download_port)])


def poison_sched_state(sched: Scheduler) -> dict:
    """What phase 16 reads of a scheduler: the quarantine ladder, its
    decision rows, each fleet-pulse series' cumulative corrupt counts and
    the quarantine component of the snapshot on disk."""
    snap = None
    if os.path.exists(sched.statestore.path):
        with open(sched.statestore.path) as f:
            snap = json.load(f)["components"]["quarantine"]
    return {
        "quarantine": sched.quarantine.snapshot(),
        "rows": [r for r in sched.ledger._ring
                 if r.get("decision_kind") == "quarantine"],
        "fleet": {hid: [smp["corrupt"] for smp in series.ring]
                  for hid, series in sched.fleetpulse._series.items()},
        "snapshot": snap}


def poison_sched_child(port: int, seed_host: Host, state_dir: str,
                       records_dir: str, conn) -> None:
    """Scheduler S1 of phase 16, in a spawned process the parent ends with
    SIGKILL. It answers each "state" with ``poison_sched_state``."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    asyncio.run(_poison_sched_child(port, seed_host, state_dir, records_dir,
                                    conn))


async def _poison_sched_child(port: int, seed_host: Host, state_dir: str,
                              records_dir: str, conn) -> None:
    sched = Scheduler(poison_sched_cfg(port, seed_host, state_dir,
                                       records_dir))
    await sched.start()
    conn.send({"epoch": sched.service.epoch, "started": time.time()})
    while True:
        msg = await asyncio.to_thread(conn.recv)
        if msg == "state":
            conn.send(poison_sched_state(sched))


def poisoner_child(workdir: str, sched_addr: str, url: str, conn) -> None:
    """The poisoner P of phase 16, in a spawned process that never touches
    CUDA: it pulls the file clean through S1, then arms the corrupt script
    on its own host key, so every range it serves carries a flipped byte.
    It sends its host, address and peer id, serves until the parent says
    "stop", then sends the faults fired."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    asyncio.run(_poisoner_child(workdir, sched_addr, url, conn))


async def _poisoner_child(workdir: str, sched_addr: str, url: str,
                          conn) -> None:
    from dragonfly2_tpu_torch.common import faultgate
    d = Daemon(poison_daemon_cfg(workdir, "p", sched_addr, device="cpu"))
    await d.start()
    try:
        t0 = time.monotonic()
        task_id = None
        async for resp in d.ptm.start_file_task(DownloadRequest(
                url=url, disable_back_source=True, timeout_s=1200.0)):
            task_id = resp.task_id or task_id
        c = d.ptm.conductor(task_id)
        host = d.host_info()
        faultgate.arm_script(f"upload.serve@{host.id}=corrupt:n=-1")
        conn.send({"host": host, "peer_id": c.peer_id, "state": c.state,
                   "traffic_source": c.traffic_source,
                   "addr": f"127.0.0.1:{d.upload_server.port}",
                   "pull_s": time.monotonic() - t0})
        await asyncio.to_thread(conn.recv)      # the parent is done
        conn.send({"faults": faultgate.status()})
    finally:
        await d.stop()


def _wait(what: str, cond, limit: float = POISON_WAIT_S) -> float:
    """Poll ``cond()`` (which may block) until it holds; the seconds."""
    t0 = time.monotonic()
    while not cond():
        check(time.monotonic() - t0 < limit,
              f"{what} not within {limit:.0f} s")
        time.sleep(0.1)
    return time.monotonic() - t0


def _ask(conn, msg: str, timeout: float = 60.0):
    conn.send(msg)
    check(conn.poll(timeout), f"no answer to {msg!r}")
    return conn.recv()


async def _poison_run(workdir: str, url: str, manifest: ShardManifest,
                      sched_port: int, seed_host: Host, state_dir: str,
                      records_dir: str, poison: dict, s1, s1_conn,
                      origin_conn) -> dict:
    """L1-L4 here, started together, pull through S1 while P serves
    corrupt bytes; each leecher's verdicts, pulses and podscope are read;
    S1 is SIGKILLed once its snapshot holds P, S2 starts on its port over
    its state directory, the origin stops and a fresh L5 pulls through
    S2. L1-L4 serve throughout."""
    sched_addr = f"127.0.0.1:{sched_port}"
    daemons = {n: Daemon(poison_daemon_cfg(workdir, n, sched_addr))
               for n in POISON}
    phost, paddr = poison["host"].id, poison["addr"]
    out: dict = {}
    s2 = l5 = None
    try:
        for d in daemons.values():
            await d.start()
        out["start_wall"] = time.time()
        runs = await asyncio.gather(*(
            _leecher_pull(daemons[n], url, UrlMeta(), manifest, {})
            for n in POISON))
        out["runs"] = dict(zip(POISON, runs))
        task_id = runs[0]["conductor"].task_id

        async def verdicts() -> dict:
            got = {}
            for n, d in daemons.items():
                status, body = await _http_json(d.upload_server.port,
                                                "/debug/verdicts")
                check(status == 200, f"phase 16 {n} /debug/verdicts: "
                                     f"{status}")
                got[n] = body["parents"].get(paddr)
            return got

        # a leecher the pod-wide quarantine spared before its second
        # corrupt piece learns of P from its siblings' digests (suspects):
        # a gossip round or two later it too orders P last
        t0 = time.monotonic()
        while True:
            seen = await verdicts()
            if all(v is not None and (v["shunned"] or v["deprioritized"])
                   for v in seen.values()):
                break
            check(time.monotonic() - t0 < POISON_WAIT_S,
                  f"phase 16: not every leecher's /debug/verdicts names P: "
                  f"{seen}")
            await asyncio.sleep(0.2)
        out["verdicts"] = seen
        out["verdicts_wait_s"] = time.monotonic() - t0
        out["pulses"] = {n: pulse_mod.build_pulse(d, 0).corrupt_verdicts
                         for n, d in daemons.items()}
        out["hosts"] = {n: d.host_info().id for n, d in daemons.items()}
        addrs = [f"127.0.0.1:{d.upload_server.port}"
                 for d in daemons.values()]
        snaps = await asyncio.to_thread(podscope.collect_pod, addrs,
                                        timeout_s=10.0)
        out["podscope"] = podscope.aggregate(snaps)["quarantine"]
        for run in out["runs"].values():
            s = run["conductor"].flight.summarize()
            run["corrupt_pieces"] = sum((s.get("corrupt_pieces")
                                         or {}).values())
        # the pulses of the last announces reach S1's fleet pulse
        await asyncio.sleep(2 * POISON_ANNOUNCE_S)
        out["s1"] = await asyncio.to_thread(_ask, s1_conn, "state")
        # the verdict must be on disk before the crash: the snapshot
        # ticker persists the quarantine transition
        out["snapshot_wait_s"] = await asyncio.to_thread(
            _wait, "phase 16: S1's snapshot holding P quarantined",
            lambda: ((_ask(s1_conn, "state")["snapshot"] or {})
                     .get("hosts", {}).get(phost, {}).get("state")
                     in ("quarantined", "probation")))
        # the records' rows reach download.jsonl on the age flush
        rec_path = os.path.join(records_dir, "download.jsonl")

        def record_rows() -> list:
            if not os.path.exists(rec_path):
                return []
            with open(rec_path) as f:
                rows = [json.loads(line) for line in f if line.strip()]
            return [r for r in rows
                    if r.get("decision_kind") == "quarantine"]
        await asyncio.to_thread(
            _wait, "phase 16: quarantine rows in S1's records",
            lambda: any(r["host_id"] == phost
                        and r["to_state"] == "quarantined"
                        for r in record_rows()))
        out["records_rows"] = record_rows()

        os.kill(s1.pid, signal.SIGKILL)
        await asyncio.to_thread(s1.join, 30)
        check(not s1.is_alive(), "phase 16: S1 survived SIGKILL")
        s2 = Scheduler(poison_sched_cfg(sched_port, seed_host, state_dir))
        t_start = time.time()
        await s2.start()
        out["restore_s"] = time.time() - t_start
        out["provenance"] = s2.statestore.provenance
        # before any fresh evidence: the ladder came back from disk
        out["p_state_at_start"] = s2.quarantine.state(phost)
        out["recovery_rows"] = [r for r in s2.ledger._ring
                                if r.get("decision_kind") == "recovery"]
        origin_conn.send("report")
        out["origin"] = await asyncio.to_thread(origin_conn.recv)
        origin_conn.send("stop")
        want = {seed_host.id, *out["hosts"].values()}
        t0 = time.monotonic()
        while not _holders(s2, task_id) >= want:
            check(time.monotonic() - t0 < POISON_WAIT_S,
                  f"phase 16: S2 holders {_holders(s2, task_id)}, want "
                  f"{want}")
            await asyncio.sleep(0.02)
        out["reannounce_s"] = time.monotonic() - t0
        l5 = Daemon(poison_daemon_cfg(workdir, "l5", s2.address))
        await l5.start()
        run = await _leecher_pull(l5, url, UrlMeta(), manifest, {})
        s = run["conductor"].flight.summarize()
        run["corrupt_pieces"] = sum((s.get("corrupt_pieces")
                                     or {}).values())
        out["runs"]["l5"] = run
        finds = [r for r in s2.ledger._ring
                 if r.get("decision_kind") in ("find", "refresh")]
        check(finds, "phase 16: S2 made no ruling")
        out["restore_to_first_ruling_s"] = finds[0]["created_at"] - t_start
        out["p_state_at_end"] = s2.quarantine.state(phost)
        return out
    finally:
        if l5 is not None:
            await l5.stop()
        for d in daemons.values():
            await d.stop()
        if s2 is not None:
            await s2.stop()


def phase_poison(workdir: str, device: torch.device) -> None:
    """Phase 16: a poisoned pod and a scheduler restart, on phase 8's
    origin over HTTP."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    path = os.path.join(workdir, "deploy", "model-00004-of-00004.safetensors")
    name = os.path.basename(path)
    layout = deploy_layout()
    header, _ = safetensors_header(layout)
    size = os.path.getsize(path)
    d = os.path.join(workdir, "poison")
    os.makedirs(d, exist_ok=True)
    free = shutil.disk_usage(workdir).free
    need = 7 * size + (1 << 30)
    check(free >= need, f"phase 16 needs {need} bytes of free disk for the "
                        f"seed's, P's and five leechers' copies, {free} free")
    manifest = manifest_from_file(path)
    with open(path, "rb") as f:
        f.seek(len(header))
        ref = torch.frombuffer(bytearray(f.read()), dtype=torch.uint8).to(
            device)
    state_dir = os.path.join(d, "sched-state")
    records_dir = os.path.join(d, "records")
    with socket.socket() as sock:          # S1's port, known to the seed
        sock.bind(("127.0.0.1", 0))
        sched_port = sock.getsockname()[1]
    sched_addr = f"127.0.0.1:{sched_port}"
    ctx = multiprocessing.get_context("spawn")
    origin_conn, o_child = ctx.Pipe()
    seed_conn, sd_child = ctx.Pipe()
    s1_conn, s1_child = ctx.Pipe()
    p_conn, p_child = ctx.Pipe()
    origin = ctx.Process(target=http_origin_child, name="smoke-poison-origin",
                         args=(path, CHAIN_PACE_BPS, o_child))
    seed = ctx.Process(target=crash_seed_child, name="smoke-poison-seed",
                       args=(d, sched_addr, sd_child))
    s1 = p = None
    origin.start()
    seed.start()
    try:
        check(origin_conn.poll(120), "phase 16 origin did not start")
        url = f"http://127.0.0.1:{origin_conn.recv()['port']}/{name}"
        check(seed_conn.poll(300), "phase 16 seed did not start")
        seed_host = seed_conn.recv()["host"]
        s1 = ctx.Process(target=poison_sched_child, name="smoke-poison-s1",
                         args=(sched_port, seed_host, state_dir, records_dir,
                               s1_child))
        s1.start()
        check(s1_conn.poll(300), "phase 16 S1 did not start")
        s1_conn.recv()
        p = ctx.Process(target=poisoner_child, name="smoke-poison-p",
                        args=(d, sched_addr, url, p_child))
        p.start()
        check(p_conn.poll(600), "phase 16 P did not pull its clean copy")
        poison = p_conn.recv()
        check(poison["state"] == "success" and poison["traffic_source"] == 0,
              f"phase 16 P's clean pull: {poison}")
        pod = asyncio.run(_poison_run(
            d, url, manifest, sched_port, seed_host, state_dir, records_dir,
            poison, s1, s1_conn, origin_conn))
        p_conn.send("stop")
        check(p_conn.poll(120), "phase 16 P did not report")
        p_stats = p_conn.recv()
        seed_conn.send("stop")
        check(seed_conn.poll(300), "phase 16 seed did not report")
        seed_stats = seed_conn.recv()
    finally:
        if s1 is not None and s1.is_alive():
            s1.kill()                  # the phase failed before the crash
        for conn in (p_conn, seed_conn, origin_conn):
            try:
                conn.send("stop")      # a no-op for a child already gone
            except OSError:
                pass
        for proc in (p, s1, seed, origin):
            if proc is None:
                continue
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=30)
    check(seed.exitcode == 0 and p.exitcode == 0,
          f"phase 16 seed exited {seed.exitcode}, P {p.exitcode}")
    base, shapes = len(header), dict(layout)
    phost = poison["host"].id
    lines = {}
    for n, run in pod["runs"].items():
        c, tensors = run["conductor"], run["out"]
        for info in manifest.shards:
            t = tensors[info.name]
            lo = info.range_start - base
            check(t.device == device and t.dtype == torch.bfloat16
                  and list(t.shape) == shapes[info.name]
                  and torch.equal(t.reshape(-1).view(torch.uint8),
                                  ref[lo:lo + info.range_size]),
                  f"phase 16 {n}: {info.name} differs from the origin")
        check(c.traffic_source == 0 and c.traffic_p2p == size,
              f"phase 16 {n}: p2p {c.traffic_p2p}, source "
              f"{c.traffic_source}")
        check_crc32c(c.storage.md, f"phase 16 {n}")
        from_p = {pid: k for pid, k in c.pieces_by_parent.items()
                  if pid == poison["peer_id"] or pid.startswith(phost)}
        lines[n] = {"time_to_ready_s": run["wall"],
                    "wasted_corrupt_pieces": run["corrupt_pieces"],
                    "pieces_from_p": sum(from_p.values()),
                    "pieces_per_parent": dict(c.pieces_by_parent)}
        del tensors, run["out"]
    del ref
    shutil.rmtree(d, ignore_errors=True)
    # the immune system: P quarantined pod-wide at S1 on bounded evidence
    s1_state = pod["s1"]
    row = s1_state["quarantine"]["hosts"].get(phost)
    check(row is not None and row["state"] in ("quarantined", "probation")
          and row["reporters"] >= 2
          and row["corrupt_evidence"]
          <= POISON_EVIDENCE_PER_CHILD * len(POISON),
          f"phase 16 S1's standing of P: {row}")
    quarantined = [r for r in s1_state["rows"]
                   if r["to_state"] == "quarantined"]
    check([r["host_id"] for r in quarantined] == [phost],
          f"phase 16 S1 quarantined {[r['host_id'] for r in quarantined]}")
    check(sum(v["shunned"] for v in pod["verdicts"].values()) >= 1,
          f"phase 16: no leecher shunned P: {pod['verdicts']}")
    check(any(v > 0 for v in pod["pulses"].values())
          and any(max(s1_state["fleet"].get(pod["hosts"][n]) or [0]) > 0
                  for n in POISON),
          f"phase 16 pulses' corrupt verdicts: {pod['pulses']}, S1's "
          f"series {s1_state['fleet']}")
    check(poison["addr"] in pod["podscope"]["shunned"],
          f"phase 16 podscope's quarantine view: {pod['podscope']}")
    check(any(r["to_state"] == "quarantined" for r in pod["records_rows"]),
          "phase 16: no quarantine row in S1's records")
    # the restart: the verdict survived S1's SIGKILL
    prov = pod["provenance"]
    check(prov.get("recovered") is True
          and prov["components"]["quarantine"]["restored"] >= 1
          and [r["source"] for r in pod["recovery_rows"]][:1]
          == ["snapshot"],
          f"phase 16 S2 provenance {prov}, rows {pod['recovery_rows']}")
    check(pod["p_state_at_start"] in ("quarantined", "probation")
          and pod["p_state_at_end"] != "healthy",
          f"phase 16 S2's standing of P: {pod['p_state_at_start']} at "
          f"start, {pod['p_state_at_end']} at the end")
    check(lines["l5"]["pieces_from_p"] == 0,
          f"phase 16 L5 landed {lines['l5']['pieces_from_p']} pieces from P")
    origin_t = pod["origin"]
    check(origin_t["body_bytes"] == size
          and seed_stats["traffic_source"] == size,
          f"phase 16 origin sent {origin_t['body_bytes']} bytes, seed took "
          f"{seed_stats['traffic_source']}, file {size}")
    first_q = min(r["created_at"] for r in quarantined)
    emit("phase 16 poison", {
        "file_bytes": size, "announce_interval_s": POISON_ANNOUNCE_S,
        "pex_interval_s": POISON_PEX_S,
        "snapshot_interval_s": POISON_SNAPSHOT_S,
        "time_to_ready_s": {n: lines[n]["time_to_ready_s"] for n in lines},
        # a corrupt serve flips one byte of its range: the other pieces
        # of a multi-piece span from P verify and land
        "pieces_from_p": {n: lines[n]["pieces_from_p"] for n in lines},
        "wasted_corrupt_pieces": {n: lines[n]["wasted_corrupt_pieces"]
                                  for n in lines},
        "time_to_quarantine_s": first_q - pod["start_wall"],
        "s1_standing_of_p": row,
        "s1_quarantine_rows": [(r["host_id"], r["from_state"], r["to_state"],
                                r["reporters"]) for r in s1_state["rows"]],
        "verdicts_of_p": {n: (v or {}).get("codes")
                          for n, v in pod["verdicts"].items()},
        "shunned_by": sorted(n for n, v in pod["verdicts"].items()
                             if v["shunned"]),
        "verdicts_wait_s": pod["verdicts_wait_s"],
        "pulse_corrupt_verdicts": pod["pulses"],
        "podscope_shunned": pod["podscope"]["shunned"],
        "records_quarantine_rows": len(pod["records_rows"]),
        "snapshot_wait_s": pod["snapshot_wait_s"],
        "p_pull_s": poison["pull_s"],
        "p_faults": p_stats["faults"],
        "s2_restore_s": pod["restore_s"],
        "s2_restore_to_first_ruling_s": pod["restore_to_first_ruling_s"],
        "s2_reannounce_s": pod["reannounce_s"],
        "s2_components": {k: v.get("restored") for k, v in
                          prov["components"].items()},
        "s2_standing_of_p": [pod["p_state_at_start"],
                             pod["p_state_at_end"]],
        "l5_time_to_ready_s": lines["l5"]["time_to_ready_s"],
        "l5_pieces_per_parent": lines["l5"]["pieces_per_parent"],
        "origin_bytes_sent": origin_t["body_bytes"],
        "seed_traffic_source": seed_stats["traffic_source"],
        "phase_s": time.monotonic() - t_phase, "card": smi})


# ---------------------------------------------------------------- phase 17

FED_PODS = ("pod-a", "pod-b")
FED_MEMBERS = 2               # daemons per pod
FED_WAIT_S = 600.0            # bound on a pod child's start and pulls


def fed_pod_child(workdir: str, pod: str, sched_addr: str, url: str,
                  path: str, layout: list, device: str, conn) -> None:
    """One pod of phase 17 in a spawned process: ``DF_POD_ID`` names its
    pod before the topology is first read, as a deployment's environment
    does. Its two daemons pull with manifest sinks on ``device`` when the
    parent says "go" and hold every tensor against the file's bytes."""
    os.environ["DF_POD_ID"] = pod
    asyncio.run(_fed_pod_child(workdir, pod, sched_addr, url, path, layout,
                               torch.device(device), conn))


async def _fed_pod_child(workdir: str, pod: str, sched_addr: str, url: str,
                         path: str, layout: list, device: torch.device,
                         conn) -> None:
    header, _ = safetensors_header(layout)
    manifest = manifest_from_file(path)
    with open(path, "rb") as f:
        f.seek(len(header))
        ref = torch.frombuffer(bytearray(f.read()), dtype=torch.uint8).to(
            device)
    daemons = [Daemon(DaemonConfig(
        workdir=os.path.join(workdir, f"{pod}-{i}"),
        hostname=f"fed-{pod}-{i}", listen_ip="127.0.0.1",
        host_ip="127.0.0.1", device=device.type,
        announce_interval_s=POISON_ANNOUNCE_S,
        scheduler=SchedulerConfig(addresses=[sched_addr])))
        for i in range(FED_MEMBERS)]
    try:
        for d in daemons:
            await d.start()
        conn.send({"hosts": [d.host_info().id for d in daemons],
                   "pods": [d.topology.pod for d in daemons]})
        await asyncio.to_thread(conn.recv)      # "go"
        runs = await asyncio.gather(*(
            _leecher_pull(d, url, UrlMeta(), manifest, {}) for d in daemons))
        base, shapes = len(header), dict(layout)
        out = []
        for d, run in zip(daemons, runs):
            c, tensors = run["conductor"], run["out"]
            equal = all(
                tensors[i.name].device == device
                and tensors[i.name].dtype == torch.bfloat16
                and list(tensors[i.name].shape) == shapes[i.name]
                and torch.equal(
                    tensors[i.name].reshape(-1).view(torch.uint8),
                    ref[i.range_start - base:
                        i.range_start - base + i.range_size])
                for i in manifest.shards)
            out.append({"host": d.host_info().id, "peer_id": c.peer_id,
                        "pod": d.topology.pod, "tensors_equal": equal,
                        "traffic_source": c.traffic_source,
                        "traffic_p2p": c.traffic_p2p,
                        "t0": run["t0"], "wall": run["wall"],
                        "pieces_by_parent": dict(c.pieces_by_parent)})
            del tensors, run["out"]
        conn.send(out)
        await asyncio.to_thread(conn.recv)      # "stop"
    finally:
        for d in daemons:
            await d.stop()


async def _fed_run(sched: Scheduler, conns: dict) -> dict:
    await sched.start()
    try:
        hellos = {}
        for pod, conn in conns.items():
            check(await asyncio.to_thread(conn.poll, FED_WAIT_S),
                  f"phase 17 {pod} did not start")
            hellos[pod] = conn.recv()
        for conn in conns.values():
            conn.send("go")
        results = {}
        for pod, conn in conns.items():
            check(await asyncio.to_thread(conn.poll, FED_WAIT_S),
                  f"phase 17 {pod} did not finish")
            results[pod] = conn.recv()
        rows = [r for r in sched.ledger._ring
                if r.get("decision_kind") == "federation"]
        excluded = sum(1 for r in sched.ledger._ring
                       for e in r.get("excluded") or []
                       if e["reason"] == "cross-pod")
        return {"hellos": hellos, "results": results, "rows": rows,
                "cross_pod_exclusions": excluded,
                "describe": sched.federation.describe()}
    finally:
        await sched.stop()


def phase_federation(workdir: str, device: torch.device) -> None:
    """Phase 17: two federated pods, on phase 8's origin over HTTP."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    path = os.path.join(workdir, "deploy", "model-00004-of-00004.safetensors")
    name = os.path.basename(path)
    size = os.path.getsize(path)
    d = os.path.join(workdir, "federation")
    os.makedirs(d, exist_ok=True)
    free = shutil.disk_usage(workdir).free
    need = (1 + len(FED_PODS) * FED_MEMBERS) * size + (1 << 30)
    check(free >= need, f"phase 17 needs {need} bytes of free disk for the "
                        f"seed's and four members' copies, {free} free")
    with socket.socket() as sock:          # the scheduler's port
        sock.bind(("127.0.0.1", 0))
        sched_port = sock.getsockname()[1]
    sched_addr = f"127.0.0.1:{sched_port}"
    ctx = multiprocessing.get_context("spawn")
    origin_conn, o_child = ctx.Pipe()
    seed_conn, sd_child = ctx.Pipe()
    origin = ctx.Process(target=http_origin_child, name="smoke-fed-origin",
                         args=(path, CHAIN_PACE_BPS, o_child))
    seed = ctx.Process(target=crash_seed_child, name="smoke-fed-seed",
                       args=(d, sched_addr, sd_child))
    pods: dict = {}
    conns: dict = {}
    origin.start()
    seed.start()
    try:
        check(origin_conn.poll(120), "phase 17 origin did not start")
        url = f"http://127.0.0.1:{origin_conn.recv()['port']}/{name}"
        check(seed_conn.poll(300), "phase 17 seed did not start")
        seed_host = seed_conn.recv()["host"]
        for pod in FED_PODS:
            conns[pod], child = ctx.Pipe()
            pods[pod] = ctx.Process(
                target=fed_pod_child, name=f"smoke-fed-{pod}",
                args=(d, pod, sched_addr, url, path, deploy_layout(),
                      str(device), child))
            pods[pod].start()
        sched = Scheduler(SchedCfg(
            listen_ip="127.0.0.1", port=sched_port, federation_enabled=True,
            seed_peers=[SeedPeerAddr(
                host_id=seed_host.id, ip=seed_host.ip,
                rpc_port=seed_host.port,
                download_port=seed_host.download_port)]))
        run = asyncio.run(_fed_run(sched, conns))
        for conn in conns.values():
            conn.send("stop")
        origin_conn.send("report")
        origin_t = origin_conn.recv()
        seed_conn.send("stop")
        check(seed_conn.poll(300), "phase 17 seed did not report")
        seed_stats = seed_conn.recv()
    finally:
        for conn in (*conns.values(), seed_conn, origin_conn):
            try:
                conn.send("stop")
            except OSError:
                pass
        for proc in (*pods.values(), seed, origin):
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=30)
    shutil.rmtree(d, ignore_errors=True)
    check(all(proc.exitcode == 0 for proc in (*pods.values(), seed)),
          f"phase 17 children exited "
          f"{[proc.exitcode for proc in (*pods.values(), seed)]}")
    members = [m for pod in FED_PODS for m in run["results"][pod]]
    pod_of_peer = {m["peer_id"]: m["pod"] for m in members}
    elected = {}
    for r in run["rows"]:
        if r["result"] == "elected":
            check(r["pod"] not in elected,
                  f"phase 17: pod {r['pod']} elected twice: {run['rows']}")
            elected[r["pod"]] = r["elected"]
    check(sorted(elected) == sorted(FED_PODS)
          and all(len(v) == 1 for v in elected.values()),
          f"phase 17 elections: {run['rows']}")
    pod_seeds = {h for v in elected.values() for h in v}
    crossed = {}
    for m in members:
        check(m["pod"] in FED_PODS and m["tensors_equal"],
              f"phase 17 {m['host']} ({m['pod']}): tensors differ from the "
              f"file")
        check(m["traffic_source"] == 0 and m["traffic_p2p"] == size,
              f"phase 17 {m['host']}: p2p {m['traffic_p2p']}, source "
              f"{m['traffic_source']}")
        crossed[m["host"]] = sum(
            k for pid, k in m["pieces_by_parent"].items()
            if pod_of_peer.get(pid) not in (None, m["pod"]))
        if m["host"] not in pod_seeds:
            check(crossed[m["host"]] == 0,
                  f"phase 17 member {m['host']} took {crossed[m['host']]} "
                  f"pieces across pods")
    check(origin_t["body_bytes"] == size
          and seed_stats["traffic_source"] == size,
          f"phase 17 origin sent {origin_t['body_bytes']} bytes, seed took "
          f"{seed_stats['traffic_source']}, file {size}")
    t0 = min(m["t0"] for m in members)
    emit("phase 17 federation", {
        "file_bytes": size, "pods": run["describe"]["pods"],
        "pod_seeds": elected,
        "makespan_s": {pod: max(m["t0"] + m["wall"] - t0
                                for m in run["results"][pod])
                       for pod in FED_PODS},
        "time_to_ready_s": {m["host"]: m["wall"] for m in members},
        "cross_pod_pieces": crossed,
        "cross_pod_exclusions": run["cross_pod_exclusions"],
        "federation_rows": len(run["rows"]),
        "pieces_per_parent": {m["host"]: m["pieces_by_parent"]
                              for m in members},
        "origin_bytes_sent": origin_t["body_bytes"],
        "seed_traffic_source": seed_stats["traffic_source"],
        "phase_s": time.monotonic() - t_phase, "card": smi})


# ---------------------------------------------------------------- phase 18

QOS_HERD = 4                      # bulk pulls of tenant "batch"
QOS_SEED_RATE_BPS = 400_000_000   # the seed's uplink: the shared bottleneck
QOS_SEED_SLOTS = 4                # its upload.concurrent_limit
QOS_SEED_BULK_SLOTS = 2           # its upload.bulk_concurrent_limit
QOS_LQ_RATE_BPS = 600_000_000     # Lq's download.total_rate_limit_bps
# Lq's governor, cut so a herd of four walks the ladder to shed
QOS_LQ_GOVERNOR = QosSection(bulk_active_limit=1, queue_limit=1,
                             queue_wait_s=3.0, shed_retry_after_ms=1000)
# the tenant table: name -> (default class, max_running, retry hint ms)
QOS_TENANTS = {"serving": ("critical", 0, 0), "batch": ("bulk", 0, 0),
               "capped": ("", 1, 1500)}
# the scheduler's keepalive, cut from 30 s: it refreshes the tenant table
# every six keepalives, 3 s
QOS_KEEPALIVE_S = 0.5
QOS_ANNOUNCE_S = 1.0              # every daemon's announce, cut from 30 s
QOS_SAMPLE_S = 0.005              # the seed's bulk-slot sampling period
QOS_LAG_S = 0.001                 # an event-loop stall the timelines keep
QOS_WAIT_S = 120.0                # bound on each wait of the phase


def qos_daemon_cfg(workdir: str, name: str, sched_addr: str,
                   **kw) -> DaemonConfig:
    """Phase 18's daemons: one scheduler address, the cut cadences."""
    cfg = crash_daemon_cfg(workdir, name, sched_addr, **kw)
    cfg.hostname = f"qos-{name}"
    cfg.announce_interval_s = QOS_ANNOUNCE_S
    return cfg


def qos_seed_child(workdir: str, sched_addr: str, conn) -> None:
    """Phase 18's seed, in a spawned process that never touches CUDA: its
    uplink limit, slots and bulk slots as the phase line states. It
    samples its bulk upload slots (``_active_cls`` and the
    ``df_qos_upload_active{cls="bulk"}`` gauge) every 5 ms from start to
    stop, and keeps a timeline on CLOCK_MONOTONIC, which every process of
    the host shares: each change of a class's slot count, each slot
    acquire (its wait, or its 503) and each stall of its event loop over
    1 ms. It sends its host, serves until the parent says "stop", then
    sends its origin bytes, the samples, the timeline and, per task, its
    back-source window and its serves."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    asyncio.run(_qos_seed_child(workdir, sched_addr, conn))


async def _qos_seed_child(workdir: str, sched_addr: str, conn) -> None:
    cfg = qos_daemon_cfg(workdir, "seed", sched_addr, is_seed=True,
                         device="cpu")
    cfg.upload.rate_limit_bps = QOS_SEED_RATE_BPS
    cfg.upload.concurrent_limit = QOS_SEED_SLOTS
    cfg.upload.bulk_concurrent_limit = QOS_SEED_BULK_SLOTS
    seed = Daemon(cfg)
    await seed.start()
    srv = seed.upload_server
    gauge = REGISTRY.gauge("df_qos_upload_active", "", ("cls",))
    seen = {"samples": 0, "busy_samples": 0, "max_slots": 0,
            "max_gauge": 0.0}
    timeline = {"slots": [], "acquires": [], "lags": []}
    count_cls, acquire_slot = srv._count_cls, srv._acquire_slot

    def counted(cls: str, delta: int) -> None:
        count_cls(cls, delta)
        timeline["slots"].append((time.monotonic(), cls,
                                  srv._active_cls[cls]))

    async def timed_acquire(cls: str = "standard"):
        t = time.monotonic()
        try:
            slot = await acquire_slot(cls)
        except HTTPError as exc:
            timeline["acquires"].append((t, time.monotonic() - t, cls,
                                         exc.status))
            raise
        timeline["acquires"].append((t, time.monotonic() - t, cls, 200))
        return slot

    srv._count_cls, srv._acquire_slot = counted, timed_acquire

    async def sample() -> None:
        while True:
            bulk = srv._active_cls.get("bulk", 0)
            seen["samples"] += 1
            seen["busy_samples"] += bulk > 0
            seen["max_slots"] = max(seen["max_slots"], bulk)
            seen["max_gauge"] = max(seen["max_gauge"], gauge.value("bulk"))
            t = time.monotonic()
            await asyncio.sleep(QOS_SAMPLE_S)
            lag = time.monotonic() - t - QOS_SAMPLE_S
            if lag > QOS_LAG_S:
                timeline["lags"].append((t, lag))

    sampler = asyncio.get_running_loop().create_task(sample())
    try:
        conn.send({"host": seed.host_info()})
        await asyncio.to_thread(conn.recv)      # the parent is done
        sampler.cancel()
        conductors = list(seed.ptm._conductors.values())
        copies = {}
        for c in conductors:
            summary = c.flight.summarize()
            rows = [r for r in summary["piece_rows"]
                    if r["source"] == "origin"]
            if not rows:
                continue
            m0 = c.flight._m0
            copies[c.task_id] = {
                "url": c.url,
                "source_t0": m0 + min(r["start_ms"] for r in rows) / 1e3,
                "source_t1": m0 + max(r["start_ms"] + r["total_ms"]
                                      for r in rows) / 1e3,
                "uploads": list(summary["uploads"].values())}
        conn.send({"traffic_source": sum(c.traffic_source
                                         for c in conductors),
                   "states": [c.state for c in conductors],
                   "bulk_limit": srv.bulk_limit, **seen, **timeline,
                   "copies": copies,
                   "bulk_503": REGISTRY.counter(
                       "df_qos_upload_shed_total", "",
                       ("cls",)).value("bulk")})
    finally:
        sampler.cancel()
        await seed.stop()


async def _qos_bulk_pull(daemon: Daemon, url: str, meta: UrlMeta) -> dict:
    """One bulk pull to disk, back-source disabled. A shed admission
    (RESOURCE_EXHAUSTED) is retried after its own hint, as the retry
    ladder does; every shed is kept."""
    sheds = []
    t0 = time.monotonic()
    while True:
        try:
            task_id = None
            async for resp in daemon.ptm.start_file_task(DownloadRequest(
                    url=url, url_meta=meta, disable_back_source=True,
                    timeout_s=1200.0)):
                task_id = resp.task_id or task_id
            break
        except DFError as exc:
            if exc.code != Code.RESOURCE_EXHAUSTED:
                raise
            retry_ms = getattr(exc, "retry_after_ms", 0)
            sheds.append(retry_ms)
            await asyncio.sleep(max(retry_ms, 1) / 1000.0)
    c = daemon.ptm.conductor(task_id)
    return {"t0": t0, "wall": time.monotonic() - t0, "sheds": sheds,
            "state": c.state, "traffic_p2p": c.traffic_p2p,
            "traffic_source": c.traffic_source, "qos_class": c.qos_class}


def _quota_req(url: str, task_id: str, i: int, tenant: str
               ) -> RegisterPeerTaskRequest:
    """A register of tenant ``tenant`` on an existing task (no seed
    trigger), from a host of its own."""
    return RegisterPeerTaskRequest(
        task_id=task_id, url=url, peer_id=f"qos-probe-{tenant}-{i}",
        url_meta=UrlMeta(tenant=tenant),
        peer_host=Host(id=f"qos-probe-{tenant}-{i}-host", ip="127.0.0.1",
                       port=1, download_port=2, type=HostType.NORMAL))


async def _qos_run(workdir: str, url: str, manifest: ShardManifest,
                   sched_port: int, seed_host: Host) -> dict:
    """The manager and the scheduler here, Lq's two critical pulls around
    the herd, then the quota, the readers and the pulses."""
    mgr = Manager(ManagerConfig(listen_ip="127.0.0.1",
                                db_path=os.path.join(workdir, "m.db")))
    await mgr.start()
    for name, (cls, running, retry_ms) in QOS_TENANTS.items():
        mgr.store.upsert_tenant(name, qos_class=cls, max_running=running,
                                shed_retry_after_ms=retry_ms)
    sched = Scheduler(SchedCfg(
        listen_ip="127.0.0.1", advertise_ip="127.0.0.1", port=sched_port,
        manager_addresses=[mgr.address],
        keepalive_interval_s=QOS_KEEPALIVE_S,
        seed_peers=[SeedPeerAddr(host_id=seed_host.id, ip=seed_host.ip,
                                 rpc_port=seed_host.port,
                                 download_port=seed_host.download_port)]))
    lq = None
    out: dict = {"lq_lags": []}

    async def lag_sampler() -> None:
        # stalls of this process's loop, which Lq's pulls share
        while True:
            t = time.monotonic()
            await asyncio.sleep(QOS_SAMPLE_S)
            lag = time.monotonic() - t - QOS_SAMPLE_S
            if lag > QOS_LAG_S:
                out["lq_lags"].append((t, lag))

    lagger = asyncio.get_running_loop().create_task(lag_sampler())
    try:
        await sched.start()
        t0 = time.monotonic()
        while set(sched.service.tenants) != set(QOS_TENANTS):
            check(time.monotonic() - t0 < QOS_WAIT_S,
                  f"phase 18: the scheduler's tenants "
                  f"{sorted(sched.service.tenants)}")
            await asyncio.sleep(0.05)
        out["tenants"] = dict(sched.service.tenants)
        cfg = qos_daemon_cfg(workdir, "lq", sched.address)
        cfg.download.total_rate_limit_bps = QOS_LQ_RATE_BPS
        cfg.qos = dataclasses.replace(QOS_LQ_GOVERNOR)
        # every copy is one content: without this, Lq's content store
        # would place each pull after the first from its own disk
        cfg.storage.dedupe_enabled = False
        lq = Daemon(cfg)
        await lq.start()
        critical = UrlMeta(tenant="serving", qos_class="critical")
        out["alone"] = await _leecher_pull(
            lq, f"{url}?copy=critical-alone", critical, manifest, {})
        # the herd; the critical pull starts once a bulk task is landing
        herd = [asyncio.get_running_loop().create_task(_qos_bulk_pull(
            lq, f"{url}?copy=bulk-{i}", UrlMeta(tenant="batch",
                                                qos_class="bulk")))
            for i in range(QOS_HERD)]
        t0 = time.monotonic()
        while not any(c.qos_class == "bulk" and c.ready
                      for c in lq.ptm._conductors.values()):
            check(time.monotonic() - t0 < QOS_WAIT_S
                  and not any(t.done() and t.exception() for t in herd),
                  "phase 18: no bulk pull in flight")
            await asyncio.sleep(0.01)
        out["herd_in_flight"] = {
            "active": dict(lq.qos.active), "queued_now": len(lq.qos._waiters),
            "shed": dict(lq.qos.counters["shed"])}
        out["under_herd"] = await _leecher_pull(
            lq, f"{url}?copy=critical-herd", critical, manifest, {})
        out["herd"] = await asyncio.gather(*herd)
        # a pull's last frame comes before its conductor's run ends and
        # releases its admission and its shaper bucket
        t0 = time.monotonic()
        while any(lq.qos.active.values()) or lq.shaper._tasks:
            check(time.monotonic() - t0 < QOS_WAIT_S,
                  f"phase 18: Lq's governor still counts {lq.qos.active}")
            await asyncio.sleep(0.05)
        # the quota: the second concurrent register of "capped" is refused
        task_id = out["under_herd"]["conductor"].task_id
        svc = sched.service
        shed_total = REGISTRY.counter("df_qos_quota_shed_total", "",
                                      ("tenant",))
        before = shed_total.value("capped")
        await svc.register_peer_task(
            _quota_req(url, task_id, 0, "capped"), None)
        try:
            await svc.register_peer_task(
                _quota_req(url, task_id, 1, "capped"), None)
            out["quota"] = {"refused": False}
        except DFError as exc:
            out["quota"] = {"refused": True, "code": exc.code.name,
                            "retry_after_ms": exc.retry_after_ms}
        out["quota"]["shed_counted"] = shed_total.value("capped") - before
        # a classless register of "batch" takes its class from the row
        await svc.register_peer_task(
            _quota_req(url, task_id, 0, "batch"), None)
        probe = sched.resource.find_peer(task_id, "qos-probe-batch-0")
        out["tenant_class"] = {"qos_class": probe.qos_class,
                               "priority": probe.priority}
        # the readers: /debug/qos against dfdiag --qos, both on Lq
        status, snap = await _http_json(lq.upload_server.port, "/debug/qos")
        check(status == 200, f"phase 18 /debug/qos: {status}")
        addr = f"127.0.0.1:{lq.upload_server.port}"
        rc_json, text_json, _ = await asyncio.to_thread(
            run_cli, dfdiag.main, ["--daemon", addr, "--qos", "--json"])
        rc, text, diag_s = await asyncio.to_thread(
            run_cli, dfdiag.main, ["--daemon", addr, "--qos"])
        out["debug_qos"] = snap
        out["dfdiag"] = {"rc_json": rc_json, "snap": json.loads(text_json),
                         "rc": rc, "text": text, "wall_s": diag_s}
        out["governor"] = {"counters": json.loads(json.dumps(
            lq.qos.counters)), "tenants": dict(lq.qos.tenant_counters),
            "state": lq.qos.state}
        # the pulse, and the scheduler's series of it
        pulse = pulse_mod.build_pulse(lq, 0)
        out["pulse"] = {"qos_state": pulse.qos_state,
                        "qos_shed": pulse.qos_shed}
        host_id = lq.host_info().id
        t0 = time.monotonic()
        while True:
            series = sched.fleetpulse._series.get(host_id)
            sheds = [smp["shed"] for smp in (series.ring if series else [])]
            if sheds and max(sheds) >= pulse.qos_shed:
                break
            check(time.monotonic() - t0 < 10 * QOS_ANNOUNCE_S,
                  f"phase 18: the scheduler's series of Lq: sheds {sheds}")
            await asyncio.sleep(0.1)
        out["fleet_sheds"] = max(sheds)
        out["preempt_rows"] = sum(
            1 for r in sched.ledger._ring
            if r.get("decision_kind") == "preempt")
        return out
    finally:
        lagger.cancel()
        if lq is not None:
            await lq.stop()
        await sched.stop()
        await mgr.stop()


def _occupancy(slots: list, a: float, b: float) -> dict:
    """Mean upload slots each class held over ``[a, b]``, weighted by
    time, from a timeline of ``(t, class, count)`` changes."""
    out = {}
    for cls in sorted({c for _, c, _ in slots}):
        level, area, t_prev = 0, 0.0, a
        for t, c, n in slots:
            if c != cls:
                continue
            if t <= a:
                level = n
                continue
            if t >= b:
                break
            area += level * (t - t_prev)
            level, t_prev = n, t
        out[cls] = (area + level * (b - t_prev)) / (b - a)
    return out


def _lag_in(lags: list, a: float, b: float) -> dict:
    inside = [lag for t, lag in lags if a <= t < b]
    return {"stalls": len(inside), "sum_s": sum(inside),
            "max_s": max(inside, default=0.0)}


def _critical_flight(r: dict, seed_stats: dict, origin_t: dict,
                     lq_lags: list) -> dict:
    """Where a critical pull's time went, over its window ``[t0, t0 +
    wall]``: Lq's per-piece stages (``queue_ms`` is the shaper's wait,
    ``ttfb_ms`` the seed's slot, uplink and relay waits), the seed's
    back-source of the same task and its serves of it, the seed's slot
    acquires by class, its slots held by class weighted by time, both
    loops' stalls, and the origin's responses in the window."""
    c = r["conductor"]
    a, b = r["t0"], r["t0"] + r["wall"]
    rows = c.flight.summarize()["piece_rows"]
    copy = seed_stats["copies"].get(c.task_id)
    check(copy is not None, f"phase 18: the seed holds no back-source "
                            f"window of {c.url}")
    acquires = {}
    for t, wait, cls, status in seed_stats["acquires"]:
        if a <= t < b:
            row = acquires.setdefault(cls, {"n": 0, "wait_s": 0.0,
                                            "max_wait_s": 0.0, "503": 0})
            row["n"] += 1
            row["wait_s"] += wait
            row["max_wait_s"] = max(row["max_wait_s"], wait)
            row["503"] += status == 503
    stages = {}
    for key in ("queue_ms", "ttfb_ms", "wire_ms", "hbm_ms"):
        vals = sorted(x[key] for x in rows)
        stages[key] = {"sum": sum(vals), "p50": podscope._pctl(vals, 0.5),
                       "max": vals[-1]}
    return {
        "lq_pieces": len(rows), "lq_stages_ms": stages,
        "lq_loop": _lag_in(lq_lags, a, b),
        "seed_source_s": copy["source_t1"] - copy["source_t0"],
        "seed_source_from_t0_s": [copy["source_t0"] - a,
                                  copy["source_t1"] - a],
        "seed_serves": copy["uploads"],
        "seed_acquires": acquires,
        "seed_slots_mean": _occupancy(seed_stats["slots"], a, b),
        "seed_loop": _lag_in(seed_stats["lags"], a, b),
        "origin": _origin_in(origin_t["responses"], a, b)}


def _origin_in(responses: list, a: float, b: float) -> dict:
    """The origin's responses overlapping ``[a, b]``: how many, their mean
    concurrency and the bytes they sent in it (each response's bytes
    spread evenly over its life), and the median rate of one response."""
    inside = [(t0, t1, n) for t0, t1, n in responses
              if t0 < b and t1 > a and t1 > t0]
    overlap = [(min(t1, b) - max(t0, a), t1 - t0, n) for t0, t1, n in inside]
    rates = sorted(n / (t1 - t0) for t0, t1, n in inside)
    return {"responses": len(inside),
            "mean_concurrency": sum(o for o, _, _ in overlap) / (b - a),
            "bytes_per_s": sum(n * o / d for o, d, n in overlap) / (b - a),
            "response_bytes_per_s_p50": podscope._pctl(rates, 0.5)}


def phase_qos(workdir: str, device: torch.device) -> None:
    """Phase 18: a critical pull into the card through a bulk herd, on
    phase 8's origin over HTTP."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    path = os.path.join(workdir, "deploy", "model-00004-of-00004.safetensors")
    name = os.path.basename(path)
    layout = deploy_layout()
    header, _ = safetensors_header(layout)
    size = os.path.getsize(path)
    d = os.path.join(workdir, "qos")
    os.makedirs(d, exist_ok=True)
    free = shutil.disk_usage(workdir).free
    need = 2 * (2 + QOS_HERD) * size + (1 << 30)
    check(free >= need, f"phase 18 needs {need} bytes of free disk for the "
                        f"seed's and Lq's {2 + QOS_HERD} copies each, "
                        f"{free} free")
    manifest = manifest_from_file(path)
    with open(path, "rb") as f:
        f.seek(len(header))
        ref = torch.frombuffer(bytearray(f.read()), dtype=torch.uint8).to(
            device)
    with socket.socket() as sock:          # the scheduler's port
        sock.bind(("127.0.0.1", 0))
        sched_port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    origin_conn, o_child = ctx.Pipe()
    seed_conn, sd_child = ctx.Pipe()
    origin = ctx.Process(target=http_origin_child, name="smoke-qos-origin",
                         args=(path, CHAIN_PACE_BPS, o_child))
    seed = ctx.Process(target=qos_seed_child, name="smoke-qos-seed",
                       args=(d, f"127.0.0.1:{sched_port}", sd_child))
    origin.start()
    seed.start()
    try:
        check(origin_conn.poll(120), "phase 18 origin did not start")
        url = f"http://127.0.0.1:{origin_conn.recv()['port']}/{name}"
        check(seed_conn.poll(300), "phase 18 seed did not start")
        seed_host = seed_conn.recv()["host"]
        run = asyncio.run(_qos_run(d, url, manifest, sched_port, seed_host))
        origin_conn.send("report")
        origin_t = origin_conn.recv()
        seed_conn.send("stop")
        check(seed_conn.poll(300), "phase 18 seed did not report")
        seed_stats = seed_conn.recv()
    finally:
        for conn in (seed_conn, origin_conn):
            try:
                conn.send("stop")
            except OSError:
                pass
        for proc in (seed, origin):
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=30)
    check(seed.exitcode == 0, f"phase 18 seed exited {seed.exitcode}")
    base, shapes = len(header), dict(layout)
    ready, flights = {}, {}
    for key in ("alone", "under_herd"):
        r = run[key]
        flights[key] = _critical_flight(r, seed_stats, origin_t,
                                        run["lq_lags"])
        c, tensors = r["conductor"], r["out"]
        for info in manifest.shards:
            t = tensors[info.name]
            lo = info.range_start - base
            check(t.device == device and t.dtype == torch.bfloat16
                  and list(t.shape) == shapes[info.name]
                  and torch.equal(t.reshape(-1).view(torch.uint8),
                                  ref[lo:lo + info.range_size]),
                  f"phase 18 critical {key}: {info.name} differs from the "
                  f"file")
        check(c.qos_class == "critical" and c.traffic_source == 0
              and c.traffic_p2p == size,
              f"phase 18 critical {key}: class {c.qos_class}, p2p "
              f"{c.traffic_p2p}, source {c.traffic_source}")
        ready[key] = r["wall"]
        del tensors, r["out"]
    del ref
    shutil.rmtree(d, ignore_errors=True)
    gov = run["governor"]
    check(gov["tenants"].get("serving") == {"admitted": 2, "queued": 0,
                                            "shed": 0}
          and gov["counters"]["shed"]["critical"] == 0,
          f"phase 18: the critical pulls' admissions {gov}")
    herd = run["herd"]
    sheds = [ms for h in herd for ms in h["sheds"]]
    check(all(h["state"] == "success" and h["traffic_p2p"] == size
              and h["traffic_source"] == 0 and h["qos_class"] == "bulk"
              for h in herd),
          f"phase 18 herd: {[(h['state'], h['traffic_p2p']) for h in herd]}")
    check(gov["counters"]["queued"] >= 1 and gov["counters"]["shed"]["bulk"]
          >= 1 and len(sheds) == gov["counters"]["shed"]["bulk"]
          and set(sheds) == {QOS_LQ_GOVERNOR.shed_retry_after_ms},
          f"phase 18: bulk queued {gov['counters']['queued']}, shed "
          f"{gov['counters']['shed']}, retry hints seen {sheds}")
    check(1 <= seed_stats["max_slots"] <= QOS_SEED_BULK_SLOTS
          and seed_stats["max_gauge"] <= QOS_SEED_BULK_SLOTS
          and seed_stats["bulk_limit"] == QOS_SEED_BULK_SLOTS,
          f"phase 18 seed's bulk slots: {seed_stats}")
    quota = run["quota"]
    check(quota == {"refused": True, "code": "RESOURCE_EXHAUSTED",
                    "retry_after_ms": QOS_TENANTS["capped"][2],
                    "shed_counted": 1.0},
          f"phase 18 quota of tenant capped: {quota}")
    check(run["tenant_class"] == {"qos_class": "bulk", "priority": 6},
          f"phase 18: a classless register of batch: {run['tenant_class']}")
    snap, diag = dict(run["debug_qos"]), run["dfdiag"]
    got = dict(diag["snap"])
    snap.pop("state_since_s")
    got.pop("state_since_s")
    check(got == snap and diag["rc_json"] == diag["rc"] == 0
          and diag["text"].startswith(f"qos: state={snap['state']}"),
          f"phase 18: dfdiag --qos {got} (rc {diag['rc']}) against "
          f"/debug/qos {snap}")
    shed_total = sum(gov["counters"]["shed"].values())
    check(run["pulse"] == {"qos_state": gov["state"], "qos_shed": shed_total}
          and run["fleet_sheds"] >= shed_total > 0,
          f"phase 18 Lq's pulse {run['pulse']}, governor {gov['state']} "
          f"{shed_total} shed, the scheduler's series {run['fleet_sheds']}")
    copies = (2 + QOS_HERD) * size
    check(origin_t["body_bytes"] == copies
          and seed_stats["traffic_source"] == copies,
          f"phase 18 origin sent {origin_t['body_bytes']} bytes, seed took "
          f"{seed_stats['traffic_source']}, {2 + QOS_HERD} copies "
          f"{copies}")
    t_herd0 = min(h["t0"] for h in herd)
    t_herd1 = max(h["t0"] + h["wall"] for h in herd)
    emit("phase 18 qos", {
        "file_bytes": size, "tenants": run["tenants"],
        "tenant_refresh_s": QOS_KEEPALIVE_S * 6,
        "seed_upload_rate_bps": QOS_SEED_RATE_BPS,
        "seed_slots": QOS_SEED_SLOTS, "seed_bulk_slots": QOS_SEED_BULK_SLOTS,
        "lq_total_rate_bps": QOS_LQ_RATE_BPS,
        "lq_governor": dataclasses.asdict(QOS_LQ_GOVERNOR),
        "critical_ready_alone_s": ready["alone"],
        "critical_ready_under_herd_s": ready["under_herd"],
        "critical_ratio": ready["under_herd"] / ready["alone"],
        "herd_pulls": QOS_HERD,
        "herd_bytes_per_s": QOS_HERD * size / (t_herd1 - t_herd0),
        "herd_wall_s": [h["wall"] for h in herd],
        "herd_at_critical_start": run["herd_in_flight"],
        "critical_flight": flights,
        "bulk_queued": gov["counters"]["queued"],
        "bulk_shed": gov["counters"]["shed"]["bulk"],
        "governor_tenants": gov["tenants"],
        "seed_bulk_slots_max": seed_stats["max_slots"],
        "seed_bulk_busy_samples": seed_stats["busy_samples"],
        "seed_samples": seed_stats["samples"],
        "seed_bulk_503": seed_stats["bulk_503"],
        "quota": quota, "tenant_class": run["tenant_class"],
        "preempt_rows": run["preempt_rows"],
        "dfdiag_qos_s": diag["wall_s"], "pulse": run["pulse"],
        "origin_bytes_sent": origin_t["body_bytes"],
        "seed_traffic_source": seed_stats["traffic_source"],
        "phase_s": time.monotonic() - t_phase, "card": smi})


# ---------------------------------------------------------------- phase 19

OBJ_SHARDS = PREFETCH_SHARDS             # the dataset: phase 5's eight
OBJ_SHARD_BYTES = PREFETCH_SHARD_BYTES   # 256 MiB shards, 2 GiB in all
OBJ_BUCKET = "datasets"                  # the gateway's s3-backed bucket
OBJ_BACKEND_BUCKET = "smoke-datasets"    # its name on the S3 stand-in
OBJ_GEN_BUCKET = "generated"             # a bucket on the plugin's scheme
OBJ_GEN_KEY = "eval/holdout-00000.tar"
OBJ_GEN_BYTES = 64 << 20
OBJ_G = "objstore-g"                     # the gateway's hostname
OBJ_L = "objstore-l"                     # the training process's daemon
OBJ_PLUGIN = "gwfirst"                   # the scheduler's evaluator plugin
OBJ_PREFER, OBJ_OTHER = 10.0, 1.0        # its totals: G's host, any other
OBJ_STEP_COLS, OBJ_STEP_OUT = 16384, 1024   # the step's bf16 matmul
OBJ_WAIT_S = 300.0
# the stand-in's key pair: every request must carry a SigV4 signature
# that it recomputes from the secret
S3_ACCESS, S3_SECRET, S3_REGION = "AKSMOKE0000000000000", \
    "smoke/secret/key/for/the/s3/standin", "us-west-2"

OBJ_EVALUATOR_PLUGIN = f'''"""Evaluator plugin: rules on the parent's host alone. The object
gateway's host (id {OBJ_G!r}-<ip>) scores {OBJ_PREFER}, any other
{OBJ_OTHER}."""


class GatewayFirst:
    def evaluate(self, child, parent, *, total_piece_count):
        if parent.host.id.startswith({OBJ_G + "-"!r}):
            return {OBJ_PREFER}
        return {OBJ_OTHER}


def dragonfly_plugin_init(option):
    return GatewayFirst(), {{"type": "evaluator", "name": {OBJ_PLUGIN!r}}}
'''

OBJ_SOURCE_PLUGIN = '''"""Source plugin for the ``seeded`` scheme: ``seeded://<length>/<key>``
is <length> seeded bytes (uint64 words of numpy's default generator, its
seed the key's crc32). It counts its downloads and the bytes it gave."""

import zlib

import numpy as np

from dragonfly2_tpu_torch.source.client import SourceResponse


def object_bytes(url):
    length, _, key = url.split("://", 1)[1].partition("/")
    n = int(length)
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    words = rng.integers(0, np.iinfo(np.uint64).max, size=-(-n // 8),
                         dtype=np.uint64, endpoint=True)
    return words.view(np.uint8)[:n]


class SeededSource:
    def __init__(self):
        self.reads = 0
        self.bytes_read = 0

    async def content_length(self, req):
        return int(req.url.split("://", 1)[1].partition("/")[0])

    async def supports_range(self, req):
        return False

    async def last_modified(self, req):
        return ""

    async def download(self, req):
        self.reads += 1
        data = object_bytes(req.url)

        async def chunks():
            for off in range(0, len(data), 1 << 20):
                chunk = data[off:off + (1 << 20)].tobytes()
                self.bytes_read += len(chunk)
                yield chunk
        return SourceResponse(status=200, content_length=len(data),
                              total_length=len(data), chunks=chunks())

    async def list(self, req):
        return []


def dragonfly_plugin_init(option):
    return SeededSource(), {"type": "source", "name": "seeded",
                            "schemes": ["seeded"]}
'''


def seeded_object(key: str, n: int) -> np.ndarray:
    """What the ``seeded`` plugin gives for ``key``."""
    return seeded_bytes(np.random.default_rng(zlib.crc32(key.encode())), n)


def write_objstore_plugins(plugin_dir: str) -> None:
    os.makedirs(plugin_dir, exist_ok=True)
    for name, text in ((f"df_plugin_evaluator_{OBJ_PLUGIN}.py",
                        OBJ_EVALUATOR_PLUGIN),
                       ("df_plugin_source_seeded.py", OBJ_SOURCE_PLUGIN)):
        with open(os.path.join(plugin_dir, name), "w") as f:
            f.write(text)


class S3StandIn:
    """An S3-compatible store on the standard library: a
    ``ThreadingHTTPServer`` keeping objects under ``root/<bucket>/<key>``,
    path-style PUT, GET (a single ``Range``), HEAD and DELETE. Every
    request must carry an AWS SigV4 ``Authorization`` that it recomputes
    with ``secret`` over the signed headers (403 otherwise), and a payload
    hash other than ``UNSIGNED-PAYLOAD`` must be the body's sha256. It
    counts, per ``bucket/key``, the PUTs, the body bytes each PUT brought
    and the body bytes GETs sent."""

    def __init__(self, root: str, access: str = S3_ACCESS,
                 secret: str = S3_SECRET, region: str = S3_REGION):
        from dragonfly2_tpu_torch.common.objectstorage import S3Credentials
        self.root = root
        self.creds = S3Credentials(access, secret, region)
        self.lock = threading.Lock()
        self.puts: dict[str, int] = {}
        self.put_bytes: dict[str, int] = {}
        self.get_bytes: dict[str, int] = {}
        self.denied = 0
        self._server = None

    def stats(self) -> dict:
        with self.lock:
            objects = {}
            for dirpath, _dirs, files in os.walk(self.root):
                for fn in files:
                    if fn.startswith(".put-"):
                        continue
                    full = os.path.join(dirpath, fn)
                    rel = os.path.relpath(full, self.root)
                    objects[rel] = os.path.getsize(full)
            return {"puts": dict(self.puts), "put_bytes": dict(self.put_bytes),
                    "get_bytes": dict(self.get_bytes), "denied": self.denied,
                    "objects": objects}

    def _signed_ok(self, handler) -> bool:
        from dragonfly2_tpu_torch.common.objectstorage import sign_v4
        auth = handler.headers.get("Authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            return False
        try:
            fields = dict(p.strip().split("=", 1)
                          for p in auth.split(" ", 1)[1].split(","))
            signed = fields["SignedHeaders"].split(";")
            now = datetime.datetime.strptime(
                handler.headers["x-amz-date"], "%Y%m%dT%H%M%SZ").replace(
                    tzinfo=datetime.timezone.utc)
        except (KeyError, ValueError):
            return False
        url = f"http://{handler.headers['Host']}{handler.path}"
        redo = sign_v4(self.creds, handler.command, url,
                       {k: handler.headers.get(k, "") for k in signed
                        if k not in ("host", "x-amz-date",
                                     "x-amz-content-sha256")},
                       handler.headers.get("x-amz-content-sha256", ""),
                       now=now)
        return redo["Authorization"] == auth

    def start(self) -> int:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import unquote
        store = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:
                pass

            def _plain(self, status: int, headers: dict | None = None,
                       body: bytes = b"") -> None:
                self.send_response(status)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body and self.command != "HEAD":
                    self.wfile.write(body)

            def _body(self):
                """The request body in chunks (Content-Length or
                chunked)."""
                if "chunked" in self.headers.get("Transfer-Encoding", ""):
                    while True:
                        size = int(self.rfile.readline().split(b";")[0], 16)
                        if size == 0:
                            while self.rfile.readline().strip():
                                pass
                            return
                        while size > 0:
                            data = self.rfile.read(min(1 << 20, size))
                            size -= len(data)
                            yield data
                        self.rfile.read(2)
                left = int(self.headers.get("Content-Length") or 0)
                while left > 0:
                    data = self.rfile.read(min(1 << 20, left))
                    if not data:
                        return
                    left -= len(data)
                    yield data

            def _target(self) -> tuple[str, str]:
                path = self.path.split("?", 1)[0]
                bucket, _, key = path.lstrip("/").partition("/")
                name = f"{unquote(bucket)}/{unquote(key)}"
                full = os.path.realpath(os.path.join(store.root, name))
                if not full.startswith(os.path.realpath(store.root)
                                       + os.sep):
                    raise ValueError(name)
                return name, full

            def _handle(self) -> None:
                if not store._signed_ok(self):
                    for _ in self._body():
                        pass
                    with store.lock:
                        store.denied += 1
                    self._plain(403, body=b"SignatureDoesNotMatch")
                    return
                try:
                    name, full = self._target()
                except ValueError:
                    self._plain(400)
                    return
                if self.command == "PUT":
                    self._put(name, full)
                elif not os.path.isfile(full):
                    self._plain(404)
                elif self.command == "DELETE":
                    os.unlink(full)
                    self._plain(204)
                else:
                    self._get(name, full)

            def _put(self, name: str, full: str) -> None:
                want = self.headers.get("x-amz-content-sha256", "")
                sha = hashlib.sha256()
                os.makedirs(os.path.dirname(full), exist_ok=True)
                tmp = os.path.join(os.path.dirname(full),
                                   f".put-{threading.get_ident()}")
                n = 0
                with open(tmp, "wb") as f:
                    for data in self._body():
                        f.write(data)
                        n += len(data)
                        if want != "UNSIGNED-PAYLOAD":
                            sha.update(data)
                if want != "UNSIGNED-PAYLOAD" and sha.hexdigest() != want:
                    os.unlink(tmp)
                    self._plain(400, body=b"XAmzContentSHA256Mismatch")
                    return
                os.replace(tmp, full)
                with store.lock:
                    store.puts[name] = store.puts.get(name, 0) + 1
                    store.put_bytes[name] = store.put_bytes.get(name, 0) + n
                self._plain(200, {"ETag": '"standin"'})

            def _get(self, name: str, full: str) -> None:
                size = os.path.getsize(full)
                start, end, status = 0, size, 200
                m = re.match(r"bytes=(\d+)-(\d*)$",
                             self.headers.get("Range", ""))
                if m:
                    start = int(m.group(1))
                    end = min(size, int(m.group(2)) + 1 if m.group(2)
                              else size)
                    status = 206
                self.send_response(status)
                self.send_header("Content-Length", str(end - start))
                self.send_header("ETag", '"standin"')
                if status == 206:
                    self.send_header("Content-Range",
                                     f"bytes {start}-{end - 1}/{size}")
                self.end_headers()
                if self.command == "HEAD":
                    return
                with open(full, "rb") as f:
                    f.seek(start)
                    left = end - start
                    while left > 0:
                        data = f.read(min(1 << 20, left))
                        self.wfile.write(data)
                        left -= len(data)
                        with store.lock:
                            store.get_bytes[name] = \
                                store.get_bytes.get(name, 0) + len(data)

            do_PUT = do_GET = do_HEAD = do_DELETE = _handle

        os.makedirs(self.root, exist_ok=True)
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self._server.server_address[1]

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def s3_standin_child(root: str, conn) -> None:
    """Phase 19's S3 stand-in, in a spawned process: it sends its port,
    answers each "stats" with its counts, and ends at "stop"."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    store = S3StandIn(root)
    try:
        conn.send({"port": store.start()})
        while conn.recv() == "stats":
            conn.send(store.stats())
    finally:
        store.stop()


def objstore_gateway_cfg(workdir: str, s3_port: int, plugin_dir: str,
                         gen_bytes: int) -> DaemonConfig:
    """G: a seed daemon with the object gateway. ``datasets`` is backed by
    the S3 stand-in with write-back; ``generated`` reads the plugin's
    ``seeded`` scheme through the P2P task engine."""
    return DaemonConfig(
        workdir=workdir, hostname=OBJ_G, is_seed=True,
        listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu",
        plugin_dir=plugin_dir,
        object_storage=ObjectStorageConfig(
            enabled=True,
            buckets={OBJ_BUCKET: f"s3://{OBJ_BACKEND_BUCKET}",
                     OBJ_GEN_BUCKET: f"seeded://{gen_bytes}"},
            backends={OBJ_BUCKET: {
                "kind": "s3", "base": f"http://127.0.0.1:{s3_port}",
                "bucket": OBJ_BACKEND_BUCKET, "access_key": S3_ACCESS,
                "secret_key": S3_SECRET, "region": S3_REGION}}))


def objstore_child(workdir: str, s3_port: int, plugin_dir: str,
                   keys: list[str], gen_bytes: int, conn) -> None:
    """Phase 19's scheduler and gateway daemon G, in a spawned process
    that never touches CUDA: it sends the scheduler's address, the
    gateway's port and G's URLs for ``keys``, answers each "stats" with
    the scheduler's rulings and the source plugin's reads, and ends at
    "stop"."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    asyncio.run(_objstore_child(workdir, s3_port, plugin_dir, keys,
                                gen_bytes, conn))


async def _objstore_child(workdir: str, s3_port: int, plugin_dir: str,
                          keys: list[str], gen_bytes: int, conn) -> None:
    g = Daemon(objstore_gateway_cfg(os.path.join(workdir, "g"), s3_port,
                                    plugin_dir, gen_bytes))
    await g.start()
    sched = Scheduler(SchedCfg(
        listen_ip="127.0.0.1", algorithm=f"plugin:{OBJ_PLUGIN}",
        plugin_dir=plugin_dir, records_dir=os.path.join(workdir, "records"),
        seed_peers=[SeedPeerAddr(host_id=g.host_info().id, ip="127.0.0.1",
                                 rpc_port=g.rpc.port,
                                 download_port=g.upload_server.port)]))
    await sched.start()
    gw = g.object_gateway
    requests = REGISTRY.counter("df_objstore_requests_total",
                                labels=("op", "status"))
    try:
        conn.send({"scheduler": sched.address, "gateway": gw.port,
                   "g_host_id": g.host_info().id,
                   "urls": [gw._object_url(OBJ_BUCKET, k) for k in keys]})
        while await asyncio.to_thread(conn.recv) == "stats":
            plugin = source.client_for("seeded://0/x")
            conn.send({
                "decisions": sched.ledger.snapshot(limit=4096)["decisions"],
                "plugin_reads": plugin.reads,
                "plugin_bytes": plugin.bytes_read,
                "g_upload_bytes": REGISTRY.counter(
                    "df_upload_bytes_total").value(),
                "g_tasks": len(g.storage_mgr.tasks()),
                "requests": {f"{op}/{st}": requests.value(op, st)
                             for op, st in (("put", "ok"), ("get", "ok"),
                                            ("head", "ok"), ("head", "404"),
                                            ("delete", "ok"))}})
    finally:
        await g.stop()
        await sched.stop()


def dfstore(endpoint: str, *args: str) -> tuple[int, dict, float]:
    """One ``dfstore`` CLI run as its own process: (exit code, its JSON
    line, seconds)."""
    t0 = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.tools.dfstore", *args,
         "--endpoint", endpoint], capture_output=True, text=True,
        timeout=600, cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    wall = time.monotonic() - t0
    line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else "{}"
    try:
        out = json.loads(line)
    except ValueError:
        out = {"stdout": line}
    if r.returncode and r.stderr:
        out["stderr"] = r.stderr[-2000:]
    return r.returncode, out, wall


def objstore_train(daemon_box: dict, urls: list[str], refs: list,
                   device: torch.device) -> dict:
    """The training process's loop: ``ShardPrefetcher(depth=2)`` over G's
    URLs on L, each shard one step on the card (a bf16 matmul over the
    shard's bytes, its exponents' top bit cleared so every value is
    finite, and an SGD update of the weight)."""
    gen = torch.Generator(device=device).manual_seed(19)
    w = (torch.randn(OBJ_STEP_COLS, OBJ_STEP_OUT, generator=gen,
                     device=device) * 0.01).to(torch.bfloat16)
    w.requires_grad_()
    pf = ShardPrefetcher(daemon_box["daemon"], urls, depth=2,
                         loop=daemon_box["loop"],
                         url_meta=UrlMeta(tag="objstore"),
                         disable_back_source=True)
    waits, steps, losses = [], [], []
    t0 = t_ask = time.monotonic()
    for i, arrays in enumerate(pf):
        waits.append(time.monotonic() - t_ask)
        check(all(a.device.type == device.type for a in arrays),
              f"shard {i} is not on {device}")
        flat = torch.cat(arrays)[:OBJ_SHARD_BYTES]
        check(torch.equal(flat, refs[i]),
              f"shard {i} on the card differs from the bytes put")
        t_step = time.monotonic()
        x = (flat.view(torch.int16) & -16385).view(torch.bfloat16)
        x = x.view(-1, OBJ_STEP_COLS)
        loss = (x @ w).float().square().mean()
        loss.backward()
        with torch.no_grad():
            w -= 1e-3 * w.grad
            w.grad = None
        losses.append(loss.item())          # synchronizes the step
        steps.append(time.monotonic() - t_step)
        del flat, x, arrays
        t_ask = time.monotonic()
    elapsed = time.monotonic() - t0
    check(len(steps) == len(urls), f"{len(steps)} shards, want {len(urls)}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    return {"elapsed_s": elapsed, "waits_s": waits, "steps_s": steps,
            "losses": losses}


def phase_objstore(workdir: str, seed: int, device: torch.device) -> None:
    """Phase 19: dataset shards written through dfstore and the object
    gateway to an S3 stand-in, then prefetched over P2P into the card
    between training steps."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    d = os.path.join(workdir, "objstore")
    os.makedirs(os.path.join(d, "data"), exist_ok=True)
    total = OBJ_SHARDS * OBJ_SHARD_BYTES
    # the shard files, the stand-in's copies, G's cache, the spool and L's
    # in-flight shards
    need = 3 * total + 4 * OBJ_SHARD_BYTES + (1 << 30)
    free = shutil.disk_usage(workdir).free
    check(free >= need, f"phase 19 needs {need} bytes of free disk, "
                        f"{free} free")
    plugin_dir = os.path.join(d, "plugins")
    write_objstore_plugins(plugin_dir)
    rng = np.random.default_rng(seed + 19)
    keys = [f"train/shard-{i:05d}.tar" for i in range(OBJ_SHARDS)]
    paths, refs = [], []
    for i in range(OBJ_SHARDS):
        data = seeded_bytes(rng, OBJ_SHARD_BYTES)
        path = os.path.join(d, "data", f"shard-{i:05d}.tar")
        with open(path, "wb") as f:
            f.write(memoryview(data))
            os.fsync(f.fileno())
        paths.append(path)
        refs.append(torch.from_numpy(data).to(device))
    del data
    ctx = multiprocessing.get_context("spawn")
    s3_conn, s3_child_conn = ctx.Pipe()
    s3 = ctx.Process(target=s3_standin_child, name="smoke-s3",
                     args=(os.path.join(d, "s3"), s3_child_conn))
    s3.start()
    g_conn = g = None
    boot: dict = {}
    stop = threading.Event()
    thread = None
    try:
        check(s3_conn.poll(300), "phase 19's S3 stand-in did not start")
        s3_port = s3_conn.recv()["port"]
        g_conn, g_child_conn = ctx.Pipe()
        g = ctx.Process(target=objstore_child, name="smoke-objstore",
                        args=(d, s3_port, plugin_dir, keys, OBJ_GEN_BYTES,
                              g_child_conn))
        g.start()
        check(g_conn.poll(300), "phase 19's gateway child did not start")
        info = g_conn.recv()
        endpoint = f"http://127.0.0.1:{info['gateway']}"

        # writing: one dfstore put per shard, each done only once the
        # stand-in holds the object
        t0 = time.monotonic()
        put_s = []
        for key, path in zip(keys, paths):
            rc, out, wall = dfstore(endpoint, "put", OBJ_BUCKET, key,
                                    "-I", path)
            check(rc == 0 and out.get("stored") == key,
                  f"dfstore put {key}: exit {rc} {out}")
            held = _ask(s3_conn, "stats")["objects"].get(
                f"{OBJ_BACKEND_BUCKET}/{key}")
            check(held == OBJ_SHARD_BYTES,
                  f"dfstore put {key} exited 0 with the stand-in holding "
                  f"{held} bytes")
            put_s.append(wall)
        put_wall = time.monotonic() - t0
        s3_put = _ask(s3_conn, "stats")
        names = [f"{OBJ_BACKEND_BUCKET}/{k}" for k in keys]
        check(all(s3_put["puts"].get(n) == 1
                  and s3_put["put_bytes"].get(n) == OBJ_SHARD_BYTES
                  for n in names) and s3_put["denied"] == 0,
              f"the stand-in did not receive each byte once: "
              f"{s3_put['puts']} {s3_put['put_bytes']} "
              f"denied {s3_put['denied']}")
        for path in paths:
            os.unlink(path)

        # prefetching: L embedded in this process, as in phase 5
        def daemon_thread() -> None:
            async def main() -> None:
                daemon = Daemon(DaemonConfig(
                    workdir=os.path.join(d, "l"), hostname=OBJ_L,
                    listen_ip="127.0.0.1", host_ip="127.0.0.1",
                    device="cpu" if device.type == "cpu" else "cuda",
                    scheduler=SchedulerConfig(
                        addresses=[info["scheduler"]])))
                await daemon.start()
                boot.update(daemon=daemon, loop=asyncio.get_running_loop(),
                            host_id=daemon.host_info().id)
                try:
                    while not stop.is_set():
                        await asyncio.sleep(0.05)
                finally:
                    await daemon.stop()
            asyncio.run(main())

        thread = threading.Thread(target=daemon_thread, name="smoke-objstore-l",
                                  daemon=True)
        thread.start()
        t_boot = time.monotonic()
        while "daemon" not in boot:
            check(thread.is_alive() and time.monotonic() - t_boot < 120,
                  "phase 19's L did not start")
            time.sleep(0.05)
        before = hbm_counters()
        train = objstore_train(boot, info["urls"], refs, device)
        hbm = hbm_metrics(before)
        del refs
        s3_pf = _ask(s3_conn, "stats")
        check(sum(s3_pf["get_bytes"].values()) == 0,
              f"the stand-in sent {s3_pf['get_bytes']} GET bytes during "
              f"the prefetch")
        stats = _ask(g_conn, "stats")

        # every ruling of L's tasks is the plugin's
        rows = [r for r in stats["decisions"]
                if r["host_id"] == boot["host_id"] and r["candidates"]]
        check(rows, "the scheduler made no ruling with candidates for L")
        for r in rows:
            best = max(c["total"] for c in r["candidates"])
            for c in r["candidates"]:
                want = (OBJ_PREFER if c["host_id"] == info["g_host_id"]
                        else OBJ_OTHER)
                check(c.get("substituted") == {"total": "plugin"}
                      and c["total"] == want and "base_total" in c,
                      f"candidate {c['host_id']} of {r['decision_id']}: "
                      f"{c.get('substituted')} total {c['total']}, "
                      f"want {want}")
            chosen = {c["peer_id"]: c["total"] for c in r["candidates"]}
            check(all(chosen.get(p) == best for p in r["chosen"]),
                  f"{r['decision_id']} chose {r['chosen']} below the "
                  f"plugin's best {best}")
        tasks = {r["task_id"] for r in rows}

        # the gateway's GET path: the plugin's scheme through G's
        # stream_task, then from the completed task
        want = seeded_object(OBJ_GEN_KEY, OBJ_GEN_BYTES)
        gets = []
        for n in range(2):
            out_path = os.path.join(d, f"generated-{n}.tar")
            rc, out, wall = dfstore(endpoint, "get", OBJ_GEN_BUCKET,
                                    OBJ_GEN_KEY, "-O", out_path)
            check(rc == 0 and out.get("bytes") == OBJ_GEN_BYTES,
                  f"dfstore get {OBJ_GEN_KEY}: exit {rc} {out}")
            got = np.fromfile(out_path, dtype=np.uint8)
            check(np.array_equal(got, want),
                  f"get {n} of {OBJ_GEN_KEY} differs from the plugin's "
                  f"bytes")
            os.unlink(out_path)
            reads = _ask(g_conn, "stats")
            gets.append({"wall_s": wall, "plugin_reads": reads["plugin_reads"],
                         "plugin_bytes": reads["plugin_bytes"]})
        check(gets[0]["plugin_reads"] == 1
              and gets[0]["plugin_bytes"] == OBJ_GEN_BYTES
              and gets[1]["plugin_reads"] == 1
              and gets[1]["plugin_bytes"] == OBJ_GEN_BYTES,
              f"the plugin's reads across two gets: {gets}")

        # removal, in the gateway and on the stand-in
        rc, out, _ = dfstore(endpoint, "rm", OBJ_BUCKET, keys[0])
        check(rc == 0 and out.get("deleted") == keys[0],
              f"dfstore rm: exit {rc} {out}")
        rc, out, _ = dfstore(endpoint, "stat", OBJ_BUCKET, keys[0])
        check(rc == 1 and out == {"exists": False},
              f"dfstore stat after rm: exit {rc} {out}")
        s3_rm = _ask(s3_conn, "stats")
        check(names[0] not in s3_rm["objects"]
              and all(n in s3_rm["objects"] for n in names[1:]),
              f"the stand-in holds {sorted(s3_rm['objects'])} after rm")
        final = _ask(g_conn, "stats")
    finally:
        stop.set()
        if thread is not None:
            thread.join(timeout=120)
        for conn, proc in ((g_conn, g), (s3_conn, s3)):
            if conn is not None:
                try:
                    conn.send("stop")
                except (OSError, ValueError):
                    pass
            if proc is not None:
                proc.join(timeout=120)
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=30)
    check(g.exitcode == 0 and s3.exitcode == 0,
          f"phase 19 children exited {g.exitcode}, {s3.exitcode}")
    waits, steps = train["waits_s"], train["steps_s"]
    emit("phase 19 objstore", {
        "shards": OBJ_SHARDS, "shard_bytes": OBJ_SHARD_BYTES,
        "dataset_bytes": total,
        "put_wall_s": put_wall, "put_gbps": total / 1e9 / put_wall,
        "put_s": put_s,
        "prefetch_s": train["elapsed_s"],
        "prefetch_gbps": total / 1e9 / train["elapsed_s"],
        "wait_median_s": statistics.median(waits),
        "wait_max_s": max(waits), "waits_s": waits,
        "step_median_s": statistics.median(steps), "steps_s": steps,
        "losses": train["losses"],
        "standin": {"put_bytes": sum(s3_put["put_bytes"].values()),
                    "puts": sum(s3_put["puts"].values()),
                    "get_bytes_during_prefetch": sum(
                        s3_pf["get_bytes"].values()),
                    "denied": s3_pf["denied"]},
        "plugin_rulings": len(rows), "l_tasks_ruled": len(tasks),
        "g_upload_bytes": stats["g_upload_bytes"],
        "generated_gets": gets, "gateway_requests": final["requests"],
        **hbm, "phase_s": time.monotonic() - t_phase, "card": smi})


# --------------------------------------------------------------- phase 20

MIRROR_RUNTIME_BYTES = 256 << 20          # the image's runtime layer
MIRROR_TOKEN = "Bearer mirror-smoke-token"
MIRROR_REPO = "serving/vllm"
MIRROR_TAG = "v1"
MIRROR_SNI_NAME = "registry.mirror.test"  # a name only the ClientHello has
MIRROR_COPY_BYTES = 64 << 20              # the client's host-to-card unit
MIRROR_LAG_SAMPLE_S = 0.005               # the child's loop-lag sampler
MIRROR_WAIT_S = 300.0
MEDIA_MANIFEST = "application/vnd.oci.image.manifest.v1+json"
MEDIA_CONFIG = "application/vnd.oci.image.config.v1+json"
MEDIA_LAYER = "application/vnd.oci.image.layer.v1.tar"


def oci_digest(data) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


def oci_manifest(config: bytes, layers: list[tuple[str, int]]) -> bytes:
    """An OCI image manifest naming ``config`` and the (digest, size)
    layers."""
    return json.dumps({
        "schemaVersion": 2, "mediaType": MEDIA_MANIFEST,
        "config": {"mediaType": MEDIA_CONFIG, "digest": oci_digest(config),
                   "size": len(config)},
        "layers": [{"mediaType": MEDIA_LAYER, "digest": d, "size": n}
                   for d, n in layers]}).encode()


class RegistryStandIn:
    """An OCI distribution (v2) registry on the standard library, over
    TLS: a ``ThreadingHTTPServer`` whose certificate is a leaf for
    127.0.0.1 from the port's ``CertIssuer`` under a CA of its own
    (``<root>/ca/proxy-ca.crt``). Every request must carry ``token`` as
    its ``Authorization`` (401 with ``WWW-Authenticate`` otherwise). It
    answers ``GET /v2/``, ``/v2/<name>/manifests/<ref>`` (``manifest``
    for any name and reference) and ``/v2/<name>/blobs/<digest>`` (the
    files of ``blobs``, digest -> path) with HEAD and a single ``Range``.
    It counts the body bytes it sends per digest, its manifest hits and
    its refusals."""

    def __init__(self, root: str, blobs: dict[str, str], manifest: bytes,
                 token: str = MIRROR_TOKEN):
        from dragonfly2_tpu_torch.common.certs import CertIssuer
        self.issuer = CertIssuer(os.path.join(root, "ca"))
        self.blobs = blobs
        self.manifest = manifest
        self.token = token
        self.lock = threading.Lock()
        self.served = {d: 0 for d in blobs}
        self.manifest_hits = 0
        self.denied = 0
        self._server = None

    @property
    def ca_path(self) -> str:
        return self.issuer.ca_cert_path

    def stats(self) -> dict:
        with self.lock:
            return {"served": dict(self.served),
                    "manifest_hits": self.manifest_hits,
                    "denied": self.denied}

    def start(self) -> int:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        reg = self
        ctx = self.issuer.server_context("127.0.0.1")

        class TLSServer(ThreadingHTTPServer):
            daemon_threads = True

            def get_request(self):
                sock, addr = self.socket.accept()
                return ctx.wrap_socket(sock, server_side=True,
                                       do_handshake_on_connect=False), addr

            def handle_error(self, request, client_address) -> None:
                pass                # a client that hung up mid-body

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self) -> None:
                self.request.do_handshake()      # on the request's thread
                super().setup()

            def log_message(self, *args) -> None:
                pass

            def _plain(self, status: int, headers: dict | None = None,
                       body: bytes = b"") -> None:
                self.send_response(status)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if body and self.command != "HEAD":
                    self.wfile.write(body)

            def _handle(self) -> None:
                path = self.path.split("?", 1)[0]
                if self.headers.get("Authorization") != reg.token:
                    with reg.lock:
                        reg.denied += 1
                    self._plain(401, {"WWW-Authenticate":
                                      'Bearer realm="standin"'})
                    return
                if path == "/v2/":
                    self._plain(200, {"Content-Type": "application/json"},
                                b"{}")
                    return
                m = re.match(r"/v2/.+/(manifests|blobs)/([^/]+)$", path)
                if m is None:
                    self._plain(404)
                elif m.group(1) == "manifests":
                    with reg.lock:
                        reg.manifest_hits += 1
                    self._plain(200, {
                        "Content-Type": MEDIA_MANIFEST,
                        "Docker-Content-Digest": oci_digest(reg.manifest)},
                        reg.manifest)
                elif m.group(2) not in reg.blobs:
                    self._plain(404)
                else:
                    self._blob(m.group(2))

            def _blob(self, digest: str) -> None:
                full = reg.blobs[digest]
                size = os.path.getsize(full)
                start, end, status = 0, size, 200
                m = re.match(r"bytes=(\d+)-(\d*)$",
                             self.headers.get("Range", ""))
                if m:
                    start = int(m.group(1))
                    end = min(size, int(m.group(2)) + 1 if m.group(2)
                              else size)
                    status = 206
                self.send_response(status)
                self.send_header("Content-Length", str(end - start))
                self.send_header("Accept-Ranges", "bytes")
                self.send_header("Docker-Content-Digest", digest)
                if status == 206:
                    self.send_header("Content-Range",
                                     f"bytes {start}-{end - 1}/{size}")
                self.end_headers()
                if self.command == "HEAD":
                    return
                with open(full, "rb") as f:
                    f.seek(start)
                    left = end - start
                    while left > 0:
                        data = f.read(min(1 << 20, left))
                        self.wfile.write(data)
                        left -= len(data)
                        with reg.lock:
                            reg.served[digest] += len(data)

            do_GET = do_HEAD = _handle

        self._server = TLSServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self._server.server_address[1]

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def registry_child(root: str, blobs: dict[str, str], manifest: bytes,
                   conn) -> None:
    """Phase 20's registry stand-in, in a spawned process: it sends its
    port and CA file, answers each "stats" with its counts, and ends at
    "stop"."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    reg = RegistryStandIn(root, blobs, manifest)
    try:
        conn.send({"port": reg.start(), "ca": reg.ca_path})
        while conn.recv() == "stats":
            conn.send(reg.stats())
    finally:
        reg.stop()


def mirror_daemon_cfg(workdir: str, name: str, sched_addr: str,
                      registry_ca: str, proxy) -> DaemonConfig:
    from dragonfly2_tpu_torch.daemon.config import (DownloadConfig,
                                                    HealthSection,
                                                    StorageSection)
    return DaemonConfig(
        workdir=os.path.join(workdir, name), hostname=name,
        listen_ip="127.0.0.1", host_ip="127.0.0.1", device="cpu",
        scheduler=SchedulerConfig(addresses=[sched_addr]),
        storage=StorageSection(gc_interval_s=3600),
        download=DownloadConfig(source_ca=registry_ca),
        health=HealthSection(sample_interval_s=MIRROR_LAG_SAMPLE_S),
        proxy=proxy)


def peer_sources(daemon) -> dict[str, int]:
    """Piece counts by source ("origin" for back-source) over the tasks
    the daemon ran."""
    out: dict[str, int] = {}
    for conductor in daemon.ptm._conductors.values():
        if conductor.storage is None:
            continue
        for p in conductor.storage.md.pieces.values():
            key = p.source or "origin"
            out[key] = out.get(key, 0) + 1
    return out


def proxy_counters() -> dict:
    reqs = REGISTRY.counter("df_proxy_requests_total", labels=("route",))
    nbytes = REGISTRY.counter("df_proxy_bytes_total", labels=("route",))
    return {route: {"requests": reqs.value(route),
                    "bytes": nbytes.value(route)}
            for route in ("hijack", "tunnel", "p2p", "shed", "direct")}


def mirror_child(workdir: str, registry_port: int, registry_ca: str,
                 conn) -> None:
    """Phase 20's scheduler and daemons A, B and C, in a spawned process
    that never touches CUDA: it sends the proxies' ports and CA files,
    answers "stats" (the proxy counters, each daemon's piece sources,
    each leaf's mint times) and "lag_reset" / "lag" (the health plane's
    loop lag since the reset), and ends at "stop"."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from dragonfly2_tpu_torch.common import certs
    mints: list[dict] = []
    real_mint = certs.CertIssuer._mint

    def timed_mint(self, host: str):
        t0 = time.monotonic()
        out = real_mint(self, host)
        mints.append({"daemon": os.path.basename(self.workdir),
                      "host": host, "s": time.monotonic() - t0,
                      "on_loop": threading.current_thread()
                      is threading.main_thread()})
        return out

    certs.CertIssuer._mint = timed_mint
    asyncio.run(_mirror_child(workdir, registry_port, registry_ca, mints,
                              conn))


async def _mirror_child(workdir: str, registry_port: int, registry_ca: str,
                        mints: list, conn) -> None:
    from dragonfly2_tpu_torch.common import health
    from dragonfly2_tpu_torch.daemon.config import ProxyConfig
    sched = Scheduler(SchedCfg(listen_ip="127.0.0.1"))
    await sched.start()
    registry = f"https://127.0.0.1:{registry_port}"
    daemons = {
        "mirror-a": ProxyConfig(enabled=True, hijack=True),
        "mirror-b": ProxyConfig(enabled=True, hijack=True),
        "mirror-c": ProxyConfig(enabled=True, registry_mirror=registry,
                                sni_port=-1)}
    started = []
    try:
        for name, proxy in daemons.items():
            d = Daemon(mirror_daemon_cfg(workdir, name, sched.address,
                                         registry_ca, proxy))
            await d.start()
            started.append(d)
        a, b, c = started
        conn.send({"a": a.proxy_server.port,
                   "a_ca": a.proxy_server.ca_cert_path,
                   "b": b.proxy_server.port,
                   "b_ca": b.proxy_server.ca_cert_path,
                   "c": c.proxy_server.port, "c_sni": c.proxy_server.sni_port,
                   "c_ca": c.proxy_server.ca_cert_path})
        plane = health.PLANE
        while True:
            msg = await asyncio.to_thread(conn.recv)
            if msg == "lag_reset":
                plane.max_lag_s = 0.0
                conn.send({"samples": plane.samples})
            elif msg == "lag":
                conn.send({"max_lag_s": plane.max_lag_s,
                           "samples": plane.samples,
                           "sample_interval_s": plane.cfg.sample_interval_s})
            elif msg == "stats":
                conn.send({"proxy": proxy_counters(), "mints": list(mints),
                           "sources": {d.hostname: peer_sources(d)
                                       for d in started},
                           "traffic": {d.hostname: {
                               "p2p": sum(x.traffic_p2p for x in
                                          d.ptm._conductors.values()),
                               "source": sum(x.traffic_source for x in
                                             d.ptm._conductors.values())}
                               for d in started}})
            else:
                break
    finally:
        for d in reversed(started):
            await d.stop()
        await sched.stop()


class _SNIConnection(http.client.HTTPSConnection):
    """An HTTPS connection to ``host:port`` whose ClientHello names
    ``sni``: a client that resolved the registry's name to the daemon."""

    def __init__(self, host: str, port: int, sni: str,
                 context: ssl.SSLContext, timeout: float):
        super().__init__(host, port, context=context, timeout=timeout)
        self.sni = sni

    def connect(self) -> None:
        sock = socket.create_connection((self.host, self.port), self.timeout)
        self.sock = self._context.wrap_socket(sock, server_hostname=self.sni)


class OCIClient:
    """A containerd-shaped puller on ``http.client``: ``route`` is
    "connect" (through a proxy's CONNECT to ``registry``, trusting
    ``ca``), "mirror" (plain HTTP to a mirror at ``proxy`` with relative
    paths) or "sni" (TLS to ``proxy`` naming ``sni``, trusting ``ca``,
    with ``Host`` the registry's address). Each layer streams into a
    host buffer (pinned on a card; ``hosts``, by size, may be shared by
    the clients of a run) copied to ``device`` in ``MIRROR_COPY_BYTES``
    units on a side stream."""

    def __init__(self, route: str, proxy: tuple[str, int], registry: str,
                 *, ca: str = "", sni: str = "", token: str = MIRROR_TOKEN,
                 device: torch.device = torch.device("cpu"),
                 hosts: dict | None = None, timeout: float = MIRROR_WAIT_S):
        self.route, self.proxy, self.registry = route, proxy, registry
        self.ca, self.sni, self.token = ca, sni, token
        self.device = device
        self.timeout = timeout
        self.peer_sans: list[list[str]] = []
        self._hosts: dict[int, torch.Tensor] = {} if hosts is None else hosts
        self.conn = self._connect()

    def _context(self) -> ssl.SSLContext:
        return ssl.create_default_context(cafile=self.ca)

    def _connect(self) -> http.client.HTTPConnection:
        host, port = self.proxy
        if self.route == "mirror":
            return http.client.HTTPConnection(host, port,
                                              timeout=self.timeout)
        if self.route == "sni":
            return _SNIConnection(host, port, self.sni, self._context(),
                                  self.timeout)
        conn = http.client.HTTPSConnection(host, port,
                                           context=self._context(),
                                           timeout=self.timeout)
        reg = urllib.parse.urlsplit(self.registry)
        conn.set_tunnel(reg.hostname, reg.port)
        return conn

    def request(self, path: str, headers: dict | None = None):
        """GET ``path``; the response with its head read. A closed
        connection (every proxy answer closes it) reconnects."""
        hdrs = {"Authorization": self.token, **(headers or {})}
        if self.route == "sni":
            hdrs["Host"] = urllib.parse.urlsplit(self.registry).netloc
        if self.conn.sock is None:
            self.conn.connect()
        if isinstance(self.conn.sock, ssl.SSLSocket):
            sans = [v for _, v in self.conn.sock.getpeercert().get(
                "subjectAltName", ())]
            if sans not in self.peer_sans:
                self.peer_sans.append(sans)
        self.conn.request("GET", path, headers=hdrs)
        return self.conn.getresponse()

    def _host_buffer(self, n: int) -> torch.Tensor:
        buf = self._hosts.get(n)
        if buf is None:
            buf = torch.empty(n, dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
            self._hosts[n] = buf
        return buf

    def _layer(self, resp, size: int) -> tuple[torch.Tensor, torch.Tensor]:
        host = self._host_buffer(size)
        out = torch.empty(size, dtype=torch.uint8, device=self.device)
        view = memoryview(host.numpy())
        side = (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)
        got = sent = 0
        while got < size:
            n = resp.readinto(view[got:min(size, got + (1 << 20))])
            check(n > 0, f"layer body ended at {got} of {size} bytes")
            got += n
            if got - sent >= MIRROR_COPY_BYTES or got == size:
                if side is not None:
                    with torch.cuda.stream(side):
                        out[sent:got].copy_(host[sent:got],
                                            non_blocking=True)
                else:
                    out[sent:got].copy_(host[sent:got])
                sent = got
        check(resp.read(1) == b"", "layer body longer than its size")
        if side is not None:
            side.synchronize()
        return host, out

    def pull(self, repo: str, tag: str) -> dict:
        """The containerd sequence: the API check, the manifest with
        ``Accept``, then the config and each layer. Returns the wall
        time, the manifest and the blobs (the config's bytes, each
        layer's host buffer and card tensor)."""
        t0 = time.monotonic()
        resp = self.request("/v2/")
        check(resp.status == 200, f"{self.route}: /v2/ answered {resp.status}")
        resp.read()
        resp = self.request(f"/v2/{repo}/manifests/{tag}",
                            {"Accept": MEDIA_MANIFEST})
        check(resp.status == 200,
              f"{self.route}: manifest answered {resp.status}")
        manifest = json.loads(resp.read())
        out = {"layers": []}
        for i, entry in enumerate([manifest["config"], *manifest["layers"]]):
            resp = self.request(f"/v2/{repo}/blobs/{entry['digest']}")
            check(resp.status == 200,
                  f"{self.route}: blob {entry['digest'][:19]} answered "
                  f"{resp.status}")
            if i == 0:
                out["config"] = resp.read()
            else:
                out["layers"].append(self._layer(resp, entry["size"]))
        out["wall_s"] = time.monotonic() - t0
        out["manifest"] = manifest
        return out

    def close(self) -> None:
        self.conn.close()


def _layer_checks(pull: dict, digests: list[str], refs: list[torch.Tensor],
                  layout: list[tuple[str, list[int]]], route: str) -> None:
    """Every blob's sha256 is its digest, each layer on the card equals
    its reference, and the model layer's tensors equal phase 8's."""
    check(oci_digest(pull["config"]) == pull["manifest"]["config"]["digest"],
          f"{route}: the config blob's sha256 is not its digest")
    got = [e["digest"] for e in pull["manifest"]["layers"]]
    check(got == digests, f"{route}: manifest layers {got}")
    for (host, card), digest, ref in zip(pull["layers"], digests, refs):
        check(oci_digest(memoryview(host.numpy())) == digest,
              f"{route}: layer {digest[:19]}'s sha256 is not its digest")
        check(torch.equal(card, ref),
              f"{route}: layer {digest[:19]} on the card differs")
    model = pull["layers"][0][1]
    n = struct.unpack("<Q", bytes(model[:8].cpu().numpy()))[0]
    meta = json.loads(bytes(model[8:8 + n].cpu().numpy()))
    base = 8 + n
    for name, shape in layout:
        start, end = meta[name]["data_offsets"]
        check(meta[name]["shape"] == shape and meta[name]["dtype"] == "BF16",
              f"{route}: {name} is {meta[name]}")
        t = model[base + start:base + end].view(torch.bfloat16).view(shape)
        r = refs[0][base + start:base + end].view(torch.bfloat16).view(shape)
        # bitwise: seeded bytes hold NaNs, which never equal themselves
        check(torch.equal(t.view(torch.int16), r.view(torch.int16)),
              f"{route}: {name} on the card differs from phase 8's")


def phase_mirror(workdir: str, seed: int, device: torch.device) -> None:
    """Phase 20: an OCI image pulled through the registry mirror proxy
    (CONNECT interception, the mirror rewrite and the SNI listener) into
    the card."""
    try:
        ossl = subprocess.run(["openssl", "version"], capture_output=True,
                              text=True, timeout=60)
    except OSError as exc:
        raise CheckFailed(f"phase 20 needs the openssl binary (the port's "
                          f"certificates are made by it): {exc}") from None
    check(ossl.returncode == 0,
          f"phase 20: openssl version exited {ossl.returncode}: "
          f"{ossl.stderr.strip()}")
    print(f"phase 20 openssl: {ossl.stdout.strip()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t_phase = time.monotonic()
    path = os.path.join(workdir, "deploy", "model-00004-of-00004.safetensors")
    layout = deploy_layout()
    model_size = os.path.getsize(path)
    d = os.path.join(workdir, "mirror")
    blob_dir = os.path.join(d, "registry", "blobs")
    os.makedirs(blob_dir, exist_ok=True)
    image = model_size + MIRROR_RUNTIME_BYTES
    free = shutil.disk_usage(workdir).free
    need = 4 * image + (1 << 30)
    check(free >= need, f"phase 20 needs {need} bytes of free disk for the "
                        f"registry's and three daemons' copies, {free} free")
    sha = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(16 << 20), b""):
            sha.update(block)
    model_digest = "sha256:" + sha.hexdigest()
    runtime = seeded_bytes(np.random.default_rng(seed + 20),
                           MIRROR_RUNTIME_BYTES)
    runtime_digest = oci_digest(memoryview(runtime))
    config = json.dumps({
        "architecture": "amd64", "os": "linux",
        "config": {"Entrypoint": ["python3", "-m", "vllm.entrypoints"]},
        "rootfs": {"type": "layers",
                   "diff_ids": [model_digest, runtime_digest]}}).encode()
    blobs = {}
    model_blob = os.path.join(blob_dir, model_digest[7:])
    try:
        os.link(path, model_blob)
    except OSError:
        shutil.copyfile(path, model_blob)
    blobs[model_digest] = model_blob
    for digest, data in ((runtime_digest, memoryview(runtime)),
                         (oci_digest(config), config)):
        blobs[digest] = os.path.join(blob_dir, digest[7:])
        with open(blobs[digest], "wb") as f:
            f.write(data)
            os.fsync(f.fileno())
    digests = [model_digest, runtime_digest]
    manifest = oci_manifest(config, [(model_digest, model_size),
                                     (runtime_digest, MIRROR_RUNTIME_BYTES)])
    with open(path, "rb") as f:
        refs = [torch.frombuffer(bytearray(f.read()), dtype=torch.uint8).to(
            device), torch.from_numpy(runtime).to(device)]
    del runtime
    ctx = multiprocessing.get_context("spawn")
    r_conn, r_child = ctx.Pipe()
    reg = ctx.Process(target=registry_child, name="smoke-registry",
                      args=(os.path.join(d, "registry"), blobs, manifest,
                            r_child))
    reg.start()
    m_conn = m = None
    clients: list[OCIClient] = []
    pulls: list[dict] = []
    try:
        check(r_conn.poll(300), "phase 20's registry stand-in did not start")
        info = r_conn.recv()
        registry = f"https://127.0.0.1:{info['port']}"
        m_conn, m_child = ctx.Pipe()
        m = ctx.Process(target=mirror_child, name="smoke-mirror",
                        args=(d, info["port"], info["ca"], m_child))
        m.start()
        check(m_conn.poll(300), "phase 20's daemons child did not start")
        ports = m_conn.recv()

        def one_pull(route: str, client: OCIClient) -> dict:
            clients.append(client)
            pull = client.pull(MIRROR_REPO, MIRROR_TAG)
            _layer_checks(pull, digests, refs, layout, route)
            served = _ask(r_conn, "stats")
            stats = _ask(m_conn, "stats")
            rec = {"route": route, "wall_s": pull["wall_s"],
                   "gbps": image / 1e9 / pull["wall_s"],
                   "served": served["served"],
                   "manifest_hits": served["manifest_hits"],
                   "proxy": stats["proxy"], "sources": stats["sources"],
                   "traffic": stats["traffic"]}
            pulls.append(rec)
            del pull
            return rec

        sizes = {dg: os.path.getsize(p) for dg, p in blobs.items()}
        # the layers' pinned host buffers, shared by the four pulls and
        # pinned before the first
        t_pin = time.monotonic()
        hosts = {n: torch.empty(n, dtype=torch.uint8,
                                pin_memory=device.type == "cuda")
                 for n in (model_size, MIRROR_RUNTIME_BYTES)}
        pin_s = time.monotonic() - t_pin
        # 1: through A's CONNECT; A goes back to the stand-in
        p1 = one_pull("a-connect", OCIClient(
            "connect", ("127.0.0.1", ports["a"]), registry, ca=ports["a_ca"],
            device=device, hosts=hosts))
        check(p1["served"] == sizes,
              f"after A's pull the stand-in served {p1['served']}, want "
              f"each blob once {sizes}")
        # 2: through B's CONNECT; every piece from a peer
        p2 = one_pull("b-connect", OCIClient(
            "connect", ("127.0.0.1", ports["b"]), registry, ca=ports["b_ca"],
            device=device, hosts=hosts))
        check(p2["served"] == sizes,
              f"B's pull reached the stand-in: {p2['served']}")
        b_src = p2["sources"]["mirror-b"]
        check(b_src and "origin" not in b_src,
              f"B's pieces came from {b_src}")
        # 3: C's mirror rewrite, plain HTTP with relative paths
        p3 = one_pull("c-mirror", OCIClient(
            "mirror", ("127.0.0.1", ports["c"]), registry, device=device,
            hosts=hosts))
        check(p3["served"] == sizes,
              f"C's mirror pull reached the stand-in: {p3['served']}")
        c_src = p3["sources"]["mirror-c"]
        check(c_src and "origin" not in c_src,
              f"C's pieces came from {c_src}")
        # 4: C's SNI listener, replayed from C's storage; the health
        # plane's loop lag over the first handshake for the name
        _ask(m_conn, "lag_reset")
        sni = OCIClient("sni", ("127.0.0.1", ports["c_sni"]), registry,
                        ca=ports["c_ca"], sni=MIRROR_SNI_NAME, device=device,
                        hosts=hosts)
        t_hs = time.monotonic()
        sni.conn.connect()
        handshake_s = time.monotonic() - t_hs
        time.sleep(10 * MIRROR_LAG_SAMPLE_S)
        lag = _ask(m_conn, "lag")
        p4 = one_pull("c-sni", sni)
        check(p4["served"] == sizes,
              f"C's SNI pull reached the stand-in: {p4['served']}")
        check(p4["traffic"]["mirror-c"] == p3["traffic"]["mirror-c"],
              f"C's SNI pull moved bytes: {p3['traffic']['mirror-c']} -> "
              f"{p4['traffic']['mirror-c']}")
        check(p4["manifest_hits"] == 4,
              f"{p4['manifest_hits']} manifest hits for 4 pulls")
        sans = {f"{p['route']}": c.peer_sans
                for p, c in zip(pulls, clients) if c.peer_sans}
        check(any("127.0.0.1" in s for s in clients[0].peer_sans)
              and any("127.0.0.1" in s for s in clients[1].peer_sans),
              f"the CONNECT leaves name {sans}")
        check(any(MIRROR_SNI_NAME in s for s in sni.peer_sans),
              f"the SNI leaf names {sni.peer_sans}")
        final = _ask(m_conn, "stats")
        proxy = final["proxy"]
        blob_bytes = sum(sizes.values())
        check(proxy["p2p"] == {"requests": 12, "bytes": 4 * blob_bytes}
              and proxy["direct"]["requests"] == 8
              and proxy["hijack"]["requests"] == 10
              and proxy["tunnel"]["requests"] == 0
              and proxy["shed"]["requests"] == 0,
              f"proxy counters {proxy}")
    finally:
        for c in clients:
            c.close()
        for conn, proc in ((m_conn, m), (r_conn, reg)):
            if conn is not None:
                try:
                    conn.send("stop")
                except (OSError, ValueError):
                    pass
            if proc is not None:
                proc.join(timeout=120)
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=30)
    check(m.exitcode == 0 and reg.exitcode == 0,
          f"phase 20 children exited {m.exitcode}, {reg.exitcode}")
    del refs
    first_mints = {}
    for row in final["mints"]:
        first_mints.setdefault(f"{row['daemon']}/{row['host']}", row)
    emit("phase 20 mirror", {
        "openssl": ossl.stdout.strip(),
        "image_bytes": image + len(config), "model_layer_bytes": model_size,
        "runtime_layer_bytes": MIRROR_RUNTIME_BYTES,
        "config_bytes": len(config),
        "reduced": "BASELINE config 3's multi-GB vLLM image cut to phase "
                   "8's 1.05 GB model file and a 256 MiB runtime layer",
        "pulls": [{k: p[k] for k in ("route", "wall_s", "gbps", "served",
                                     "manifest_hits")} for p in pulls],
        "proxy": proxy, "sources": final["sources"],
        "traffic": final["traffic"], "first_mints": first_mints,
        "pin_s": pin_s,
        "sni_handshake_s": handshake_s,
        "sni_loop_lag_max_s": lag["max_lag_s"],
        "lag_sample_interval_s": lag["sample_interval_s"],
        "leaf_sans": sans, "phase_s": time.monotonic() - t_phase,
        "card": smi})
    shutil.rmtree(d, ignore_errors=True)


def run_phases(layers: int, seed: int, device: torch.device) -> None:
    """Phases 2-20 on ``device``; raises CheckFailed on a failed check."""
    layout = llama_layout(layers)
    header, nbytes = safetensors_header(layout)
    workdir = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        buf = seeded_bytes(np.random.default_rng(seed), nbytes)
        ref = phase_sink(buf, seed, device)
        path = os.path.join(workdir, "model-00001-of-00004.safetensors")
        # the pulls' piece digests are the native library's crc32c: it is
        # built from the port's copy of dfnative.cc here, or the run fails
        t_build = time.monotonic()
        try:
            native.build()
        except (OSError, subprocess.SubprocessError) as exc:
            detail = getattr(exc, "stderr", b"") or b""
            check(False, f"native storage library did not build: {exc} "
                         f"{detail.decode(errors='replace')[-2000:]}")
        build_s = time.monotonic() - t_build
        check(native.available(), "native storage library did not load")
        # host-side ceilings of the pull, one pass each over the bytes:
        # the finalize digest (sha256), the piece digests (crc32c, and
        # zlib's crc32 for comparison) and the origin file write
        t0 = time.monotonic()
        sha = hashlib.sha256(header)
        sha.update(buf)
        t1 = time.monotonic()
        zlib.crc32(buf)
        t2 = time.monotonic()
        native.crc32c_update(buf, 0)
        t2c = time.monotonic()
        with open(path, "wb") as f:
            f.write(header)
            f.write(memoryview(buf))
            os.fsync(f.fileno())    # set-up: no write-back during the pulls
        t3 = time.monotonic()
        emit("host", {"bytes": nbytes, "sha256_gbps": nbytes / 1e9 / (t1 - t0),
                      "crc32_gbps": nbytes / 1e9 / (t2 - t1),
                      "crc32c_gbps": nbytes / 1e9 / (t2c - t2),
                      "native_build_s": build_s,
                      "file_write_fsync_gbps": nbytes / 1e9 / (t3 - t2c),
                      "cpus": os.cpu_count()})
        del buf
        digest = "sha256:" + sha.hexdigest()
        asyncio.run(phase_daemon(workdir, path, digest, header, ref, layout,
                                 device))
        phase_prefetch(workdir, seed, device)
        phase_p2p(workdir, path, digest, header, ref, layout, device)
        # phase 6's copies are not needed again: their disk goes to
        # phase 9's, and phase 9's and the origin's to phase 8's
        shutil.rmtree(os.path.join(workdir, "p2p"), ignore_errors=True)
        phase_sharded(workdir, path, header, ref, layout, device)
        del ref
        shutil.rmtree(os.path.join(workdir, "sharded"), ignore_errors=True)
        os.unlink(path)
        phase_trainer(workdir, seed, device)
        phase_deploy(workdir, seed, device)
        phase_nt(workdir, seed, device)
        phase_chain(workdir, device)
        phase_crash(workdir, device)
        phase_dfbench(device)
        phase_observe(workdir, device)
        phase_superseed(workdir, device)
        phase_poison(workdir, device)
        phase_federation(workdir, device)
        phase_qos(workdir, device)
        phase_objstore(workdir, seed, device)
        # phase 19's copies are not needed again: their disk goes to
        # phase 20's registry and daemons
        shutil.rmtree(os.path.join(workdir, "objstore"), ignore_errors=True)
        phase_mirror(workdir, seed, device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=9,
                    help="decoder layers of Llama-3-8B to include (32 = "
                         "the whole model)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not 0 <= args.layers <= LLAMA3_8B["layers"]:
        ap.error(f"--layers must be 0..{LLAMA3_8B['layers']}")
    t_start = time.monotonic()
    name = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        run_phases(args.layers, args.seed, device)
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"kernels": [], "reason": KERNELS_NOTE,
                      "total_s": time.monotonic() - t_start}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
