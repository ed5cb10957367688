#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (quorum_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Every stage 2 below runs the corrector's default, event mode (HK5,
HK16, HK17, HK4's event entry, HK14), but the event phase's plain-mode
run. Phases, each printing one JSON line:
  build    compile the twenty-one CUDA kernels (and their entries) from
           csrc/ with nvcc (sm_90a)
  kernels  hold each kernel against its plain PyTorch version on the
           card, at the main path's shapes (8192 x 160 batches, a
           2^22-row table), plus a small table that grows; HK1 also at
           k = 13, 24 and 31 on reads of 5-157 bases in 157-wide rows
           (one batch, and a build from 100 slots that grows); HK5 at
           k = 13, 24 and 31 on reads of 0-157 bases in 157-wide rows
           (Ns, N at base 0, reads shorter than k, anchors at the scan's
           chunk edges; skip 0, 1, 3 and good 1, 2, 4; the sharded-table
           and contaminant entries); HK14 at B = 1, 2048, 3001 and 70001
           and on empty logs, at four capacities; HK5's, HK16's and HK4's
           (plain and event) contaminant entries (kill and trim) and
           HK14 on their output with a contaminant set of the adapters
           and a 2 kbp segment of that batch's genome; HK2 and HK6's
           export at k = 13, 24 and 31 on tables with planted repeats of
           a tag pair, dense (60-64 occupied slots a row) and empty
           tables, the seal into one shard's rows of a larger plane and
           the export of row ranges, with its count and without
           (seal_export_shapes), and both timed on a dense 2^20-row table
  golden   the stage CLIs reproduce tests/golden/expected*.fa/.log with
           --device cuda (the -p 4 stage 2 with --metrics: its quality
           section's counts, rates and skip reasons equal to the golden
           pins of QUALITY_BASELINE.json); the quorum driver's --device
           cuda output, and
           its --partitions 4 --device cuda output, are byte-equal to
           its --device cpu output; so are quorum_error_correct_reads'
           with --contaminant (two 2k-base windows of golden reads),
           with --contaminant --trim-contaminant and with --homo-trim 3,
           and the driver's with all three (the --device cpu runs in
           processes of their own: the drivers' beside the build,
           stage 2's from golden's stage 1, run right after the build,
           beside the kernels phase and golden's card runs)
  full     the quorum driver on a seeded E. coli-size FASTQ (random
           4,641,652 bp genome, 150 bp reads at 40x, 1% substitutions,
           ~10% low-quality bases, k = 24) at its defaults (-t the cpu
           count, --render-workers min(4, cores)), its reads parsed by
           the native parser; launch counts are reset just before it
           and read just after
  serve    quorum-serve (python -m quorum_tpu_torch.cli.serve's main,
           in-process, --device cuda --max-batch 1024) on the full run's
           v5 file: the full run's first 65,536 reads from 8 closed-loop
           clients in seeded requests of 1-512 reads, byte-equal to its
           .fa/.log records; 2,048 seeded reads of 40-300 bp in 64-read
           requests (batches across buckets 64 to 384), byte-equal to
           quorum_error_correct_reads --device cpu on them;
           engine_compiles flat after the warmup; quorum-serve-bench at
           -c 8 x 256 reads and -c 1 x 1 read from a client process of
           its own (latency percentiles, reads/s, the card's busy share,
           dispatch/wait medians, render and parse apart, peak memory);
           a hung step under the watchdog, a reload swap and a
           corrupt-file rollback, each ending byte-equal; /metrics
           lint-clean and the drain's document; each engine's warmup
           read the table walk (no all-A fallback), equal to the walk on
           the host (launch counts reset before the boot and read after
           the drain)
  pipeline the same driver run at -t 1 --render-workers 1: .fa/.log
           byte-equal to the full run's; both runs' stage seconds, producer parse + pack seconds, main-thread
           seconds blocked on the prefetch queue and on the render drain,
           render workers' summed seconds, the card's busy seconds
           (torch.profiler's device activity, as around the full run) and
           host share (launch counts reset before and read after)
  telemetry  the same driver run with --metrics --metrics-interval 1
           --trace-spans, then with --profile --metrics (outside
           DeviceBusy, the loader's event timing off): .fa/.log
           byte-equal to the full run's; every metrics document, event
           stream and span file valid under the port's schema copy and
           contract name rules; the profile's step windows the run's
           stage-1 insert and stage-2 device steps, kernel time in both
           stages, the top kernel one of the port's; the first run's
           Gbases/h beside the full run's, the profile's split by stage
           and top kernels beside the full run's busy seconds, and
           HK5's kernel time beside its wrapper's host and device spans
           (launch counts reset before and read after each run)
  parser   the native parser built, and equal to the Python parser
           batch for batch on the full run's FASTQ; both times
  two_binary  the same FASTQ through quorum_create_database with -s a
           sixteenth of the full run's (the table doubles at least
           twice), the v5 file, then quorum_error_correct_reads on its
           own from that file, at the defaults with --gzip and at -t 1
           --render-workers 1 without: the table holds the full run's
           content, the plain .fa/.log are byte-equal to the full run's
           and the gzip run's gunzip to them; both runs' times; launch
           counts reset before and read after, as for full
  paired   mate pairs of the full run's genome (as many reads as the
           full run: 150 bp mates of 400 +- 50 bp fragments, mate 2
           reverse-complemented, the full run's error model) in two
           FASTQ files through `quorum -P`, then `quorum -d` on the same
           files: equal payloads, <prefix>_1.fa byte-equal to the -d
           run's records of file 1, _2.fa to those of file 2, the same
           .log lines; both runs' stage seconds and Gbases/h; launch
           counts reset before and read after each run
  ref_format  quorum_create_database --ref-format on the full FASTQ on
           the card (the host iterate and the write timed, the file's
           bytes); histo_mer_database (lines and --json) and
           query_mer_database (1,000 seeded mers, half of them genome
           mers, all found) of that file equal to those of the full
           run's v5 database, both on the card (the bins by a bincount
           there, the mers by one HK3 launch), and on the v5 file equal
           to numpy's bins and host lookups over the rows brought back;
           stage 2 from each at the full run's cutoff (-p): .fa/.log
           equal (the v5 file's in a process of its own, beside stage
           1); launch counts reset and read around stage 1, around
           the inspection CLIs (the `inspect` path) and around each
           stage-2 run
  legacy   v1, v2 and v3 files of the golden table (as
           tests/test_ref_format.py builds them), stage 2 on each and on
           the golden v5 file with --device cuda (HK7 places each) and
           --device cpu at -p 4: all equal to tests/golden/expected.*
  resume   crash safety at the full run's size: quorum_create_database
           --checkpoint-dir --checkpoint-every 64 killed (its own process,
           a hard-exit fault plan) at stage1.insert batch 100, then
           --resume (a second process; the two start right after `full`
           and run beside the phases up to `legacy`, one parse thread
           each: their time is the 4 GiB snapshot's CRC32C on one host
           core): payload equal to the full run's; the snapshot's
           bytes, its save seconds (D2H, CRC32C, write with fsync), its
           load seconds and the resumed stage 1's seconds;
           quorum_error_correct_reads --checkpoint-every 16 killed at
           stage2.correct batch 100, then --resume: .fa/.log equal to the
           full run's, the journal commits' seconds; the golden stage 2
           with a hang fault and --stall-timeout-s 2: rc 75 (at least 10
           GiB free first; launch counts reset and read around each
           resumed run)
  prefilter  the same FASTQ through the driver with --prefilter two-pass
           at the full run's -s (the database's header, and its content
           against the full table); quorum_error_correct_reads
           --presence-floor 2 on the full run's database, byte-equal to
           the two-pass run's .fa/.log; the driver with --prefilter
           inline, held to inline's guarantees against the exact counts;
           then two-pass again from a table of a 64th of the full run's
           rows (sketch kept at the full size; in a process of its own,
           beside the floor and inline runs), so the gated build
           grows: equal to the full-s two-pass run in table, header and
           .fa/.log, peak
           memory beside the two_binary run's; launch counts reset
           before and read after each driver run
  partitions  the same FASTQ through the driver with --partitions 4 at
           the full run's -s (four passes into 2^20-row tables, HK13,
           one shard each, stage 2 from the manifest; every pass parsed
           by the native parser, the first pass's parse seconds): payload and
           .fa/.log equal to the full run's, each stage's peak device
           memory beside the full run's; then quorum_create_database
           --partitions 4 --prefilter two-pass fed the full run's packed
           batches and quorum_error_correct_reads from its manifest:
           payload, header and .fa/.log equal to the two-pass run's;
           then quorum_create_database --partitions 4 at a -s
           one doubling short of what the passes need, fed the full
           run's packed batches: exactly one geometry restart, and the
           two_binary run's payload (same final geometry); launch
           counts reset before and read after each run
  pending  HK1's keys entry on the leftovers the two-binary build meets:
           the full run's batches into a table of the two_binary
           phase's first size; at each overflow the doubled table (HK8)
           takes the batch's leftover observations through the keys
           entry and, on a copy, through its plain version; at the first
           overflow HK16 against its plain version on that table sealed
           (rows up to full, keys far from their preferred slots)
  loaded   HK1 timed on one of the full run's batches, inserted into a
           table that already holds all its other batches (the load a
           late batch of the main path meets); HK2 sealing and HK8
           doubling that table, each held against its plain version; on
           that batch HK9 aggregating it, HK10 querying and updating a
           2^30-cell sketch that holds the other batches, and HK11's
           two-pass and inline entries inserting it into copies of the
           table, each held against its plain version and timed; then
           HK1's and HK11's partition entries (pass 1 of 4) inserting it
           into copies of a 2^20-row pass table that holds the other
           batches' pass-1 mers, and HK13 rebasing that table sealed
           (and a copy with a foreign entry planted, which must set
           `bad`), each held against its plain version and timed
  contaminant  quorum_error_correct_reads on its own from the full run's
           database and FASTQ with --contaminant (the adapter set and a
           5,000 bp segment of the genome), then with --trim-contaminant:
           reads whose true sequence holds no contaminant mer keep the
           full run's records, only such reads are skipped as
           contaminated (>= 90% of those inside the segment), and no
           trimmed read keeps a contaminant mer; launch counts reset
           before and read after each run
  table    HK7 loading and HK6 exporting the full run's database (the
           export with the file's count, as write_db passes the seal's,
           timed, and without it, timed; on the loaded table and on the
           driver's handoff table, every batch through HK1 and HK2, both
           equal to the file's payload; a count one off raising; and
           HK6's compact entry compacting it at caps 0, n - 7, n and
           n + 9, and one of its DEVICES row ranges; timed beside
           boolean-mask indexing), and HK5, HK3, HK4 and
           HK14 on the batch of it with the most contaminated reads
           against that table, HK5's and HK4's contaminant entries
           (kill and trim) with the contaminant phase's set and HK14 on
           their output, HK5's and HK4's sharded-table entries in the
           same three modes on that table taken as four shards (also
           held against the plane entries), and HK12 flooring the table
           at 2, each held against its plain version and timed there
  event    HK16 (both passes), HK17 and HK4's event entry, and HK16's
           and HK4's event sharded-table entries (the table as four
           shards, devices_routed_cap's layout), in the three
           contaminant modes on the table phase's batch and table, held
           against their plain versions and timed, HK4's event entries
           held again on that batch less its last read (lanes that fill
           no whole block) and the plane entry timed on its first
           quarter, HK16 held on that batch against the two_binary
           database loaded by HK7 (rows packed from slot 0), and all
           held on the golden reads with Ns (where event
           mode departs from the plain walk on some read); then the full
           cell's stage 2 from its database in event mode and in plain
           mode (event_driven=False), in that order: device step, host
           time, kernel time and launches of each; event mode's .fa/.log
           equal the full run's, and each mode's first 2,048 reads
           equal a --device cpu run of that mode on them;
           launch counts reset before and read after each run
  devices  --devices 4 on a mesh of four entries over the host's cards
           (all naming the card on a one-card host), fed the full run's
           packed batches: quorum_create_database's sharded build at the
           full run's -s (both layouts' payloads and the shards'
           occupancy equal to the full run's; route, copy, insert and
           seal seconds; peak memory), the replicated stage 2 on its
           table (.fa/.log equal to the full run's, one table copy:
           its peak above the resident table under the table's size),
           HK3's shard entry on that table against its plain version,
           the same stage 2 with the replicate cap forced under the
           table (devices_routed_cap: the routed layout, .fa/.log equal,
           its device step beside the replicated one's), the sharded
           build from the two_binary run's -s (its payload and number of
           grows), HK15 (and its partition entry) and HK1's and HK8's
           shard entries against their plain versions on batch 150 and a
           loaded 4-shard table, timed (HK15 beside torch.sort of its
           owner words); then quorum --devices 2 on the full FASTQ where
           the host has two cards, else that run held refused with a
           line saying so; launch counts reset before the build and read
           after stage 2, and again around each later run
  devices_partitions  --partitions 4 --devices 4 on that mesh at the full
           run's -s, fed the packed batches: four passes of sharded
           builds through HK15's partition entry, HK13, one manifest
           whose payload is the full run's and the partitions run's; HK15's
           partition entry launched on every shard in every batch of
           every pass; quorum --devices 2 --partitions 4 where the host
           has two cards, else a line saying it was not run
  devices_routed  the sharded build at 8x the full run's -s (rb_log2 25,
           4 x 2^23 rows, a 16 GiB table over 32 GiB of build state),
           written as a manifest; the routed stage 2 on the in-process
           handoff and again from the manifest (one HK7 launch a shard):
           .fa/.log equal to the full run's, the shards' occupancy
           summing to its entries, no replicated copy (stage-2 peak
           above the shards under 1 GiB); query_step (HK3's shard entry)
           on 1,048,576 of the table's mers against the full run's
           values for them
  flat     the flat bucket-4 table (K25): HK18, its grow entry, HK19 and
           HK20 against their plain versions on the full run's first 16
           batches from 2^24 buckets (k = 24, -b 7: the smallest table
           the layout allows), each build with the grow-retry protocol;
           then every batch's observations through insert_observations
           and grow_build from 2^24 buckets (it must grow), the seal,
           table_stats and 1,048,576 lookups: the table's map equal to
           the full run's database, grows, final nb_log2 and peak memory
  minimizer  HK21 against its plain version at 8192 x 150 (k = 24,
           m = 7), then every read through minimizer_kmers with
           bench.py's bin skew at P = 4 (address bins against minimizer
           bins) printed on its own line
  devices_unpacked  the unpacked --devices entries on the devices mesh:
           build_database_tile_sharded from the full cell's unpacked
           batches (payload equal to the devices build's),
           correct_step and correct_step_routed on 2,048-read slices
           (equal to correct_step_wire's results), and dryrun(mesh, 4)
Kernel times are medians of CUDA events around each C launch, each
timed call behind a ~1 ms spin on its stream (LEAD_CYCLES), so that
the host's work before the launch does not count.
Then one {"kernels": [...]} line (launches from the full, serve, pipeline,
telemetry (both runs), two_binary, paired (both runs), ref_format,
inspect, legacy, the three prefilter, the three partitioned, the two
contaminant, the devices runs, the routed and partitioned mesh runs
and the event phase's two runs and the flat, minimizer and
devices_unpacked runs, times and bounds from the kernels, loaded, table, event, devices, flat
and minimizer phases; HK5's and HK4's sharded-table entries from
the table phase, on its table as four shards; HK4's plain sharded-table
entry has no default-path caller since event mode is the default), the
card's name and power limit from nvidia-smi, and {"ok":
true, "device": {...}} as the last line.
Exits non-zero, with no result line, when CUDA is unavailable, outside
a checkout, or when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import filecmp
import gzip
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
WORK = os.path.join(ROOT, ".smoke_work")

GENOME_BP = 4_641_652  # E. coli K-12 MG1655
READ_LEN = 150
COVERAGE = 40
ERR_RATE = 0.01
LOW_Q_RATE = 0.10
K = 24
BATCH = 8192
SEED = 20261016
QT = 33 + 5  # the driver's stage-1 threshold for these quals (-q 33 -m 5)
H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet

SOURCES = {  # kernel -> (source in the repo, TPU program it replaces)
    "tile_insert": ("quorum_tpu_torch/kernels/csrc/tile_insert.cu",
                    "quorum_tpu/ops/ctable.py:1280"),
    "tile_seal": ("quorum_tpu_torch/kernels/csrc/tile_seal.cu",
                  "quorum_tpu/ops/ctable.py:1443"),
    "tile_lookup": ("quorum_tpu_torch/kernels/csrc/tile_lookup.cu",
                    "quorum_tpu/ops/ctable.py:677"),
    "extend_reads": ("quorum_tpu_torch/kernels/csrc/extend_reads.cu",
                     "quorum_tpu/models/corrector.py:1095"),
    "stage2_head": ("quorum_tpu_torch/kernels/csrc/stage2_head.cu",
                    "quorum_tpu/models/corrector.py:348"),
    "tile_export": ("quorum_tpu_torch/kernels/csrc/tile_export.cu",
                    "quorum_tpu/ops/ctable.py:1643"),
    # K22, HK6's compact entry, counted apart from the export
    "tile_export_compact": ("quorum_tpu_torch/kernels/csrc/tile_export.cu",
                            "quorum_tpu/ops/ctable.py:764"),
    "tile_load": ("quorum_tpu_torch/kernels/csrc/tile_load.cu",
                  "quorum_tpu/ops/ctable.py:787"),
    "tile_grow": ("quorum_tpu_torch/kernels/csrc/tile_grow.cu",
                  "quorum_tpu/ops/ctable.py:1521"),
    "batch_aggregate": ("quorum_tpu_torch/kernels/csrc/batch_aggregate.cu",
                        "quorum_tpu/ops/ctable.py:1016"),
    "sketch_update": ("quorum_tpu_torch/kernels/csrc/sketch_update.cu",
                      "quorum_tpu/ops/sketch.py:135"),
    "gated_insert": ("quorum_tpu_torch/kernels/csrc/gated_insert.cu",
                     "quorum_tpu/ops/sketch.py:208"),
    "tile_floor": ("quorum_tpu_torch/kernels/csrc/tile_floor.cu",
                   "quorum_tpu/ops/ctable.py:1608"),
    "tile_departition": ("quorum_tpu_torch/kernels/csrc/tile_departition.cu",
                         "quorum_tpu/ops/ctable.py:1566"),
    "pack_finish": ("quorum_tpu_torch/kernels/csrc/pack_finish.cu",
                    "quorum_tpu/models/corrector.py:2038"),
    "shard_route": ("quorum_tpu_torch/kernels/csrc/shard_route.cu",
                    "quorum_tpu/parallel/tile_sharded.py:275"),
    # HK1's and HK8's shard entries, counted apart from their kernels
    "tile_insert_shard": ("quorum_tpu_torch/kernels/csrc/tile_insert.cu",
                          "quorum_tpu/parallel/tile_sharded.py:286"),
    "tile_grow_shard": ("quorum_tpu_torch/kernels/csrc/tile_grow.cu",
                        "quorum_tpu/parallel/tile_sharded.py:483"),
    # the routed stage-2 layout: HK3's shard entry, HK5's and HK4's
    # sharded-table entries; --partitions with --devices: HK15's
    # partition entry
    "tile_lookup_shard": ("quorum_tpu_torch/kernels/csrc/tile_lookup.cu",
                          "quorum_tpu/parallel/tile_sharded.py:706"),
    "stage2_head_shard": ("quorum_tpu_torch/kernels/csrc/stage2_head.cu",
                          "quorum_tpu/parallel/tile_sharded.py:878"),
    "extend_reads_shard": ("quorum_tpu_torch/kernels/csrc/extend_reads.cu",
                           "quorum_tpu/parallel/tile_sharded.py:909"),
    "shard_route_part": ("quorum_tpu_torch/kernels/csrc/shard_route.cu",
                         "quorum_tpu/parallel/tile_sharded.py:421"),
    # the event-mode stage 2 (the default): HK16, HK17, HK4's event entry,
    # and HK16's and HK4's event sharded-table entries (the routed layout)
    "event_planes": ("quorum_tpu_torch/kernels/csrc/event_planes.cu",
                     "quorum_tpu/models/corrector.py:1324"),
    "event_scan": ("quorum_tpu_torch/kernels/csrc/event_scan.cu",
                   "quorum_tpu/models/corrector.py:1670"),
    "extend_reads_event": ("quorum_tpu_torch/kernels/csrc/extend_reads.cu",
                           "quorum_tpu/models/corrector.py:549"),
    "event_planes_shard": ("quorum_tpu_torch/kernels/csrc/event_planes.cu",
                           "quorum_tpu/parallel/tile_sharded.py:951"),
    "extend_reads_event_shard": (
        "quorum_tpu_torch/kernels/csrc/extend_reads.cu",
        "quorum_tpu/parallel/tile_sharded.py:951"),
    # the flat bucket-4 table (HK18-HK20, HK18's grow entry counted apart)
    # and the minimizer (HK21)
    "flat_insert": ("quorum_tpu_torch/kernels/csrc/flat_insert.cu",
                    "quorum_tpu/ops/ctable.py:380"),
    "flat_grow": ("quorum_tpu_torch/kernels/csrc/flat_insert.cu",
                  "quorum_tpu/ops/ctable.py:434"),
    "flat_lookup": ("quorum_tpu_torch/kernels/csrc/flat_lookup.cu",
                    "quorum_tpu/ops/ctable.py:306"),
    "flat_finalize": ("quorum_tpu_torch/kernels/csrc/flat_finalize.cu",
                      "quorum_tpu/ops/ctable.py:404"),
    "minimizer": ("quorum_tpu_torch/kernels/csrc/minimizer.cu",
                  "quorum_tpu/ops/mer.py:266"),
}
# the kernels each main-path run must launch (HK3's probe runs inside
# HK5, HK16 and HK4; the query CLI is its caller); every stage 2 runs
# event mode (HK5, HK16, HK17, HK4's event entry) and ends a batch with
# HK14
S2 = ("stage2_head", "event_planes", "event_scan", "extend_reads_event",
      "pack_finish")
PATH_KERNELS = {
    "full": ("tile_insert", "tile_seal", "tile_export", *S2),
    # the same driver run at -t 1 --render-workers 1
    "pipeline": ("tile_insert", "tile_seal", "tile_export", *S2),
    "two_binary": ("tile_insert", "tile_grow", "tile_seal", "tile_export",
                   "tile_load", *S2),
    "prefilter_two_pass": ("batch_aggregate", "sketch_update", "gated_insert",
                           "tile_seal", "tile_export", "tile_floor", *S2),
    "prefilter_inline": ("batch_aggregate", "sketch_update", "gated_insert",
                         "tile_seal", "tile_export", "tile_floor", *S2),
    # stand-alone stage 2 with --contaminant FASTA: HK1 and HK2 count the
    # contaminant set, HK7 loads the database
    "contaminant": ("tile_insert", "tile_seal", "tile_load", *S2),
    "contaminant_trim": ("tile_insert", "tile_seal", "tile_load", *S2),
}
# a gated build that grows adds HK8 and HK1's keys entry
PATH_KERNELS["prefilter_two_pass_grow"] = (
    PATH_KERNELS["prefilter_two_pass"] + ("tile_grow", "tile_insert"))
# the partitioned paths: each pass seals, rebases (HK13) and exports its
# shard; stage 2 loads the manifest (HK7); the restart run is stage 1
PATH_KERNELS.update({
    "partitions": ("tile_insert", "tile_seal", "tile_departition",
                   "tile_export", "tile_load", *S2),
    "partitions_two_pass": ("batch_aggregate", "sketch_update",
                            "gated_insert", "tile_seal", "tile_departition",
                            "tile_export", "tile_load", "tile_floor", *S2),
    "partitions_restart": ("tile_insert", "tile_seal", "tile_departition",
                           "tile_export"),
})
# --devices 4 on a mesh of four entries: the sharded build with its
# export and the replicated stage 2; the grown build is stage 1 only
PATH_KERNELS.update({
    "devices": ("shard_route", "tile_insert_shard", "tile_seal",
                "tile_export", *S2),
    "devices_single": ("shard_route", "tile_insert_shard", "tile_seal",
                       "tile_export"),
    "devices_grow": ("shard_route", "tile_insert_shard", "tile_grow_shard",
                     "tile_seal", "tile_export"),
})
# the routed stage-2 layout: the 2^25-row build, its stage 2 on the
# handoff and the routed query; its stage 2 from the manifest (HK7 a
# shard); the devices table's stage 2 under a forced replicate cap; and
# --partitions 4 over the mesh (stage 1)
S2_SHARD = ("stage2_head_shard", "event_planes_shard", "event_scan",
            "extend_reads_event_shard", "pack_finish")
PATH_KERNELS.update({
    "devices_routed": ("shard_route", "tile_insert_shard", "tile_seal",
                       "tile_export", "tile_lookup_shard", *S2_SHARD),
    "devices_routed_manifest": ("tile_load", *S2_SHARD),
    "devices_routed_cap": S2_SHARD,
    "devices_partitions": ("shard_route_part", "tile_insert_shard",
                           "tile_seal", "tile_departition", "tile_export"),
})
# the event phase: the full cell's stage 2 from its database in event
# mode and in plain mode (event_driven=False: HK4's plain entry)
PATH_KERNELS.update({
    "event": ("tile_load", *S2),
    "event_plain": ("tile_load", "stage2_head", "extend_reads",
                    "pack_finish"),
})
# the flat table over the whole cell (insert, grows, seal, lookups of
# the full run's mers), the minimizer over every read, and the
# unpacked --devices entries (sharded build, both stage-2 layouts, the
# dryrun, whose one-card reference is the plane corrector)
PATH_KERNELS.update({
    "flat": ("flat_insert", "flat_grow", "flat_finalize", "flat_lookup"),
    "minimizer": ("minimizer",),
    "devices_unpacked": ("shard_route", "tile_insert_shard", "tile_seal",
                         *S2, *S2_SHARD, "tile_lookup_shard",
                         "tile_export_compact"),
})
# the driver's -P and its -d comparison run (stage 1 exports the v5
# file); stage 1 with --ref-format and stage 2 from the reference-format
# and v5 files; the inspection CLIs on both files (HK7 places each
# table, HK3 answers the queries); stage 2 from v1-v3 files and the v5
# file (HK7)
PATH_KERNELS.update({
    "paired": ("tile_insert", "tile_seal", "tile_export", *S2),
    "ref_format": ("tile_insert", "tile_seal", "tile_load", *S2),
    "inspect": ("tile_load", "tile_lookup"),
    "legacy": ("tile_load", *S2),
})
# the telemetry phase: the full run's driver with --metrics
# --metrics-interval --trace-spans, then with --profile --metrics
PATH_KERNELS.update({"telemetry": PATH_KERNELS["full"],
                     "telemetry_profile": PATH_KERNELS["full"]})
# the resume phase: stage 1 resumed from a snapshot (its table back on
# the card, then HK1, HK2 and HK6 over the rest), stage 2 resumed from a
# journal over the full run's database (HK7, then the event path)
PATH_KERNELS.update({"resume_stage1": ("tile_insert", "tile_seal",
                                       "tile_export"),
                     "resume_stage2": ("tile_load", *S2)})
# the serve phase: quorum-serve on the full run's v5 file (HK7 at boot,
# at the watchdog's rebuild and at a reload; HK3 counts the warmup's
# representative read; every step the event path)
PATH_KERNELS["serve"] = ("tile_load", "tile_lookup", *S2)
# the sharded build's device time by step (CUDA events, STATS.timing):
# the step's name -> the counter or span its events are kept under
SPLIT = {"route": "shard_route", "exchange": "exchange",
         "insert": "tile_insert_shard", "grow": "tile_grow_shard",
         "seal": "tile_seal", "export": "tile_export"}
PARTS = 4  # --partitions in the partitioned runs
# the contaminant phase's genome segment: a 5,000 bp spike-in
SEGMENT = (1_000_000, 1_005_000)
# the event phase's --device cpu check: the first reads of the full run
CPU_READS = 2048


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


START = time.perf_counter()  # run() sets it again


def emit(obj):
    """Print one JSON line; a phase's line carries the script's elapsed
    seconds at its end."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - START, 1)}
    print(json.dumps(obj), flush=True)


# work that runs in a process of its own beside later phases: the child
# imports this script, calls one of its functions on JSON arguments, and
# prints that function's phase lines and, last, its JSON result
CHILD = """
import json, sys
import chip_smoke
chip_smoke.START = float(sys.argv[1])
out = getattr(chip_smoke, sys.argv[2])(*json.loads(sys.argv[3]))
print(json.dumps(out), flush=True)
"""
CHILDREN: list = []  # started and not yet joined (run() ends them)


def child_start(fn: str, *args, env: dict | None = None):
    """Start `fn(*args)` of this script in a process of its own (its
    phase lines keep this run's elapsed seconds: perf_counter is the
    host's monotonic clock)."""
    p = subprocess.Popen(
        [sys.executable, "-c", CHILD, repr(START), fn, json.dumps(args)],
        cwd=ROOT, env=dict(os.environ) if env is None else env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    CHILDREN.append(p)
    return p


def child_join(p, what: str, timeout: float = 900):
    """Wait for a child_start process: print its phase lines, return its
    result; fail with its stderr's tail if it failed."""
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        out, err = "", f"no end within {timeout} s"
    CHILDREN.remove(p)
    lines = out.strip().splitlines()
    check(p.returncode == 0 and lines,
          f"{what} (a process of its own) rc {p.returncode}: {err[-800:]}")
    for ln in lines[:-1]:
        print(ln, flush=True)
    return json.loads(lines[-1])


def stop_children() -> None:
    """End every child_start process not yet joined (a failed run)."""
    while CHILDREN:
        p = CHILDREN.pop()
        if p.poll() is None:
            p.kill()
        p.communicate()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------- data


def synth_reads(gen, genome_bp: int, coverage: int, low_q: bool = True):
    """Seeded genome and reads (torch.Generator on the CPU): 150 bp from
    random positions and strands, 1% substitutions, ~10% low-quality
    bases. Returns (genome codes, codes [n, 150] int8 with the errors,
    true codes [n, 150], quals [n, 150] uint8, origins [n] int64: each
    read's first genome position)."""
    import torch

    genome = torch.randint(0, 4, (genome_bp,), generator=gen,
                           dtype=torch.int8)
    n = -(-genome_bp * coverage // READ_LEN)  # reads for the coverage
    start = torch.randint(0, genome_bp - READ_LEN + 1, (n,), generator=gen)
    idx = start[:, None] + torch.arange(READ_LEN)[None, :]
    true = genome[idx]
    rev = torch.rand(n, generator=gen) < 0.5
    true[rev] = (3 - true[rev]).flip(1)
    err = torch.rand((n, READ_LEN), generator=gen) < ERR_RATE
    shift = torch.randint(1, 4, (n, READ_LEN), generator=gen,
                          dtype=torch.int8)
    codes = torch.where(err, (true + shift) % 4, true)
    hi = torch.full((n, READ_LEN), 33 + 40, dtype=torch.uint8)
    if low_q:
        lowq = torch.rand((n, READ_LEN), generator=gen) < LOW_Q_RATE
        hi[lowq] = 33 + 2
    return genome, codes, true, hi, start


def write_fastq(path: str, codes, quals, suffix: bytes = b""):
    """Fixed-width records: @r<9 digits><suffix>\\n seq \\n+\\n qual \\n."""
    import numpy as np

    n, l = codes.shape
    acgt = np.frombuffer(b"ACGT", np.uint8)
    h = 12 + len(suffix)  # len(b"@r%09d" + suffix + b"\n")
    rec = np.empty((n, h + l + 3 + l + 1), np.uint8)
    rec[:, :h] = np.frombuffer(
        b"".join(b"@r%09d%s\n" % (i, suffix) for i in range(n)),
        np.uint8).reshape(n, h)
    rec[:, h:h + l] = acgt[codes.numpy()]
    rec[:, h + l:h + l + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, h + l + 3:h + 2 * l + 3] = quals.numpy()
    rec[:, -1] = ord("\n")
    rec.tofile(path)


def pack_batch(codes, quals, qt: int):
    """One parser-shaped batch (BATCH rows, -2 / 0 padding) of up to
    BATCH reads, packed with the qual >= qt plane."""
    import numpy as np

    from quorum_tpu_torch.io import fastq, packing

    n = codes.shape[0]
    L = fastq.bucket_for(READ_LEN)
    c = np.full((BATCH, L), -2, np.int8)
    q = np.zeros((BATCH, L), np.uint8)
    c[:n, :READ_LEN] = codes.numpy()
    q[:n, :READ_LEN] = quals.numpy()
    lengths = np.zeros(BATCH, np.int32)
    lengths[:n] = READ_LEN
    return c, q, lengths, packing.pack_reads(c, q, lengths, thresholds=(qt,))


def table_size(bases: int, genome_bp: int) -> int:
    """-s as bench.py sizes it: genome mers + ~k error mers per error."""
    return int((genome_bp + bases * ERR_RATE * K * 1.3) * 1.25) + 1_000_000


def write_contaminant(path: str, segment) -> list:
    """A contaminant FASTA: the port's adapter set (data.adapter_fasta),
    then `segment` (genome codes, int8) as one record. Returns the
    records as (header, sequence)."""
    import numpy as np

    from quorum_tpu_torch import data

    data.adapter_fasta(path)
    seq = np.frombuffer(b"ACGT", np.uint8)[segment.numpy()].tobytes().decode()
    with open(path, "a") as f:
        f.write(f">segment\n{seq}\n")
    return list(data.adapter_records()) + [("segment", seq)]


def load_contaminant(path: str):
    """The port's contaminant set of a FASTA at k = K on the card."""
    from quorum_tpu_torch.io import contaminant

    return contaminant.load_contaminant(path, K, "cuda")


_LUT = [-1] * 256
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i


def contaminant_set(records):
    """Every canonical K-mer of the records' ACGT windows, sorted unique
    int64, in numpy (f = sum c_j 4^(K-1-j), its reverse complement
    sum (3 - c_j) 4^j), apart from the port's ops/mer."""
    import numpy as np

    lut = np.array(_LUT, np.int64)
    p = 4 ** np.arange(K - 1, -1, -1, dtype=np.int64)
    out = []
    for _h, seq in records:
        c = lut[np.frombuffer(seq.encode(), np.uint8)]
        if len(c) < K:
            continue
        w = np.lib.stride_tricks.sliding_window_view(c, K)
        f, r = w @ p, (3 - w) @ p[::-1]
        out.append(np.minimum(f, r)[(w >= 0).all(1)])
    return np.unique(np.concatenate(out))


def holds_mer(codes, cset):
    """Which rows of `codes` (int8 [n, L] on the CPU, -1 = not ACGT)
    hold an all-ACGT K-mer of `cset` (sorted int64 on the card), with
    the same arithmetic as contaminant_set, on the card in chunks."""
    import torch

    p = 4 ** torch.arange(K - 1, -1, -1, device="cuda", dtype=torch.int64)
    out = torch.zeros(codes.shape[0], dtype=torch.bool)
    for s in range(0, codes.shape[0], 1 << 15):
        w = codes[s:s + (1 << 15)].to("cuda", torch.int64).unfold(1, K, 1)
        c = w.clamp(min=0)
        m = torch.minimum((c * p).sum(-1), ((3 - c) * p.flip(0)).sum(-1))
        at = torch.searchsorted(cset, m).clamp(max=cset.numel() - 1)
        hit = (cset[at] == m) & (w >= 0).all(-1)
        out[s:s + (1 << 15)] = hit.any(1).cpu()
    return out


def read_outputs(prefix: str):
    """A stage-2 run's records by read index: {i: .fa record} and {i:
    .log line} (reads are named r<9 digits>)."""
    with open(prefix + ".fa", "rb") as f:
        lines = f.read().split(b"\n")
    fa = {int(h[2:11]): h + b"\n" + q
          for h, q in zip(lines[0::2], lines[1::2]) if h}
    with open(prefix + ".log", "rb") as f:
        log = {int(ln[9:18]): ln for ln in f.read().split(b"\n") if ln}
    return fa, log, lines[1::2]


def seq_codes(seqs, width: int):
    """ASCII sequences -> int8 codes [n, width], -1 past each (and for a
    non-ACGT base)."""
    import numpy as np
    import torch

    lens = np.fromiter(map(len, seqs), np.int64, len(seqs))
    buf = np.frombuffer(b"".join(seqs) + b"N", np.uint8)
    idx = (np.cumsum(lens) - lens)[:, None] + np.arange(width)[None, :]
    inside = np.arange(width)[None, :] < lens[:, None]
    lut = np.array(_LUT, np.int8)
    return torch.from_numpy(np.where(inside, lut[buf[np.minimum(
        idx, len(buf) - 1)]], -1).astype(np.int8))


# ------------------------------------------------------------- timing


# A timed call starts behind a spin of LEAD_CYCLES clocks on its stream
# (torch.cuda._sleep, ~1 ms), so that the card is busy while the host
# checks the wrapper's arguments, allocates its outputs, marshals the C
# launcher's arguments and launches: the first event then fires when the
# spin ends, with the launch already queued behind it, and the events
# bracket the device's work alone. Without the spin the card waits idle
# between the first event and the launch, and that wait counts too.
LEAD_CYCLES = 2_000_000


def lead() -> None:
    """Queue the spin ahead of a timed call."""
    import torch

    torch.cuda._sleep(LEAD_CYCLES)


def event_ms(fn, reps: int, setup=None) -> float:
    """Median CUDA-event time of fn() over reps (setup() outside), each
    behind the lead spin."""
    import torch

    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        lead()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_ms(fn, name: str, reps: int, setup=None, detail=None) -> float:
    """Median time of the kernel's own C launches (loader events around
    each, summed over the wrapper call), each call behind the lead spin.
    With a `detail` dict, also the median time of each C launcher and of
    the whole wrapper call (`span`, with the host work between its
    launches)."""
    import torch

    from quorum_tpu_torch.kernels.loader import STATS

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    times, spans, per = [], [], {}
    for _ in range(reps):
        if setup is not None:
            setup()
        STATS.events.clear()
        STATS.calls.clear()
        torch.cuda.synchronize()
        lead()
        STATS.timing = True
        try:
            fn()
        finally:
            STATS.timing = False
        torch.cuda.synchronize()
        # one wrapper call: one event, or one a phase (a bucket pass)
        ev = [(a, b) for n, a, b in STATS.events if n == name]
        check(len(ev) in (1, 2), f"{name}: expected one timed launch")
        spans.append(ev[0][0].elapsed_time(ev[-1][1]))
        calls = [(f, a.elapsed_time(b)) for n, f, a, b in STATS.calls
                 if n == name]
        times.append(sum(t for _f, t in calls))
        for f, t in calls:
            per.setdefault(f, []).append(t)
    if detail is not None:
        detail["span"] = median(spans)
        detail.update({f: median(v) for f, v in per.items()})
    return median(times)


class DeviceBusy:
    """The card's busy seconds over a window: the union of every device
    activity interval (kernels, copies, sets) torch.profiler's CUPTI
    records. Read `busy_s` and `wall_s` after the block."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in self.prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy, end = 0, None
        for a, b in spans:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        self.busy_s = busy / 1e6
        self.events = len(spans)
        del self.prof
        return False


class StagePeaks:
    """Each stage's peak device memory in one quorum driver run, less
    what this script held on the card when the run began: the peak
    statistic is read and reset where the driver calls stage 2 (its
    error_correct_reads.main, wrapped for the run)."""

    def __enter__(self):
        import torch

        from quorum_tpu_torch.cli import error_correct_reads as ec

        self.ec, self.orig = ec, ec.main
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.resident = torch.cuda.memory_allocated()
        self.stage1 = self.stage2 = None

        def stage2(*a, **kw):
            torch.cuda.synchronize()
            self.stage1 = torch.cuda.max_memory_allocated() - self.resident
            torch.cuda.reset_peak_memory_stats()
            try:
                return self.orig(*a, **kw)
            finally:
                torch.cuda.synchronize()
                self.stage2 = (torch.cuda.max_memory_allocated()
                               - self.resident)

        ec.main = stage2
        return self

    def __exit__(self, *exc):
        self.ec.main = self.orig
        return False

    def as_dict(self) -> dict:
        return {"stage1": self.stage1, "stage2": self.stage2}


# ------------------------------------------------------------- phases


def phase_build():
    from quorum_tpu_torch.kernels import loader

    t0 = time.perf_counter()
    reports = loader.build_all()
    for name in loader.KERNELS:
        loader.library(name)
    regs = {n: [ln.strip() for ln in r.splitlines() if "registers" in ln]
            for n, r in reports.items()}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": regs})


def _export(state, meta):
    from quorum_tpu_torch.ops import ctable

    return ctable.tile_export_v4(state, meta)


def phase_kernels(card: str) -> dict:
    """Each kernel vs its plain version on the same CUDA inputs."""
    import numpy as np
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.io import packing
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.models import create_database
    from quorum_tpu_torch.ops import ctable

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    # one full batch at the main path's shape: a 30 kbp genome at 40x
    # (anchors form), inserted into the main path's table geometry
    genome, codes, _t, quals, _o = synth_reads(gen, 30_720, COVERAGE)
    b = BATCH
    c, q, lengths, pk = pack_batch(codes, quals, QT)
    L = pk.length
    wire = torch.from_numpy(pk.to_wire()).to(dev)
    full_bases = -(-GENOME_BP * COVERAGE // READ_LEN) * READ_LEN
    meta = ctable.TileMeta(K, 7, ctable.tile_rb_for(
        table_size(full_bases, GENOME_BP), K, 7))
    out = {}

    # --- HK1 + HK2: same batch, kernel build vs plain build
    bk = ctable.make_tile_build(meta, dev)
    full, pend = kernels.tile_insert_reads(bk, meta, wire, b, L,
                                           pk.thresholds, QT)
    check(not full, "tile_insert: main-path table reported full")
    bp = ctable.make_tile_build(meta, dev)
    left = ref.tile_insert_reads(bp, meta, wire, b, L, pk.thresholds, QT)
    check(left[0].numel() == 0, "plain insert: main-path table full")
    rows_k, stats_k = kernels.tile_seal(bk, meta)
    rows_kp, stats_kp = ref.tile_seal(bk, meta)
    seal_equal = (torch.equal(rows_k, rows_kp)
                  and torch.equal(stats_k, stats_kp))
    rows_p, stats_p = ref.tile_seal(bp, meta)
    ins_equal = (np.array_equal(_export(ctable.TileState(rows_k), meta),
                                _export(ctable.TileState(rows_p), meta))
                 and torch.equal(stats_k, stats_p))
    check(int(stats_k[0]) == 0, "tile_seal: duplicate tag pair")
    del rows_kp, rows_p, bp

    # a small table that must grow: the whole build, kernels vs plain
    # (plain on the CPU, whose wrappers take the plain versions)
    gsmall = torch.Generator().manual_seed(SEED + 2)
    _g2, c2, _t2, q2, _o2 = synth_reads(gsmall, 4_000, 20)
    rb = [packing.pack_reads(c2.numpy(), q2.numpy(),
                             np.full(c2.shape[0], READ_LEN, np.int32),
                             thresholds=(QT,))]

    def batches():
        from quorum_tpu_torch.io.fastq import ReadBatch
        for p in rb:
            yield ReadBatch(None, None, p.lengths, [], p.n_reads), p

    gcfg = create_database.BuildConfig(k=K, bits=7, qual_thresh=QT,
                                       initial_size=100, batch_size=BATCH)
    sk, mk, stk = create_database.build_database([], gcfg, dev, batches)
    sp, mp, stp = create_database.build_database([], gcfg,
                                                 torch.device("cpu"),
                                                 batches)
    grow_equal = (stk.grows >= 2 and mk == mp
                  and np.array_equal(_export(sk, mk), _export(sp, mp))
                  and (stk.distinct, stk.distinct_hq, stk.total_hq)
                  == (stp.distinct, stp.distinct_hq, stp.total_hq))
    check(ins_equal, "tile_insert differs from its plain version")
    check(grow_equal, "tile_insert/tile_seal differ through grows")
    check(seal_equal, "tile_seal differs from its plain version")
    shapes = insert_shapes()
    head = head_shapes()
    packs = pack_shapes()
    sealx = seal_export_shapes()

    # HK1's and HK2's times come from the loaded phase, at the load the
    # main path meets (HK2's same-address counter atomics grow with it)
    cw, hqb = ref.widen_wire(wire, b, L, pk.thresholds, QT)
    _keys, _q, valid = ref.extract_observations(cw, hqb, K)
    out["tile_insert"] = dict(equal=ins_equal and grow_equal,
                              n=int(valid.sum()), shapes=shapes)
    out["tile_seal"] = dict(equal=seal_equal, n=meta.rows * 64,
                            bound_bytes=meta.rows * (512 + 512 + 512) + 32,
                            dense=sealx["dense"]["tile_seal"])
    # the export's main-path figures come from the table phase
    out["tile_export"] = dict(equal=sealx["dense"]["tile_export"]["equal"],
                              n=sealx["dense"]["tile_export"]["n"],
                              dense=sealx["dense"]["tile_export"])
    del bk

    # --- HK5, HK3, HK4: the batch with Ns, short reads and reads with
    # no anchor (timed later, on the full run's table)
    g4 = torch.Generator().manual_seed(SEED + 3)
    c4 = c.copy()
    inread = np.arange(L)[None, :] < lengths[:, None]
    c4[(torch.rand(c4.shape, generator=g4).numpy() < 0.01) & inread] = -1
    l4 = lengths.copy()
    short = (torch.rand(b, generator=g4).numpy() < 0.05) & (l4 > 0)
    l4[short] = torch.randint(5, 60, (int(short.sum()),),
                              generator=g4).numpy()
    rnd_reads = (torch.rand(b, generator=g4).numpy() < 0.03) & (l4 > 0)
    c4[rnd_reads, :READ_LEN] = torch.randint(
        0, 4, (int(rnd_reads.sum()), READ_LEN), generator=g4).numpy()
    c4[np.arange(L)[None, :] >= l4[:, None]] = -2
    # a contaminant set: the adapters and a 2 kbp segment of the genome
    fa = os.path.join(WORK, "kernels_contaminant.fa")
    write_contaminant(fa, genome[10_000:12_000])
    contam = load_contaminant(fa)
    out.update(stage2_kernels(ctable.TileState(rows_k), meta, c4, q, l4,
                              reps=0, contam=contam))
    out.update(event_kernels(ctable.TileState(rows_k), meta, c4, q, l4,
                             reps=0, contam=contam, shards=False)[0])
    emit({"kernels": [{"name": nm, "equal": bool(v["equal"]), "n": v["n"]}
                      for nm, v in out.items()],
          "tile_insert_shapes": {f"k{k}": v for k, v in shapes.items()},
          "stage2_head_shapes": {f"k{k}": v for k, v in head.items()},
          "pack_finish_shapes": packs,
          "seal_export_shapes": sealx["shapes"], "card": card})
    return out


# HK1's reads entry at the shapes other than the main path's: k = 13, 24
# and 31 (62-bit windows), reads of 5 to 157 bases (shorter than k too)
# in rows 157 bases wide (code, N and qual rows of 40 and 20 bytes, no
# multiple of 8)
SHAPE_KS = (13, 24, 31)
SHAPE_WIDTH = 157


def insert_shapes() -> dict:
    """HK1 against its plain version at SHAPE_KS on 3,072 seeded reads of
    mixed lengths with ~1% Ns: one batch into a roomy table (the sealed
    exports and statistics equal), and the whole build from 100 slots,
    which fails most windows of its first batches past the failure list
    (the wrapper's second, listing launch) and grows through HK8 and the
    keys entry (kernels on the card against the plain versions on the
    CPU: equal exports, statistics and grows)."""
    import numpy as np
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.io import packing
    from quorum_tpu_torch.io.fastq import ReadBatch
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.models import create_database
    from quorum_tpu_torch.ops import ctable

    rng = np.random.default_rng(SEED + 7)
    b, w = 3072, SHAPE_WIDTH
    genome = rng.integers(0, 4, 20_000).astype(np.int8)
    lengths = rng.integers(5, w + 1, b).astype(np.int32)
    start = rng.integers(0, genome.size - w, b)
    codes = genome[start[:, None] + np.arange(w)[None, :]]
    codes = np.where(rng.random((b, w)) < 0.01, -1, codes).astype(np.int8)
    quals = rng.integers(33, 75, (b, w)).astype(np.uint8)
    outside = np.arange(w)[None, :] >= lengths[:, None]
    codes[outside], quals[outside] = -2, 0
    batches = [(ReadBatch(None, None, lengths[a:a + 1024], [], 1024),
                packing.pack_reads(codes[a:a + 1024], quals[a:a + 1024],
                                   lengths[a:a + 1024], thresholds=(QT,)))
               for a in range(0, b, 1024)]
    out = {}
    for k in SHAPE_KS:
        meta = ctable.TileMeta(k, 7, 12)
        pk = batches[0][1]
        wire = torch.from_numpy(pk.to_wire()).to("cuda")
        args = (wire, pk.n_reads, pk.length, pk.thresholds, QT)
        bk = ctable.make_tile_build(meta, "cuda")
        bp = ctable.make_tile_build(meta, "cuda")
        full, _left = kernels.tile_insert_reads(bk, meta, *args)
        left_p, _q = ref.tile_insert_reads(bp, meta, *args)
        sk, st_k = kernels.tile_seal(bk, meta)
        sp, st_p = kernels.tile_seal(bp, meta)
        one = (not full and left_p.numel() == 0 and torch.equal(st_k, st_p)
               and torch.equal(kernels.tile_export(sk, meta),
                               kernels.tile_export(sp, meta)))
        cfg = create_database.BuildConfig(k=k, bits=7, qual_thresh=QT,
                                          initial_size=100, batch_size=1024)
        gk, mk, stk = create_database.build_database(
            [], cfg, torch.device("cuda"), lambda: batches)
        gp, mp, stp = create_database.build_database(
            [], cfg, torch.device("cpu"), lambda: batches)
        grown = (stk.grows >= 2 and mk == mp and stk.grows == stp.grows
                 and np.array_equal(_export(gk, mk), _export(gp, mp))
                 and (stk.distinct, stk.distinct_hq, stk.total_hq)
                 == (stp.distinct, stp.distinct_hq, stp.total_hq))
        out[k] = dict(one_batch_equal=one, build_equal=grown,
                      grows=stk.grows, distinct=stk.distinct)
        check(one and grown, f"tile_insert differs from its plain version "
              f"at k = {k}, width {w}")
    return out


# HK5's anchor scan at the shapes its control flow can get wrong: the
# (skip, good) pairs beside the default (1, 2), and the chunk lanes of an
# anchor at a chunk's edge (the scan takes window ends 32 at a time from
# skip + k - 1): a chunk's last lane, or its first three past the first
# chunk (a run that crossed the edge)
HEAD_MODES = ((1, 2), (0, 1), (3, 4))
EDGE_LANES = (0, 1, 2, 31)


def head_shapes() -> dict:
    """HK5 against its plain version at SHAPE_KS on 2,048 seeded reads of
    5-157 bases in rows SHAPE_WIDTH wide, against a table built (HK1,
    HK2) from clean reads of their 5 kbp genome at ~64x: the plane entry
    at every (skip, good) of HEAD_MODES, the sharded-table entry on the
    table as DEVICES row ranges, and the contaminant entry (kill, trim)
    with a 400 bp segment of the genome as the set. The reads hold 1% Ns
    and 0.5% substitutions; an empty read and reads shorter than k;
    random sequence (no anchor), half with an N at position 0; and reads
    whose first bases up to a random q are N, so that the first valid
    window ends at q + k and anchors fall on every chunk lane, the
    chunks' edges included. Every output of every call must equal the
    plain version's; each k and mode must anchor reads at EDGE_LANES of
    a chunk and leave reads without an anchor."""
    import numpy as np
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.io import packing
    from quorum_tpu_torch.io.contaminant import load_contaminant as load_set
    from quorum_tpu_torch.io.fastq import ReadBatch
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.models import create_database
    from quorum_tpu_torch.ops import ctable
    from quorum_tpu_torch.parallel import tile_sharded as ts

    rng = np.random.default_rng(SEED + 8)
    gbp, n, w, qc = 5_000, 2048, SHAPE_WIDTH, 33 + 40
    genome = rng.integers(0, 4, gbp).astype(np.int8)
    start = rng.integers(0, gbp - w, n)
    clean = genome[start[:, None] + np.arange(w)[None, :]]
    quals = np.where(rng.random((n, w)) < 0.1, 33 + 27,
                     33 + 42).astype(np.uint8)
    quals[rng.random((n, w)) < 0.01] = 33 + 2
    full_len = np.full(n, w, np.int32)
    batches = [(ReadBatch(None, None, full_len[a:a + 1024], [], 1024),
                packing.pack_reads(clean[a:a + 1024], quals[a:a + 1024],
                                   full_len[a:a + 1024], thresholds=(QT,)))
               for a in range(0, n, 1024)]
    fa = os.path.join(WORK, "head_shapes.fa")
    with open(fa, "w") as f:
        f.write(">segment\n" + np.frombuffer(b"ACGT", np.uint8)[
            genome[2_000:2_400]].tobytes().decode() + "\n")
    out = {}
    for k in SHAPE_KS:
        cfg = create_database.BuildConfig(k=k, bits=7, qual_thresh=QT,
                                          initial_size=1 << 16,
                                          batch_size=1024)
        state, meta, _st = create_database.build_database(
            [], cfg, torch.device("cuda"), lambda: batches)
        cset = load_set(fa, k, "cuda")
        smeta = ts.RoutedTileMeta(k=k, bits=meta.bits, rb_log2=meta.rb_log2,
                                  n_shards=DEVICES)
        shards = list(ts.row_shards(state, smeta, ["cuda"] * DEVICES).shards)
        codes = clean.copy()
        lengths = rng.integers(5, w + 1, n).astype(np.int32)
        lengths[0] = 0
        lengths[1:41] = rng.integers(1, k, 40)
        rnd = np.arange(41, 101)
        codes[rnd] = rng.integers(0, 4, (rnd.size, w))
        codes[rnd[::2], 0] = -1
        edge = np.arange(101, 701)
        lengths[edge] = w
        q = rng.integers(0, w - k - 8, edge.size)
        codes[edge] = np.where(np.arange(w)[None, :] <= q[:, None], -1,
                               codes[edge])
        rest = np.arange(701, n)
        sub = rng.random((rest.size, w)) < 0.005
        codes[rest] = np.where(sub, (codes[rest] + rng.integers(1, 4, (
            rest.size, w))) % 4, codes[rest])
        codes[rest] = np.where(rng.random((rest.size, w)) < 0.01, -1,
                               codes[rest])
        outside = np.arange(w)[None, :] >= lengths[:, None]
        codes[outside] = -2
        qs = np.where(outside, 0, quals)
        pk = packing.pack_reads(codes, qs, lengths, thresholds=(qc,))
        wire = torch.from_numpy(pk.to_wire()).to("cuda")
        tail = (wire, n, pk.length, pk.thresholds, qc)
        res = {}
        for skip, good in HEAD_MODES:
            kw = dict(skip=skip, good=good, anchor_count=3)
            calls = [("plane", state.rows, meta, {}),
                     ("shard", shards, smeta, {})]
            if (skip, good) == HEAD_MODES[0]:
                calls += [("contaminant", state.rows, meta,
                           dict(contam=(cset[0].rows, cset[1]))),
                          ("contaminant_trim", state.rows, meta,
                           dict(contam=(cset[0].rows, cset[1]),
                                trim_contaminant=True))]
            for name, rows, m, extra in calls:
                hk = kernels.stage2_head(rows, m, *tail, **kw, **extra)
                hp = ref.stage2_head(rows, m, *tail, **kw, **extra)
                equal = all(torch.equal(x, y) for x, y in
                            zip(hk[:3] + tuple(hk[3]), hp[:3] + tuple(hp[3])))
                check(equal, f"stage2_head ({name}) differs from its plain "
                      f"version at k = {k}, skip {skip}, good {good}, "
                      f"width {w}")
                found, start_off, status = hk[3][0], hk[3][1], hk[3][5]
                rel = start_off - 1 - (skip + k - 1)  # from the first chunk
                lane = rel % 32
                at_edge = found & ((lane == 31) | ((rel >= 32) & torch.isin(
                    lane, torch.tensor(EDGE_LANES, device=lane.device))))
                res[f"{name}_s{skip}_g{good}"] = dict(
                    found=int(found.sum()),
                    no_anchor=int((status == ref.ST_NO_ANCHOR).sum()),
                    contaminated=int((status == ref.ST_CONTAMINANT).sum()),
                    at_chunk_edges=int(at_edge.sum()))
                check(int(at_edge.sum()) > 0 and bool((~found).any()),
                      f"stage2_head shapes at k = {k} ({name}, skip {skip}, "
                      f"good {good}) anchor no read at a chunk's edge")
            check(res["contaminant_s1_g2"]["contaminated"] > 0,
                  f"stage2_head shapes at k = {k}: no read contaminated")
        out[k] = res
        del state, shards, cset
    return out


def pack_shapes() -> dict:
    """HK14 against its plain version, buffer word for word and merged
    status, on seeded lanes (statuses, start/end, logs of 0..maxe
    entries) at B = 1, 2,048 (the devices slices), 3,001 (no multiple
    of a tile) and 70,001 (more tiles than a block has threads), and on
    2,048 reads whose logs are all empty: with room
    for every entry (the tail zeroed), at half the entries (entries
    dropped, `total` past the capacity), at no capacity, and with HK4's
    overflow flag set."""
    import numpy as np
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref

    rng = np.random.default_rng(SEED + 9)
    length, maxe = 160, 24
    out = {}
    for name, b, empty in (("b1", 1, False), ("b2048", 2048, False),
                           ("b3001", 3001, False), ("b70001", 70001, False),
                           ("empty", 2048, True)):
        def lanes(*shape, lo=-12, hi=length):
            return torch.from_numpy(rng.integers(lo, hi, shape).astype(
                np.int32)).to("cuda")
        st = [lanes(b, lo=0, hi=3) for _ in range(2)]
        n = [torch.zeros(b, dtype=torch.int32, device="cuda") if empty
             else lanes(b, lo=0, hi=maxe + 1) for _ in range(2)]
        logs = [(n[d], lanes(b, maxe, lo=-1, hi=length + 1),
                 lanes(b, maxe, lo=0, hi=1 << 16)) for d in range(2)]
        args = (lanes(b), lanes(b), st[0], st[1], logs[0], logs[1])
        total = int(n[0].sum() + n[1].sum())
        res = {}
        for cap, flag in ((total + 7, 0), (total // 2, 0), (0, 0),
                          (total + 7, 1)):
            over = torch.full((1,), flag, dtype=torch.int32, device="cuda")
            bk, sk = kernels.pack_finish(*args, over, length=length, cap=cap)
            bp, sp = ref.pack_finish(*args, over, cap)
            equal = (torch.equal(bk, bp) and torch.equal(sk, sp)
                     and int(bk[1]) == total)
            check(equal, f"pack_finish differs from its plain version "
                  f"({name}, cap {cap}, overflow {flag})")
            res[f"cap{cap}" + ("_overflow" if flag else "")] = equal
        out[name] = dict(entries=total, **res)
    return out


# HK2's duplicate check and HK6's export at the shapes their control flow
# can get wrong: a planted repeat of one tag pair in one half of a row,
# across its halves (slots 0 and 63), and in a row of three occupied
# slots (each must set the flag); a repeat whose second slot has no
# count, and one whose hi word is all ones (neither may); rows of 60-64
# occupied slots (the warp sort past 32), with and without a repeat; an
# empty table
SEAL_TABLES = {"dup_same_half": (0.25, "half", True),
               "dup_across_halves": (0.25, "across", True),
               "dup_row_of_three": (0.25, "three", True),
               "no_dup_repeats": (0.25, "repeats", False),
               "dense": (0.97, None, False),
               "dense_dup": (0.97, "dense", True),
               "empty": (0.0, None, False)}
SEAL_PAIR = (0x5A5A5, 3)  # the planted tag pair (rlo, rhi)


def seal_planes(meta, occupancy: float, plant, seed: int):
    """A seeded build table on the card at meta's geometry: each slot
    occupied with probability `occupancy` (rlo unique in its row by the
    slot in its top bits; hq 0-199, 30% without, lq 0-3; a tenth single
    observations, some tags without a count but in a dense table), with
    `plant`'s repeats of SEAL_PAIR (SEAL_TABLES)."""
    import torch

    from quorum_tpu_torch.ops import ctable

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows, sh = meta.rows, (meta.rows, 64)

    def rand(hi):
        return torch.randint(0, hi, sh, device="cuda", generator=g,
                             dtype=torch.int64)

    occ = torch.rand(sh, device="cuda", generator=g) < occupancy
    top = meta.rlo_bits - 6
    tlo = (torch.arange(64, device="cuda")[None] << top) | rand(1 << top)
    thi = rand(1 << min(31, max(0, meta.rem_bits - meta.rlo_bits)))
    hq, lq = rand(200), rand(4)
    hq[torch.rand(sh, device="cuda", generator=g) < 0.3] = 0
    one = torch.rand(sh, device="cuda", generator=g) < 0.1
    hq[one], lq[one] = 1, 0
    if occupancy > 0.9:  # a dense table: every tag counted
        lq[hq == 0] |= 1

    def put(r, s, pair=SEAL_PAIR, h=5, q=1):
        occ[r, s] = True
        tlo[r, s], thi[r, s] = pair
        hq[r, s], lq[r, s] = h, q

    if plant == "half":
        put(0, 3)
        put(0, 10)
    elif plant == "across":
        put(1, 0)
        put(1, 63)
    elif plant == "three":
        occ[2] = False
        put(2, 7)
        put(2, 40)
        put(2, 21, pair=(77, 0))
    elif plant == "repeats":
        put(0, 5)
        put(0, 40, h=0, q=0)
        put(1, 2, pair=(99, 0xFFFFFFFF))
        put(1, 50, pair=(99, 0xFFFFFFFF))
    elif plant == "dense":
        put(3, 1)
        put(3, 62)
    tag = torch.stack([torch.where(occ, tlo, -1), torch.where(occ, thi, -1)],
                      dim=2).view(rows, 128)
    return ctable.TBuildState(
        tag.to(torch.int32).contiguous(),
        torch.where(occ, hq, 0).view(-1).to(torch.int32),
        torch.where(occ, lq, 0).view(-1).to(torch.int32))


def seal_export_shapes() -> dict:
    """HK2 and HK6's export against their plain versions on every table
    of SEAL_TABLES at SHAPE_KS (4,096 rows): sealed rows and all five
    statistics equal, the duplicate flag as planted; the seal written
    into one shard's rows of a plane four times its size (`out=`, as
    tile_sharded.finalize passes it) equal, the rows around it
    untouched; the export with the seal's count and without it equal on
    the table, on shards 1, 2 and 3 of 4 and on its first 1 and 2 rows
    (lo words unaligned), and a count one too high raising. Then, at k =
    24 on a dense table of 2^20 rows, both kernels timed (the export
    with its count, and without it) beside their plain versions."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import ctable

    out: dict = {}
    ok = True
    for k in SHAPE_KS:
        meta = ctable.TileMeta(k, 7, 12)
        for i, (name, (occupancy, plant, dup)) in enumerate(
                SEAL_TABLES.items()):
            bt = seal_planes(meta, occupancy, plant, SEED + 100 * k + i)
            rows_k, st_k = kernels.tile_seal(bt, meta)
            rows_p, st_p = ref.tile_seal(bt, meta)
            q = meta.rows
            whole = torch.full((4 * q, 128), 7, dtype=torch.int32,
                               device="cuda")
            r_out, st_out = kernels.tile_seal(bt, meta,
                                              out=whole[q:2 * q])
            seal = (torch.equal(rows_k, rows_p) and torch.equal(st_k, st_p)
                    and int(st_k[0]) == int(dup)
                    and torch.equal(whole[q:2 * q], rows_p)
                    and torch.equal(st_out, st_p)
                    and not bool((whole[:q] != 7).any())
                    and not bool((whole[2 * q:] != 7).any()))
            del whole, r_out, bt
            n = int(st_k[1])
            export = True
            for a, b in ((0, q), (q // 4, q // 2), (q // 2, 3 * q // 4),
                         (3 * q // 4, q), (0, 1), (0, 2)):
                sub = rows_k[a:b]
                want = ref.tile_export(sub, meta)
                m = n if (a, b) == (0, q) else int(want[:b - a].sum())
                export &= (torch.equal(kernels.tile_export(sub, meta, m),
                                       want)
                           and torch.equal(kernels.tile_export(sub, meta),
                                           want))
            try:
                kernels.tile_export(rows_k, meta, n + 1)
                export = False
            except RuntimeError:
                pass
            out[f"k{k}_{name}"] = dict(seal_equal=seal, export_equal=export,
                                       occupied=n, dup=int(st_k[0]))
            ok &= seal and export
    check(ok, f"tile_seal or tile_export differs from its plain version "
          f"at SEAL_TABLES' shapes: {out}")
    # a dense table at the main path's k, timed
    meta = ctable.TileMeta(K, 7, 20)
    bt = seal_planes(meta, 0.97, None, SEED + 3000)
    rows_k, st_k = kernels.tile_seal(bt, meta)
    rows_p, st_p = ref.tile_seal(bt, meta)
    n = int(st_k[1])
    want = ref.tile_export(rows_k, meta)
    equal = torch.equal(rows_k, rows_p) and torch.equal(st_k, st_p)
    exp_equal = (torch.equal(kernels.tile_export(rows_k, meta, n), want)
                 and torch.equal(kernels.tile_export(rows_k, meta), want))
    check(equal and exp_equal, "tile_seal or tile_export differs from its "
          "plain version on the dense table")
    row_bytes = meta.rows * 512
    dense = {
        "tile_seal": dict(
            equal=equal, n=n,
            ms=kernel_ms(lambda: kernels.tile_seal(bt, meta), "tile_seal",
                         5),
            plain_ms=event_ms(lambda: ref.tile_seal(bt, meta), 2),
            bound_bytes=3 * row_bytes + 40),
        "tile_export": dict(
            equal=exp_equal, n=n,
            ms=kernel_ms(lambda: kernels.tile_export(rows_k, meta, n),
                         "tile_export", 5),
            plain_ms=event_ms(lambda: ref.tile_export(rows_k, meta), 2),
            bound_bytes=row_bytes + want.numel())}
    out["dense_k24_rows"] = meta.rows
    out["dense_k24_occupied"] = n
    out.update({f"dense_{nm}_{key}": round(v[key], 5)
                for nm, v in dense.items() for key in ("ms", "plain_ms")})
    return dict(shapes=out, dense=dense)


def planes_layout(state, meta, c, q, lengths, label: str, reps: int) -> dict:
    """HK16 (both passes) against its plain version on one batch (codes
    int8 [B, L], quals, lengths; HK5 makes the inputs) and a sealed table
    whose rows are laid out otherwise than a handoff table's: packed from
    slot 0 by HK7, or near full, so that keys sit far from their
    preferred slot. Also the layout's most keys in a row and the mean
    slot distance of a key from its preferred slot, and HK16's time."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref

    w = walk_inputs(state, meta, c, q, lengths)
    got = kernels.event_planes(state.rows, meta, *w.pargs, **w.pkw)
    want = ref.event_planes(state.rows, meta, *w.pargs, **w.pkw)
    equal = all(torch.equal(x, y) for x, y in zip(got, want))
    check(equal, f"event_planes differs from its plain version ({label})")
    slots = state.rows.view(meta.rows, ref.TSLOTS, 2).to(torch.int64)
    lo, hi = slots[..., 0] & 0xFFFFFFFF, slots[..., 1] & 0xFFFFFFFF
    live = (lo & meta.max_val) != 0
    pref = ref.preferred_slot(lo >> (meta.bits + 1), hi)
    dist = (torch.arange(ref.TSLOTS, device=lo.device)[None, :] - pref) \
        % ref.TSLOTS
    parts: dict = {}
    ms = kernel_ms(lambda: kernels.event_planes(state.rows, meta, *w.pargs,
                                                **w.pkw),
                   "event_planes", reps, detail=parts)
    return dict(label=label, equal=equal, rows=meta.rows,
                max_keys_in_a_row=int(live.sum(1).max()),
                mean_keys_in_a_row=round(float(live.sum()) / meta.rows, 3),
                mean_slot_distance=round(float(dist[live].float().mean()), 3),
                ms=round(ms, 5), parts_ms={f: round(t, 5)
                                           for f, t in parts.items()})


def stage2_kernels(state, meta, c, q, lengths, reps: int,
                   contam=None) -> dict:
    """HK5, HK3, HK4 and HK14 against their plain versions on one batch
    (codes int8 [B, L] with -1 / -2, quals, lengths) and the table
    `state`; with reps > 0 also timed, with their byte bounds. HK3 looks
    up the batch's window mers plus as many random (absent) keys; HK14
    packs HK4's output at the main path's capacity and, as its own
    entry, at half the entries (the overflow the host packs again).
    With `contam` (a contaminant table (TileState, TileMeta)), HK5's and
    HK4's contaminant entries, with and without trimming, and HK14 on
    their output, each held and timed as entries `contaminant` and
    `contaminant_trim` of their kernel."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.io import packing
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.models import corrector
    from quorum_tpu_torch.ops import mer

    dev = state.rows.device
    b, L = c.shape
    cfg = corrector.ECConfig(k=K, cutoff=4, qual_cutoff=33 + 40)
    pk = packing.pack_reads(c, q, lengths, thresholds=(cfg.qual_cutoff,))
    wire = torch.from_numpy(pk.to_wire()).to(dev)
    hargs = (state.rows, meta, wire, b, L, pk.thresholds, cfg.qual_cutoff)
    keep = corrector.make_keep_table(meta, cfg, dev)
    maxe = corrector.log_capacity(L, cfg)
    out = {}
    modes = [(None, False, None)]
    if contam is not None:
        ctab = (contam[0].rows, contam[1])
        modes += [(ctab, False, "contaminant"), (ctab, True,
                                                 "contaminant_trim")]
    for ctab, trim, entry in modes:
        hkw = dict(skip=cfg.skip, good=cfg.good,
                   anchor_count=cfg.anchor_count, contam=ctab,
                   trim_contaminant=trim)
        hk = kernels.stage2_head(*hargs, **hkw)
        hp = ref.stage2_head(*hargs, **hkw)
        head_equal = all(torch.equal(x, y) for x, y in
                         zip(hk[:3] + tuple(hk[3]), hp[:3] + tuple(hp[3])))
        check(head_equal, f"stage2_head ({entry or 'plain entry'}) differs "
              "from its plain version")
        codes, hqb, lens, anc = hk
        found, status = anc[0], anc[5]
        check(bool(found.any()) and bool((~found).any()),
              "stage-2 check lacks anchored or unanchored reads")
        if entry == "contaminant":
            check(bool((status == ref.ST_CONTAMINANT).any()),
                  "no read killed by the contaminant")
        tables = [(state.rows, meta)] + ([ctab] if ctab else [])
        # HK5's least traffic: the wire, its outputs, and the lines that
        # probing every window the scan must probe reads (checked-or-valid
        # windows up to the anchor; all of them in a read without one),
        # in each table
        f, r, validk = mer.rolling_kmers(codes, K)
        sweep = mer.canonical(f, r)
        p = torch.arange(L, device=dev)[None, :]
        vw = validk & (p >= cfg.skip + K - 1)
        need = vw & ((status != 0)[:, None] | (p < anc[1][:, None]))
        probe = [probe_bytes(rows, m, sweep[need]) for rows, m in tables]
        head = dict(equal=head_equal, n=b,
                    bound_bytes=wire.numel() + 2 * b * L + 33 * b
                    + sum(x["bytes"] for x in probe),
                    probe_bytes=probe,
                    probes_per_read=head_probes(vw, anc[1],
                                                cfg.skip + K - 1))
        args = (state.rows, meta, codes, hqb, lens, status, anc[1], anc[2],
                anc[3], anc[4], keep)
        kw = dict(window=cfg.effective_window, error=cfg.effective_error,
                  min_count=cfg.min_count, cutoff=cfg.cutoff, maxe=maxe,
                  contam=ctab, trim_contaminant=trim)
        rk = kernels.extend_reads(*args, **kw)
        probed = []
        orig = ref.tile_lookup

        def spy(rows, m, ks):
            # a contaminant row counts apart from a main-table row
            probed.append(ref.tile_key_parts(ks, m)[0]
                          + (meta.rows if rows is not state.rows else 0))
            return orig(rows, m, ks)

        ref.tile_lookup = spy
        try:
            rp = ref.extend_reads(*args, **kw)
        finally:
            ref.tile_lookup = orig
        ext_equal = _batch_equal(rk, rp, found)
        check(ext_equal, f"extend_reads ({entry or 'plain entry'}) differs "
              "from its plain version")
        paddr = torch.unique(torch.cat(probed)).numel() if probed else 0
        io_bytes = (2 * b * L + b * 32 + keep.numel()            # inputs
                    + b * L + 8 * b + 2 * b * (12 + 8 * maxe))   # outputs
        ext = dict(equal=ext_equal, n=b, bound_bytes=io_bytes + 512 * paddr)
        pack, over = pack_check(rk, L, reps)
        if reps:
            head.update(
                ms=kernel_ms(lambda: kernels.stage2_head(*hargs, **hkw),
                             "stage2_head", reps),
                plain_ms=event_ms(lambda: ref.stage2_head(*hargs, **hkw), 2))
            ext.update(
                ms=kernel_ms(lambda: kernels.extend_reads(*args, **kw),
                             "extend_reads", reps),
                plain_ms=event_ms(lambda: ref.extend_reads(*args, **kw), 1))
        if entry is None:
            out.update(stage2_head=head, extend_reads=ext,
                       pack_finish=dict(pack, overflow=over))
        else:
            out["stage2_head"][entry] = head
            out["extend_reads"][entry] = ext
            out["pack_finish"][entry] = pack
    out.update(lookup_kernel(state, meta, sweep.reshape(-1), reps))
    return out


def probe_bytes(rows, meta, keys) -> dict:
    """The least bytes that probing canonical mers `keys` in the table
    plane `rows` (at `meta`'s geometry) must read: the 128-byte line (16
    slots) that holds each found key, and the whole 512-byte row of each
    absent key (no probe knows a key is absent before it has read every
    slot of the row), each line or row once."""
    import torch

    from quorum_tpu_torch.kernels import reference as ref

    addr, rlo, rhi = ref.tile_key_parts(torch.unique(keys), meta)
    r3 = rows.view(-1, ref.TSLOTS, 2)
    line = torch.empty_like(addr)
    step = 1 << 16
    for a in range(0, addr.numel(), step):
        g = r3[addr[a:a + step]]
        lo, hi = ref.u32(g[..., 0]), ref.u32(g[..., 1])
        match = (((lo & meta.max_val) != 0)
                 & ((lo >> (meta.bits + 1)) == rlo[a:a + step, None])
                 & (hi == rhi[a:a + step, None]))
        line[a:a + step] = torch.where(match.any(dim=1),
                                       match.int().argmax(dim=1) // 16, -1)
    absent = torch.unique(addr[line < 0])
    held = torch.unique(addr[line >= 0] * 4 + line[line >= 0])
    held = held[~torch.isin(held // 4, absent)]
    return {"bytes": 512 * absent.numel() + 128 * held.numel(),
            "absent_rows": absent.numel(), "found_lines": held.numel()}


def head_probes(vw, start_off, base: int) -> dict:
    """Mean windows a read probes in HK5's scan (each probe one row a
    table), from the valid windows past `skip` (vw [B, L]) and the
    anchors (start_off, one past the first window whose run reaches
    `good`; 1 where there is none): `need`, the windows up to the anchor
    (every one without it); `chunk32`, every window of each 32-position
    chunk from position 0 up to the anchor's chunk (a lane a window, as
    the kernel once probed); `grouped`, the windows in groups of the
    build's group size (stage2_head.cu's `stage2_head_group`) of each
    32-window chunk from `base` (skip + k - 1) up to the anchor's group
    (the kernel's design)."""
    import ctypes

    import torch

    from quorum_tpu_torch.kernels import loader

    group = ctypes.c_int.in_dll(loader.library("stage2_head"),
                                "stage2_head_group").value
    b, L = vw.shape
    p = torch.arange(L, device=vw.device)[None, :]
    hit = start_off > 1
    hp = (start_off - 1).clamp(min=0).to(torch.int64)[:, None]
    chunk = (p - base).clamp(min=0) // 32
    first = base + 32 * chunk  # the chunk's first window end
    cs = torch.cumsum(vw.to(torch.int64), dim=1)
    before = torch.where(first > 0, torch.gather(
        cs, 1, (first - 1).clamp(min=0).expand(b, L)), 0)
    gid = chunk * 64 + (cs - vw.to(torch.int64) - before) // group
    upto = {"need": p <= hp,
            "chunk32": p < 32 * (hp // 32 + 1),
            "grouped": gid <= torch.gather(gid.expand(b, L), 1, hp)}
    return {name: round(float((vw & (~hit[:, None] | m)).sum()) / b, 4)
            for name, m in upto.items()}


def lookup_kernel(state, meta, sweep, reps: int) -> dict:
    """HK3 against its plain version on a batch's window mers plus as
    many random (absent) keys; timed on the window mers."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref

    rnd = torch.randint(0, 1 << 48, (sweep.numel(),), device=sweep.device,
                        generator=torch.Generator(sweep.device)
                        .manual_seed(SEED))
    lk = torch.cat([sweep, rnd])
    vk = kernels.tile_lookup(state.rows, meta, lk)
    vp = ref.tile_lookup(state.rows, meta, lk)
    lk_equal = torch.equal(vk, vp) and bool((vk[:sweep.numel()] != 0).any())
    check(lk_equal, "tile_lookup differs from its plain version")
    laddr = torch.unique(ref.tile_key_parts(sweep, meta)[0]).numel()
    out = dict(equal=lk_equal, n=lk.numel(),
               bound_bytes=16 * sweep.numel() + 512 * laddr)
    if reps:
        out.update(
            ms=kernel_ms(lambda: kernels.tile_lookup(state.rows, meta, sweep),
                         "tile_lookup", reps),
            plain_ms=event_ms(lambda: ref.tile_lookup(state.rows, meta,
                                                      sweep), 2))
    return {"tile_lookup": out}


def shard_stage2_kernels(state, meta, c, q, lengths, reps: int, contam,
                         plane: dict) -> dict:
    """HK5's and HK4's sharded-table entries on stage2_kernels' batch and
    table, the table taken as DEVICES row ranges of its plane (a
    RoutedTileMeta; on one card every shard is local), in the same three
    modes (none, contaminant kill, trim): each held against its plain
    version (the routed lookup over the shard planes) and against the
    plane entry's output on the same inputs, and timed. They read the
    plane entries' rows, so their byte bounds are `plane`'s."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.io import packing
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.models import corrector
    from quorum_tpu_torch.parallel import tile_sharded as ts

    dev = state.rows.device
    b, L = c.shape
    smeta = ts.RoutedTileMeta(k=meta.k, bits=meta.bits,
                              rb_log2=meta.rb_log2, n_shards=DEVICES)
    shards = list(ts.row_shards(state, smeta, [dev] * DEVICES).shards)
    cfg = corrector.ECConfig(k=K, cutoff=4, qual_cutoff=33 + 40)
    pk = packing.pack_reads(c, q, lengths, thresholds=(cfg.qual_cutoff,))
    wire = torch.from_numpy(pk.to_wire()).to(dev)
    tail = (wire, b, L, pk.thresholds, cfg.qual_cutoff)
    keep = corrector.make_keep_table(meta, cfg, dev)
    maxe = corrector.log_capacity(L, cfg)
    ctab = (contam[0].rows, contam[1])
    out = {"stage2_head_shard": {}, "extend_reads_shard": {}}
    for mtab, trim, entry in ((None, False, None),
                              (ctab, False, "contaminant"),
                              (ctab, True, "contaminant_trim")):
        hkw = dict(skip=cfg.skip, good=cfg.good,
                   anchor_count=cfg.anchor_count, contam=mtab,
                   trim_contaminant=trim)
        hk = kernels.stage2_head(shards, smeta, *tail, **hkw)
        hp = ref.stage2_head(shards, smeta, *tail, **hkw)
        h1 = kernels.stage2_head(state.rows, meta, *tail, **hkw)
        flat = [x[:3] + tuple(x[3]) for x in (hk, hp, h1)]
        head_equal = all(torch.equal(x, y) and torch.equal(x, z)
                         for x, y, z in zip(*flat))
        check(head_equal, f"stage2_head's sharded-table entry "
              f"({entry or 'plain entry'}) differs from its plain version "
              "or the plane entry")
        codes, hqb, lens, anc = hk
        rest = (codes, hqb, lens, anc[5], anc[1], anc[2], anc[3], anc[4],
                keep)
        kw = dict(window=cfg.effective_window, error=cfg.effective_error,
                  min_count=cfg.min_count, cutoff=cfg.cutoff, maxe=maxe,
                  contam=mtab, trim_contaminant=trim)
        ek = kernels.extend_reads(shards, smeta, *rest, **kw)
        ext_equal = (_batch_equal(ek, ref.extend_reads(shards, smeta, *rest,
                                                       **kw), anc[0])
                     and _batch_equal(ek, kernels.extend_reads(
                         state.rows, meta, *rest, **kw), anc[0]))
        check(ext_equal, f"extend_reads' sharded-table entry "
              f"({entry or 'plain entry'}) differs from its plain version "
              "or the plane entry")
        pb = {n: plane[n] if entry is None else plane[n][entry]
              for n in ("stage2_head", "extend_reads")}
        head = dict(equal=head_equal, n=b,
                    bound_bytes=pb["stage2_head"]["bound_bytes"],
                    ms=kernel_ms(lambda: kernels.stage2_head(
                        shards, smeta, *tail, **hkw), "stage2_head_shard",
                        reps),
                    plain_ms=event_ms(lambda: ref.stage2_head(
                        shards, smeta, *tail, **hkw), 2))
        ext = dict(equal=ext_equal, n=b,
                   bound_bytes=pb["extend_reads"]["bound_bytes"],
                   ms=kernel_ms(lambda: kernels.extend_reads(
                       shards, smeta, *rest, **kw), "extend_reads_shard",
                       reps),
                   plain_ms=event_ms(lambda: ref.extend_reads(
                       shards, smeta, *rest, **kw), 1))
        if entry is None:
            out["stage2_head_shard"].update(head)
            out["extend_reads_shard"].update(ext)
        else:
            out["stage2_head_shard"][entry] = head
            out["extend_reads_shard"][entry] = ext
    return out


def pack_check(rk, L: int, reps: int):
    """HK14 against its plain version on HK4's output `rk`, buffer word
    for word and merged status, at the main path's first capacity
    (16384 entries) and at half the batch's entries (entries dropped,
    `total` past the capacity); with reps > 0 each timed (`parts_ms`:
    its C launch and the wrapper call's span). Byte bound: 24 B a read
    and 8 B a live entry read, the buffer and the status written."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref

    _out, start, end, lstatus, fwd, bwd, overflow = rk
    b = start.numel()
    args = (start, end, lstatus[:b], lstatus[b:], (fwd[0], fwd[2], fwd[3]),
            (bwd[0], bwd[2], bwd[3]), overflow)
    res = []
    total = int((fwd[0].sum() + bwd[0].sum()).item())
    for cap in (16384, total // 2):
        bk, sk = kernels.pack_finish(*args, length=L, cap=cap)
        bp, sp = ref.pack_finish(*args, cap)
        equal = (torch.equal(bk, bp) and torch.equal(sk, sp)
                 and int(bk[1]) == total)
        check(equal, f"pack_finish differs from its plain version (cap "
              f"{cap}, {total} entries)")
        d = dict(equal=equal, n=b, entries=total, cap=cap,
                 bound_bytes=24 * b + 8 * total + 4 + 4 * (2 + 3 * b + cap)
                 + 4 * b)
        if reps:
            parts: dict = {}
            d.update(ms=kernel_ms(lambda: kernels.pack_finish(
                *args, length=L, cap=cap), "pack_finish", reps,
                detail=parts),
                plain_ms=event_ms(lambda: ref.pack_finish(*args, cap), 2),
                parts_ms={f: round(t, 5) for f, t in parts.items()})
        res.append(d)
    check(total > res[1]["cap"], "the overflow check did not overflow")
    return res


def _batch_equal(a, b, found) -> bool:
    """extend_reads outputs equal under the test rule: start/end, lane
    status and the overflow flag for every read, out inside [start,
    end) for anchored reads, each log's n and its first n entries."""
    import torch

    out_a, s_a, e_a, st_a, f_a, b_a, o_a = a
    out_b, s_b, e_b, st_b, f_b, b_b, o_b = b
    if not all(torch.equal(x, y) for x, y in ((s_a, s_b), (e_a, e_b),
                                              (st_a, st_b), (o_a, o_b))):
        return False
    pos = torch.arange(out_a.shape[1], device=out_a.device)[None, :]
    live = found[:, None] & (pos >= s_a[:, None]) & (pos < e_a[:, None])
    if not torch.equal(torch.where(live, out_a, 0),
                       torch.where(live, out_b, 0)):
        return False
    for la, lb in ((f_a, f_b), (b_a, b_b)):
        if not torch.equal(la[0], lb[0]):
            return False
        j = torch.arange(la[2].shape[1], device=la[2].device)[None, :]
        m = j < la[0][:, None]
        for x, y in ((la[2], lb[2]), (la[3], lb[3])):
            if not torch.equal(torch.where(m, x, 0), torch.where(m, y, 0)):
                return False
    return True


def golden_paths() -> dict:
    """The golden phase's reads, database and contaminant file."""
    d = os.path.join(WORK, "golden")
    return {"d": d, "reads": os.path.join(GOLDEN, "reads.fastq"),
            "db": os.path.join(d, "db.jf"),
            "cfa": os.path.join(d, "contaminant.fa")}


def golden_runs(cfa: str):
    """The golden runs held card against CPU: the quorum driver's (tag,
    extra argv) and quorum_error_correct_reads' (the contaminant and
    homo-trim path: two 2k-base windows of golden reads as the
    contaminant, as tests/test_error_correct_cli.py)."""
    drivers = (("drv", []),
               ("drv_contam", ["--contaminant", cfa, "--trim-contaminant",
                               "--homo-trim", "3"]))
    stage2 = (("contaminant", ["--contaminant", cfa]),
              ("contaminant_trim", ["--contaminant", cfa,
                                    "--trim-contaminant"]),
              ("homo_trim", ["--homo-trim", "3"]))
    return drivers, stage2


def golden_cpu_start(which: str):
    """Start golden_cpu(`which`) in a process of its own (four torch
    threads), so the CPU's references run beside the card's work. The
    drivers' runs need only the reads and the contaminant file (written
    here first); stage 2's need the card-built golden database."""
    g = golden_paths()
    if which == "drivers":
        import numpy as np

        from quorum_tpu_torch.io import fastq

        os.makedirs(g["d"], exist_ok=True)
        r = next(fastq.read_batches([g["reads"]], 256))
        acgt = np.frombuffer(b"ACGT", np.uint8)
        with open(g["cfa"], "w") as f:
            for i, (j, at) in enumerate(((3, 10), (40, 20))):
                w = acgt[r.codes[j, at:at + 26]].tobytes().decode()
                f.write(f">w{i}\n{w}\n")
    return child_start("golden_cpu", which,
                       env=dict(os.environ, OMP_NUM_THREADS="4"))


def golden_cpu(which: str) -> dict:
    """The golden phase's --device cpu references at the defaults:
    `drivers` (the quorum driver's runs) or `stage2` (the stage-2 runs
    on the golden database). Returns {tag: seconds}."""
    from quorum_tpu_torch.cli import error_correct_reads as ec
    from quorum_tpu_torch.cli import quorum

    g = golden_paths()
    drivers, stage2 = golden_runs(g["cfa"])
    spent = {}
    for tag, extra in (drivers if which == "drivers" else stage2):
        out = os.path.join(g["d"], f"{tag}_cpu")
        t0 = time.perf_counter()
        if which == "drivers":
            rc = quorum.main(["-s", "64k", "-k", "13", "-p", out, "--device",
                              "cpu", *extra, g["reads"]])
        else:
            rc = ec.main(extra + [g["db"], g["reads"], "-o", out,
                                  "--device", "cpu"])
        check(rc == 0, f"golden {tag} (cpu) rc {rc}")
        spent[tag] = round(time.perf_counter() - t0, 3)
    return spent


def golden_stage1():
    """The golden reads' stage 1 on the card, right after the build; then
    golden_cpu_start("stage2") on its database."""
    from quorum_tpu_torch.cli import create_database as cdb

    g = golden_paths()
    check(cdb.main(["-s", "64k", "-m", "13", "-b", "7", "-q", "38", "-o",
                    g["db"], "--device", "cuda", g["reads"]]) == 0,
          "golden stage 1")
    return golden_cpu_start("stage2")


def phase_golden(drivers_cpu, stage2_cpu):
    """The golden reads on the card (after golden_stage1): stage 2
    against the golden expected files, the -p 4 run's quality section
    against QUALITY_BASELINE.json, and the driver's and stage 2's runs
    of golden_runs held to their --device cpu references (`drivers_cpu`
    and `stage2_cpu`: golden_cpu_start's processes, the drivers' started
    before the build, stage 2's after golden_stage1)."""
    from quorum_tpu_torch.cli import error_correct_reads as ec
    from quorum_tpu_torch.cli import quorum

    g = golden_paths()
    d, reads, db = g["d"], g["reads"], g["db"]
    res = {}
    metrics = os.path.join(d, "p4.metrics.json")
    for tag, extra, suffix in (("p4", ["-p", "4", "--metrics", metrics], ""),
                               ("auto", [], "_auto")):
        o = os.path.join(d, tag)
        check(ec.main(extra + [db, reads, "-o", o, "--device", "cuda"]) == 0,
              f"golden stage 2 ({tag})")
        res[tag] = all(filecmp.cmp(o + ext, os.path.join(
            GOLDEN, f"expected{suffix}{ext}"), shallow=False)
            for ext in (".fa", ".log"))
    # the -p 4 run's quality section, by the port's own arithmetic,
    # against the golden pins of QUALITY_BASELINE.json (exact: the run
    # is deterministic)
    from quorum_tpu_torch.telemetry import quality

    with open(metrics) as f:
        doc = json.load(f)
    with open(os.path.join(ROOT, "QUALITY_BASELINE.json")) as f:
        pins = json.load(f)["docs"]["golden"]["metrics"]
    prof = quality_profile(quality.section_from_doc(doc))
    off = {k: (prof.get(k), pin["value"]) for k, pin in pins.items()
           if prof.get(k) != pin["value"]}
    res["quality_baseline"] = not off
    res["quality_section_in_document"] = (
        doc.get("quality") == quality.section_from_doc(doc))
    drivers, stage2 = golden_runs(g["cfa"])
    for tag, extra in drivers:
        check(quorum.main(["-s", "64k", "-k", "13", "-p",
                           os.path.join(d, f"{tag}_cuda"), "--device",
                           "cuda", *extra, reads]) == 0,
              f"golden {tag} (cuda)")
    check(quorum.main(["-s", "64k", "-k", "13", "-p",
                       os.path.join(d, "drv_part"), "--device", "cuda",
                       "--partitions", str(PARTS), reads]) == 0,
          "golden driver (--partitions)")
    for tag, extra in stage2:
        check(ec.main(extra + [db, reads, "-o", os.path.join(d, f"{tag}_cuda"),
                               "--device", "cuda"]) == 0,
              f"golden stage 2 {tag} (cuda)")
    t0 = time.perf_counter()
    cpu_s = {**child_join(drivers_cpu, "the golden drivers on the CPU"),
             **child_join(stage2_cpu, "golden stage 2 on the CPU")}
    waited = round(time.perf_counter() - t0, 3)
    for tag in ("cuda", "part"):
        res[f"driver_{tag}_eq_cpu"] = same_fa_log(
            os.path.join(d, f"drv_{tag}"), os.path.join(d, "drv_cpu"))
    for tag, _extra in stage2:
        res[f"{tag}_cuda_eq_cpu"] = same_fa_log(
            os.path.join(d, f"{tag}_cuda"), os.path.join(d, f"{tag}_cpu"))
    with open(os.path.join(d, "contaminant_cuda.log")) as f:
        res["contaminant_skips"] = f.read().count("Contaminated read")
    res["driver_contaminant_cuda_eq_cpu"] = same_fa_log(
        os.path.join(d, "drv_contam_cuda"), os.path.join(d, "drv_contam_cpu"))
    emit({"phase": "golden", **res, "quality_off_baseline": off,
          "cpu_reference_s": cpu_s, "waited_for_cpu_s": waited})
    check(all(res.values()), f"golden mismatch: {res}")


def phase_full(card: str) -> dict:
    import numpy as np
    import torch

    from quorum_tpu_torch.cli import quorum
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.native import binding as native

    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    genome, codes, true, quals, origin = synth_reads(gen, GENOME_BP,
                                                     COVERAGE)
    n = codes.shape[0]
    fq = os.path.join(WORK, "reads.fastq")
    write_fastq(fq, codes, quals)
    gen_s = time.perf_counter() - t0
    bases = n * READ_LEN
    size = table_size(bases, GENOME_BP)
    prefix = os.path.join(WORK, "full")
    report: dict = {}
    native0 = native.STATS["batches"]
    STATS.reset()
    STATS.timing = True
    with StagePeaks() as peaks, DeviceBusy() as busy:
        t1 = time.perf_counter()
        rc = quorum.main(["-s", str(size), "-k", str(K), "-p", prefix,
                          "--device", "cuda", fq], report=report)
        wall = time.perf_counter() - t1
    report["busy"] = busy
    STATS.timing = False
    launches = dict(STATS.launches)
    kms = STATS.kernel_ms()
    check(rc == 0, f"full-size driver rc {rc}")
    for name in PATH_KERNELS["full"]:
        check(launches[name] > 0, f"{name} was not launched on the main path")
    ec = report["ec"]
    build = report["build"]
    check(ec.reads == n and ec.corrected + ec.skipped == n,
          "full-size read accounting")
    # correctness by the repo's own measure: the corrected reads carry
    # fewer substitutions against the true genome than they came with
    errs_in = errs_out = checked = 0
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(prefix + ".fa", "rb") as f:
        for _ in range(2000):
            hdr = f.readline()
            seq = f.readline().rstrip(b"\n")
            if not hdr:
                break
            i = int(hdr[2:11])
            parts = hdr.split()
            start = 0
            for ent in parts[1:]:
                p, _, kind = ent.partition(b":")
                if kind == b"5_trunc":
                    start = max(start, int(p))
            t = acgt[true[i].numpy()][start:start + len(seq)]
            o = acgt[codes[i].numpy()][start:start + len(seq)]
            s = np.frombuffer(seq, np.uint8)
            errs_in += int((o != t).sum())
            errs_out += int((s != t).sum())
            checked += 1
    check(checked > 0 and errs_out < errs_in,
          f"correction did not reduce errors ({errs_in} -> {errs_out})")
    s1, s2 = report["stage1_s"], report["stage2_s"]
    check(native.STATS["batches"] > native0,
          "the native parser did not parse the full run's reads")
    emit({"phase": "full", "card": card, "genome_bp": GENOME_BP,
          "reads": n, "bases": bases, "k": K, "size": size,
          "fastq_gen_s": round(gen_s, 3), "stage1_s": round(s1, 3),
          "stage2_s": round(s2, 3), "wall_s": round(wall, 3),
          "gbases_per_hour": round(bases / (s1 + s2) * 3600 / 1e9, 4),
          "max_memory_allocated": max(peaks.stage1, peaks.stage2),
          "max_memory_allocated_by_stage": peaks.as_dict(),
          "corrected_share": round(ec.corrected / n, 6),
          "distinct_mers": build.distinct, "grows": build.grows,
          "cutoff": ec.cutoff,
          "pipeline": pipeline_times(report),
          "kernel_s": {k: round(v / 1e3, 4) for k, v in kms.items()},
          "kernel_ms_per_launch": {k: round(v / launches[k], 5)
                                   for k, v in kms.items() if launches[k]},
          "sample_errors_in_out": [errs_in, errs_out, checked],
          "launches": launches})
    return dict(launches=launches, codes=codes, quals=quals, size=size,
                genome=genome, true=true, origin=origin, cutoff=ec.cutoff,
                max_memory=max(peaks.stage1, peaks.stage2),
                peaks=peaks.as_dict(),
                grows=build.grows, fastq=fq, prefix=prefix,
                db=prefix + "_mer_database.jf", build=build,
                insert_ms_per_launch=kms["tile_insert"]
                / launches["tile_insert"], report=report)


def pipeline_times(report: dict) -> dict:
    """A driver run's host pipeline: each stage's wall seconds, the
    producer thread's parse + pack seconds (stage 1's first pass; stage
    2 replays its batches), the main thread's seconds blocked on the
    prefetch queue (both stages) and on the render drain (stage 2), the
    render workers' summed seconds, stage 2's main-thread device step
    (H2D, kernels, synchronize) and fetch seconds; where the run was
    profiled (DeviceBusy), the card's busy seconds and the host share:
    the share of the run's wall seconds in which the card ran nothing,
    waiting on the host (PERF.md section 2)."""
    ec = report["ec"]
    s1, s2 = report["stage1_s"], report["stage2_s"]
    blocked = report["stage1_wait_s"] + ec.queue_wait_s
    out = {"threads": report["threads"],
           "render_workers": ec.render_workers,
           "stage1_s": round(s1, 3), "stage2_s": round(s2, 3),
           "parse_pack_s": round(report["stage1_host_s"]
                                 + ec.parse_pack_s, 3),
           "blocked_on_prefetch_s": round(blocked, 3),
           "blocked_on_render_s": round(ec.drain_wait_s, 3),
           "render_s": round(ec.render_s, 3),
           "stage2_device_step_s": round(ec.device_s, 3),
           "stage2_fetch_s": round(ec.fetch_s, 3)}
    busy = report.get("busy")
    if busy is not None:
        out.update(device_busy_s=round(busy.busy_s, 3),
                   profiled_wall_s=round(busy.wall_s, 3),
                   device_events=busy.events,
                   host_share=round(1 - busy.busy_s / busy.wall_s, 4))
    return out


def phase_parser(card: str, full: dict) -> dict:
    """The native parser on the full run's FASTQ against the Python
    parser, batch for batch (headers, n, codes, quals, lengths); each
    one's seconds."""
    import numpy as np

    from quorum_tpu_torch.io import fastq
    from quorum_tpu_torch.native import binding

    check(binding.available(), "the native FASTQ parser did not build")
    nat = binding.read_batches([full["fastq"]], BATCH)
    py = fastq.batch_records(fastq.iter_records([full["fastq"]]), BATCH)
    t_nat = t_py = 0.0
    batches = reads = 0
    while True:
        t0 = time.perf_counter()
        a = next(nat, None)
        t1 = time.perf_counter()
        b = next(py, None)
        t_nat += t1 - t0
        t_py += time.perf_counter() - t1
        if a is None or b is None:
            check(a is None and b is None, "the parsers' batch counts differ")
            break
        check(a.n == b.n and a.headers == b.headers
              and np.array_equal(a.codes, b.codes)
              and np.array_equal(a.quals, b.quals)
              and np.array_equal(a.lengths, b.lengths),
              f"native batch {batches} differs from the Python parser's")
        batches += 1
        reads += a.n
    emit({"phase": "parser", "card": card, "library": binding.library_path(),
          "batches": batches, "reads": reads, "native_s": round(t_nat, 3),
          "python_s": round(t_py, 3), "equal": True})
    return {"native_s": t_nat, "python_s": t_py}


def phase_serial(card: str, full: dict) -> dict:
    """The full run's driver again at -t 1 --render-workers 1 (one parse
    worker, one render worker): .fa/.log byte-equal to the full run's,
    and both runs' pipeline times side by side. Launch counts reset
    before and read after. (The defaults' second run went to make room
    for the resume phase.)"""
    from quorum_tpu_torch.cli import quorum
    from quorum_tpu_torch.kernels.loader import STATS

    runs = {}
    STATS.reset()
    STATS.timing = True  # as in the full run: the same event overhead
    for tag, extra in (("serial", ["-t", "1", "--render-workers", "1"]),):
        prefix = os.path.join(WORK, tag)
        report: dict = {}
        with DeviceBusy() as busy:
            rc = quorum.main(["-s", str(full["size"]), "-k", str(K), "-p",
                              prefix, *extra, "--device", "cuda",
                              full["fastq"]], report=report)
        check(rc == 0, f"{tag} driver rc {rc}")
        report["busy"] = busy
        runs[tag] = (report, same_fa_log(prefix, full["prefix"]))
    STATS.timing = False
    STATS.events.clear()
    STATS.calls.clear()
    launches = dict(STATS.launches)
    for name in PATH_KERNELS["pipeline"]:
        check(launches[name] > 0, f"{name} was not launched on the "
                                  "pipeline runs")
    emit({"phase": "pipeline", "card": card,
          "default": pipeline_times(full["report"]),
          **{tag: pipeline_times(r) for tag, (r, _same) in runs.items()},
          "same_fa_log": {tag: same for tag, (_r, same) in runs.items()},
          "launches": launches})
    for tag, (_r, same) in runs.items():
        check(same, f"the {tag} run's .fa/.log differ from the full run's")
    return launches


# torch's own fill and copy kernels (tensor set-up and moves around the
# port's kernels); sets show as gpu_memset, not as kernels
TORCH_FILL_COPY = re.compile(r"^at::native::.*(FillFunctor|[Cc]opy)")


def port_kernel_names() -> set:
    """The __global__ functions of the port's CUDA sources."""
    from quorum_tpu_torch.kernels import loader

    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)"
                     r"\s*)?(?:void\s+)?(\w+)\s*\(", re.S)
    names = set()
    for f in os.listdir(loader.CSRC):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(loader.CSRC, f)) as src:
                names |= set(pat.findall(src.read()))
    return names


def telemetry_artifacts(d: str) -> dict:
    """Every telemetry file a driver run wrote under `d`, validated: each
    by the port's copy of the schema (telemetry/schema.check_file), each
    metrics document also by the contract's name rules
    (contract.missing_names). Returns {file name: metrics document} for
    the documents."""
    from quorum_tpu_torch.telemetry import contract, schema

    docs = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            path = os.path.join(root, f)
            if not f.endswith((".json", ".jsonl")) or \
                    f == "torch_profiler.trace.json":
                continue
            problems = schema.check_file(path)
            check(not problems, f"{path} fails the schema: {problems[:3]}")
            if f.startswith("m") and f.endswith(".json") and \
                    ".events." not in f:
                with open(path) as fh:
                    doc = json.load(fh)
                missing = contract.missing_names(doc)
                check(not missing, f"{path} lacks names: {missing[:3]}")
                docs[f] = doc
    return docs


def phase_telemetry(card: str, full: dict) -> dict:
    """The full run's driver twice more, launch counts reset before each
    and read after: (a) with --metrics --metrics-interval 1
    --trace-spans, (b) with --profile --metrics, outside DeviceBusy and
    with the loader's CUDA-event timing off (one profiler session a
    process; the events would pad the timeline). Both runs' .fa/.log
    are byte-equal to the full run's and every document, event stream
    and span file validates; in (b) the profile's step windows are the
    run's stage-1 insert and stage-2 device steps, each stage's kernel
    time is above 0 and the top kernel is one of the port's. Prints
    (a)'s Gbases/h beside the full run's, (b)'s split by stage and its
    top kernels beside the full run's DeviceBusy seconds, and HK5's
    kernel time beside its wrapper's spans from the same trace."""
    from quorum_tpu_torch.cli import quorum
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.telemetry import devtrace

    base = os.path.join(WORK, "telemetry")
    bases = full["codes"].shape[0] * READ_LEN
    runs, launches = {}, {}
    for tag, path in (("metrics", "telemetry"),
                      ("profile", "telemetry_profile")):
        d = os.path.join(base, tag)
        os.makedirs(d, exist_ok=True)
        m = os.path.join(d, "m.json")
        flags = (["--metrics", m, "--metrics-interval", "1", "--trace-spans",
                  os.path.join(d, "s.jsonl")] if tag == "metrics" else
                 ["--profile", os.path.join(d, "prof"), "--metrics", m])
        report: dict = {}
        STATS.reset()
        STATS.timing = False
        t0 = time.perf_counter()
        with RenderCapture(every=4 if tag == "metrics" else 0) as captured:
            rc = quorum.main(["-s", str(full["size"]), "-k", str(K), "-p",
                              os.path.join(d, "out"), "--device", "cuda",
                              *flags, full["fastq"]], report=report)
        wall = time.perf_counter() - t0
        check(rc == 0, f"telemetry {tag} driver rc {rc}")
        launches[path] = dict(STATS.launches)
        for name in PATH_KERNELS[path]:
            check(launches[path][name] > 0,
                  f"{name} was not launched on the {path} run")
        check(same_fa_log(os.path.join(d, "out"), full["prefix"]),
              f"the telemetry {tag} run's .fa/.log differ from the full "
              "run's")
        docs = telemetry_artifacts(d)
        check(set(docs) == {"m.json", "m.stage1.json", "m.stage2.json"},
              f"telemetry {tag} documents: {sorted(docs)}")
        s1, s2 = report["stage1_s"], report["stage2_s"]
        runs[tag] = {"stage1_s": round(s1, 3), "stage2_s": round(s2, 3),
                     "wall_s": round(wall, 3),
                     "gbases_per_hour": round(bases / (s1 + s2) * 3600
                                              / 1e9, 4),
                     "documents": sorted(docs), "docs": docs,
                     "steps": {"stage1_insert": report["build"].batches,
                               "stage2_device":
                                   launches[path]["stage2_head"]},
                     "pipeline": pipeline_times(report),
                     "dir": d}
        if captured.args:
            runs[tag]["render_cost"] = render_cost(captured.args)
    fr = full["report"]
    full_gbph = bases / (fr["stage1_s"] + fr["stage2_s"]) * 3600 / 1e9
    a = runs["metrics"]
    a["full_gbases_per_hour"] = round(full_gbph, 4)
    a["cost_share"] = round(1 - a["gbases_per_hour"] / full_gbph, 4)
    a["full_pipeline"] = pipeline_times(fr)
    b = runs["profile"]
    meta = b["docs"]["m.json"]["meta"]
    counters = b["docs"]["m.json"]["counters"]
    check(meta["devtrace_source"] == devtrace.SOURCE_LAUNCH,
          f"the profile's device activity was not joined by launch "
          f"correlation ({meta['devtrace_source']})")
    check(meta["devtrace_stage_steps"] == b["steps"],
          f"profile step windows {meta['devtrace_stage_steps']} != the "
          f"run's steps {b['steps']}")
    check(b["docs"]["m.json"]["gauges"]["devtrace_steps"]
          == sum(b["steps"].values()), "devtrace_steps != the run's steps")
    for doc in ("m.stage1.json", "m.stage2.json"):
        check(b["docs"][doc]["counters"]["device_kernel_us_total"] > 0,
              f"{doc}: no kernel time in the profile")
    ours = port_kernel_names()
    top = []
    for ent in meta["devtrace_top_kernels"]:
        label, _, us = ent.rpartition("=")
        top.append({"kernel": label, "us": float(us),
                    "port": label.split("<")[0] in ours,
                    "torch_fill_copy": bool(TORCH_FILL_COPY.match(label))})
    others = [t["kernel"] for t in top
              if not (t["port"] or t["torch_fill_copy"])]
    check(top and top[0]["port"] and not others,
          f"top kernels that are neither the port's nor torch's fills and "
          f"copies: {others} (top {top})")
    hk5 = {key: meta.get(f"devtrace_launch_{key}", {}).get("stage2_head")
           for key in ("calls", "host_us", "device_us", "kernel_us")}
    check(hk5["calls"] and hk5["kernel_us"], f"no HK5 launch ranges: {hk5}")
    traces = {os.path.relpath(p, b["dir"]): os.path.getsize(p)
              for p in devtrace.find_trace_files(os.path.join(b["dir"],
                                                              "prof"))}
    out = {"phase": "telemetry", "card": card,
           "metrics_run": {k: v for k, v in a.items()
                           if k not in ("docs", "dir")},
           "profile_run": {
               **{k: v for k, v in b.items() if k not in ("docs", "dir")},
               "devtrace_source": meta["devtrace_source"],
               "stages": {s: {"steps": meta["devtrace_stage_steps"][s],
                              "kernel_us":
                                  meta["devtrace_stage_kernel_us"][s],
                              "step_us": meta["devtrace_stage_step_us"][s],
                              "idle_us": meta["devtrace_stage_idle_us"][s]}
                          for s in meta["devtrace_stage_steps"]},
               "device_kernel_us_total": counters["device_kernel_us_total"],
               "device_kernel_unattributed_us_total":
                   counters["device_kernel_unattributed_us_total"],
               "memcpy_us": meta["devtrace_memcpy_us"],
               "memset_us": meta["devtrace_memset_us"],
               "top_kernels": top,
               "trace_bytes": traces},
           "full_device_busy_s": round(fr["busy"].busy_s, 3),
           "hk5": {**hk5, **{f"{k}_per_call": round(hk5[k] / hk5["calls"], 3)
                             for k in ("host_us", "device_us",
                                       "kernel_us")}},
           "launches": launches}
    emit(out)
    return launches


class RenderCapture:
    """Keeps the arguments of every `every`-th call of stage 2's render
    (error_correct.render_batch_host, which the render workers look up
    at each call) while a run is inside; `every` 0 keeps none."""

    def __init__(self, every: int):
        self.every, self.calls, self.args = every, 0, []

    def __enter__(self):
        from quorum_tpu_torch.models import error_correct

        self.plain = error_correct.render_batch_host
        if self.every:
            error_correct.render_batch_host = self.render
        return self

    def render(self, *args):
        if self.calls % self.every == 0:
            self.args.append(args)
        self.calls += 1
        return self.plain(*args)

    def __exit__(self, *exc):
        from quorum_tpu_torch.models import error_correct

        error_correct.render_batch_host = self.plain


def render_cost(captured: list) -> dict:
    """Where the outcome tallies' seconds go: stage 2's render of the
    captured batches, serial on this thread, with `count_outcomes` off
    and on (which runs first alternates by batch); and its parts on the
    same batches: the finish (corrector.finish_batch_host) and the
    tally loop alone (error_correct._tally_log over every corrected
    read's two logs, as render_result runs it)."""
    from quorum_tpu_torch.models import corrector, error_correct

    secs = dict.fromkeys(("render_off", "render_on", "finish", "tally"), 0.0)
    reads = entries = 0
    for i, (batch, buf, b, l, maxe, cfg, _count) in enumerate(captured):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            t0 = time.perf_counter()
            error_correct.render_batch_host(batch, buf, b, l, maxe, cfg, on)
            secs["render_on" if on else "render_off"] += \
                time.perf_counter() - t0
        t0 = time.perf_counter()
        results = corrector.finish_batch_host(buf, batch.n, batch.codes, b,
                                              l, maxe, cfg)
        t1 = time.perf_counter()
        outcome = error_correct.new_outcome()
        for r in results:
            if r.ok:
                error_correct._tally_log(r.fwd_log, outcome)
                error_correct._tally_log(r.bwd_log, outcome)
        secs["tally"] += time.perf_counter() - t1
        secs["finish"] += t1 - t0
        reads += batch.n
        entries += outcome["subs"] + outcome["t3"] + outcome["t5"]
    out = {"batches": len(captured), "reads": reads, "log_entries": entries,
           **{f"{k}_s": round(v, 4) for k, v in secs.items()}}
    out["tally_us_per_read"] = round(secs["tally"] / max(1, reads) * 1e6, 4)
    out["on_minus_off_s"] = round(secs["render_on"] - secs["render_off"], 4)
    return out


def quality_profile(section: dict) -> dict:
    """The flat metrics QUALITY_BASELINE.json pins, from one quality
    section, by tools/quality_diff.py's own profile_from_quality (loaded
    by path; its module-level imports are the standard library and
    tools/perf_diff.py)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "quality_diff", os.path.join(ROOT, "tools", "quality_diff.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.profile_from_quality(section)


def table_content(path: str):
    """A database's entries as (full hash, value word) pairs sorted by
    hash, on the card: the table's content whatever its row count (the
    full hash is (rem << rb_log2) | row, rem = hi:rlo)."""
    import numpy as np
    import torch

    from quorum_tpu_torch.io import db_format

    h = db_format.read_header(path)
    rb, bits, n = h["rb_log2"], h["bits"], h["n_entries"]
    rows, rl = 1 << rb, 31 - bits
    buf = torch.from_numpy(np.frombuffer(db_format.db_payload_bytes(path),
                                         np.uint8).copy()).to("cuda")
    addr = torch.repeat_interleave(torch.arange(rows, device="cuda"),
                                   buf[:rows].to(torch.int64))
    lo = buf[rows:rows + 4 * n].view(n, 4).to(torch.int64)
    lo = lo[:, 0] | lo[:, 1] << 8 | lo[:, 2] << 16 | lo[:, 3] << 24
    hi = torch.zeros_like(lo)
    for j in range(h["hi_bytes"]):
        at = rows + 4 * n + j * n
        hi |= buf[at:at + n].to(torch.int64) << (8 * j)
    full_hash = ((hi << rl) | (lo >> (bits + 1))) << rb | addr
    order = torch.argsort(full_hash)
    return full_hash[order], (lo & ((1 << (bits + 1)) - 1))[order]


def stage2_times(stats, wall: float) -> dict:
    """A stand-alone stage 2's pipeline: wall seconds, the producer's
    parse + pack, the main thread blocked on the prefetch queue and on
    the render drain, the render workers' sum, and the main thread's
    device and fetch seconds."""
    return {"render_workers": stats.render_workers,
            "wall_s": round(wall, 3),
            "parse_pack_s": round(stats.parse_pack_s, 3),
            "blocked_on_prefetch_s": round(stats.queue_wait_s, 3),
            "blocked_on_render_s": round(stats.drain_wait_s, 3),
            "render_s": round(stats.render_s, 3),
            "device_s": round(stats.device_s, 3),
            "fetch_s": round(stats.fetch_s, 3)}


def phase_two_binary(card: str, full: dict) -> dict:
    """The two binaries on the full run's FASTQ: quorum_create_database
    with a table of a sixteenth of the full run's rows (so it doubles
    at least twice), the v5 file, then quorum_error_correct_reads on its
    own from that file, with the driver's stage arguments."""
    import filecmp

    import torch

    from quorum_tpu_torch.cli import create_database as cdb
    from quorum_tpu_torch.cli import error_correct_reads as ec
    from quorum_tpu_torch.io import db_format
    from quorum_tpu_torch.kernels.loader import STATS

    rb_full = db_format.read_header(full["db"])["rb_log2"]
    size = 24 << (rb_full - 4)  # tile_rb_for(size) = rb_full - 4
    db = os.path.join(WORK, "two_binary.jf")
    prefix = os.path.join(WORK, "two_binary")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    handoff: dict = {}
    report: dict = {}
    STATS.reset()
    STATS.timing = True
    t0 = time.perf_counter()
    rc1 = cdb.main(["-s", str(size), "-m", str(K), "-q", str(QT), "-b", "7",
                    "-o", db, "--device", "cuda", full["fastq"]],
                   handoff=handoff)
    t1 = time.perf_counter()
    build = handoff.pop("db")[2] if rc1 == 0 else None
    # stage 2 at the defaults with --gzip, then at -t 1 --render-workers 1
    rc2 = ec.main(["--device", "cuda", "--gzip", "-o", prefix + "_gz", db,
                   full["fastq"]], report=report) if rc1 == 0 else None
    t2 = time.perf_counter()
    serial: dict = {}
    rc3 = ec.main(["--device", "cuda", "-t", "1", "--render-workers", "1",
                   "-o", prefix, db, full["fastq"]],
                  report=serial) if rc2 == 0 else None
    t3 = time.perf_counter()
    STATS.timing = False
    peak = torch.cuda.max_memory_allocated() - resident
    launches = dict(STATS.launches)
    kms = STATS.kernel_ms()
    check(rc1 == 0 and rc2 == 0 and rc3 == 0,
          f"two-binary run rc {rc1}, {rc2}, {rc3}")
    for name in PATH_KERNELS["two_binary"]:
        check(launches[name] > 0,
              f"{name} was not launched on the two-binary path")
    rb = db_format.read_header(db)["rb_log2"]
    same_out = all(filecmp.cmp(prefix + ext, full["prefix"] + ext,
                               shallow=False) for ext in (".fa", ".log"))
    same_gz = True
    for ext in (".fa", ".log"):
        with gzip.open(prefix + "_gz" + ext + ".gz", "rb") as g, \
                open(prefix + ext, "rb") as f:
            while same_gz:
                a, b = g.read(1 << 24), f.read(1 << 24)
                same_gz = a == b
                if not a:
                    break
    ha, va = table_content(db)
    hb, vb = table_content(full["db"])
    same_table = torch.equal(ha, hb) and torch.equal(va, vb)
    del ha, va, hb, vb
    same_payload = (db_format.db_payload_bytes(db)
                    == db_format.db_payload_bytes(full["db"]))
    stats = report["stats"]
    emit({"phase": "two_binary", "card": card, "size": size,
          "rb_log2_start": rb_full - 4, "rb_log2_end": rb,
          "rb_log2_full": rb_full, "grows": build.grows,
          "distinct_mers": build.distinct, "cutoff": stats.cutoff,
          "create_database_s": round(t1 - t0, 3),
          "build_s": round(build.seconds, 3),
          "create_database_parse_pack_s": round(build.parse_pack_s, 3),
          "create_database_blocked_on_prefetch_s": round(build.queue_wait_s,
                                                         3),
          "error_correct_s": round(t2 - t1, 3),
          "stage2_device_s": round(stats.device_s, 3),
          "stage2_host_s": round(stats.host_s, 3),
          "stage2_gzip_default": stage2_times(stats, t2 - t1),
          "stage2_serial": stage2_times(serial["stats"], t3 - t2),
          "same_gunzipped_fa_log": same_gz,
          "max_memory_allocated": peak, "resident_before_run": resident,
          "same_table_content": same_table, "same_payload_bytes": same_payload,
          "same_fa_log": same_out, "launches": launches,
          "kernel_s": {k: round(v / 1e3, 4) for k, v in kms.items()},
          "kernel_ms_per_launch": {k: round(v / launches[k], 5)
                                   for k, v in kms.items() if launches[k]}})
    check(build.grows >= 2, f"the table grew {build.grows} times, not >= 2")
    check(same_table, "the grown table's content differs from the full run's")
    check(same_payload == (rb == rb_full),
          "payload bytes disagree with the table geometry")
    check(same_out, "two-binary .fa/.log differ from the full run's")
    check(same_gz, "the --gzip run's output does not gunzip to the plain "
                   "run's")
    return dict(launches=launches, rb_start=rb_full - 4, peak=peak, db=db,
                rb_end=rb, grows=build.grows)


def driver_run(card: str, full: dict, mode: str, size: int = 0) -> dict:
    """The quorum driver on the full run's FASTQ with --prefilter `mode`,
    at the full run's -s or, with `size`, at that smaller -s so that the
    gated build grows (HK8, then HK1's keys entry after HK11); launch
    counts reset just before, read just after. Prints the stage and pass
    seconds, launches, kernel seconds, the prefilter's counts and the
    run's own peak device memory (the peak less what this script held
    on the card when the run began)."""
    import torch

    from quorum_tpu_torch.cli import quorum
    from quorum_tpu_torch.io import db_format
    from quorum_tpu_torch.kernels.loader import STATS

    tag = mode.replace("-", "_") + ("_grow" if size else "")
    prefix = os.path.join(WORK, "pf_" + tag)
    path = "prefilter_" + tag
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    report: dict = {}
    STATS.reset()
    STATS.timing = True
    t0 = time.perf_counter()
    rc = quorum.main(["-s", str(size or full["size"]), "-k", str(K), "-p",
                      prefix, "--device", "cuda", "--prefilter", mode,
                      full["fastq"]], report=report)
    wall = time.perf_counter() - t0
    STATS.timing = False
    launches = dict(STATS.launches)
    kms = STATS.kernel_ms()
    order = [n for n, _a, _b in STATS.events]
    keys_entry = sum(f == "tile_insert_keys" for _n, f, _a, _b in STATS.calls)
    check(rc == 0, f"prefilter {mode} driver rc {rc}")
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"{name} was not launched on the {path} path")
    build, ec = report["build"], report["ec"]
    db = prefix + "_mer_database.jf"
    h = db_format.read_header(db)
    pf = h["prefilter"]
    peak = torch.cuda.max_memory_allocated() - resident
    emit({"phase": path, "card": card, "size": size or full["size"],
          "grows": build.grows, "rb_log2_end": h["rb_log2"],
          "stage1_s": round(report["stage1_s"], 3),
          "sketch_pass_s": round(build.sketch_seconds, 3),
          "insert_pass_and_seal_s": round(build.seconds - build.sketch_seconds,
                                          3),
          "stage1_parse_pack_s": round(report["stage1_host_s"], 3),
          "stage2_s": round(report["stage2_s"], 3),
          "stage2_device_s": round(ec.device_s, 3),
          "wall_s": round(wall, 3), "cutoff": ec.cutoff,
          "presence_floor": ec.presence_floor, "entries": h["n_entries"],
          "entries_full": full["build"].distinct, "dropped": pf["dropped"],
          "false_pass": pf["false_pass"],
          "sketch_bytes": 1 << pf["sketch_cells_log2"],
          "max_memory_allocated": peak, "resident_before_run": resident,
          "max_memory_allocated_full": full["max_memory"],
          "corrected_share": round(ec.corrected / ec.reads, 6),
          "keys_entry_launches": keys_entry, "launches": launches,
          "kernel_s": {k: round(v / 1e3, 4) for k, v in kms.items()},
          "kernel_ms_per_launch": {k: round(v / launches[k], 5)
                                   for k, v in kms.items() if launches[k]}})
    if size:
        # the grow loop after the gated insert: HK8 doubles the table,
        # then the leftovers go through HK1's keys entry
        check(build.grows >= 1 and keys_entry > 0
              and order.index("gated_insert") < order.index("tile_grow")
              < order.index("tile_insert"),
              f"{path}: {build.grows} grows, {keys_entry} keys-entry "
              f"launches, not after a gated insert and a grow")
    return dict(launches=launches, prefix=prefix, db=db, header=h,
                build=build, ec=ec, peak=peak)


def exact_counts(full: dict):
    """Every mer of the full run with its exact (hq, lq) observations, as
    (full hash, hq, lq) sorted by hash: the full run's batches into a
    fresh build table at its geometry, read before the seal (the full
    hash is (rem << rb_log2) | row, rem = hi:rlo)."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.ops import ctable

    meta = ctable.TileMeta(K, 7, ctable.tile_rb_for(full["size"], K, 7)
                           + full["grows"])
    bs = ctable.make_tile_build(meta, "cuda")
    for pk, wire in full["wires"]:
        f, _left = kernels.tile_insert_reads(bs, meta, wire, BATCH, pk.length,
                                             pk.thresholds, QT)
        check(not f, "exact-count table reported full")
    tag = bs.tag.view(-1, 2)
    slot = torch.nonzero(tag[:, 0] != -1).squeeze(1)
    rlo = tag[slot, 0].to(torch.int64) & 0xFFFFFFFF
    rhi = tag[slot, 1].to(torch.int64) & 0xFFFFFFFF
    full_hash = (((rhi << meta.rlo_bits) | rlo) << meta.rb_log2) | (slot // 64)
    hq, lq = bs.hq[slot].to(torch.int64), bs.lq[slot].to(torch.int64)
    del bs, tag, rlo, rhi
    order = torch.argsort(full_hash)
    return full_hash[order], hq[order], lq[order]


def same_fa_log(a: str, b: str) -> bool:
    return all(filecmp.cmp(a + ext, b + ext, shallow=False)
               for ext in (".fa", ".log"))


def inline_check(card: str, run: dict, exact, two_db: str, label: str):
    """Inline's guarantees for `run`'s table against the exact counts:
    every entry is a real mer, every mer seen >= 2 times is present,
    every absent mer is a true singleton, and a stored count is within
    one of the truth in its quality class (below saturation). Prints
    how many entries differ (hash or value) from the table in `two_db`."""
    import torch

    check(run["header"]["prefilter"]["mode"] == "inline", "inline header mode")
    fh, fhq, flq = exact
    ih, iv = table_content(run["db"])
    at = torch.searchsorted(fh, ih).clamp(max=fh.numel() - 1)
    real = bool((fh[at] == ih).all())
    present = torch.zeros_like(fh, dtype=torch.bool)
    present[at] = True
    tot = fhq + flq
    max_val = 127
    q = ((iv >> 7) & 1) == 1
    cnt = iv & max_val
    h, l = fhq[at], flq[at]
    below = (h < max_val - 1) & (l < max_val - 1)
    res = dict(real_mers=real, recurring_kept=bool(present[tot >= 2].all()),
               absent_single=bool((tot[~present] == 1).all()),
               within_one_hq=bool(((cnt - h).abs() <= 1)[q & below].all()),
               within_one_lq=bool(((h <= 1) & ((cnt - l).abs() <= 1))
                                  [~q & below].all()))
    ha, va = table_content(two_db)
    ta = torch.searchsorted(ha, ih).clamp(max=ha.numel() - 1)
    common = ha[ta] == ih
    n_common = int(common.sum())
    differ = (ih.numel() - n_common) + (ha.numel() - n_common) \
        + int((va[ta][common] != iv[common]).sum())
    emit({"phase": label, "card": card, "entries": ih.numel(),
          "entries_compared": ha.numel(), "entries_differing": differ,
          "mers": fh.numel(), "singletons": int((tot == 1).sum()), **res})
    check(all(res.values()), f"{label}: inline guarantees {res}")


def phase_prefilter(card: str, full: dict, two_binary: dict) -> dict:
    """The memory-frugal stage 1 at full width. two-pass: the header
    declares floor 2 and the full table's (distinct_hq, total_hq); the
    table is the full one without the dropped singletons (dropped =
    singletons - false passes, every missing entry a count-1 entry, every
    kept entry unchanged); quorum_error_correct_reads --presence-floor 2
    on the full run's database (HK7, HK12) gives the two-pass run's
    .fa/.log. inline: every mer seen >= 2 times is present, every entry
    is a real mer, every absent mer is a true singleton, and a stored
    count is within one of the truth in its quality class. Then two-pass
    again at the -s of a table with fewer slots than the two-pass table
    holds entries (a 64th of the full run's rows at full width), with
    the sketch held at the full run's size (QUORUM_SKETCH_BITS), so that
    the gated build grows (grow_run: in a process of its own, beside the
    floor and inline runs): its table, header and .fa/.log equal the
    full-s two-pass run's, and each run's peak device memory stands
    beside the unfiltered two-binary run's."""
    import torch

    from quorum_tpu_torch.cli import error_correct_reads as ec_cli
    from quorum_tpu_torch.kernels.loader import STATS

    fb = full["build"]
    two = driver_run(card, full, "two-pass")
    h = two["header"]
    pf = h["prefilter"]
    check(pf["min_obs"] == 2 and pf["mode"] == "two-pass",
          f"two-pass header declares {pf}")
    check(h["poisson_stats"] == {"distinct_hq": fb.distinct_hq,
                                 "total_hq": fb.total_hq},
          f"poisson_stats {h['poisson_stats']} are not the full table's "
          f"({fb.distinct_hq}, {fb.total_hq})")
    check(pf["dropped"] == fb.singletons - pf["false_pass"]
          and h["n_entries"] == fb.distinct - pf["dropped"],
          f"two-pass counts: dropped {pf['dropped']}, singletons "
          f"{fb.singletons}, false passes {pf['false_pass']}, entries "
          f"{h['n_entries']} of {fb.distinct}")
    ha, va = table_content(two["db"])
    hb, vb = table_content(full["db"])
    at = torch.searchsorted(hb, ha).clamp(max=hb.numel() - 1)
    kept_same = bool((hb[at] == ha).all()) and torch.equal(vb[at], va)
    gone = torch.ones_like(hb, dtype=torch.bool)
    gone[at] = False
    gone_count1 = bool(((vb[gone] & 127) == 1).all())
    check(kept_same and gone_count1 and int(gone.sum()) == pf["dropped"],
          f"two-pass content: kept entries equal {kept_same}, missing "
          f"{int(gone.sum())} all count-1 {gone_count1}")
    del hb, vb, gone, at
    # two-pass from a table with fewer slots than the two-pass run keeps
    # entries, so it must grow; the sketch as large as above (the inline
    # mode's grown run went to make room for the resume phase)
    small = 24 << (h["n_entries"] // 128).bit_length()
    grow = child_start(
        "grow_run", card, {"size": full["size"], "fastq": full["fastq"],
                           "max_memory": full["max_memory"],
                           "distinct": fb.distinct}, small,
        env=dict(os.environ, QUORUM_SKETCH_BITS=str(pf["sketch_cells_log2"])))

    # the full database's stage 2 at floor 2: the floor theorem
    prefix = os.path.join(WORK, "full_floor2")
    report: dict = {}
    STATS.reset()
    STATS.timing = True
    t0 = time.perf_counter()
    rc = ec_cli.main(["--device", "cuda", "--presence-floor", "2", "-o",
                      prefix, full["db"], full["fastq"]], report=report)
    ec_s = time.perf_counter() - t0
    STATS.timing = False
    floor_launches = dict(STATS.launches)
    check(rc == 0, f"floored stage 2 rc {rc}")
    check(floor_launches["tile_load"] > 0 and floor_launches["tile_floor"] > 0,
          "the floored stage 2 did not launch tile_load and tile_floor")
    same = same_fa_log(prefix, two["prefix"])
    emit({"phase": "prefilter_floor", "card": card,
          "error_correct_s": round(ec_s, 3),
          "stage2_device_s": round(report["stats"].device_s, 3),
          "cutoff": report["stats"].cutoff,
          "cutoff_two_pass": two["ec"].cutoff,
          "same_fa_log_as_two_pass": same, "launches": floor_launches})
    check(same, "full database at floor 2 differs from the two-pass run")

    inl = driver_run(card, full, "inline")
    exact = exact_counts(full)
    inline_check(card, inl, exact, two["db"], "prefilter_inline_check")

    t0 = time.perf_counter()
    two_g = child_join(grow, "the grown two-pass run")
    waited = round(time.perf_counter() - t0, 3)
    hg, vg = table_content(two_g["db"])
    same_table = torch.equal(hg, ha) and torch.equal(vg, va)
    del ha, va, hg, vg
    same_header = all(two_g["header"][key] == h[key]
                      for key in ("prefilter", "poisson_stats", "n_entries"))
    same_out = same_fa_log(two_g["prefix"], two["prefix"])
    emit({"phase": "prefilter_grow", "card": card, "size": small,
          "grows_two_pass": two_g["grows"],
          "ran_beside": ["prefilter_floor", "prefilter_inline"],
          "waited_for_s": waited,
          "same_table_as_full_s_two_pass": same_table,
          "same_header_as_full_s_two_pass": same_header,
          "same_fa_log_as_full_s_two_pass": same_out,
          "max_memory_allocated": {
              "prefilter_two_pass_grow": two_g["peak"],
              "prefilter_two_pass": two["peak"],
              "prefilter_inline": inl["peak"],
              "two_binary": two_binary["peak"]}})
    check(same_table and same_header and same_out,
          f"grown two-pass run: table {same_table}, header {same_header}, "
          f".fa/.log {same_out} against the full-s two-pass run")
    del exact
    return {"prefilter_two_pass": two["launches"],
            "prefilter_inline": inl["launches"],
            "prefilter_two_pass_grow": two_g["launches"]}, two


def grow_run(card: str, sub: dict, size: int) -> dict:
    """driver_run's two-pass run at -s `size` (phase_prefilter starts it
    in a process of its own): `sub` holds the full run's size, FASTQ,
    peak memory and distinct entries. Returns the run's launches,
    prefix, database, header, peak memory and grows."""
    import types

    full = dict(sub, build=types.SimpleNamespace(distinct=sub["distinct"]))
    r = driver_run(card, full, "two-pass", size)
    return {"launches": r["launches"], "prefix": r["prefix"], "db": r["db"],
            "header": r["header"], "peak": r["peak"],
            "grows": r["build"].grows}


def partition_run(card: str, full: dict, path: str, extra: list) -> dict:
    """The quorum driver on the full run's FASTQ at the full run's -s
    with --partitions 4 and `extra`; launch counts reset just before,
    read just after. Prints the stage and sketch seconds, launches,
    kernel seconds and each stage's peak device memory."""
    from quorum_tpu_torch.cli import quorum
    from quorum_tpu_torch.io import db_format
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.native import binding as native

    prefix = os.path.join(WORK, path)
    report: dict = {}
    native0 = native.STATS["batches"]
    STATS.reset()
    STATS.timing = True
    with StagePeaks() as peaks:
        t0 = time.perf_counter()
        rc = quorum.main(["-s", str(full["size"]), "-k", str(K), "-p", prefix,
                          "--device", "cuda", "--partitions", str(PARTS),
                          *extra, full["fastq"]], report=report)
        wall = time.perf_counter() - t0
    native_batches = native.STATS["batches"] - native0
    STATS.timing = False
    launches = dict(STATS.launches)
    kms = STATS.kernel_ms()
    check(rc == 0, f"{path} driver rc {rc}")
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"{name} was not launched on the {path} path")
    check(native_batches > 0, f"{path}: the native parser did not run")
    build, ec = report["build"], report["ec"]
    db = prefix + "_mer_database.jf"
    h = db_format.read_header(db)
    emit({"phase": path, "card": card, "size": full["size"],
          "partitions": h["n_shards"], "rb_log2": h["rb_log2"],
          "grows": build.grows, "entries": h["n_entries"],
          "stage1_s": round(report["stage1_s"], 3),
          "sketch_pass_s": round(build.sketch_seconds, 3),
          "stage1_parse_pack_s": round(report["stage1_host_s"], 3),
          "native_batches": native_batches,
          "pipeline": pipeline_times(report),
          "stage2_s": round(report["stage2_s"], 3),
          "stage2_device_s": round(ec.device_s, 3),
          "stage2_host_s": round(ec.host_s, 3),
          "wall_s": round(wall, 3), "cutoff": ec.cutoff,
          "presence_floor": ec.presence_floor,
          "gbases_per_hour": round(ec.bases_in / (report["stage1_s"]
                                                  + report["stage2_s"])
                                   * 3600 / 1e9, 4),
          "max_memory_allocated_by_stage": peaks.as_dict(),
          "max_memory_allocated_by_stage_full": full["peaks"],
          "launches": launches,
          "kernel_s": {k: round(v / 1e3, 4) for k, v in kms.items()},
          "kernel_ms_per_launch": {k: round(v / launches[k], 5)
                                   for k, v in kms.items() if launches[k]}})
    return dict(launches=launches, prefix=prefix, db=db, header=h,
                build=build, ec=ec, peaks=peaks.as_dict())


def packed_partition_run(card: str, full: dict, path: str,
                         extra: list) -> dict:
    """quorum_create_database --partitions 4 and `extra` at the full run's
    -s, fed the full run's batches already packed (the driver's route
    into stage 1; it spares a parse a pass), then
    quorum_error_correct_reads on its own from the manifest; launch
    counts reset just before the build and read just after stage 2.
    Prints the stage seconds, launches and kernel seconds."""
    from quorum_tpu_torch.cli import create_database as cdb
    from quorum_tpu_torch.cli import error_correct_reads as ec_cli
    from quorum_tpu_torch.io import db_format
    from quorum_tpu_torch.io.fastq import ReadBatch
    from quorum_tpu_torch.kernels.loader import STATS

    prefix = os.path.join(WORK, path)
    db = prefix + "_mer_database.jf"

    def packed():
        for pk, _wire in full["wires"]:
            yield ReadBatch(None, None, pk.lengths, [], pk.n_reads), pk

    handoff: dict = {}
    report: dict = {}
    STATS.reset()
    STATS.timing = True
    t0 = time.perf_counter()
    rc = cdb.main(["-s", str(full["size"]), "-m", str(K), "-q", str(QT),
                   "-b", "7", "-o", db, "--partitions", str(PARTS),
                   "--device", "cuda", *extra, full["fastq"]],
                  handoff=handoff, batches_factory=packed)
    s1 = time.perf_counter() - t0
    check(rc == 0, f"{path} build rc {rc}")
    t1 = time.perf_counter()
    rc = ec_cli.main(["--device", "cuda", "-o", prefix, db, full["fastq"]],
                     report=report)
    s2 = time.perf_counter() - t1
    STATS.timing = False
    launches = dict(STATS.launches)
    kms = STATS.kernel_ms()
    check(rc == 0, f"{path} stage 2 rc {rc}")
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"{name} was not launched on the {path} path")
    h = db_format.read_header(db)
    ec = report["stats"]
    emit({"phase": path, "card": card, "size": full["size"],
          "input": "packed batches", "partitions": h["n_shards"],
          "rb_log2": h["rb_log2"], "grows": handoff["stats"].grows,
          "entries": h["n_entries"], "stage1_s": round(s1, 3),
          "stage2_s": round(s2, 3), "stage2_device_s": round(ec.device_s, 3),
          "stage2_host_s": round(ec.host_s, 3), "cutoff": ec.cutoff,
          "presence_floor": ec.presence_floor, "launches": launches,
          "kernel_s": {k: round(v / 1e3, 4) for k, v in kms.items()},
          "kernel_ms_per_launch": {k: round(v / launches[k], 5)
                                   for k, v in kms.items() if launches[k]}})
    return dict(launches=launches, prefix=prefix, db=db, header=h)


def phase_partitions(card: str, full: dict, two_pass: dict,
                     two_binary: dict) -> dict:
    """The partitioned multi-pass stage 1 at full width. --partitions 4
    at the full run's -s builds the full run's global geometry in four
    2^20-row passes: the manifest's payload is the full run's single
    file's and the .fa/.log are the full run's, with stage 1's peak
    device memory about a quarter of the full run's. With --prefilter
    two-pass too (quorum_create_database fed the packed batches, then
    quorum_error_correct_reads from the manifest): the payload, the
    header's prefilter, poisson_stats and n_entries, and the .fa/.log
    are the two-pass run's. Then
    quorum_create_database --partitions 4 at a -s one doubling short of
    the geometry the two_binary build grew to, fed the full run's
    batches already packed (the driver's route into stage 1; it spares
    five parses): the passes fill, restart once at twice the rows, and
    end with the two_binary run's payload."""
    from quorum_tpu_torch.cli import create_database as cdb
    from quorum_tpu_torch.io import db_format
    from quorum_tpu_torch.io.fastq import ReadBatch
    from quorum_tpu_torch.kernels.loader import STATS

    part = partition_run(card, full, "partitions", [])
    full["partitions_peaks"] = part["peaks"]
    res = dict(
        same_payload_as_full=(db_format.db_payload_bytes(part["db"])
                              == db_format.db_payload_bytes(full["db"])),
        same_fa_log_as_full=same_fa_log(part["prefix"], full["prefix"]),
        fewer_stage1_bytes=part["peaks"]["stage1"] < full["peaks"]["stage1"])
    emit({"phase": "partitions_check", "card": card, **res})
    check(all(res.values()), f"partitions against the full run: {res}")

    pt = packed_partition_run(card, full, "partitions_two_pass",
                              ["--prefilter", "two-pass"])
    h, h2 = pt["header"], two_pass["header"]
    res = dict(
        same_payload_as_two_pass=(db_format.db_payload_bytes(pt["db"])
                                  == db_format.db_payload_bytes(
                                      two_pass["db"])),
        same_header_as_two_pass=all(h[key] == h2[key] for key in
                                    ("prefilter", "poisson_stats",
                                     "n_entries")),
        same_fa_log_as_two_pass=same_fa_log(pt["prefix"],
                                            two_pass["prefix"]))
    emit({"phase": "partitions_two_pass_check", "card": card,
          "prefilter": h["prefilter"], **res})
    check(all(res.values()), f"partitions two-pass against two-pass: {res}")

    rb_need = two_binary["rb_end"]
    size = 24 << (rb_need - 1)  # tile_rb_for(size) = rb_need - 1
    db = os.path.join(WORK, "partitions_restart.jf")
    handoff: dict = {}
    STATS.reset()
    t0 = time.perf_counter()
    def packed():
        for pk, _wire in full["wires"]:
            yield ReadBatch(None, None, pk.lengths, [], pk.n_reads), pk

    rc = cdb.main(["-s", str(size), "-m", str(K), "-q", str(QT), "-b", "7",
                   "-o", db, "--partitions", str(PARTS), "--device", "cuda",
                   full["fastq"]], handoff=handoff, batches_factory=packed)
    build_s = time.perf_counter() - t0
    restart = dict(STATS.launches)
    check(rc == 0, f"partitions restart build rc {rc}")
    for name in PATH_KERNELS["partitions_restart"]:
        check(restart[name] > 0,
              f"{name} was not launched on the partitions_restart path")
    stats = handoff["stats"]
    rb = db_format.read_header(db)["rb_log2"]
    res = dict(one_restart=stats.grows == 1, geometry=rb == rb_need,
               same_payload_as_two_binary=(
                   db_format.db_payload_bytes(db)
                   == db_format.db_payload_bytes(two_binary["db"])))
    emit({"phase": "partitions_restart", "card": card, "size": size,
          "rb_log2_start": rb_need - 1, "rb_log2_end": rb,
          "grows": stats.grows, "bases": stats.bases,
          "entries": stats.distinct, "create_database_s": round(build_s, 3),
          "launches": restart, **res})
    check(all(res.values()), f"partitions restart: {res}")
    return {"partitions": part["launches"],
            "partitions_two_pass": pt["launches"],
            "partitions_restart": restart}


def phase_contaminant(card: str, full: dict) -> dict:
    """The contaminant path at E. coli size: quorum_error_correct_reads
    on its own from the full run's database and FASTQ, with
    --contaminant a FASTA of the port's adapter set and a 5,000 bp
    segment of the genome (SEGMENT: a spike-in or vector contaminant),
    first discarding (kill), then with --trim-contaminant. A read is
    touched when its TRUE codes hold a canonical K-mer of that set
    (numpy/plain torch here, apart from the port). Kill: every untouched
    read's record or skip line equals the full run's, every
    `Contaminated read` skip is a touched read, and >= 90% of the reads
    lying wholly inside the segment are skipped so. Trim: untouched reads
    equal the full run's, no read is skipped as contaminated, and no kept
    sequence holds an all-ACGT K-mer of the set. Launch counts reset
    before and read after each run."""
    import numpy as np
    import torch

    from quorum_tpu_torch.cli import error_correct_reads as ec
    from quorum_tpu_torch.kernels.loader import STATS

    fa = os.path.join(WORK, "contaminant_set.fa")  # apart from the outputs
    t0 = time.perf_counter()
    recs = write_contaminant(fa, full["genome"][SEGMENT[0]:SEGMENT[1]])
    cset = torch.from_numpy(contaminant_set(recs)).to("cuda")
    touched = holds_mer(full["true"], cset).numpy()
    origin = full["origin"].numpy()
    inside = (origin >= SEGMENT[0]) & (origin + READ_LEN <= SEGMENT[1])
    base_fa, base_log, _seqs = read_outputs(full["prefix"])
    prep_s = time.perf_counter() - t0
    n = len(touched)
    out = {"launches": {}, "fa": fa, "touched": touched}
    for tag, extra in (("contaminant", []),
                       ("contaminant_trim", ["--trim-contaminant"])):
        prefix = os.path.join(WORK, tag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        report: dict = {}
        STATS.reset()
        STATS.timing = True
        t1 = time.perf_counter()
        rc = ec.main(["--device", "cuda", "--contaminant", fa, *extra, "-o",
                      prefix, full["db"], full["fastq"]], report=report)
        wall = time.perf_counter() - t1
        STATS.timing = False
        launches = dict(STATS.launches)
        kms = STATS.kernel_ms()
        peak = torch.cuda.max_memory_allocated() - resident
        check(rc == 0, f"{tag} stage 2 rc {rc}")
        for name in PATH_KERNELS[tag]:
            check(launches[name] > 0, f"{name} was not launched on the "
                  f"{tag} path")
        fa_rec, log_rec, seqs = read_outputs(prefix)
        differ = killed = killed_untouched = changed = 0
        contam = np.zeros(n, bool)
        for i in range(n):
            ln = log_rec.get(i)
            if ln is not None and ln.endswith(b"Contaminated read"):
                contam[i] = True
            same = (fa_rec.get(i) == base_fa.get(i)
                    and ln == base_log.get(i))
            if touched[i]:
                changed += not same and i in fa_rec
            else:
                differ += not same
        killed = int(contam.sum())
        killed_untouched = int((contam & ~touched).sum())
        stats = report["stats"]
        res = {"phase": tag, "card": card, "reads": n,
               "touched": int(touched.sum()), "inside_segment":
               int(inside.sum()), "contaminant_mers": cset.numel(),
               "prep_s": round(prep_s, 3), "skipped": stats.skipped,
               "skipped_contaminated": killed,
               "inside_skipped_contaminated": int((contam & inside).sum()),
               "touched_kept_changed": changed,
               "untouched_differing": differ,
               "stage2_s": round(wall, 3),
               "stage2_device_s": round(stats.device_s, 3),
               "stage2_host_s": round(stats.host_s, 3),
               "max_memory_allocated": peak, "resident_before_run": resident,
               "launches": launches,
               "kernel_s": {k: round(v / 1e3, 4) for k, v in kms.items()
                            if launches[k]},
               "kernel_ms_per_launch": {k: round(v / launches[k], 5)
                                        for k, v in kms.items()
                                        if launches[k]}}
        if extra:
            kept = holds_mer(seq_codes(seqs, READ_LEN), cset)
            res["kept_holding_a_set_mer"] = int(kept.sum())
        emit(res)
        check(differ == 0, f"{tag}: {differ} untouched reads differ from "
              "the full run's")
        if extra:
            check(killed == 0 and res["kept_holding_a_set_mer"] == 0,
                  f"{tag}: {killed} reads skipped as contaminated, "
                  f"{res['kept_holding_a_set_mer']} kept sequences hold a "
                  "contaminant mer")
        else:
            check(killed_untouched == 0, f"{tag}: {killed_untouched} "
                  "untouched reads skipped as contaminated")
            check(res["inside_skipped_contaminated"] >= 0.9 * inside.sum(),
                  f"{tag}: {res['inside_skipped_contaminated']} of "
                  f"{int(inside.sum())} reads inside the segment skipped")
        out["launches"][tag] = launches
    return out


def phase_table(card: str, full: dict, contam: dict) -> dict:
    """HK7 loading and HK6 exporting the full run's database, each held
    against its plain version (and HK6, with the count and without, on
    that table and on the handoff table, against the file's payload
    bytes); then HK5, HK3, HK4 and HK14 on the full batch of the run's
    reads that holds the most reads the contaminant phase touched,
    against that table, held and timed there, and HK5's and HK4's
    contaminant entries (kill and trim) with the contaminant phase's
    set, with HK14 on their output; then HK5's and HK4's sharded-table
    entries, in the same modes, on that table taken as four shards."""
    import numpy as np
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.io import db_format
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import ctable

    dev = torch.device("cuda")
    h = db_format.read_header(full["db"])
    meta = ctable.TileMeta(h["key_len"] // 2, h["bits"], h["rb_log2"])
    n = h["n_entries"]
    raw = db_format.db_payload_bytes(full["db"])
    payload = torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(dev)
    rows, stats = kernels.tile_load(payload, meta, n)
    rows_p, stats_p = ref.tile_load(payload, meta, n)
    b = full["build"]
    load_equal = (torch.equal(rows, rows_p) and torch.equal(stats, stats_p)
                  and stats.tolist() == [b.distinct, b.distinct_hq,
                                         b.total_hq])
    check(load_equal, "tile_load differs from its plain version")
    del rows_p
    # HK6's export with the file's count (as write_db passes the seal's)
    # and without it, on this HK7-loaded table (rows packed from slot 0)
    # and on the table the driver hands to stage 2 (every batch inserted
    # by HK1 and sealed by HK2: keys at or after their preferred slot);
    # a count one off raises
    ek = kernels.tile_export(rows, meta, n)
    export_equal = (torch.equal(ek, ref.tile_export(rows, meta))
                    and ek.cpu().numpy().tobytes() == raw
                    and torch.equal(kernels.tile_export(rows, meta), ek))
    del ek
    build = ctable.make_tile_build(meta, dev)
    for pk, wire in full["wires"]:
        grown, _left = kernels.tile_insert_reads(
            build, meta, wire, pk.n_reads, pk.length, pk.thresholds, QT)
        check(not grown, "the handoff table reported full")
    hrows, hstats = kernels.tile_seal(build, meta)
    del build
    hk = kernels.tile_export(hrows, meta, n)
    handoff_equal = (int(hstats[1]) == n
                     and hk.cpu().numpy().tobytes() == raw
                     and torch.equal(hk, ref.tile_export(hrows, meta))
                     and torch.equal(kernels.tile_export(hrows, meta), hk))
    del hk
    for wrong in (n - 1, n + 1):
        try:
            kernels.tile_export(rows, meta, wrong)
            export_equal = False
        except RuntimeError:
            pass
    check(export_equal and handoff_equal,
          "tile_export differs from its plain version")
    # HK6's compact entry (K22): the occupied slots in slot order, against
    # its plain version at caps that drop entries, fit them exactly, leave
    # lanes to zero and take none, and on the second of DEVICES row ranges
    # (a shard, whose last tile is ragged: 24 rows a tile) at its own n
    sub = rows[meta.rows // DEVICES:2 * meta.rows // DEVICES]
    n_sub = int(ref.tile_compact(sub, meta, 0)[3])
    compact_equal = True
    for part, cap in ((rows, 0), (rows, n - 7), (rows, n), (rows, n + 9),
                      (sub, n_sub)):
        ck = kernels.tile_compact(part, meta, cap)
        cp = ref.tile_compact(part, meta, cap)
        compact_equal &= all(torch.equal(x, y) for x, y in zip(ck, cp))
    compact_equal &= int(kernels.tile_compact(rows, meta, n)[3]) == n
    del ck, cp, sub
    check(compact_equal, "tile_export's compact entry differs from its "
          "plain version")
    row_bytes = meta.rows * 512
    export_parts: dict = {}
    no_n_parts: dict = {}
    # K22 as one PyTorch call: boolean-mask indexing of the slot pairs
    # (the occupancy mask made beforehand, outside the timing)
    slots = rows.view(-1, 2)
    occupied = (slots[:, 0] & meta.max_val) != 0
    out = {
        "tile_load": dict(
            equal=load_equal, n=n,
            ms=kernel_ms(lambda: kernels.tile_load(payload, meta, n),
                         "tile_load", 5),
            plain_ms=event_ms(lambda: ref.tile_load(payload, meta, n), 2),
            bound_bytes=len(raw) + row_bytes),
        "tile_export": dict(
            equal=export_equal, n=n,
            ms=kernel_ms(lambda: kernels.tile_export(rows, meta, n),
                         "tile_export", 5, detail=export_parts),
            plain_ms=event_ms(lambda: ref.tile_export(rows, meta), 2),
            bound_bytes=row_bytes + len(raw),
            # without the count (the same function and bound; its count
            # launch reads the rows a second time)
            no_n=dict(ms=kernel_ms(lambda: kernels.tile_export(rows, meta),
                                   "tile_export", 5, detail=no_n_parts),
                      plain_ms=event_ms(lambda: ref.tile_export(rows, meta),
                                        2),
                      bound_bytes=row_bytes + len(raw)),
            handoff=dict(
                equal=handoff_equal,
                ms=kernel_ms(lambda: kernels.tile_export(hrows, meta, n),
                             "tile_export", 5),
                plain_ms=event_ms(lambda: ref.tile_export(hrows, meta), 2),
                bound_bytes=row_bytes + len(raw))),
        # the rows read once, three 4-byte words written per entry
        "tile_export_compact": dict(
            equal=compact_equal, n=n,
            ms=kernel_ms(lambda: kernels.tile_compact(rows, meta, n),
                         "tile_export_compact", 5),
            plain_ms=event_ms(lambda: ref.tile_compact(rows, meta, n), 2),
            library_ms=event_ms(lambda: slots[occupied], 5),
            bound_bytes=row_bytes + 12 * n),
    }
    del slots, occupied, hrows
    codes, quals = full["codes"], full["quals"]
    touched = contam["touched"]
    nb = -(-codes.shape[0] // BATCH)
    i = int(np.argmax([touched[j * BATCH:(j + 1) * BATCH].sum()
                       for j in range(nb)]))
    c, q, lengths, _pk = pack_batch(codes[i * BATCH:(i + 1) * BATCH],
                                    quals[i * BATCH:(i + 1) * BATCH], QT)
    cset = load_contaminant(contam["fa"])
    out.update(stage2_kernels(ctable.TileState(rows), meta, c, q, lengths,
                              reps=5, contam=cset))
    out.update(shard_stage2_kernels(ctable.TileState(rows), meta, c, q,
                                    lengths, 5, cset, out))
    out["pack_finish"]["repack"] = repack_check(ctable.TileState(rows), meta,
                                                c, q, lengths, cset)
    # HK6's wrapper span and its C launches apart: with the count, one
    # launch; without it, the count launch, the host's wait for the
    # payload size and the buffer's allocation, then that launch
    out["tile_export"]["parts_ms"] = export_parts
    out["tile_export"]["no_n"]["parts_ms"] = no_n_parts
    out["tile_floor"] = floor_table(rows, meta)
    emit({"phase": "table", "card": card, "rows": meta.rows, "entries": n,
          "payload_bytes": len(raw), "batch": i,
          "batch_touched": int(touched[i * BATCH:(i + 1) * BATCH].sum()),
          **{nm: {k: (round(v, 5) if isinstance(v, float) else v)
                  for k, v in d.items()} for nm, d in out.items()}})
    return out


def repack_check(state, meta, c, q, lengths, contam) -> dict:
    """fetch_finish's exact re-pack on the card: the batch corrected
    through correct_batch and finish_batch (contaminant kill, so merged
    statuses cross the re-pack) at the main path's first capacity, then
    again with the capacity kept for its shape set to half its entries,
    so that HK14's buffer overflows and the host packs again. The
    rendered reads must be equal, and the second run must launch HK14
    twice."""
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.models import corrector

    cfg = corrector.ECConfig(k=K, cutoff=4, qual_cutoff=33 + 40)
    cache = corrector._LEAN_CAP_CACHE
    key = (c.shape[0], corrector.log_capacity(c.shape[1], cfg))
    saved = dict(cache)
    runs = []
    try:
        for forced in (False, True):
            cache.clear()
            if forced:
                cache[key] = runs[0][2] // 2
            before = STATS.launches["pack_finish"]
            res = corrector.correct_batch(state, meta, c, q, lengths, cfg,
                                          contam=contam)
            total = int(res.packed[1])
            reads = corrector.finish_batch(res, c.shape[0], c, cfg)
            runs.append((reads, STATS.launches["pack_finish"] - before,
                         total, res.packed.numel() - 2 - 3 * c.shape[0]))
    finally:
        cache.clear()
        cache.update(saved)
    (first, n1, total, cap1), (again, n2, _t, cap2) = runs
    equal = first == again
    killed = sum(r.error == corrector.ERROR_CONTAMINANT for r in first)
    check(equal and n2 == 2 and cap2 < total and killed > 0,
          f"the exact re-pack differs (equal {equal}, launches {n2}, cap "
          f"{cap2} of {total} entries, {killed} contaminated)")
    return dict(equal=equal, entries=total, cap=cap1, launches=n1,
                forced_cap=cap2, forced_launches=n2, contaminated=killed)


def floor_table(rows, meta) -> dict:
    """HK12 and its plain version flooring copies of the full run's
    table at 2: equal rows, and entries gone; timed in place on a copy
    restored before each launch. Bound: the rows read once, and each
    32-byte sector that holds a dropped entry written once."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref

    work = rows.clone()
    kernels.tile_floor(work, meta, 2)
    plain = rows.clone()
    ref.tile_floor(plain, meta, 2)
    equal = torch.equal(work, plain)
    kept = int(((work[:, 0::2] & meta.max_val) != 0).sum())
    gone = (((rows[:, 0::2] & meta.max_val) != 0)
            & ((work[:, 0::2] & meta.max_val) == 0))
    dropped = int(gone.sum())
    sectors = int(gone.view(meta.rows, -1, 4).any(2).sum())
    del plain, gone
    check(equal and dropped > 0,
          f"tile_floor differs from its plain version (equal {equal}, "
          f"dropped {dropped})")

    def restore():
        work.copy_(rows)

    out = dict(equal=equal, n=meta.rows * 64, kept=kept, dropped=dropped,
               written_sectors=sectors,
               ms=kernel_ms(lambda: kernels.tile_floor(work, meta, 2),
                            "tile_floor", 5, restore),
               plain_ms=event_ms(lambda: ref.tile_floor(work, meta, 2), 2,
                                 restore),
               bound_bytes=meta.rows * 512 + 32 * sectors)
    del work
    return out


def full_wires(full: dict) -> list:
    """The full run's reads as the stage-1 batches on the card: a list
    of (PackedReads, wire)."""
    import torch

    codes, quals = full["codes"], full["quals"]
    out = []
    for i in range(-(-codes.shape[0] // BATCH)):
        _c, _q, _l, pk = pack_batch(codes[i * BATCH:(i + 1) * BATCH],
                                    quals[i * BATCH:(i + 1) * BATCH], QT)
        out.append((pk, torch.from_numpy(pk.to_wire()).to("cuda")))
    return out


def phase_pending(card: str, full: dict, rb_start: int) -> dict:
    """HK1's keys entry against its plain version on the leftovers the
    two-binary build meets. The full run's batches go (HK1's reads
    entry) into a table of 2^rb_start rows; at each overflow the table
    doubles (HK8) and the batch's leftover observations go into two
    copies of the doubled table, one through the keys entry and one
    through its plain version: equal when the placed flags, the sealed
    exports (HK2, HK6) and the statistics agree. The build goes on from
    the keys entry's copy, as the path does. At the first overflow HK16
    is held against its plain version on the full run's first batch and
    this table sealed (planes_layout: rows up to full). The keys entry
    is timed on the last overflow (the largest table); its byte bound
    reads each
    observation (8 + 1 B) and writes its flag, and touches the tag and
    counter sectors as HK1's reads entry does (phase_loaded)."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import ctable

    dev = torch.device("cuda")
    meta = ctable.TileMeta(K, 7, rb_start)
    bstate = ctable.make_tile_build(meta, dev)

    def copy(st):
        return ctable.TBuildState(*(t.clone() for t in st))

    def occupied(st):
        return int((st.tag[:, 0::2] != -1).sum())

    overflows = []
    near_full = None
    for pk, wire in full["wires"]:
        full_, (keys, qual) = kernels.tile_insert_reads(
            bstate, meta, wire, BATCH, pk.length, pk.thresholds, QT)
        if full_ and near_full is None:
            # HK16 on this table sealed: rows up to full, keys far from
            # their preferred slots
            rows, _st = kernels.tile_seal(bstate, meta)
            c, q, lengths, _pk = pack_batch(full["codes"][:BATCH],
                                            full["quals"][:BATCH], QT)
            near_full = planes_layout(ctable.TileState(rows), meta, c, q,
                                      lengths, "near_full", 3)
            del rows
        while full_:
            bstate, meta = ctable.tile_grow_build(bstate, meta)
            base = copy(bstate)
            plain = copy(bstate)
            placed = kernels.tile_insert_keys(bstate, meta, keys, qual)
            placed_p = ref.insert_keys(plain, meta, keys, qual)
            rows_k, stats_k = kernels.tile_seal(bstate, meta)
            rows_p, stats_p = kernels.tile_seal(plain, meta)
            del plain
            equal = (torch.equal(placed, placed_p)
                     and torch.equal(stats_k, stats_p)
                     and torch.equal(kernels.tile_export(rows_k, meta),
                                     kernels.tile_export(rows_p, meta)))
            del rows_k, rows_p
            check(equal, f"tile_insert_keys differs from its plain version "
                  f"at {meta.rows} rows")
            new_keys = occupied(bstate) - occupied(base)
            kq = keys * 2 + qual.to(torch.int64)
            overflows.append(dict(
                rows=meta.rows, leftover=keys.numel(),
                distinct_keys=torch.unique(keys).numel(), new_keys=new_keys,
                distinct_key_classes=torch.unique(kq).numel(),
                placed=int(placed.sum()), equal=equal))
            before, left = base, (keys, qual)
            keys, qual = keys[~placed], qual[~placed]
            full_ = keys.numel() > 0
    check(len(overflows) >= 2, f"{len(overflows)} overflows, not >= 2")

    # the last overflow again: `before` is its doubled table before the
    # leftovers went in
    last = overflows[-1]
    work = copy(before)

    def reset():
        for dst, src in zip(work, before):
            dst.copy_(src)

    ms = kernel_ms(lambda: kernels.tile_insert_keys(work, meta, *left),
                   "tile_insert", 5, reset)
    plain_ms = event_ms(lambda: ref.insert_keys(work, meta, *left), 2, reset)
    n = last["leftover"]
    bound_bytes = (10 * n + 32 * (last["distinct_keys"] + last["new_keys"])
                   + 64 * last["distinct_key_classes"])
    del work, before, bstate
    emit({"phase": "pending", "card": card, "rb_log2_start": rb_start,
          "overflows": overflows, "event_planes_near_full": near_full,
          "keys_entry_ms": round(ms, 5),
          "keys_entry_plain_ms": round(plain_ms, 5),
          "keys_entry_bound_ms": round(bound_bytes / H100_BYTES_PER_S * 1e3,
                                       5)})
    return dict(overflows=overflows, ms=ms, plain_ms=plain_ms,
                near_full=near_full)


def phase_loaded(card: str, full: dict) -> dict:
    """HK1 and its plain version on one full batch of the full run,
    into a copy of a table that holds every other batch of that run;
    then HK2 and its plain version sealing that table.
    The byte bound counts what an insert must touch: the scan stops at
    the first empty or matching slot, so per distinct key one 32-byte
    tag sector is read (and written when the key is new) and per
    distinct (key, qual class) one 32-byte counter sector is read and
    written; plus the wire."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import ctable

    dev = torch.device("cuda")
    meta = ctable.TileMeta(K, 7, ctable.tile_rb_for(full["size"], K, 7)
                           + full["grows"])
    wires = full["wires"]
    timed = len(wires) - 2  # a full batch late in the run
    loaded = ctable.make_tile_build(meta, dev)
    for i, (pk, wire) in enumerate(wires):
        if i != timed:
            full_, _p = kernels.tile_insert_reads(
                loaded, meta, wire, BATCH, pk.length, pk.thresholds, QT)
            check(not full_, "loaded table reported full")
    pk, wire = wires[timed]
    work = ctable.make_tile_build(meta, dev)

    def reset():
        work.tag.copy_(loaded.tag)
        work.hq.copy_(loaded.hq)
        work.lq.copy_(loaded.lq)

    def insert(fn):
        return lambda: fn(work, meta, wire, BATCH, pk.length, pk.thresholds,
                          QT)

    def occupied():
        return int((work.tag[:, 0::2] != -1).sum())

    reset()
    before = occupied()
    ms = kernel_ms(insert(kernels.tile_insert_reads), "tile_insert", 5,
                   reset)
    new_keys = occupied() - before
    plain = event_ms(insert(ref.tile_insert_reads), 3, reset)
    cw, hqb = ref.widen_wire(wire, BATCH, pk.length, pk.thresholds, QT)
    keys, qual, valid = ref.extract_observations(cw, hqb, K)
    kv, qv = keys[valid], qual[valid].to(torch.int64)
    n_keys = torch.unique(kv).numel()
    n_classes = torch.unique(kv * 2 + qv).numel()
    bound_bytes = wire.numel() + 32 * (n_keys + new_keys) + 64 * n_classes
    occ = before / (meta.rows * 64)
    del work
    pre = prefilter_kernels(card, full, loaded, meta, timed)
    rows_k, stats_k = kernels.tile_seal(loaded, meta)
    rows_p, stats_p = ref.tile_seal(loaded, meta)
    seal_equal = torch.equal(rows_k, rows_p) and torch.equal(stats_k, stats_p)
    check(seal_equal, "tile_seal differs from its plain version (loaded)")
    del rows_k, rows_p
    ms_seal = kernel_ms(lambda: kernels.tile_seal(loaded, meta), "tile_seal",
                        5)
    plain_seal = event_ms(lambda: ref.tile_seal(loaded, meta), 2)
    grow = grow_loaded(loaded, meta)
    emit({"phase": "loaded", "card": card, "batch": timed,
          "table_occupancy": round(occ, 6), "observations": int(valid.sum()),
          "distinct_keys": n_keys, "new_keys": new_keys,
          "distinct_key_classes": n_classes, "bound_bytes": bound_bytes,
          "ms": round(ms, 5), "plain_ms": round(plain, 5),
          "full_run_ms_per_launch": round(full["insert_ms_per_launch"], 5),
          "seal_equal": seal_equal, "seal_ms": round(ms_seal, 5),
          "seal_plain_ms": round(plain_seal, 5),
          "grow": {k: v for k, v in grow.items() if k != "equal"}})
    del loaded
    out = {"tile_insert": dict(n=int(valid.sum()), ms=ms, plain_ms=plain,
                               bound_bytes=bound_bytes),
           "tile_seal": dict(ms=ms_seal, plain_ms=plain_seal),
           "tile_grow": grow}
    for name, v in pre.items():
        out.setdefault(name, {}).update(v)
    return out


def prefilter_kernels(card: str, full: dict, loaded, meta, timed: int) -> dict:
    """HK9, HK10 and HK11 on batch `timed` of the full run, each held
    against its plain version on the same inputs and timed:
    - HK9 aggregating the batch: the lanes equal as sorted (key, hq, lq)
      sets;
    - HK10 at the driver's sketch size (cells_log2_for(-s) = 2^30 cells,
      1 GiB) holding every other batch of the run: the query of the
      batch's lanes and the one-batch update, byte-equal cells;
    - HK11's two-pass entry behind the finished sketch and its inline
      entry on the lanes with the pre-batch query, each on copies of
      the loaded build table: equal placed / pending flags, dropped
      counts, sealed export (HK2, HK6) and statistics.
    Byte bounds (3.35 TB/s), counting only what each function must
    move, from this batch's data (a scratch hash, its clearing and the
    empty lanes belong to a design, not to the function): HK9 the wire
    in and 16 bytes per distinct lane out; HK10's update the live lanes
    (16 bytes each) and each distinct 32-byte cell sector the lanes'
    two hashes reach, read and written once; its query the live keys in,
    an int32 each out, and those sectors read once; HK11 two-pass the
    wire, HK1's sectors for the gated observations and those cell
    sectors read once; inline the live lanes and `old` in and a flag
    each out (21 bytes), plus HK1's sectors per gated lane."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import ctable, sketch

    dev = loaded.tag.device
    wires = full["wires"]
    smeta = sketch.SketchMeta(sketch.cells_log2_for(full["size"]))
    cl = smeta.cells_log2
    sk = sketch.make_sketch(smeta, dev)
    for i, (pk, wire) in enumerate(wires):
        if i != timed:
            sketch.sketch_update_packed(sk, smeta, K, pk, wire, QT)
    pk, wire = wires[timed]
    L = pk.length
    wargs = (wire, BATCH, L, pk.thresholds, QT)

    # --- HK9
    keys, hq, lq = kernels.batch_aggregate(*wargs, K)
    pkeys, phq, plq = ref.batch_aggregate(*wargs, K)
    live = keys >= 0
    order = torch.argsort(keys[live])
    agg_equal = (torch.equal(keys[live][order], pkeys)
                 and torch.equal(hq[live][order], phq)
                 and torch.equal(lq[live][order], plq))
    check(agg_equal, "batch_aggregate differs from its plain version")
    n_obs, n_lanes, slots = (int((phq + plq).sum()), int(live.sum()),
                             keys.numel())
    # K3 as one PyTorch call: torch.unique with counts over the batch's
    # observation words (key << 1) | qual, extracted beforehand
    okeys, oq, ovalid = ref.extract_observations(
        *ref.widen_wire(*wargs), K)
    words = (okeys[ovalid] << 1) | oq[ovalid].to(torch.int64)
    agg = dict(equal=agg_equal, n=n_obs,
               ms=kernel_ms(lambda: kernels.batch_aggregate(*wargs, K),
                            "batch_aggregate", 5),
               plain_ms=event_ms(lambda: ref.batch_aggregate(*wargs, K), 2),
               library_ms=event_ms(lambda: torch.unique(
                   words, return_counts=True), 5),
               bound_bytes=wire.numel() + 16 * n_lanes)
    del okeys, oq, ovalid, words
    # the distinct 32-byte cell sectors the batch's mers reach (HK10, HK11)
    cell_sectors = torch.unique(torch.cat(ref.sketch_addrs(pkeys, cl))
                                >> 5).numel()
    del pkeys, phq, plq

    # --- HK10: query the pre-batch sketch, then update it with the batch
    old = kernels.sketch_min(sk.cells, cl, keys)
    min_equal = torch.equal(old, ref.sketch_min(sk.cells, cl, keys))
    pre = sk.cells.clone()
    kernels.sketch_update(sk.cells, cl, keys, hq, lq)
    plain_cells = pre.clone()
    ref.sketch_update(plain_cells, cl, keys, hq, lq)
    upd_equal = torch.equal(sk.cells, plain_cells)
    check(min_equal and upd_equal,
          f"sketch_update differs from its plain version (query "
          f"{min_equal}, update {upd_equal})")
    work = plain_cells

    def restore():
        work.copy_(pre)

    query_ms = kernel_ms(lambda: kernels.sketch_min(pre, cl, keys),
                         "sketch_update", 5)
    sku = dict(equal=min_equal and upd_equal, n=n_lanes, cells=smeta.cells,
               ms=kernel_ms(lambda: kernels.sketch_update(work, cl, keys, hq,
                                                          lq),
                            "sketch_update", 5, restore),
               plain_ms=event_ms(lambda: ref.sketch_update(work, cl, keys, hq,
                                                           lq), 2, restore),
               bound_bytes=16 * n_lanes + 64 * cell_sectors,
               cell_sectors=cell_sectors,
               query=dict(ms=query_ms,
                          plain_ms=event_ms(lambda: ref.sketch_min(pre, cl,
                                                                   keys), 2),
                          bound_bytes=12 * n_lanes + 32 * cell_sectors),
               cell_values=[int((sk.cells == v).sum()) for v in range(3)])
    del work, plain_cells

    def copy(st):
        return ctable.TBuildState(*(t.clone() for t in st))

    def sealed(st):
        rows, stats = kernels.tile_seal(st, meta)
        return kernels.tile_export(rows, meta), stats

    def occupied(st):
        return int((st.tag[:, 0::2] != -1).sum())

    before = occupied(loaded)
    work = copy(loaded)

    def reset():
        for dst, src in zip(work, loaded):
            dst.copy_(src)

    # --- HK11 two-pass, behind the finished sketch (sk.cells)
    gargs = (meta, sk.cells, cl, *wargs)
    a, b = copy(loaded), copy(loaded)
    full_k, (left_k, _lq), drop_k = kernels.gated_insert_reads(a, *gargs)
    (left_p, _pq), drop_p = ref.gated_insert_reads(b, *gargs)
    ea, sa = sealed(a)
    eb, sb = sealed(b)
    new_two = occupied(a) - before
    del a, b
    two_equal = (not full_k and left_k.numel() == 0 and left_p.numel() == 0
                 and torch.equal(drop_k, drop_p) and torch.equal(sa, sb)
                 and torch.equal(ea, eb))
    del ea, eb
    check(two_equal, "gated_insert (two-pass) differs from its plain version")
    cw, hqb = ref.widen_wire(*wargs)
    okeys, oqual, ovalid = ref.extract_observations(cw, hqb, K)
    okeys, oqual = okeys[ovalid], oqual[ovalid].to(torch.int64)
    gate = ref.sketch_min(sk.cells, cl, okeys) >= 2
    g_keys = torch.unique(okeys[gate]).numel()
    g_classes = torch.unique(okeys[gate] * 2 + oqual[gate]).numel()
    del cw, hqb, okeys, oqual, ovalid, gate
    two = dict(ms=kernel_ms(lambda: kernels.gated_insert_reads(work, *gargs),
                            "gated_insert", 5, reset),
               plain_ms=event_ms(lambda: ref.gated_insert_reads(work, *gargs),
                                 2, reset),
               bound_bytes=wire.numel() + 32 * (g_keys + new_two)
               + 64 * g_classes + 32 * cell_sectors,
               dropped=drop_k.tolist(), new_keys=new_two)

    # --- HK11 inline, on the lanes with the PRE-batch query `old`
    largs = (meta, keys, hq, lq, old)
    a, b = copy(loaded), copy(loaded)
    fk, dk = kernels.gated_insert_lanes(a, *largs)
    fp, dp = ref.gated_insert_lanes(b, *largs)
    ea, sa = sealed(a)
    eb, sb = sealed(b)
    new_inl = occupied(a) - before
    del a, b
    inl_equal = (torch.equal(fk, fp) and torch.equal(dk, dp)
                 and torch.equal(sa, sb) and torch.equal(ea, eb))
    del ea, eb
    check(inl_equal, "gated_insert (inline) differs from its plain version")
    h, l, o = hq.long(), lq.long(), old.long()
    gated = live & (o + (h + l).clamp(max=2) >= 2)
    retro = gated & (o == 1)
    n_cls = int(((h + (retro & (h > 0))) > 0)[gated].sum()
                + ((l + (retro & (h == 0))) > 0)[gated].sum())
    inline = dict(ms=kernel_ms(lambda: kernels.gated_insert_lanes(work, *largs),
                               "gated_insert", 5, reset),
                  plain_ms=event_ms(
                      lambda: ref.gated_insert_lanes(work, *largs), 2, reset),
                  bound_bytes=21 * n_lanes
                  + 32 * (int(gated.sum()) + new_inl) + 64 * n_cls,
                  dropped=dk.tolist(), gated_lanes=int(gated.sum()),
                  failed=int(fk.sum()), new_keys=new_inl)
    del work, pre
    part = partition_kernels(card, full, timed, sk.cells, cl)
    del sk
    gi = dict(equal=two_equal and inl_equal, n=n_obs, **two, inline=inline)
    emit({"phase": "loaded_prefilter", "card": card, "batch": timed,
          "observations": n_obs, "lanes": n_lanes, "slots": slots,
          **{nm: {k: (round(v, 5) if isinstance(v, float) else v)
                  for k, v in d.items()}
             for nm, d in (("batch_aggregate", agg), ("sketch_update", sku),
                           ("gated_insert", gi))}})
    out = {"batch_aggregate": agg, "sketch_update": sku, "gated_insert": gi}
    for name, v in part.items():
        out.setdefault(name, {}).update(v)
    return out


def partition_kernels(card: str, full: dict, timed: int, cells,
                      cl: int) -> dict:
    """HK1's and HK11's partition entries and HK13 at the partitioned
    build's shapes (--partitions 4 at the full run's -s: 2^20-row pass
    tables). The full run's other batches go through HK1's partition
    entry for pass 1 into a pass table; batch `timed` then goes into
    copies of it through HK1's partition entry and its plain version,
    and through HK11's two-pass entry (behind `cells`, the finished
    2^30-cell sketch) and its plain version: equal sealed exports (HK2,
    HK6), statistics and dropped counts; each timed. Then HK2 seals the
    pass table and HK13 and its plain version rebase copies of it: equal
    rows, `bad` clear; a copy with a foreign entry planted (an entry's
    remainder bit 0 flipped, written to an empty slot of its row) sets
    `bad` in both. HK13 is timed in place on a copy restored before
    each launch.
    Byte bounds (3.35 TB/s), from this batch's data: HK1 and HK11 as in
    the loaded phase, over the observations pass 1 owns (HK11: plus the
    distinct cell sectors of the owned mers, read once); HK13 the pass
    table read once and each 32-byte sector holding an entry written
    once."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import ctable

    part, g = 1, PARTS.bit_length() - 1
    dev = cells.device
    lmeta = ctable.TileMeta(K, 7, ctable.tile_rb_for(full["size"], K, 7) - g)
    wires = full["wires"]
    table = ctable.make_tile_build(lmeta, dev)
    for i, (pk, wire) in enumerate(wires):
        if i != timed:
            f, _left = kernels.tile_insert_reads(
                table, lmeta, wire, BATCH, pk.length, pk.thresholds, QT,
                part, PARTS)
            check(not f, "pass table reported full")
    pk, wire = wires[timed]
    wargs = (wire, BATCH, pk.length, pk.thresholds, QT)

    def copy(st):
        return ctable.TBuildState(*(t.clone() for t in st))

    def sealed(st):
        rows, stats = kernels.tile_seal(st, lmeta)
        return kernels.tile_export(rows, lmeta), stats

    def occupied(st):
        return int((st.tag[:, 0::2] != -1).sum())

    work = copy(table)

    def reset():
        for dst, src in zip(work, table):
            dst.copy_(src)

    # the observations pass 1 owns, for the bounds
    cw, hqb = ref.widen_wire(*wargs)
    okeys, oqual, ovalid = ref.extract_observations(cw, hqb, K)
    okeys, oqual = okeys[ovalid], oqual[ovalid].to(torch.int64)
    own = ref.partition_mask(okeys, lmeta, part, PARTS)
    okeys, oqual = okeys[own], oqual[own]
    del cw, hqb, ovalid, own
    before = occupied(table)

    # --- HK1's partition entry
    a, b = copy(table), copy(table)
    fk, _left = kernels.tile_insert_reads(a, lmeta, *wargs, part, PARTS)
    left_p, _q = ref.tile_insert_reads(b, lmeta, *wargs, part, PARTS)
    new_ins = occupied(a) - before
    ea, sa = sealed(a)
    eb, sb = sealed(b)
    del a, b
    ins_equal = (not fk and left_p.numel() == 0 and torch.equal(sa, sb)
                 and torch.equal(ea, eb))
    del ea, eb
    check(ins_equal, "tile_insert's partition entry differs from its plain "
          "version")
    ins = dict(equal=ins_equal, n=okeys.numel(), new_keys=new_ins,
               ms=kernel_ms(lambda: kernels.tile_insert_reads(
                   work, lmeta, *wargs, part, PARTS), "tile_insert", 5,
                   reset),
               plain_ms=event_ms(lambda: ref.tile_insert_reads(
                   work, lmeta, *wargs, part, PARTS), 2, reset),
               bound_bytes=wire.numel()
               + 32 * (torch.unique(okeys).numel() + new_ins)
               + 64 * torch.unique(okeys * 2 + oqual).numel())

    # --- HK11's partition entry (two-pass), behind the finished sketch
    gargs = (lmeta, cells, cl, *wargs, part, PARTS)
    a, b = copy(table), copy(table)
    fk, (left_k, _lq), drop_k = kernels.gated_insert_reads(a, *gargs)
    (left_p, _pq), drop_p = ref.gated_insert_reads(b, *gargs)
    new_gate = occupied(a) - before
    ea, sa = sealed(a)
    eb, sb = sealed(b)
    del a, b
    gate_equal = (not fk and left_k.numel() == 0 and left_p.numel() == 0
                  and torch.equal(drop_k, drop_p) and torch.equal(sa, sb)
                  and torch.equal(ea, eb))
    del ea, eb
    check(gate_equal, "gated_insert's partition entry differs from its plain "
          "version")
    gate = ref.sketch_min(cells, cl, okeys) >= 2
    ukeys = torch.unique(okeys)
    sectors = torch.unique(torch.cat(ref.sketch_addrs(ukeys, cl)) >> 5).numel()
    gated = dict(
        equal=gate_equal, n=okeys.numel(), new_keys=new_gate,
        dropped=drop_k.tolist(),
        ms=kernel_ms(lambda: kernels.gated_insert_reads(work, *gargs),
                     "gated_insert", 5, reset),
        plain_ms=event_ms(lambda: ref.gated_insert_reads(work, *gargs), 2,
                          reset),
        bound_bytes=wire.numel()
        + 32 * (torch.unique(okeys[gate]).numel() + new_gate)
        + 64 * torch.unique(okeys[gate] * 2 + oqual[gate]).numel()
        + 32 * sectors)
    del work, okeys, oqual, gate, ukeys

    # --- HK13 on the sealed pass table
    rows, _stats = kernels.tile_seal(table, lmeta)
    del table
    occ = (rows[:, 0::2] & lmeta.max_val) != 0
    entries = int(occ.sum())
    written = int(occ.view(lmeta.rows, -1, 4).any(2).sum())
    del occ
    rk, rp = rows.clone(), rows.clone()
    bk = kernels.tile_departition(rk, lmeta, g, part)
    bp = ref.tile_departition(rp, lmeta, g, part)
    dep_equal = (torch.equal(rk, rp) and int(bk) == 0 and int(bp) == 0
                 and not torch.equal(rk, rows))
    del rk, rp
    # a foreign entry: the first entry of a row with room, its remainder's
    # bit 0 flipped, written to that row's first empty slot
    planted = rows.clone()
    slots = planted.view(lmeta.rows, -1, 2)
    live = (slots[..., 0] & lmeta.max_val) != 0
    r = int(torch.nonzero(live.any(1) & ~live.all(1))[0])
    s_in = int(torch.nonzero(live[r])[0])
    s_out = int(torch.nonzero(~live[r])[0])
    slots[r, s_out, 0] = slots[r, s_in, 0] ^ (1 << (lmeta.bits + 1))
    slots[r, s_out, 1] = slots[r, s_in, 1]
    pk_, pp_ = planted.clone(), planted
    bad_k = int(kernels.tile_departition(pk_, lmeta, g, part))
    bad_p = int(ref.tile_departition(pp_, lmeta, g, part))
    del pk_, pp_, planted, slots, live
    dep_equal = dep_equal and bad_k == 1 and bad_p == 1
    check(dep_equal, f"tile_departition differs from its plain version (a "
          f"planted entry: bad {bad_k}, plain {bad_p})")
    work = rows.clone()

    def restore():
        work.copy_(rows)

    dep = dict(equal=dep_equal, n=lmeta.rows * 64, entries=entries,
               written_sectors=written,
               ms=kernel_ms(lambda: kernels.tile_departition(work, lmeta, g,
                                                             part),
                            "tile_departition", 5, restore),
               plain_ms=event_ms(lambda: ref.tile_departition(work, lmeta, g,
                                                              part), 2,
                                 restore),
               bound_bytes=lmeta.rows * 512 + 32 * written)
    del work, rows
    emit({"phase": "loaded_partitions", "card": card, "batch": timed,
          "partition": part, "of": PARTS, "pass_rows": lmeta.rows,
          "pass_table_entries_before": before,
          **{nm: {k: (round(v, 5) if isinstance(v, float) else v)
                  for k, v in d.items()}
             for nm, d in (("tile_insert", ins), ("gated_insert", gated),
                           ("tile_departition", dep))}})
    return {"tile_insert": {"partition": ins},
            "gated_insert": {"partition": gated},
            "tile_departition": dep}


def grow_loaded(loaded, meta) -> dict:
    """HK8 and its plain version doubling the loaded build table: equal
    when both doubled tables seal (HK2) to the same export (HK6) and
    statistics; then both timed into a fresh doubled table. The byte
    bound reads the old tags and counters once (1 KiB a row) and
    writes, per live key, one 32-byte tag sector and one 32-byte
    counter sector of the new table."""
    import dataclasses

    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import ctable

    new_meta = dataclasses.replace(meta, rb_log2=meta.rb_log2 + 1)
    dev = loaded.tag.device
    sealed = []
    for fn in (kernels.tile_grow, ref.tile_grow):
        new = ctable.make_tile_build(new_meta, dev)
        check(not fn(loaded, meta, new, new_meta), "doubled table full")
        rows, stats = kernels.tile_seal(new, new_meta)
        del new
        sealed.append((kernels.tile_export(rows, new_meta), stats))
        del rows
    equal = (torch.equal(sealed[0][0], sealed[1][0])
             and torch.equal(sealed[0][1], sealed[1][1]))
    check(equal, "tile_grow differs from its plain version")
    live = int(sealed[0][1][1])
    del sealed
    work = ctable.make_tile_build(new_meta, dev)

    def fresh():
        work.tag.fill_(-1)
        work.hq.zero_()
        work.lq.zero_()

    ms = kernel_ms(lambda: kernels.tile_grow(loaded, meta, work, new_meta),
                   "tile_grow", 3, fresh)
    plain = event_ms(lambda: ref.tile_grow(loaded, meta, work, new_meta), 1,
                     fresh)
    del work
    return dict(equal=equal, n=meta.rows * 64, live_keys=live, ms=ms,
                plain_ms=plain, bound_bytes=meta.rows * 1024 + 64 * live)


DEVICES = 4  # shards of the devices phase: a mesh of four entries


def devices_mesh():
    """Four mesh entries over the host's cards, in turn: on a one-card
    host all four name the card."""
    import torch

    from quorum_tpu_torch.parallel import tile_sharded as ts

    n = torch.cuda.device_count()
    return ts.make_mesh(DEVICES, devices=[torch.device("cuda", i % n)
                                          for i in range(DEVICES)])


def packed_batches(full: dict):
    """The full run's stage-1 batches, already packed (no parse)."""
    from quorum_tpu_torch.io.fastq import ReadBatch

    for pk, _wire in full["wires"]:
        yield ReadBatch(None, None, pk.lengths, [],
                        int((pk.lengths > 0).sum())), pk


def stage2_batches(full: dict):
    """The full run's reads as the driver replays them into stage 2:
    each batch with the parser's headers, packed with stage 2's quality
    plane (no parse)."""
    from quorum_tpu_torch.io.fastq import ReadBatch
    from quorum_tpu_torch.models.ec_config import DEFAULT_QUAL_CUTOFF

    codes, quals = full["codes"], full["quals"]
    for i in range(0, codes.shape[0], BATCH):
        c, _q, lengths, pk = pack_batch(codes[i:i + BATCH],
                                        quals[i:i + BATCH],
                                        DEFAULT_QUAL_CUTOFF)
        n = min(BATCH, codes.shape[0] - i)
        yield ReadBatch(c, None, lengths,
                        [f"r{j:09d}" for j in range(i, i + n)], n), pk


def sharded_build(full: dict, mesh, size: int, db: str,
                  layout: str = "sharded", partitions: int = 1) -> dict:
    """quorum_create_database's stage 1 with --devices 4 --db-layout
    `layout` (--partitions `partitions`) on `mesh` at -s `size`, fed the
    full run's packed batches;
    launch counts reset just before and read just after, kernels and
    the bucket exchange timed by CUDA events. Returns the handoff,
    launches, kernel ms, seconds and the peak device memory above what
    was resident."""
    import torch

    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.models import create_database as cdb

    cfg = cdb.BuildConfig(k=K, bits=7, qual_thresh=QT, initial_size=size,
                          batch_size=BATCH, device="cuda", devices=DEVICES,
                          db_layout=layout, partitions=partitions)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    handoff: dict = {}
    STATS.reset()
    STATS.timing = True
    t0 = time.perf_counter()
    cdb.create_database_main([], db, cfg, handoff=handoff,
                             batches_factory=lambda: packed_batches(full),
                             mesh=mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    STATS.timing = False
    return dict(handoff=handoff, launches=dict(STATS.launches),
                kms=STATS.kernel_ms(), seconds=seconds,
                peak=torch.cuda.max_memory_allocated() - resident)


def plain_grow(bstate, meta, mesh):
    """tile_sharded.grow through HK8's shard entry's plain versions."""
    import dataclasses

    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import ctable
    from quorum_tpu_torch.parallel import tile_sharded as ts

    nmeta = dataclasses.replace(meta, rb_log2=meta.rb_log2 + 1)
    sent = [ref.grow_shard(b, meta, s) for s, b in enumerate(bstate.shards)]
    recv = ts._exchange([(lanes, sizes.tolist()) for lanes, sizes in sent],
                        mesh)
    del sent
    shards = []
    for d, lanes in enumerate(recv):
        new = ctable.make_tile_build(nmeta.local_meta, mesh[d])
        check(not ref.grow_place(new, lanes), "plain grow found no room")
        shards.append(new)
    return ctable.ShardedBuildState(tuple(shards)), nmeta


def sealed_exports(bstate, meta) -> list:
    """Each shard sealed (HK2) and exported (HK6's row-range entry) at
    the global geometry, with HK2's statistics."""
    from quorum_tpu_torch import kernels

    out = []
    for b in bstate.shards:
        rows, stats = kernels.tile_seal(b, meta.local_meta)
        out.append((kernels.tile_export(rows, meta), stats))
        del rows
    return out


def devices_kernels(card: str, full: dict, mesh, rb: int) -> dict:
    """HK15, HK1's shard entry and HK8's shard entry on batch `timed` of
    the full run against a 4-shard build table at the full geometry that
    holds every other batch, each held against its plain version on the
    same inputs and timed. HK15 routes shard 0's rows of the batch (its
    library yardstick: torch.sort of the lanes' owner words, stable);
    HK1's shard entry counts the lanes routed to shard 0 into a copy of
    its slice; HK8's shard entry doubles the loaded table (all four
    shards: eight wrapper calls, twelve C launches). Byte bounds: HK15
    the sub-wire read and 8 B a lane written; HK1's shard entry 9 B a
    lane plus the tag and counter sectors of phase_loaded; HK8's shard
    entry 1 KiB an old row read plus a tag and a counter sector a live
    key written."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.io import packing
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.ops import ctable
    from quorum_tpu_torch.parallel import tile_sharded as ts

    meta = ts.TileShardedMeta(k=K, bits=7, rb_log2=rb, n_shards=DEVICES)
    wires = full["wires"]
    timed = len(wires) - 2
    loaded = ts.make_build_state(meta, mesh)
    for i, (pk, _wire) in enumerate(wires):
        if i != timed:
            loaded, _m, grows = ts.build_step_wire(loaded, meta, mesh, pk, QT)
            check(grows == 0, "loaded sharded table grew")
    pk = wires[timed][0]
    subs = packing.split_rows(pk, DEVICES)
    out = {}

    # HK15 on shard 0's rows of the batch
    sub = subs[0]
    wire0 = torch.from_numpy(sub.to_wire()).to(mesh[0])
    job = (wire0, sub.n_reads, sub.length, sub.thresholds)

    def route():
        return kernels.shard_route([job], QT, meta)[0]

    lanes_k, sizes_k = route()
    lanes_p, sizes_p = ref.shard_route(*job, QT, meta)
    at = [0]
    for n in sizes_k:
        at.append(at[-1] + n)
    equal = sizes_k == sizes_p.tolist() and all(
        torch.equal(torch.sort(lanes_k[a:b]).values,
                    torch.sort(lanes_p[a:b]).values)
        for a, b in zip(at, at[1:]))
    check(equal, "shard_route differs from its plain version")
    # HK15's partition entry: the same rows, pass 1 of PARTS at the pass
    # geometry of --partitions PARTS over the mesh
    pmeta = ts.TileShardedMeta(k=K, bits=7,
                               rb_log2=rb - (PARTS.bit_length() - 1),
                               n_shards=DEVICES)

    def route_part():
        return kernels.shard_route([job], QT, pmeta, 1, PARTS)[0]

    part_k, psizes_k = route_part()
    part_p, psizes_p = ref.shard_route(*job, QT, pmeta, 1, PARTS)
    pat = [0]
    for n in psizes_k:
        pat.append(pat[-1] + n)
    part_equal = psizes_k == psizes_p.tolist() and all(
        torch.equal(torch.sort(part_k[a:b]).values,
                    torch.sort(part_p[a:b]).values)
        for a, b in zip(pat, pat[1:]))
    check(part_equal, "shard_route's partition entry differs from its "
          "plain version")
    out["shard_route_part"] = dict(
        equal=part_equal, n=part_k.numel(), sizes=psizes_k,
        ms=kernel_ms(route_part, "shard_route_part", 5),
        plain_ms=event_ms(lambda: ref.shard_route(*job, QT, pmeta, 1, PARTS),
                          3),
        bound_bytes=wire0.numel() + 8 * part_k.numel())
    del part_k, part_p
    owner = ref.shard_key_parts(lanes_k >> 1, meta)[0]
    out["shard_route"] = dict(
        equal=equal, n=lanes_k.numel(), sizes=sizes_k,
        ms=kernel_ms(route, "shard_route", 5),
        plain_ms=event_ms(lambda: ref.shard_route(*job, QT, meta), 3),
        library_ms=event_ms(lambda: torch.sort(owner, stable=True), 5),
        bound_bytes=wire0.numel() + 8 * lanes_k.numel())
    del lanes_p, owner

    # HK1's shard entry: the batch routed, the lanes for shard 0
    sent = kernels.shard_route(
        [(torch.from_numpy(sb.to_wire()).to(mesh[s]), sb.n_reads, sb.length,
          sb.thresholds) for s, sb in enumerate(subs)], QT, meta)
    lanes = ts._exchange(sent, mesh)[0]
    del sent
    base = loaded.shards[0]
    work = ctable.TBuildState(*(t.clone() for t in base))
    plain = ctable.TBuildState(*(t.clone() for t in base))

    def reset():
        for dst, src in zip(work, base):
            dst.copy_(src)

    before = int((work.tag[:, 0::2] != -1).sum())
    placed_k = kernels.tile_insert_shard(work, meta, lanes)
    placed_p = ref.insert_shard(plain, meta, lanes)
    new_keys = int((work.tag[:, 0::2] != -1).sum()) - before
    local = meta.local_meta
    rk, sk = kernels.tile_seal(work, local)
    rp, sp = kernels.tile_seal(plain, local)
    equal = (torch.equal(placed_k, placed_p) and bool(placed_k.all())
             and torch.equal(sk, sp)
             and torch.equal(kernels.tile_export(rk, meta),
                             kernels.tile_export(rp, meta)))
    del rk, rp, plain
    check(equal, "tile_insert_shard differs from its plain version")
    n_keys = torch.unique(lanes >> 1).numel()
    n_classes = torch.unique(lanes).numel()
    out["tile_insert_shard"] = dict(
        equal=equal, n=lanes.numel(), new_keys=new_keys,
        ms=kernel_ms(lambda: kernels.tile_insert_shard(work, meta, lanes),
                     "tile_insert_shard", 5, reset),
        plain_ms=event_ms(lambda: ref.insert_shard(work, meta, lanes), 2,
                          reset),
        bound_bytes=(9 * lanes.numel() + 32 * (n_keys + new_keys)
                     + 64 * n_classes))
    del work, lanes

    # HK8's shard entry: the loaded table doubled
    grown, gmeta = ts.grow(loaded, meta, mesh)
    exp_k = sealed_exports(grown, gmeta)
    del grown
    grown, _gm = plain_grow(loaded, meta, mesh)
    exp_p = sealed_exports(grown, gmeta)
    del grown
    equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                for a, b in zip(exp_k, exp_p))
    live = sum(int(st[1]) for _e, st in exp_k)
    del exp_k, exp_p
    check(equal, "tile_grow_shard differs from its plain version")
    grow_ms, span_ms = [], []
    for _ in range(3):
        STATS.events.clear()
        STATS.calls.clear()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        STATS.timing = True
        a.record()
        try:
            grown, _gm = ts.grow(loaded, meta, mesh)
        finally:
            STATS.timing = False
        b.record()
        torch.cuda.synchronize()
        del grown
        calls = [x.elapsed_time(y) for n, _f, x, y in STATS.calls
                 if n == "tile_grow_shard"]
        check(len(calls) == 3 * DEVICES, "grow: expected 12 C launches")
        grow_ms.append(sum(calls))
        span_ms.append(a.elapsed_time(b))
    out["tile_grow_shard"] = dict(
        equal=equal, live_keys=live, ms=sorted(grow_ms)[1],
        span_ms=sorted(span_ms)[1],
        plain_ms=event_ms(lambda: plain_grow(loaded, meta, mesh), 1),
        bound_bytes=meta.rows * 1024 + 64 * live)
    del loaded
    emit({"phase": "devices_kernels", "card": card, "batch": timed,
          "shards": DEVICES, "rb_log2": rb,
          **{name: {k: (round(v, 5) if isinstance(v, float) else v)
                    for k, v in d.items()} for name, d in out.items()}})
    return out


def phase_devices(card: str, full: dict, two: dict) -> dict:
    """--devices N at full width on a mesh of four entries (all naming
    the card on a one-card host), fed the full run's packed batches:
    the sharded build at the full run's -s (its payload and the shards'
    occupancy against the full run's), the replicated stage 2 on its
    table (.fa/.log against the full run's, one table copy on a
    repeated device; the path's launches are the build's and stage
    2's), the build again with --db-layout single (its payload, its
    launches), the sharded grow from the two_binary run's -s
    (its payload and grows), the new kernels against their plain
    versions, and the quorum driver with --devices 2 (run where the
    host has two cards, else held refused)."""
    import contextlib
    import io

    import torch

    from quorum_tpu_torch.cli import quorum
    from quorum_tpu_torch.io import db_format
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.models import error_correct as ec
    from quorum_tpu_torch.parallel import tile_sharded as ts

    t_phase = time.perf_counter()
    mesh = devices_mesh()
    full_payload = db_format.db_payload_bytes(full["db"])
    db = os.path.join(WORK, "devices.jf")
    b1 = sharded_build(full, mesh, full["size"], db)
    state, meta, stats = b1["handoff"]["db"]
    one_copy = all(r is state.whole for r in ts.replicate_table(state, mesh))

    prefix = os.path.join(WORK, "devices")
    opts = ec.ECOptions(output=prefix, device="cuda", devices=DEVICES,
                        batch_size=BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    STATS.reset()
    STATS.timing = True
    t0 = time.perf_counter()
    ecs = ec.run_error_correct(full["fastq"], [full["fastq"]], opts,
                               db=b1["handoff"]["db"],
                               prepacked=stage2_batches(full), mesh=mesh)
    torch.cuda.synchronize()
    s2 = time.perf_counter() - t0
    STATS.timing = False
    peak2 = torch.cuda.max_memory_allocated() - resident
    # the path's launches: the build's (read as it returned) and stage 2's
    launches = {k: v + STATS.launches[k] for k, v in b1["launches"].items()}
    kms = STATS.kernel_ms()
    for name in PATH_KERNELS["devices"]:
        check(launches[name] > 0, f"{name} was not launched on the devices "
              "path")
    table_bytes = meta.rows * 512
    occ = stats.shard_occupancy
    split = {k: round(b1["kms"][name] / 1e3, 4) for k, name in SPLIT.items()}
    res = dict(
        same_payload_sharded=db_format.db_payload_bytes(db) == full_payload,
        same_occupancy=sum(occ) == full["build"].distinct,
        same_fa_log=same_fa_log(prefix, full["prefix"]),
        one_table_copy=one_copy and peak2 < table_bytes)
    emit({"phase": "devices", "card": card, "shards": DEVICES,
          "mesh": [str(d) for d in mesh], "size": full["size"],
          "rb_log2": meta.rb_log2, "grows": stats.grows,
          "shard_occupancy": occ, "entries": sum(occ),
          "entries_full": full["build"].distinct,
          "occupancy_spread": round(max(occ) / min(occ), 6),
          "stage1_s": round(b1["seconds"], 3),
          "stage1_device_split_s": split,
          "stage1_peak_memory": b1["peak"],
          "stage1_peak_memory_full": full["peaks"]["stage1"],
          "stage1_launches": b1["launches"],
          "stage2_s": round(s2, 3), "stage2_device_s": round(ecs.device_s, 3),
          "stage2_host_s": round(ecs.host_s, 3),
          "stage2_peak_memory_above_table": peak2,
          "table_bytes": table_bytes,
          "stage2_peak_memory_full": full["peaks"]["stage2"],
          "corrected": ecs.corrected, "skipped": ecs.skipped,
          "launches": launches,
          "stage2_kernel_s": {k: round(v / 1e3, 4) for k, v in kms.items()},
          "stage2_kernel_ms_per_launch": {
              k: round(v / STATS.launches[k], 5) for k, v in kms.items()
              if STATS.launches.get(k)},
          **res})
    check(all(res.values()), f"devices against the full run: {res}")
    lookup = shard_lookup_kernel(state, meta, full)
    emit({"phase": "devices_lookup", "card": card, "shards": DEVICES,
          "rb_log2": meta.rb_log2,
          "tile_lookup_shard": {k: (round(v, 5) if isinstance(v, float)
                                    else v) for k, v in lookup.items()}})
    cap = routed_cap_run(card, full, b1["handoff"]["db"], mesh, ecs, kms,
                         launches)
    rb = meta.rb_log2
    del state, meta, stats, b1

    # --db-layout single: the shards gathered onto the lead device and
    # written as one file, in a run of its own
    single = os.path.join(WORK, "devices_single.jf")
    b1s = sharded_build(full, mesh, full["size"], single, layout="single")
    for name in PATH_KERNELS["devices_single"]:
        check(b1s["launches"][name] > 0, f"{name} was not launched on the "
              "devices_single path")
    res = dict(same_payload_single=db_format.db_payload_bytes(single)
               == full_payload)
    emit({"phase": "devices_single", "card": card, "shards": DEVICES,
          "stage1_s": round(b1s["seconds"], 3),
          "stage1_device_split_s": {
              k: round(b1s["kms"][name] / 1e3, 4)
              for k, name in SPLIT.items()},
          "stage1_peak_memory": b1s["peak"], "launches": b1s["launches"],
          **res})
    check(all(res.values()), f"devices_single against the full run: {res}")
    single_launches = b1s["launches"]
    del b1s

    dbg = os.path.join(WORK, "devices_grow.jf")
    b2 = sharded_build(full, mesh, 24 << two["rb_start"], dbg)
    stats_g = b2["handoff"]["stats"]
    for name in PATH_KERNELS["devices_grow"]:
        check(b2["launches"][name] > 0,
              f"{name} was not launched on the devices_grow path")
    res = dict(same_grows=stats_g.grows == two["grows"],
               same_payload_as_two_binary=(
                   db_format.db_payload_bytes(dbg)
                   == db_format.db_payload_bytes(two["db"])))
    emit({"phase": "devices_grow", "card": card, "shards": DEVICES,
          "size": 24 << two["rb_start"], "rb_log2_start": two["rb_start"],
          "rb_log2_end": b2["handoff"]["db"][1].rb_log2,
          "grows": stats_g.grows, "grows_two_binary": two["grows"],
          "stage1_s": round(b2["seconds"], 3),
          "stage1_device_split_s": {
              k: round(b2["kms"][name] / 1e3, 4)
              for k, name in SPLIT.items()},
          "stage1_peak_memory": b2["peak"], "launches": b2["launches"],
          "kernel_s": {k: round(v / 1e3, 4) for k, v in b2["kms"].items()},
          **res})
    check(all(res.values()), f"devices_grow against two_binary: {res}")
    grow_launches = b2["launches"]
    del b2

    kern = devices_kernels(card, full, mesh, rb)

    n_cards = torch.cuda.device_count()
    cli_prefix = os.path.join(WORK, "devices_cli")
    argv = ["-s", str(full["size"]), "-k", str(K), "-p", cli_prefix,
            "--device", "cuda", "--devices", "2", full["fastq"]]
    if n_cards >= 2:
        rc = quorum.main(argv)
        cli = dict(two_card_run=True, rc=rc,
                   same_fa_log=rc == 0 and same_fa_log(cli_prefix,
                                                       full["prefix"]))
        check(cli["same_fa_log"], "quorum --devices 2 differs from full")
    else:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = quorum.main(argv)
        want = "--devices 2 but only 1 local device(s) present"
        cli = dict(two_card_run=False, rc=rc, refused=want in err.getvalue())
        check(rc == 1 and cli["refused"],
              f"quorum --devices 2 on one card: rc {rc}, {err.getvalue()!r}")
        print(f"devices: the two-card CLI run (quorum --devices 2) was not "
              f"possible on this host ({n_cards} CUDA device); no copy "
              "between two cards was run", flush=True)
    emit({"phase": "devices_cli", "card": card, "cards": n_cards, **cli,
          "phase_s": round(time.perf_counter() - t_phase, 3)})
    kern["tile_lookup_shard"] = lookup
    return dict(launches=launches, single_launches=single_launches,
                grow_launches=grow_launches, cap_launches=cap, kernels=kern)


def shard_lookup_kernel(state, meta, full: dict) -> dict:
    """HK3's shard entry on the devices phase's sealed four-shard table
    (4 x 2^20 rows): the window mers of one of the full run's stage-2
    batches plus as many random keys, held against its plain version
    (the routed lookup over the shard planes) and, where the shards are
    row ranges of one plane (a mesh naming one card), against HK3 on
    that plane, and timed on the window mers (HK3's plane entry too, on
    the same keys: the pointer table's cost). Byte bound: 16 B a key and
    one 512-byte row per distinct row touched."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import mer
    from quorum_tpu_torch.ops.ctable import TileMeta

    codes = full["codes"][:BATCH].to("cuda", torch.int8)
    f, r, valid = mer.rolling_kmers(codes, K)
    sweep = mer.canonical(f, r)[valid]
    rnd = torch.randint(0, 1 << 48, (sweep.numel(),), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    keys = torch.cat([sweep, rnd])
    shards = list(state.shards)
    vk = kernels.tile_lookup(shards, meta, keys)
    plane = TileMeta(k=meta.k, bits=meta.bits, rb_log2=meta.rb_log2)
    equal = (torch.equal(vk, ref.lookup(shards, meta, keys))
             and (state.whole is None or torch.equal(
                 vk, kernels.tile_lookup(state.whole, plane, keys)))
             and bool((vk[:sweep.numel()] != 0).all()))
    check(equal, "tile_lookup's shard entry differs from its plain version")
    rows = torch.unique(ref.tile_key_parts(sweep, meta)[0]).numel()
    out = dict(equal=equal, n=keys.numel(),
               ms=kernel_ms(lambda: kernels.tile_lookup(shards, meta, sweep),
                            "tile_lookup_shard", 5),
               plain_ms=event_ms(lambda: ref.lookup(shards, meta, sweep), 2),
               bound_bytes=16 * sweep.numel() + 512 * rows)
    if state.whole is not None:  # the plane entry on the same keys
        out["plane_ms"] = kernel_ms(
            lambda: kernels.tile_lookup(state.whole, plane, sweep),
            "tile_lookup", 5)
    return out


def routed_cap_run(card: str, full: dict, db, mesh, rep, rep_kms: dict,
                   rep_launches: dict) -> dict:
    """devices_routed_cap: the replicated devices run's stage 2 again on
    the same table (4 x 2^20 rows, 2 GiB) with the replicate cap forced
    under it (QUORUM_REPLICATE_TABLE_BYTES=1G, the lever JAX reads), so
    ShardedCorrector takes the routed layout on the shards as they are:
    .fa/.log equal to the full run's and to the replicated run's, its
    device step beside the replicated layout's from this call. Returns
    its launches."""
    import torch

    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.models import error_correct as ec

    prefix = os.path.join(WORK, "devices_routed_cap")
    opts = ec.ECOptions(output=prefix, device="cuda", devices=DEVICES,
                        batch_size=BATCH)
    before = os.environ.get("QUORUM_REPLICATE_TABLE_BYTES")
    os.environ["QUORUM_REPLICATE_TABLE_BYTES"] = "1G"
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        STATS.reset()
        STATS.timing = True
        t0 = time.perf_counter()
        ecs = ec.run_error_correct(full["fastq"], [full["fastq"]], opts,
                                   db=db, prepacked=stage2_batches(full),
                                   mesh=mesh)
        torch.cuda.synchronize()
        s2 = time.perf_counter() - t0
        STATS.timing = False
    finally:
        if before is None:
            del os.environ["QUORUM_REPLICATE_TABLE_BYTES"]
        else:
            os.environ["QUORUM_REPLICATE_TABLE_BYTES"] = before
    launches = dict(STATS.launches)
    kms = STATS.kernel_ms()
    for name in PATH_KERNELS["devices_routed_cap"]:
        check(launches[name] > 0, f"{name} was not launched on the "
              "devices_routed_cap path")
    res = dict(same_fa_log=same_fa_log(prefix, full["prefix"]),
               same_as_replicated=same_fa_log(
                   prefix, os.path.join(WORK, "devices")),
               no_replicated_probe=launches["extend_reads_event"] == 0,
               no_table_copy=(torch.cuda.max_memory_allocated() - resident
                              < (1 << 30)))
    emit({"phase": "devices_routed_cap", "card": card, "shards": DEVICES,
          "replicate_cap": "1G", "table_bytes": db[1].rows * 512,
          "stage2_s": round(s2, 3),
          "stage2_device_s": round(ecs.device_s, 3),
          "stage2_device_s_replicated": round(rep.device_s, 3),
          "device_step_ratio": round(ecs.device_s / rep.device_s, 4),
          "stage2_host_s": round(ecs.host_s, 3),
          "hk4_s": round(kms["extend_reads_event_shard"] / 1e3, 4),
          "hk4_s_replicated": round(rep_kms["extend_reads_event"] / 1e3, 4),
          "hk5_s": round(kms["stage2_head_shard"] / 1e3, 4),
          "hk5_s_replicated": round(rep_kms["stage2_head"] / 1e3, 4),
          "hk16_s": round(kms["event_planes_shard"] / 1e3, 4),
          "hk16_s_replicated": round(rep_kms["event_planes"] / 1e3, 4),
          "hk4_launches": launches["extend_reads_event_shard"],
          "hk4_launches_replicated": rep_launches["extend_reads_event"],
          "stage2_peak_memory_above_table": (torch.cuda.max_memory_allocated()
                                             - resident),
          "launches": launches, **res})
    check(all(res.values()), f"devices_routed_cap: {res}")
    return launches


def phase_devices_partitions(card: str, full: dict) -> dict:
    """--partitions 4 with --devices 4 on the four-entry mesh at the full
    run's -s, fed its packed batches (no parse): four passes, each a
    sharded build of 4 x 2^18 rows through HK15's partition entry, then
    HK13 and one shard file a pass: the manifest's payload equal to the
    full run's and to the partitions run's, HK15's partition entry
    launched on every shard in every batch of the four passes, stage 1's
    peak beside the partitions run's. Then quorum --devices 2
    --partitions 4 on the full FASTQ where the host has two cards, else
    a line saying it was not run."""
    import torch

    from quorum_tpu_torch.cli import quorum
    from quorum_tpu_torch.io import db_format

    mesh = devices_mesh()
    db = os.path.join(WORK, "devices_partitions.jf")
    b = sharded_build(full, mesh, full["size"], db, partitions=PARTS)
    launches, stats = b["launches"], b["handoff"]["stats"]
    for name in PATH_KERNELS["devices_partitions"]:
        check(launches[name] > 0,
              f"{name} was not launched on the devices_partitions path")
    n_batches = len(full["wires"])
    payload = db_format.db_payload_bytes(db)
    h = db_format.read_header(db)
    res = dict(
        same_payload_as_full=payload == db_format.db_payload_bytes(full["db"]),
        same_payload_as_partitions=payload == db_format.db_payload_bytes(
            os.path.join(WORK, "partitions_mer_database.jf")),
        no_restart=stats.grows == 0,
        route_every_shard_every_batch=(launches["shard_route_part"]
                                       == PARTS * n_batches * DEVICES))
    emit({"phase": "devices_partitions", "card": card, "shards": DEVICES,
          "partitions": h["n_shards"], "passes": PARTS * (stats.grows + 1),
          "batches": n_batches, "size": full["size"],
          "rb_log2": h["rb_log2"], "entries": h["n_entries"],
          "stage1_s": round(b["seconds"], 3),
          "stage1_device_split_s": {
              k: round(b["kms"][name] / 1e3, 4) for k, name in SPLIT.items()},
          "hk15_partition_s": round(b["kms"]["shard_route_part"] / 1e3, 4),
          "hk13_s": round(b["kms"]["tile_departition"] / 1e3, 4),
          "stage1_peak_memory": b["peak"],
          "stage1_peak_memory_partitions": full["partitions_peaks"]["stage1"],
          "stage1_peak_memory_full": full["peaks"]["stage1"],
          "launches": launches, **res})
    check(all(res.values()), f"devices_partitions: {res}")
    del b

    n_cards = torch.cuda.device_count()
    prefix = os.path.join(WORK, "devices_partitions_cli")
    if n_cards >= 2:
        rc = quorum.main(["-s", str(full["size"]), "-k", str(K), "-p", prefix,
                          "--device", "cuda", "--devices", "2",
                          "--partitions", str(PARTS), full["fastq"]])
        cli = dict(two_card_run=True, rc=rc,
                   same_fa_log=rc == 0 and same_fa_log(prefix,
                                                       full["prefix"]))
        check(cli["same_fa_log"], "quorum --devices 2 --partitions 4 differs "
              "from full")
    else:
        cli = dict(two_card_run=False)
        print(f"devices_partitions: quorum --devices 2 --partitions {PARTS} "
              f"was not run: this host has {n_cards} CUDA device", flush=True)
    emit({"phase": "devices_partitions_cli", "card": card, "cards": n_cards,
          **cli})
    return launches


def unmix(full_hash, k: int):
    """The canonical mers whose Feistel-mixed keys are `full_hash` (int64
    on the card): the four rounds of ctable's feistel_mix undone."""
    from quorum_tpu_torch.kernels import reference as ref

    kmask = (1 << k) - 1
    l, r = (full_hash >> k) & kmask, full_hash & kmask
    for c in reversed((0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)):
        l, r = r ^ (ref.mix32((l + c) & 0xFFFFFFFF) & kmask), l
    return (l << k) | r


def routed_stage2(full: dict, mesh, prefix: str, db=None,
                  path: str | None = None) -> dict:
    """quorum_error_correct_reads' stage 2 over the mesh on the handoff
    `db`, or from the database at `path` (the mesh load, timed), fed the
    full run's replayed batches; launch counts reset before and read
    after, kernels timed by CUDA events. Returns its stats, seconds,
    launches, kernel ms, load seconds and peak device memory above what
    was resident."""
    import torch

    from quorum_tpu_torch.io import db_format
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.models import error_correct as ec

    loads = []
    orig = db_format.load_db

    def timed_load(*a, **kw):
        t = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            torch.cuda.synchronize()
            loads.append(time.perf_counter() - t)

    opts = ec.ECOptions(output=prefix, device="cuda", devices=DEVICES,
                        batch_size=BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    STATS.reset()
    STATS.timing = True
    db_format.load_db = timed_load
    t0 = time.perf_counter()
    try:
        ecs = ec.run_error_correct(path or full["fastq"], [full["fastq"]],
                                   opts, db=db,
                                   prepacked=stage2_batches(full), mesh=mesh)
        torch.cuda.synchronize()
    finally:
        db_format.load_db = orig
        STATS.timing = False
    return dict(ecs=ecs, seconds=time.perf_counter() - t0,
                launches=dict(STATS.launches), kms=STATS.kernel_ms(),
                load_s=sum(loads),
                peak=torch.cuda.max_memory_allocated() - resident)


def phase_devices_routed(card: str, full: dict) -> dict:
    """The routed stage-2 layout at full width: the sharded build at 8x
    the full run's -s (rb_log2 25: 4 shards of 2^23 rows, a 16 GiB
    sealed table over 32 GiB of build state) on the four-entry mesh, fed
    the full run's packed batches, written with --db-layout sharded;
    stage 2 on the in-process handoff (routed: past 2^24 rows), the
    routed query (query_step, HK3's shard entry) of 1,048,576 of the
    table's mers against the values the full run's table holds for
    them, then stage 2 again from the manifest (the mesh load, one HK7
    launch a shard). Holds .fa/.log equal to the full run's for both,
    the shards' occupancy summing to the full run's entries, the stage-2
    peak above the resident shards under 1 GiB (no replicated copy)."""
    import torch

    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.parallel import tile_sharded as ts

    mesh = devices_mesh()
    size = 8 * full["size"]
    rb = ts.initial_rb(size, K, 7, DEVICES)
    check(rb == 25, f"-s {size} starts at rb_log2 {rb}, not 25")
    table = ts.table_bytes(rb)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    free, _total = torch.cuda.mem_get_info()
    check(3 * table < free, f"the routed build needs {3 * table} B, "
          f"{free} B free")
    # the routed query's mers and their values, from the full run's table
    content_hash, content_val = table_content(full["db"])
    pick = torch.linspace(0, content_hash.numel() - 1, 1 << 20,
                          device="cuda").long()
    qkeys = unmix(content_hash[pick], K)
    check(torch.equal(ref.feistel(qkeys, K), content_hash[pick]),
          "unmix is not feistel's inverse")
    v = content_val[pick]
    qwant = ((v & 127) << 1) | (v >> 7)
    del content_hash, content_val, pick, v

    db = os.path.join(WORK, "devices_routed.jf")
    b1 = sharded_build(full, mesh, size, db)
    state, meta, stats = b1["handoff"]["db"]
    check(meta.rb_log2 == 25 and len(state.shards) == DEVICES,
          "the routed build's geometry")
    prefix = os.path.join(WORK, "devices_routed")
    s2 = routed_stage2(full, mesh, prefix, db=b1["handoff"]["db"])
    STATS.reset()
    got = ts.query_step(mesh, meta)(state, qkeys)
    torch.cuda.synchronize()
    query_launches = dict(STATS.launches)
    launches = {k: b1["launches"][k] + s2["launches"][k] + query_launches[k]
                for k in b1["launches"]}
    for name in PATH_KERNELS["devices_routed"]:
        check(launches[name] > 0,
              f"{name} was not launched on the devices_routed path")
    occ = stats.shard_occupancy
    stage1 = dict(b1)
    del state, meta, stats, b1, stage1["handoff"]
    torch.cuda.empty_cache()

    s2m = routed_stage2(full, mesh, prefix + "_manifest", path=db)
    for name in PATH_KERNELS["devices_routed_manifest"]:
        check(s2m["launches"][name] > 0,
              f"{name} was not launched on the devices_routed_manifest path")
    res = dict(
        same_occupancy=sum(occ) == full["build"].distinct,
        same_fa_log=same_fa_log(prefix, full["prefix"]),
        same_fa_log_manifest=same_fa_log(prefix + "_manifest",
                                         full["prefix"]),
        query_values=torch.equal(got, qwant),
        no_replicated_copy=s2["peak"] < (1 << 30),
        one_load_a_shard=s2m["launches"]["tile_load"] == DEVICES)

    def s2_json(x):
        return {"stage2_s": round(x["seconds"], 3),
                "stage2_device_s": round(x["ecs"].device_s, 3),
                "stage2_host_s": round(x["ecs"].host_s, 3),
                "hk4_s": round(x["kms"]["extend_reads_event_shard"] / 1e3,
                               4),
                "hk4_launches": x["launches"]["extend_reads_event_shard"],
                "hk16_s": round(x["kms"]["event_planes_shard"] / 1e3, 4),
                "hk5_s": round(x["kms"]["stage2_head_shard"] / 1e3, 4),
                "hk5_launches": x["launches"]["stage2_head_shard"],
                "hk14_s": round(x["kms"]["pack_finish"] / 1e3, 4)}

    emit({"phase": "devices_routed", "card": card, "shards": DEVICES,
          "mesh": [str(d) for d in mesh], "size": size, "rb_log2": rb,
          "rows": 1 << rb, "table_bytes": table,
          "shard_occupancy": occ, "entries": sum(occ),
          "stage1_s": round(stage1["seconds"], 3),
          "stage1_device_split_s": {
              k: round(stage1["kms"][name] / 1e3, 4)
              for k, name in SPLIT.items()},
          "stage1_peak_memory": stage1["peak"],
          "handoff": {**s2_json(s2),
                      "stage2_peak_memory_above_shards": s2["peak"]},
          "manifest": {**s2_json(s2m), "load_s": round(s2m["load_s"], 3),
                       "stage2_peak_memory_above_table": s2m["peak"] - table},
          "query_keys": int(qkeys.numel()),
          "query_launches": query_launches["tile_lookup_shard"],
          "launches": launches, **res})
    check(all(res.values()), f"devices_routed: {res}")
    return dict(launches=launches, manifest_launches=s2m["launches"])


# ------------------------------------------------------------- event mode


def _probed_rows(fn, rows):
    """fn() (a plain version) with its reads recorded: (its result, the
    distinct rows its plane-table probes reach, a row of another table,
    the contaminant set's, counted apart; the bytes of the distinct
    frame-plane elements the event walk reads, `reference.plane_read`)."""
    import torch

    from quorum_tpu_torch.kernels import reference as ref

    probed = []
    read: dict = {}
    orig, orig_read = ref.tile_lookup, ref.plane_read

    def spy(r, m, ks):
        probed.append(ref.tile_key_parts(ks, m)[0]
                      + (0 if r is rows else 1 << 40))
        return orig(r, m, ks)

    def read_spy(plane, lane, fp, mask):
        w = plane.shape[1]
        read.setdefault(plane.data_ptr(), (plane.element_size(), []))[1] \
            .append(lane[mask] * w + fp[mask].clamp(0, w - 1))
        return orig_read(plane, lane, fp, mask)

    ref.tile_lookup, ref.plane_read = spy, read_spy
    try:
        res = fn()
    finally:
        ref.tile_lookup, ref.plane_read = orig, orig_read
    plane_bytes = sum(size * torch.unique(torch.cat(ix)).numel()
                      for size, ix in read.values())
    return (res, torch.unique(torch.cat(probed)).numel() if probed else 0,
            plane_bytes)


def walk_inputs(state, meta, c, q, lengths, contam=None, trim=False):
    """HK4's event-entry inputs for one batch (codes int8 [B, L], quals,
    lengths) against the table `state`, made by the port's own kernels
    (HK5, HK16, HK17) as stage 2 makes them, with the optional
    contaminant table (rows, meta): a namespace of HK5's lengths and
    anchors (lens, anc), the keep table and log capacity (keep, maxe),
    HK16's arguments and output (pargs, pkw, planes16), HK17's output
    (sk) and HK4's arguments (args, kw)."""
    import types

    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.io import packing
    from quorum_tpu_torch.models import corrector

    dev = state.rows.device
    b, L = c.shape
    cfg = corrector.ECConfig(k=meta.k, cutoff=4, qual_cutoff=33 + 40)
    pk = packing.pack_reads(c, q, lengths, thresholds=(cfg.qual_cutoff,))
    wire = torch.from_numpy(pk.to_wire()).to(dev)
    keep = corrector.make_keep_table(meta, cfg, dev)
    maxe = corrector.log_capacity(L, cfg)
    codes, hqb, lens, anc = kernels.stage2_head(
        state.rows, meta, wire, b, L, pk.thresholds, cfg.qual_cutoff,
        skip=cfg.skip, good=cfg.good, anchor_count=cfg.anchor_count,
        contam=contam, trim_contaminant=trim)
    pargs = (codes, hqb, lens, anc[1], keep)
    pkw = dict(min_count=cfg.min_count, cutoff=cfg.cutoff, contam=contam)
    planes16 = kernels.event_planes(state.rows, meta, *pargs, **pkw)
    sk = kernels.event_scan(*planes16, lens, meta.k)
    args = (state.rows, meta, codes, hqb, lens, anc[5], anc[1], anc[2],
            anc[3], anc[4], keep)
    kw = dict(window=cfg.effective_window, error=cfg.effective_error,
              min_count=cfg.min_count, cutoff=cfg.cutoff, maxe=maxe,
              contam=contam, trim_contaminant=trim)
    return types.SimpleNamespace(lens=lens, anc=anc, keep=keep, maxe=maxe,
                                 pargs=pargs, pkw=pkw, planes16=planes16,
                                 sk=sk, args=args, kw=kw)


def event_kernels(state, meta, c, q, lengths, reps: int, contam=None,
                  shards: bool = True) -> dict:
    """HK16 (both passes), HK17 and HK4's event entry against their plain
    versions on one batch (as stage2_kernels: codes int8 [B, L], quals,
    lengths) and the table `state`, in the three contaminant modes where
    `contam` is given; with `shards`, HK16's and HK4's event
    sharded-table entries on the table taken as DEVICES row ranges of its
    plane (a RoutedTileMeta, devices_routed_cap's layout), each also
    held against the plane entry. With reps > 0 each is timed (HK16's
    two C launches apart). Byte bounds, from this batch: HK16 its
    inputs, 29 B a window out and one read of every distinct row its
    probes reach; HK17 its inputs and 37 B a frame position out; HK4's
    event entry HK4's inputs and outputs, the distinct plane elements its
    walk reads (a teleport's start and end, a synced step's cnt and aux)
    and the distinct rows of its live probes. The sharded-table entries read the
    same rows, so share the plane entries' bounds. Also returns, per
    mode, the reads whose event-mode result differs from the plain
    walk's (`departing`)."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.parallel import tile_sharded as ts

    dev = state.rows.device
    b, L = c.shape
    k = meta.k
    if shards:
        smeta = ts.RoutedTileMeta(k=k, bits=meta.bits, rb_log2=meta.rb_log2,
                                  n_shards=DEVICES)
        srows = list(ts.row_shards(state, smeta, [dev] * DEVICES).shards)
    modes = [(None, False, None)]
    if contam is not None:
        ctab = (contam[0].rows, contam[1])
        modes += [(ctab, False, "contaminant"),
                  (ctab, True, "contaminant_trim")]
    out = {n: {} for n in ("event_planes", "event_scan",
                           "extend_reads_event")}
    if shards:
        out.update(event_planes_shard={}, extend_reads_event_shard={})
    departing = {}
    for mtab, trim, entry in modes:
        tag = entry or "plain entry"
        w = walk_inputs(state, meta, c, q, lengths, mtab, trim)
        anc, keep, maxe, lens = w.anc, w.keep, w.maxe, w.lens
        pargs, pkw, ck = w.pargs, w.pkw, w.planes16
        cp, prow, _pb = _probed_rows(
            lambda: ref.event_planes(state.rows, meta, *pargs, **pkw),
            state.rows)
        p_equal = all(torch.equal(x, y) for x, y in zip(ck, cp))
        check(p_equal, f"event_planes ({tag}) differs from its plain version")
        n_amb = int(((ck[2] >> ref.AX_PRE) & 1).sum())
        sk = w.sk
        s_equal = all(torch.equal(x, y) for x, y in
                      zip(sk, ref.event_scan(*ck, lens, k)))
        check(s_equal, f"event_scan ({tag}) differs from its plain version")
        args, kw = w.args, w.kw
        rk = kernels.extend_reads(*args, **kw, planes=sk)
        rp, wrow, wplanes = _probed_rows(
            lambda: ref.extend_reads(*args, **kw, planes=sk), state.rows)
        w_equal = _batch_equal(rk, rp, anc[0])
        check(w_equal, f"extend_reads' event entry ({tag}) differs from its "
              "plain version")
        plain = kernels.extend_reads(*args, **kw)
        departing[tag] = int((~_lanes_equal(rk, plain, anc[0])).sum())
        windows = b * L
        d16 = dict(equal=p_equal, n=windows, ambiguous=n_amb,
                   bound_bytes=2 * windows + 8 * b + keep.numel()
                   + 29 * windows + 512 * prow)
        d17 = dict(equal=s_equal, n=2 * windows,
                   bound_bytes=29 * windows + 4 * b + 37 * 2 * windows)
        io_bytes = (2 * b * L + b * 32 + keep.numel()            # inputs
                    + b * L + 8 * b + 2 * b * (12 + 8 * maxe))   # outputs
        d4 = dict(equal=w_equal, n=b, plane_bytes=wplanes,
                  bound_bytes=io_bytes + wplanes + 512 * wrow)
        if reps:
            parts: dict = {}
            d16.update(
                ms=kernel_ms(lambda: kernels.event_planes(
                    state.rows, meta, *pargs, **pkw), "event_planes", reps,
                    detail=parts),
                plain_ms=event_ms(lambda: ref.event_planes(
                    state.rows, meta, *pargs, **pkw), 1),
                parts_ms={f: round(t, 5) for f, t in parts.items()})
            d17.update(
                ms=kernel_ms(lambda: kernels.event_scan(*ck, lens, k),
                             "event_scan", reps),
                plain_ms=event_ms(lambda: ref.event_scan(*ck, lens, k), 2))
            d4.update(
                ms=kernel_ms(lambda: kernels.extend_reads(
                    *args, **kw, planes=sk), "extend_reads_event", reps),
                plain_ms=event_ms(lambda: ref.extend_reads(
                    *args, **kw, planes=sk), 1))
        got = {"event_planes": d16, "extend_reads_event": d4}
        if entry is None:
            out["event_scan"].update(d17)
        if shards:
            # the plain versions run once, timed, for both checks
            cs = kernels.event_planes(srows, smeta, *pargs, **pkw)
            csp, cs_ms = _timed(lambda: ref.event_planes(srows, smeta,
                                                         *pargs, **pkw))
            cs_equal = all(torch.equal(x, y) and torch.equal(x, z)
                           for x, y, z in zip(cs, csp, ck))
            check(cs_equal, f"event_planes' sharded-table entry ({tag}) "
                  "differs from its plain version or the plane entry")
            sargs = (srows, smeta) + args[2:]
            ws = kernels.extend_reads(*sargs, **kw, planes=sk)
            wsp, ws_ms = _timed(lambda: ref.extend_reads(*sargs, **kw,
                                                         planes=sk))
            ws_equal = (_batch_equal(ws, wsp, anc[0])
                        and _batch_equal(ws, rk, anc[0]))
            check(ws_equal, f"extend_reads' event sharded-table entry "
                  f"({tag}) differs from its plain version or the plane "
                  "entry")
            e16 = dict(equal=cs_equal, n=windows,
                       bound_bytes=d16["bound_bytes"])
            e4 = dict(equal=ws_equal, n=b, bound_bytes=d4["bound_bytes"])
            if reps:
                e16.update(
                    ms=kernel_ms(lambda: kernels.event_planes(
                        srows, smeta, *pargs, **pkw), "event_planes_shard",
                        reps),
                    plain_ms=cs_ms)
                e4.update(
                    ms=kernel_ms(lambda: kernels.extend_reads(
                        *sargs, **kw, planes=sk),
                        "extend_reads_event_shard", reps),
                    plain_ms=ws_ms)
            got.update(event_planes_shard=e16, extend_reads_event_shard=e4)
        for name, d in got.items():
            if entry is None:
                out[name].update(d)
            else:
                out[name][entry] = d
    return out, departing


def event_cuts(state, meta, c, q, lengths, reps: int, contam) -> dict:
    """HK4's event entries (plane and sharded-table, DEVICES row ranges of
    the plane; the three contaminant modes with `contam`) held against
    their plain versions on the batch less its last read, whose lanes
    fill no whole block, and the plane entry timed on the batch's first
    quarter: beside its time on the whole batch, a time that barely
    moves with B is set by the slowest lane, one that scales with B by
    throughput."""
    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.parallel import tile_sharded as ts

    smeta = ts.RoutedTileMeta(k=meta.k, bits=meta.bits, rb_log2=meta.rb_log2,
                              n_shards=DEVICES)
    srows = list(ts.row_shards(state, smeta,
                               [state.rows.device] * DEVICES).shards)
    ctab = (contam[0].rows, contam[1])
    b = c.shape[0] - 1
    plane = shard = True
    for mtab, trim, tag in ((None, False, "plain entry"),
                            (ctab, False, "contaminant"),
                            (ctab, True, "contaminant_trim")):
        w = walk_inputs(state, meta, c[:b], q[:b], lengths[:b], mtab, trim)
        found = w.anc[0]
        sargs = (srows, smeta) + w.args[2:]
        rk = kernels.extend_reads(*w.args, **w.kw, planes=w.sk)
        rs = kernels.extend_reads(*sargs, **w.kw, planes=w.sk)
        p_eq = _batch_equal(rk, ref.extend_reads(*w.args, **w.kw,
                                                 planes=w.sk), found)
        s_eq = (_batch_equal(rs, ref.extend_reads(*sargs, **w.kw,
                                                  planes=w.sk), found)
                and _batch_equal(rs, rk, found))
        check(p_eq and s_eq, f"extend_reads' event entries ({tag}) differ "
              f"from their plain versions at B = {b}")
        plane, shard = plane and p_eq, shard and s_eq
    quarter = c.shape[0] // 4
    w = walk_inputs(state, meta, c[:quarter], q[:quarter], lengths[:quarter])
    return dict(plane_equal=plane, shard_equal=shard, cut_b=b,
                quarter_b=quarter,
                ms_quarter=kernel_ms(lambda: kernels.extend_reads(
                    *w.args, **w.kw, planes=w.sk), "extend_reads_event",
                    reps))


def _timed(fn):
    """fn()'s result and its CUDA-event time in ms (one run)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    res = fn()
    b.record()
    torch.cuda.synchronize()
    return res, a.elapsed_time(b)


def _lanes_equal(a, b, found):
    """Per read: extend_reads outputs `a` and `b` equal under
    _batch_equal's rule."""
    import torch

    out_a, s_a, e_a, st_a, f_a, b_a, _o = a
    out_b, s_b, e_b, st_b, f_b, b_b, _o = b
    n = s_a.numel()
    eq = (s_a == s_b) & (e_a == e_b) & (st_a[:n] == st_b[:n]) \
        & (st_a[n:] == st_b[n:])
    pos = torch.arange(out_a.shape[1], device=out_a.device)[None, :]
    live = found[:, None] & (pos >= s_a[:, None]) & (pos < e_a[:, None])
    eq &= (torch.where(live, out_a, 0) == torch.where(live, out_b, 0)).all(1)
    for la, lb in ((f_a, f_b), (b_a, b_b)):
        j = torch.arange(la[2].shape[1], device=la[2].device)[None, :]
        m = j < la[0][:, None]
        eq &= la[0] == lb[0]
        for x, y in ((la[2], lb[2]), (la[3], lb[3])):
            eq &= (torch.where(m, x, 0) == torch.where(m, y, 0)).all(1)
    return eq


def golden_with_ns():
    """The golden reads' table (k = 13, built on the card) and its first
    256 reads with ~2% of their bases set to N (seeded), so that some N
    lies in reach of a backward extension: (state, meta, codes, quals,
    lengths) for event_kernels."""
    import numpy as np
    import torch

    from quorum_tpu_torch.io import fastq, packing
    from quorum_tpu_torch.models import create_database

    reads = os.path.join(GOLDEN, "reads.fastq")
    batches = [(bt, packing.pack_reads(bt.codes, bt.quals, bt.lengths,
                                       thresholds=(38,)))
               for bt in fastq.read_batches([reads], 256)]
    cfg = create_database.BuildConfig(k=13, bits=7, qual_thresh=38,
                                      initial_size=64000, batch_size=256)
    state, meta, _st = create_database.build_database(
        [], cfg, torch.device("cuda"), lambda: batches)
    g = batches[0][0]
    gen = torch.Generator().manual_seed(SEED + 5)
    codes = g.codes.copy()
    inread = np.arange(codes.shape[1])[None, :] < g.lengths[:, None]
    codes[(torch.rand(codes.shape, generator=gen).numpy() < 0.02)
          & inread] = -1
    return state, meta, codes, g.quals, g.lengths


def phase_event(card: str, full: dict, contam: dict, two_db: str) -> dict:
    """The event-mode stage 2. HK16 (both passes, plane and sharded-table
    entries, three contaminant modes), HK17 and HK4's event entry held
    against their plain versions and timed on the table phase's batch
    and table (the full run's database, the contaminant phase's set),
    HK16 held again on that batch against the two_binary run's database
    loaded by HK7 (`two_db`: rows packed from slot 0), and all held on
    the golden reads with Ns; then the full cell's stage 2
    from its database in event mode (the default) and in plain mode
    (event_driven=False), in that order: event's .fa/.log equal the full
    run's, and each mode's records of the first CPU_READS reads equal a
    --device cpu run of the same mode on them (event_cpu, in a process
    of its own from the phase's start). Launch counts reset before and
    read after each run."""
    import numpy as np
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.io import db_format
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.models import error_correct as ec
    from quorum_tpu_torch.ops import ctable

    # each mode's first CPU_READS reads on the CPU, in a process of its
    # own (event_cpu) beside the kernels' checks and the card's runs
    codes, quals = full["codes"], full["quals"]
    sub = os.path.join(WORK, "event_head.fastq")
    write_fastq(sub, codes[:CPU_READS], quals[:CPU_READS])
    cpu_runs = child_start("event_cpu", full["db"], sub, full["cutoff"],
                           env=dict(os.environ, OMP_NUM_THREADS="4"))
    dev = torch.device("cuda")
    h = db_format.read_header(full["db"])
    meta = ctable.TileMeta(h["key_len"] // 2, h["bits"], h["rb_log2"])
    raw = db_format.db_payload_bytes(full["db"])
    payload = torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(dev)
    rows, _stats = kernels.tile_load(payload, meta, h["n_entries"])
    del payload
    touched = contam["touched"]
    nb = -(-codes.shape[0] // BATCH)
    i = int(np.argmax([touched[j * BATCH:(j + 1) * BATCH].sum()
                       for j in range(nb)]))
    c, q, lengths, _pk = pack_batch(codes[i * BATCH:(i + 1) * BATCH],
                                    quals[i * BATCH:(i + 1) * BATCH], QT)
    cset = load_contaminant(contam["fa"])
    stats, departing = event_kernels(ctable.TileState(rows), meta, c, q,
                                     lengths, 5, cset)
    cuts = event_cuts(ctable.TileState(rows), meta, c, q, lengths, 5, cset)
    del cset
    ev4 = stats["extend_reads_event"]
    ev4.update(equal=ev4["equal"] and cuts["plane_equal"],
               cut_b=cuts["cut_b"], quarter_b=cuts["quarter_b"],
               ms_quarter=cuts["ms_quarter"])
    stats["extend_reads_event_shard"]["equal"] &= cuts["shard_equal"]
    # HK16 on a table HK7 loaded (rows packed from slot 0): the two_binary
    # run's grown database
    h2 = db_format.read_header(two_db)
    meta2 = ctable.TileMeta(h2["key_len"] // 2, h2["bits"], h2["rb_log2"])
    payload = torch.from_numpy(np.frombuffer(
        db_format.db_payload_bytes(two_db), np.uint8).copy()).to(dev)
    rows2, _s = kernels.tile_load(payload, meta2, h2["n_entries"])
    del payload
    hk7 = planes_layout(ctable.TileState(rows2), meta2, c, q, lengths,
                        "hk7_two_binary", 3)
    del rows2
    gs, gm, gc, gq, gl = golden_with_ns()
    _g, gdep = event_kernels(gs, gm, gc, gq, gl, 0)
    check(gdep["plain entry"] > 0, "the golden reads with Ns hold no read "
          "where event mode departs from the plain walk")
    del gs
    # the full cell's stage 2 in both modes
    del rows
    runs = {}
    # event, then plain
    order = (("event", True), ("event_plain", False))
    for mode, event in order:
        prefix = os.path.join(WORK, mode)
        STATS.reset()
        STATS.timing = True
        t0 = time.perf_counter()
        ecs = ec.run_error_correct(full["db"], [full["fastq"]],
                                   ec.ECOptions(output=prefix, device="cuda",
                                                batch_size=BATCH),
                                   event_driven=event)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        STATS.timing = False
        launches = dict(STATS.launches)
        kms = STATS.kernel_ms()
        path = "event" if event else "event_plain"
        for name in PATH_KERNELS[path]:
            check(launches[name] > 0, f"{name} was not launched on the "
                  f"{mode} path")
        runs[mode] = dict(
            stage2_s=round(wall, 3), stage2_device_s=round(ecs.device_s, 3),
            stage2_host_s=round(ecs.host_s, 3), cutoff=ecs.cutoff,
            corrected=ecs.corrected, skipped=ecs.skipped,
            kernel_s={k: round(v / 1e3, 4) for k, v in kms.items()
                      if launches[k]},
            kernel_ms_per_launch={k: round(v / launches[k], 5)
                                  for k, v in kms.items() if launches[k]},
            launches=launches)
        check(ecs.cutoff == full["cutoff"], f"{mode}: cutoff {ecs.cutoff}, "
              f"the CPU runs' {full['cutoff']}")
    cpu_s = child_join(cpu_runs, "event's CPU runs")
    for mode, _event in order:
        fa, log, _s = read_outputs(os.path.join(WORK, mode))
        cfa, clog, _s = read_outputs(os.path.join(WORK, mode + "_cpu"))
        runs[mode].update(
            cpu_reads=CPU_READS, cpu_s=cpu_s[mode],
            head_eq_cpu=(cfa == {j: r for j, r in fa.items()
                                 if j < CPU_READS}
                         and clog == {j: r for j, r in log.items()
                                      if j < CPU_READS}))
    ev, pl = runs["event"], runs["event_plain"]
    fa_e, log_e, _s = read_outputs(os.path.join(WORK, "event"))
    fa_p, log_p, _s = read_outputs(os.path.join(WORK, "event_plain"))
    res = dict(event_eq_full=same_fa_log(os.path.join(WORK, "event"),
                                         full["prefix"]),
               event_head_eq_cpu=ev["head_eq_cpu"],
               plain_head_eq_cpu=pl["head_eq_cpu"])

    def ratio(a, b, key):
        return round(a[key] / b[key], 4)

    emit({"phase": "event", "card": card, "batch": i,
          "event_planes_hk7_two_binary": hk7,
          "departing_reads_table_batch": departing,
          "departing_reads_golden_ns": gdep["plain entry"],
          "records_differing_event_plain": sum(
              fa_e.get(j) != fa_p.get(j) or log_e.get(j) != log_p.get(j)
              for j in range(codes.shape[0])),
          "order": [m for m, _e in order],
          "device_step_ratio_event_plain": ratio(ev, pl, "stage2_device_s"),
          "host_ratio_event_plain": ratio(ev, pl, "stage2_host_s"),
          "event": ev, "plain": pl,
          **{nm: {kk: (round(v, 5) if isinstance(v, float) else v)
                  for kk, v in d.items()} for nm, d in stats.items()},
          **res})
    check(all(res.values()), f"event phase: {res}")
    return dict(kernels=stats,
                launches={m: runs[m]["launches"]
                          for m in ("event", "event_plain")})


def event_cpu(db: str, fastq: str, cutoff: int) -> dict:
    """phase_event's --device cpu runs (a process of its own): the reads
    of `fastq` in event mode and in plain mode at `cutoff`, into
    WORK/event_cpu and WORK/event_plain_cpu. Returns {mode: seconds}."""
    from quorum_tpu_torch.models import error_correct as ec

    spent = {}
    for mode, event in (("event", True), ("event_plain", False)):
        t0 = time.perf_counter()
        ec.run_error_correct(db, [fastq], ec.ECOptions(
            output=os.path.join(WORK, mode + "_cpu"), device="cpu",
            cutoff=cutoff, batch_size=CPU_READS), event_driven=event)
        spent[mode] = round(time.perf_counter() - t0, 3)
    return spent


# ------------------------------------------------------------- flat table

FLAT_NB = 24  # the smallest nb_log2 the flat layout allows at k = 24, -b 7
FLAT_CHECK = 16  # batches of the kernel-against-plain build
# The flat phase's peak: the whole cell's mers need 2^30 buckets (2 of
# them overflow at 2^29), so the last grow holds the 2^29-bucket build
# planes and the doubled ones, 12 B a slot (keytag, hq, lq); flat_kernels'
# grow check holds as much at 2^29 -> 2^30. One batch's observations
# and the torch allocator's rounding come on top.
FLAT_PLAN_BYTES = 12 * 4 * ((1 << 29) + (1 << 30)) + (1 << 28)


def flat_observations(full: dict, i: int):
    """Batch i of the full run as flat observations on the card (keys
    int64, qual bool, valid bool [8192 * 160]): the wire widened and the
    windows extracted by their plain versions (input preparation, not
    the flat table's work)."""
    from quorum_tpu_torch.kernels import reference as ref

    pk, wire = full["wires"][i]
    codes, hqb = ref.widen_wire(wire, BATCH, pk.length, pk.thresholds, QT)
    return ref.extract_observations(codes, hqb, K)


def flat_build(full: dict, n_batches: int, plain: bool = False):
    """The first n_batches of the full run through insert_observations'
    grow-retry protocol from 2^FLAT_NB buckets: on full, double and
    insert again the valid lanes not placed. `plain` runs the plain
    versions (HK18's and its grow entry's) with CUDA events around each
    insert. Returns (bstate, meta, grows, observations, plain insert
    times in ms)."""
    import torch

    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import ctable

    meta = ctable.CTableMeta(K, 7, FLAT_NB)
    bstate = ctable.make_build_table(meta, "cuda")
    grows, n_obs, times = 0, 0, []
    for i in range(n_batches):
        keys, qual, valid = flat_observations(full, i)
        n_obs += int(valid.sum())
        pend = valid
        while True:
            if plain:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                placed, is_full = ref.flat_insert(bstate, meta, keys, qual,
                                                  pend)
                b.record()
                times.append((a, b))
            else:
                bstate, is_full, placed = ctable.insert_observations(
                    bstate, meta, keys, qual, pend)
            if not is_full:
                break
            pend = pend & ~placed
            if plain:
                nmeta = ctable.CTableMeta(K, 7, meta.nb_log2 + 1)
                new = ctable.make_build_table(nmeta, "cuda")
                ref.flat_grow(bstate, meta, new, nmeta)
                bstate, meta = new, nmeta
                del new
            else:
                bstate, meta = ctable.grow_build(bstate, meta)
            grows += 1
    torch.cuda.synchronize()
    return bstate, meta, grows, n_obs, [a.elapsed_time(b) for a, b in times]


def flat_map(state, meta):
    """A sealed flat table's content on the card: (full hashes sorted,
    their value words count << 1 | qual), from iterate_entries."""
    import torch

    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import ctable

    khi, klo, vals = ctable.iterate_entries(state, meta)
    keys = (torch.from_numpy(khi.astype("int64")) << 32
            | torch.from_numpy(klo.astype("int64"))).to("cuda")
    h = ref.feistel(keys, meta.k)
    order = torch.argsort(h)
    return h[order], torch.from_numpy(vals.astype("int64")).to("cuda")[order]


def build_map(bstate, meta):
    """A flat BUILD table's content on the card, read in chunks of its
    planes (nothing table-sized allocated): (full hashes sorted, value
    words count << 1 | qual as finalize_build would seal them)."""
    import torch

    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.ops import ctable

    hs, vs = [], []
    chunk = 1 << 26
    for s in range(0, meta.size, chunk):
        tag = bstate.keytag[s:s + chunk]
        at = torch.nonzero(tag != -1).squeeze(1)
        rem = ref.u32(tag[at])
        hq = bstate.hq[s:s + chunk][at].long()
        lq = bstate.lq[s:s + chunk][at].long()
        q = (hq > 0).long()
        cnt = torch.where(q == 1, hq, lq).clamp(1, meta.max_val)
        hs.append(ref.feistel(ctable.keys_from_table((at + s) // 4, rem,
                                                     meta), meta.k))
        vs.append((cnt << 1) | q)
    h, v = torch.cat(hs), torch.cat(vs)
    order = torch.argsort(h)
    return h[order], v[order]


def count_sectors(bstate, meta) -> tuple[int, int]:
    """The 32-byte sectors (8 slots) of a flat build plane that hold an
    occupied slot, and those that hold an occupied slot without hq (the
    lq sectors the seal must read), counted in chunks of the planes."""
    import torch

    occ, lq = 0, 0
    chunk = 1 << 26  # a multiple of 8: no sector spans two chunks
    for s in range(0, meta.size, chunk):
        at = torch.nonzero(bstate.keytag[s:s + chunk] != -1).squeeze(1)
        occ += torch.unique_consecutive(at // 8).numel()
        at = at[bstate.hq[s:s + chunk][at] == 0]
        lq += torch.unique_consecutive(at // 8).numel()
    return occ, lq


def flat_kernels(card: str, full: dict) -> dict:
    """HK18 (and its grow entry), HK19 and HK20 against their plain
    versions on the card, on the first FLAT_CHECK batches of the full
    run from 2^FLAT_NB buckets: the kernels' build and the plain build
    (each with the grow-retry protocol) grow alike and hold one map;
    HK20 seals the kernels' build word for word as its plain version,
    with the same statistics; HK19 answers the table's mers and 1,048,576 random keys as
    its plain version, the mers with the map's values; the grow entry
    and its plain version each double the kernels' build to its own
    map. Maps are read off the build planes in chunks (build_map), so
    the two builds and one doubled table are all the phase holds at
    once. Times: HK18 a launch over the build's inserts (the plain
    version's the same), the others with kernel_ms/event_ms."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.ops import ctable

    STATS.reset()
    STATS.timing = True
    kb, km, kg, n_obs, _t = flat_build(full, FLAT_CHECK)
    STATS.timing = False
    launches = dict(STATS.launches)
    kms = STATS.kernel_ms()
    ins_ms = kms["flat_insert"] / launches["flat_insert"]
    kh, kv = build_map(kb, km)
    n_entries = kh.numel()
    size = km.size
    occ_sectors, lq_sectors = count_sectors(kb, km)
    res = {}

    # HK20
    kstate = ctable.finalize_build(kb, km)
    e_p, s_p = ref.flat_finalize(kb, km)
    res["finalize_equal"] = (torch.equal(kstate.entries, e_p)
                             and torch.equal(kstate.stats, s_p))
    del e_p
    fh, fv = flat_map(kstate, km)
    res["sealed_map"] = torch.equal(fh, kh) and torch.equal(fv, kv)
    del fh, fv
    fin_ms = kernel_ms(lambda: kernels.flat_finalize(kb, km),
                       "flat_finalize", 5)
    fin_plain = event_ms(lambda: ref.flat_finalize(kb, km), 2)

    # HK19: the table's mers and 1,048,576 random keys
    keys = torch.cat([ref.feistel_inverse(kh, K),
                      torch.randint(0, 1 << (2 * K), (1 << 20,),
                                    device="cuda",
                                    generator=torch.Generator("cuda")
                                    .manual_seed(SEED))])
    got = kernels.flat_lookup(kstate.entries, km, keys)
    res["lookup_equal"] = torch.equal(got, ref.flat_lookup(kstate.entries,
                                                           km, keys))
    res["lookup_values"] = torch.equal(got[:n_entries].long(), kv)
    n_buckets = torch.unique(ctable.bucket_rem(keys, km)[0]).numel()
    look_ms = kernel_ms(lambda: kernels.flat_lookup(kstate.entries, km, keys),
                        "flat_lookup", 5)
    look_plain = event_ms(lambda: ref.flat_lookup(kstate.entries, km, keys),
                          2)
    n_keys = keys.numel()
    del keys, got, kstate
    torch.cuda.empty_cache()

    # HK18's grow entry against its plain version, on the kernels' build
    nmeta = ctable.CTableMeta(K, 7, km.nb_log2 + 1)
    new = ctable.make_build_table(nmeta, "cuda")

    def clear():
        new.keytag.fill_(-1)
        new.hq.zero_()
        new.lq.zero_()

    grow_ms = kernel_ms(lambda: kernels.flat_grow(kb, km, new, nmeta),
                        "flat_grow", 3, clear)
    gh, gv = build_map(new, nmeta)
    res["grow_map"] = torch.equal(gh, kh) and torch.equal(gv, kv)
    grow_plain = event_ms(lambda: ref.flat_grow(kb, km, new, nmeta), 2,
                          clear)
    gh, gv = build_map(new, nmeta)
    res["plain_grow_map"] = torch.equal(gh, kh) and torch.equal(gv, kv)
    del new, gh, gv
    torch.cuda.empty_cache()

    # HK18 against its plain version: the plain build of the same batches
    pb, pm, pg, _n, ptimes = flat_build(full, FLAT_CHECK, plain=True)
    res["same_grows"] = kg == pg and km.nb_log2 == pm.nb_log2
    ph, pv = build_map(pb, pm)
    res["same_map"] = torch.equal(kh, ph) and torch.equal(kv, pv)
    del pb, ph, pv, kh, kv
    # bytes each function must move, from this run's data: an insert
    # (the build's last batch) reads each lane (8 B mer, 1 B qual, 1 B
    # valid) and writes its placed byte, and per distinct key reads its
    # 16-byte bucket row and reads and writes its count word; a grow
    # reads keytag (4 B a slot), the 32-byte sectors of hq and lq that
    # hold an occupied slot, and writes three words an entry (the
    # doubled table's fill, torch.full and torch.zeros, is neither the
    # kernel's nor its bound's); the seal
    # reads keytag and writes the entries (8 B a slot), and reads the hq
    # sectors that hold an occupied slot and the lq sectors that hold an
    # occupied slot without hq; a lookup reads its key and bucket row
    # and writes its value
    keys, _q, valid = flat_observations(full, FLAT_CHECK - 1)
    ins_bytes = 11 * keys.numel() + 24 * torch.unique(keys[valid]).numel()
    del keys, valid
    torch.cuda.empty_cache()
    bounds = {"insert": ins_bytes,
              "grow": 4 * size + 64 * occ_sectors + 12 * n_entries,
              "finalize": 8 * size + 32 * (occ_sectors + lq_sectors),
              "lookup": 12 * n_keys + 16 * n_buckets}
    emit({"phase": "flat_kernels", "card": card, "batches": FLAT_CHECK,
          "bound_bytes": bounds, "slots": size,
          "occupied_sectors": occ_sectors, "lq_seal_sectors": lq_sectors,
          "observations": n_obs, "entries": n_entries,
          "nb_log2": km.nb_log2, "grows": kg, "plain_grows": pg,
          "insert_launches": launches["flat_insert"],
          "insert_ms": round(ins_ms, 5),
          "insert_plain_ms": round(sum(ptimes) / len(ptimes), 5),
          "grow_ms": round(grow_ms, 5), "grow_plain_ms": round(grow_plain, 5),
          "finalize_ms": round(fin_ms, 5),
          "finalize_plain_ms": round(fin_plain, 5),
          "lookup_keys": n_keys, "lookup_ms": round(look_ms, 5),
          "lookup_plain_ms": round(look_plain, 5), **res})
    check(all(res.values()), f"flat kernels against plain: {res}")
    equal = all(res.values())
    times = {"insert": (ins_ms, sum(ptimes) / len(ptimes)),
             "grow": (grow_ms, grow_plain), "finalize": (fin_ms, fin_plain),
             "lookup": (look_ms, look_plain)}
    return {f"flat_{part}": dict(equal=equal, ms=times[part][0],
                                 plain_ms=times[part][1],
                                 bound_bytes=bounds[part])
            for part in bounds}


def phase_flat(card: str, full: dict) -> dict:
    """K25, the flat bucket-4 table: flat_kernels, then the whole cell's
    observations (every batch of the full run) through
    insert_observations and grow_build from 2^FLAT_NB buckets (it must
    grow), finalize_build and table_stats, and lookup of 1,048,576 of
    the full run's mers; launch counts reset just before and read just
    after. The sealed table's iterate_entries map must equal the full
    run's database content, and its statistics that build's."""
    import torch

    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.ops import ctable

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    check(free >= FLAT_PLAN_BYTES,
          f"flat: {free} B free on the card before the phase, and its "
          f"builds and grows need {FLAT_PLAN_BYTES} B: free memory that "
          f"earlier phases leave resident")
    kern = flat_kernels(card, full)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    STATS.reset()
    STATS.timing = True
    t0 = time.perf_counter()
    bstate, meta, grows, n_obs, _t = flat_build(full, len(full["wires"]))
    t_build = time.perf_counter() - t0
    state = ctable.finalize_build(bstate, meta)
    occ, distinct, total_hq = ctable.table_stats(state, meta)
    del bstate
    content_hash, content_val = table_content(full["db"])
    pick = torch.linspace(0, content_hash.numel() - 1, 1 << 20,
                          device="cuda").long()
    qkeys = ref.feistel_inverse(content_hash[pick], K)
    v = content_val[pick]
    got = ctable.lookup(state, meta, qkeys)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    STATS.timing = False
    launches = dict(STATS.launches)
    kms = STATS.kernel_ms()
    peak = torch.cuda.max_memory_allocated() - resident
    for name in PATH_KERNELS["flat"]:
        check(launches[name] > 0, f"{name} was not launched on the flat path")
    h, fv = flat_map(state, meta)
    want = ((content_val & 127) << 1) | (content_val >> 7)
    res = dict(grew=grows >= 1,
               same_map=torch.equal(h, content_hash) and torch.equal(fv, want),
               same_entries=occ == full["build"].distinct == h.numel(),
               lookup_values=torch.equal(got.long(),
                                         ((v & 127) << 1) | (v >> 7)))
    del state, h, fv, content_hash, content_val, want, got, qkeys
    torch.cuda.empty_cache()
    emit({"phase": "flat", "card": card, "k": K, "bits": 7,
          "nb_log2_start": FLAT_NB, "nb_log2_end": meta.nb_log2,
          "grows": grows, "slots": meta.size, "observations": n_obs,
          "entries": occ, "distinct_hq": distinct, "total_hq": total_hq,
          "build_s": round(t_build, 3), "path_s": round(seconds, 3),
          "free_before": free, "card_memory": total,
          "planned_peak": FLAT_PLAN_BYTES,
          "peak_memory": peak, "launches": launches,
          "kernel_s": {k: round(x / 1e3, 4) for k, x in kms.items() if x},
          "kernel_ms_per_launch": {k: round(x / launches[k], 5)
                                   for k, x in kms.items() if launches[k]},
          "phase_s": round(time.perf_counter() - t_phase, 3), **res})
    check(all(res.values()), f"flat against the full run: {res}")
    for name in ("flat_insert", "flat_grow", "flat_finalize", "flat_lookup"):
        kern[name]["run_ms"] = kms[name] / launches[name]
    return dict(launches=launches, kernels=kern)


# ------------------------------------------------------------- minimizer

MIN_M = 7  # bench.py's min(7, k - 1)
BIN_P = 4  # bench.py's partitions of the bin-skew figure


def phase_minimizer(card: str, full: dict) -> dict:
    """K23: HK21 against its plain version at 8192 x 150 (the full run's
    first reads, k = 24, m = 7), timed; then every read of the full
    cell through minimizer_kmers (launch counts reset just before and
    read just after), with the bin skew bench.py's ab_partitions
    prints, over the cell's valid windows at P = 4: the address bins
    (the remainder's low bits at the full run's table geometry, what
    --partitions splits by) against the minimizer bins (value mod P),
    each as max / mean."""
    import torch

    from quorum_tpu_torch import kernels
    from quorum_tpu_torch.kernels import reference as ref
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.ops import ctable, mer

    codes = full["codes"]
    c0 = codes[:BATCH].to("cuda")
    a, b = kernels.minimizer(c0, K, MIN_M), ref.minimizer(c0, K, MIN_M)
    equal = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    check(equal, "minimizer differs from its plain version")
    ms = kernel_ms(lambda: kernels.minimizer(c0, K, MIN_M), "minimizer", 5)
    plain = event_ms(lambda: ref.minimizer(c0, K, MIN_M), 3)
    del a, b
    meta = ctable.TileMeta(K, 7, ctable.tile_rb_for(full["size"], K, 7)
                           + full["grows"])
    a_counts = torch.zeros(BIN_P, dtype=torch.int64, device="cuda")
    m_counts = torch.zeros_like(a_counts)
    STATS.reset()
    STATS.timing = True
    t0 = time.perf_counter()
    for i in range(0, codes.shape[0], BATCH):
        c = codes[i:i + BATCH].to("cuda")
        mval, kvalid = mer.minimizer_kmers(c, K, MIN_M)
        f, r, valid = mer.rolling_kmers(c, K)
        check(torch.equal(kvalid, valid), "kvalid is not the k-window's "
              "validity")
        keys = mer.canonical(f, r)[valid]
        _addr, rlo, rhi = ref.tile_key_parts(keys, meta)
        abin = (rlo | (rhi << meta.rlo_bits)) & (BIN_P - 1)
        mbin = ref.u32(mval[valid]) % BIN_P
        a_counts += torch.bincount(abin, minlength=BIN_P)
        m_counts += torch.bincount(mbin, minlength=BIN_P)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    STATS.timing = False
    launches = dict(STATS.launches)
    kms = STATS.kernel_ms()
    for name in PATH_KERNELS["minimizer"]:
        check(launches[name] > 0,
              f"{name} was not launched on the minimizer path")
    ac, mc = a_counts.cpu().tolist(), m_counts.cpu().tolist()
    skew = {"addr_bin_skew": max(ac) / (sum(ac) / BIN_P),
            "minimizer_bin_skew": max(mc) / (sum(mc) / BIN_P)}
    emit({"phase": "minimizer_bins", "card": card, "k": K, "m": MIN_M,
          "partitions": BIN_P, "rb_log2": meta.rb_log2,
          "windows": sum(ac), "addr_bin_counts": ac,
          "minimizer_bin_counts": mc, **skew})
    emit({"phase": "minimizer", "card": card, "reads": codes.shape[0],
          "batch": [BATCH, READ_LEN], "ms": round(ms, 5),
          "plain_ms": round(plain, 5), "equal": equal,
          "path_s": round(seconds, 3),
          "run_ms": round(kms["minimizer"] / launches["minimizer"], 5),
          "launches": launches})
    return dict(launches=launches, kernels={"minimizer": dict(
        equal=equal, ms=ms, plain_ms=plain,
        run_ms=kms["minimizer"] / launches["minimizer"],
        bound_bytes=BATCH * READ_LEN * (1 + 4 + 1))})


# ------------------------------------------------------------- unpacked


UNPACKED_SLICE = 2048  # reads of each stage-2 comparison


def unpacked_batches(full: dict):
    """The full run's stage-1 batches unpacked, as the parser shapes
    them (8192 x 160 rows, -2 / 0 padding): (codes int8, quals uint8)."""
    codes, quals = full["codes"], full["quals"]
    for i in range(0, codes.shape[0], BATCH):
        c, q, _l, _pk = pack_batch(codes[i:i + BATCH], quals[i:i + BATCH], QT)
        yield c, q


def phase_devices_unpacked(card: str, full: dict) -> dict:
    """K24's unpacked entries on the devices mesh (four entries naming
    the host's cards): build_database_tile_sharded from the full cell's
    unpacked batches at the full run's -s, its payload byte-equal to the
    devices phase's build; correct_step (replicated) and
    correct_step_routed on 2,048-read slices of the first batches, each
    equal to correct_step_wire's result on the same reads packed; then
    dryrun(mesh, 4). Launch counts reset before the build and read
    after the dryrun. The batches are made before the build's clock
    starts; the host pack inside the build (tile_sharded._pack_unpacked)
    is timed again alone on the same batches (pack_s, its share of
    build_s), and on the first 16 batches handed over as CUDA tensors,
    whose pack copies them to the host first."""
    import numpy as np
    import torch

    from quorum_tpu_torch.io import db_format, packing
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.models.ec_config import ECConfig
    from quorum_tpu_torch.ops import ctable
    from quorum_tpu_torch.parallel import tile_sharded as ts

    t_phase = time.perf_counter()
    mesh = devices_mesh()
    meta = ts.TileShardedMeta(k=K, bits=7,
                              rb_log2=ts.initial_rb(full["size"], K, 7,
                                                    DEVICES),
                              n_shards=DEVICES)
    batches = list(unpacked_batches(full))
    STATS.reset()
    t0 = time.perf_counter()
    state, meta = ts.build_database_tile_sharded(batches, mesh, meta, QT)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    for c, q in batches:
        ts._pack_unpacked(c, q, None, QT)
    pack_s = time.perf_counter() - t1
    on_card = [(torch.from_numpy(c).cuda(), torch.from_numpy(q).cuda())
               for c, q in batches[:16]]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for c, q in on_card:
        ts._pack_unpacked(c, q, None, QT)
    pack_cuda_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    for c, q in batches[:16]:
        ts._pack_unpacked(c, q, None, QT)
    pack_host16_s = time.perf_counter() - t1
    del batches, on_card
    gstate, gmeta = ts.gather_table(state, meta)
    payload = ctable.tile_export_v4(gstate, gmeta).tobytes()
    res = dict(same_payload=payload == db_format.db_payload_bytes(
        os.path.join(WORK, "devices.jf")))
    del payload
    cfg = ECConfig(k=K, cutoff=full["cutoff"])
    rep = ts.replicate_table(gstate, mesh)
    rmeta = ts.RoutedTileMeta(k=K, bits=7, rb_log2=meta.rb_log2,
                              n_shards=DEVICES)
    keeps = ts._keeps(mesh, gmeta, cfg)
    steps = {"replicated": (ts.correct_step(mesh, gmeta, cfg), rep,
                            (rep, gmeta)),
             "routed": (ts.correct_step_routed(mesh, meta, cfg), state,
                        (ts.row_shards(state, rmeta, mesh), rmeta))}
    L = full["wires"][0][0].length
    slices = 0
    n_reads = full["codes"].shape[0]
    for i in range(0, min(2 * BATCH, n_reads - UNPACKED_SLICE + 1),
                   UNPACKED_SLICE):
        n = UNPACKED_SLICE
        c = np.full((n, L), -2, np.int8)
        q = np.zeros((n, L), np.uint8)
        c[:, :READ_LEN] = full["codes"][i:i + n].numpy()
        q[:, :READ_LEN] = full["quals"][i:i + n].numpy()
        lengths = np.full(n, READ_LEN, np.int32)
        pk = packing.pack_reads(c, q, lengths, thresholds=(cfg.qual_cutoff,))
        for tag, (step, st, (rows, m)) in steps.items():
            got = step(st, c, q, lengths)
            want = ts.correct_step_wire(mesh, rows, m, pk, cfg, keeps,
                                        [None] * DEVICES)
            same = all(torch.equal(getattr(got, f), getattr(want, f))
                       for f in ("out", "start", "end", "status", "packed"))
            res[f"{tag}_slice_{i // n}"] = same
        slices += 1
    del rep, steps, state, gstate
    t1 = time.perf_counter()
    ts.dryrun(mesh, DEVICES)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t1
    launches = dict(STATS.launches)
    for name in PATH_KERNELS["devices_unpacked"]:
        check(launches[name] > 0,
              f"{name} was not launched on the devices_unpacked path")
    emit({"phase": "devices_unpacked", "card": card, "shards": DEVICES,
          "mesh": [str(d) for d in mesh], "rb_log2": meta.rb_log2,
          "build_s": round(build_s, 3), "pack_s": round(pack_s, 3),
          "pack_share_of_build": round(pack_s / build_s, 4),
          "pack_16_batches_host_inputs_s": round(pack_host16_s, 4),
          "pack_16_batches_cuda_inputs_s": round(pack_cuda_s, 4),
          "slices": slices,
          "slice_reads": UNPACKED_SLICE, "dryrun_s": round(dry_s, 3),
          "launches": launches,
          "phase_s": round(time.perf_counter() - t_phase, 3), **res})
    check(all(res.values()), f"devices_unpacked: {res}")
    return dict(launches=launches)

# ---------------------------------------------- paired, ref_format, legacy

FRAGMENT = (400, 50)  # the paired phase's fragment length, mean and sd (bp)
REF_QUERIES = 1000  # the ref_format phase's query mers, half present


def synth_pairs(gen, genome, n_pairs: int):
    """Seeded mate pairs of `genome` (int8 codes): fragments of 400 +- 50
    bp (normal, at least READ_LEN) at random positions and strands, mate
    1 the fragment's first READ_LEN bases on its strand and mate 2 the
    reverse complement of its last READ_LEN, with the full run's error
    model (1% substitutions, ~10% low-quality bases). Returns (codes,
    quals), each [2, n_pairs, READ_LEN]: mate 1's, then mate 2's."""
    import torch

    genome_bp = genome.shape[0]
    mean, sd = FRAGMENT
    frag = (mean + sd * torch.randn(n_pairs, generator=gen)).round().long()
    frag = frag.clamp(READ_LEN, genome_bp)
    start = (torch.rand(n_pairs, generator=gen, dtype=torch.float64)
             * (genome_bp - frag + 1)).long()
    ar = torch.arange(READ_LEN)
    left = genome[start[:, None] + ar]
    right = (3 - genome[(start + frag - READ_LEN)[:, None] + ar]).flip(1)
    # a fragment of the reverse strand reads its other end first
    rev = (torch.rand(n_pairs, generator=gen) < 0.5)[:, None]
    true = torch.stack([torch.where(rev, right, left),
                        torch.where(rev, left, right)])
    del left, right
    err = torch.rand(true.shape, generator=gen) < ERR_RATE
    shift = torch.randint(1, 4, true.shape, generator=gen, dtype=torch.int8)
    codes = torch.where(err, (true + shift) % 4, true)
    quals = torch.full(true.shape, 33 + 40, dtype=torch.uint8)
    quals[torch.rand(true.shape, generator=gen) < LOW_Q_RATE] = 33 + 2
    return codes, quals


def phase_paired(card: str, full: dict) -> dict:
    """The driver's paired mode at full width: mate pairs of the full
    run's genome, as many reads as the full run (two FASTQ files), through
    `quorum -P`, then through `quorum -d` (unpaired, --no-discard) on the
    same two files. Each read is corrected alone against the same table,
    so the two runs' payloads are equal, <prefix>_1.fa is byte for byte
    the unpaired .fa's records of file 1, in order, <prefix>_2.fa those
    of file 2, and the .log lines are the same. Launch counts reset
    before each run and read after it."""
    import torch

    from quorum_tpu_torch.cli import quorum
    from quorum_tpu_torch.io import db_format
    from quorum_tpu_torch.kernels.loader import STATS

    gen = torch.Generator().manual_seed(SEED + 15)
    n = full["codes"].shape[0] // 2
    t0 = time.perf_counter()
    codes, quals = synth_pairs(gen, full["genome"], n)
    mates = [os.path.join(WORK, f"mates_{m}.fastq") for m in (1, 2)]
    for m in (0, 1):
        write_fastq(mates[m], codes[m], quals[m], b"/%d" % (m + 1))
    del codes, quals
    gen_s = time.perf_counter() - t0
    bases = 2 * n * READ_LEN
    runs, launches = {}, {}
    for tag, flag in (("paired", "-P"), ("unpaired", "-d")):
        prefix = os.path.join(WORK, tag)
        report: dict = {}
        STATS.reset()
        rc = quorum.main(["-s", str(full["size"]), "-k", str(K), "-p", prefix,
                          flag, "--device", "cuda", *mates], report=report)
        launches[tag] = dict(STATS.launches)
        check(rc == 0, f"{tag} driver rc {rc}")
        for name in PATH_KERNELS["paired"]:
            check(launches[tag][name] > 0,
                  f"{name} was not launched on the {tag} run")
        runs[tag] = (prefix, report)
    (pp, rp), (up, ru) = runs["paired"], runs["unpaired"]
    same_payload = (db_format.db_payload_bytes(pp + "_mer_database.jf")
                    == db_format.db_payload_bytes(up + "_mer_database.jf"))
    with open(up + ".fa", "rb") as f:
        whole = f.read()
    with open(pp + "_1.fa", "rb") as f:
        one = f.read()
    with open(pp + "_2.fa", "rb") as f:
        two = f.read()
    same_1, same_2 = whole[:len(one)] == one, whole[len(one):] == two
    records = [one.count(b"\n") // 2, two.count(b"\n") // 2]
    del whole, one, two
    logs = []
    for prefix in (pp, up):
        with open(prefix + ".log", "rb") as f:
            logs.append(sorted(f.read().split(b"\n")))
    same_log = logs[0] == logs[1]
    del logs

    def times(report):
        s1, s2 = report["stage1_s"], report["stage2_s"]
        return {"stage1_s": round(s1, 3), "stage2_s": round(s2, 3),
                "stage1_parse_pack_s": round(report["stage1_host_s"], 3),
                "stage2_parse_pack_s": round(report["ec"].parse_pack_s, 3),
                "render_s": round(report["ec"].render_s, 3),
                "gbases_per_hour": round(bases / (s1 + s2) * 3600 / 1e9, 4),
                "corrected": report["ec"].corrected,
                "skipped": report["ec"].skipped}

    emit({"phase": "paired", "card": card, "pairs": n, "bases": bases,
          "fragment_mean_sd": list(FRAGMENT), "fastq_gen_s": round(gen_s, 3),
          "paired": times(rp), "unpaired_d": times(ru),
          "records_1_2": records, "same_payload": same_payload,
          "mate1_eq_file1_records": same_1, "mate2_eq_file2_records": same_2,
          "same_log_lines": same_log, "launches": launches["paired"],
          "launches_unpaired": launches["unpaired"]})
    check(records == [n, n], f"paired records {records}, not {n} a file")
    check(same_payload, "the paired run's payload differs from the "
                        "unpaired run's")
    check(same_1 and same_2, "a mate file differs from the unpaired "
                             "run's records of its input file")
    check(same_log, "the paired run's .log lines differ from the "
                    "unpaired run's")
    for path in (pp + "_1.fa", pp + "_2.fa", up + ".fa") + tuple(mates):
        os.remove(path)
    return launches


def _cli_stdout(main, argv):
    """(rc, stdout) of an in-process CLI run."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def phase_ref_format(card: str, full: dict) -> dict:
    """The reference's binary/quorum_db at the full run's reads: stage 1
    with --ref-format on the card (the sealed table's entries iterated
    and written on the host, each timed); histo_mer_database of that file
    and of the full run's v5 database (lines and --json document equal);
    query_mer_database of 1,000 seeded mers, half of them genome mers, on
    both (lines equal, every genome mer found); the v5 file's bins and
    query answers on the card equal to the host's (numpy over the rows
    brought back: the bins by np.bincount, the mers by db_lookup_np);
    stage 2 on the card from each file at the full run's cutoff given
    with -p (.fa/.log equal; the v5 file's in a process of its own
    (stage2_run), started at the phase's start beside stage 1). Launch
    counts reset before stage 1 and read after it, reset before the
    first inspection CLI and read after the last (the `inspect` path),
    and reset before the reference file's stage 2 and read after it;
    `ref_format` is stage 1's and both stage 2s'."""
    import numpy as np
    import torch

    from quorum_tpu_torch.cli import create_database as cdb
    from quorum_tpu_torch.cli import error_correct_reads as ec
    from quorum_tpu_torch.cli import histo_mer_database as histo
    from quorum_tpu_torch.cli import query_mer_database as query
    from quorum_tpu_torch.io import db_format, quorum_db
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.ops import ctable, mer

    ref = os.path.join(WORK, "ref_format.jf")
    v5_out = os.path.join(WORK, "ref_s2_v5")
    v5_stage2 = child_start("stage2_run", [
        "-p", str(full["cutoff"]), "--device", "cuda", "-o", v5_out,
        full["db"], full["fastq"]])
    spent: dict = {}
    originals = (quorum_db.write_ref_db, ctable.tile_iterate)

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] = round(time.perf_counter() - t, 3)
        return run

    quorum_db.write_ref_db = timed("write_s", originals[0])
    ctable.tile_iterate = timed("iterate_s", originals[1])
    STATS.reset()
    try:
        t0 = time.perf_counter()
        rc = cdb.main(["-s", str(full["size"]), "-m", str(K), "-q", str(QT),
                       "-b", "7", "--ref-format", "-o", ref, "--device",
                       "cuda", full["fastq"]])
        spent["stage1_s"] = round(time.perf_counter() - t0, 3)
    finally:
        quorum_db.write_ref_db, ctable.tile_iterate = originals
    stage1 = dict(STATS.launches)
    check(rc == 0, f"--ref-format stage 1 rc {rc}")
    rng = np.random.default_rng(SEED)
    genome = full["genome"].numpy()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    present = [acgt[genome[a:a + K]].tobytes().decode()
               for a in rng.integers(0, GENOME_BP - K + 1, REF_QUERIES // 2)]
    absent = ["".join("ACGT"[c] for c in rng.integers(0, 4, K))
              for _ in range(REF_QUERIES - len(present))]
    files = (("ref", ref), ("v5", full["db"]))
    out: dict = {tag: {} for tag, _db in files}
    STATS.reset()
    for tag, db in files:
        js = os.path.join(WORK, f"histo_{tag}.json")
        t0 = time.perf_counter()
        rc1, text = _cli_stdout(histo.main, ["--device", "cuda", "--json",
                                             js, db])
        t1 = time.perf_counter()
        rc2, lines = _cli_stdout(query.main, ["--device", "cuda", db]
                                 + present + absent)
        t2 = time.perf_counter()
        check(rc1 == 0 and rc2 == 0, f"inspection CLIs on {tag}: rc "
                                     f"{rc1}, {rc2}")
        with open(js) as f:
            doc = json.load(f)
        out[tag].update(histo=text, doc=doc, query=lines,
                        histo_s=round(t1 - t0, 3), query_s=round(t2 - t1, 3))
    inspect = dict(STATS.launches)
    for name in PATH_KERNELS["inspect"]:
        check(inspect[name] > 0, f"{name} was not launched on the inspect "
                                 "path")
    # the card's bins and answers against numpy on the rows brought back
    state, meta, _h, _st = db_format.load_db(full["db"], device="cuda")
    rows = ctable.host_rows(state.rows)
    lo = rows[:, 0::2].astype(np.int64)
    count = lo & meta.max_val
    v = count[count != 0]
    bins = np.bincount(np.minimum(v, histo.HLEN - 1) * 2
                       + ((lo[count != 0] >> meta.bits) & 1),
                       minlength=2 * histo.HLEN).reshape(histo.HLEN, 2)
    del lo, count, v
    keys = [(chi << 32) | clo for chi, clo in
            (mer.canonical_py(*mer.pack_kmer(s), K) for s in present + absent)]
    host = ctable.TileState(torch.from_numpy(rows.view(np.int32)))
    same_card_host = {
        "histo": np.array_equal(
            histo.histo(ctable.slot_values(state.rows, meta)), bins),
        "query": (query.lookup_values(state, meta, keys)
                  == query.lookup_values(host, meta, keys))}
    del state, host, rows
    STATS.reset()
    o = os.path.join(WORK, "ref_s2_ref")
    t0 = time.perf_counter()
    rc3 = ec.main(["-p", str(full["cutoff"]), "--device", "cuda", "-o", o,
                   ref, full["fastq"]])
    check(rc3 == 0, f"stage 2 on the ref file rc {rc3}")
    out["ref"].update(out=o, stage2_s=round(time.perf_counter() - t0, 3))
    v5 = child_join(v5_stage2, "stage 2 on the v5 file")
    check(v5["rc"] == 0, f"stage 2 on the v5 file rc {v5['rc']}")
    out["v5"].update(out=v5_out, stage2_s=v5["seconds"])
    launches = {name: n + stage1.get(name, 0) + v5["launches"][name]
                for name, n in STATS.launches.items()}
    for name in PATH_KERNELS["ref_format"]:
        check(launches[name] > 0, f"{name} was not launched on the "
                                  "ref_format path")
    found = sum(" val:0 " not in ln for ln in
                out["v5"]["query"].splitlines()[1:1 + len(present)])
    res = {"same_histo": out["ref"]["histo"] == out["v5"]["histo"],
           "same_histo_json": out["ref"]["doc"] == out["v5"]["doc"],
           "same_query": out["ref"]["query"] == out["v5"]["query"],
           "same_stage2_fa_log": same_fa_log(out["ref"]["out"],
                                             out["v5"]["out"]),
           **{f"card_{k}_eq_host": v for k, v in same_card_host.items()}}
    emit({"phase": "ref_format", "card": card, **spent,
          "file_bytes": os.path.getsize(ref),
          "v5_file_bytes": os.path.getsize(full["db"]),
          "entries": out["v5"]["doc"]["stats"]["distinct_total"],
          "cutoff": full["cutoff"], "genome_mers_found": found,
          "queries": REF_QUERIES,
          **{f"{tag}_{k}": v[k] for tag, v in out.items()
             for k in ("histo_s", "query_s", "stage2_s")},
          "v5_stage2_ran_beside": "stage1", **res, "launches": launches,
          "launches_inspect": inspect})
    check(all(res.values()), f"ref_format mismatch: {res}")
    check(found == len(present), f"{found} of {len(present)} genome mers "
                                 "found")
    check(out["v5"]["doc"]["stats"]["distinct_total"]
          == full["build"].distinct, "the histogram's entries differ from "
                                     "the full run's")
    os.remove(ref)
    return {"ref_format": launches, "inspect": inspect}


def stage2_run(argv: list) -> dict:
    """quorum_error_correct_reads on `argv` (in a process of its own),
    launch counts reset just before: its rc, seconds and launches."""
    from quorum_tpu_torch.cli import error_correct_reads as ec
    from quorum_tpu_torch.kernels.loader import STATS

    STATS.reset()
    t0 = time.perf_counter()
    rc = ec.main(argv)
    return {"rc": rc, "seconds": round(time.perf_counter() - t0, 3),
            "launches": dict(STATS.launches)}


def legacy_files(d: str, v5: str) -> dict:
    """Version 1, 2 and 3 files of the table in `v5`, as
    tests/test_ref_format.py builds them for the JAX reader: v1 the wide
    keys with empty slots between, v2 the raw row plane, v3 (address, lo,
    hi) triplets in a seeded shuffled order."""
    import numpy as np

    from quorum_tpu_torch.io import db_format
    from quorum_tpu_torch.ops import ctable

    state, meta, _h, _st = db_format.load_db(v5, device="cpu")
    rows = np.ascontiguousarray(ctable.host_rows(state.rows))
    base = {"format": db_format.FORMAT, "key_len": 2 * meta.k,
            "bits": meta.bits}
    rng = np.random.default_rng(SEED)
    paths = {}

    def write(name, header, *planes):
        paths[name] = os.path.join(d, f"legacy_{name}.qdb")
        with open(paths[name], "wb") as f:
            f.write((json.dumps(header) + "\n").encode())
            for plane in planes:
                f.write(np.ascontiguousarray(plane).tobytes())

    khi, klo, vals = ctable.tile_iterate(state, meta)
    size = len(vals) + 37
    at = np.sort(rng.choice(size, len(vals), replace=False))
    wide = np.zeros((3, size), np.uint32)
    wide[0, at], wide[1, at], wide[2, at] = khi, klo, vals
    write("v1", dict(base, version=1, size=size), *wide)
    write("v2", dict(base, version=2, rb_log2=meta.rb_log2, rows=meta.rows),
          rows)
    lo = rows[:, 0::2]
    r, s = np.nonzero(lo & np.uint32(meta.max_val))
    order = rng.permutation(len(r))
    write("v3", dict(base, version=3, rb_log2=meta.rb_log2, rows=meta.rows,
                     n_entries=len(r)),
          r[order].astype(np.int32), lo[r, s][order],
          rows[:, 1::2][r, s][order])
    return paths


def phase_legacy(card: str) -> dict:
    """Stage 2 on v1, v2 and v3 files of the golden table (legacy_files)
    and on the golden v5 file, with --device cuda (HK7 places each) and
    with --device cpu, all at -p 4: every run's .fa/.log equal, and equal
    to tests/golden/expected.fa/.log. Launch counts reset before the
    runs and read after."""
    from quorum_tpu_torch.cli import error_correct_reads as ec
    from quorum_tpu_torch.kernels.loader import STATS

    d = os.path.join(WORK, "golden")
    v5 = os.path.join(d, "db.jf")
    reads = os.path.join(GOLDEN, "reads.fastq")
    files = {"v5": v5, **legacy_files(d, v5)}
    STATS.reset()
    outs = {}
    for name, path in files.items():
        for dev in ("cuda", "cpu"):
            o = os.path.join(d, f"legacy_{name}_{dev}")
            check(ec.main(["-p", "4", "--batch-size", "256", "--device", dev,
                           "-o", o, path, reads]) == 0,
                  f"stage 2 on the {name} file ({dev})")
            outs[f"{name}_{dev}"] = o
    launches = dict(STATS.launches)
    res = {tag: same_fa_log(o, os.path.join(GOLDEN, "expected"))
           for tag, o in outs.items()}
    emit({"phase": "legacy", "card": card, "equal_to_golden": res,
          "launches": launches})
    check(all(res.values()), f"legacy stage 2 differs: {res}")
    for name in PATH_KERNELS["legacy"]:
        check(launches[name] > 0, f"{name} was not launched on the legacy "
                                  "path")
    return launches


# the serve phase: quorum-serve of the port on full's v5 file
SERVE_ROWS = 1024  # --max-batch
SERVE_PARITY_READS = 65_536  # full's first reads, served and held to .fa
SERVE_CLIENTS = 8  # closed-loop clients of the parity and mixed parts
SERVE_MIXED = (2048, 40, 300)  # mixed-length reads: count, shortest, longest
SERVE_MIXED_REQ = 64  # reads a mixed-length request
SERVE_WARM = (64, 128, 160, 192, 256, 384)  # every bucket the phase sends
SERVE_STEP_TIMEOUT_MS = 3000  # the watchdog's budget in the phase
SERVE_LOAD = ((8, 256, 512), (1, 1, 256))  # bench -c, -r, -n
FASTQ_REC = 12 + READ_LEN + 3 + READ_LEN + 1  # bytes of one full record


def mixed_reads(genome, path: str):
    """SERVE_MIXED[0] reads of SERVE_MIXED[1]-[2] bp (seeded) from the
    genome, either strand, 1% substitutions, ~10% low-quality bases, as
    FASTQ named m<6 digits>. Returns their lengths."""
    import torch

    n, lo, hi = SERVE_MIXED
    gen = torch.Generator().manual_seed(SEED + 18)
    lens = torch.randint(lo, hi + 1, (n,), generator=gen)
    acgt = b"ACGT"
    with open(path, "wb") as f:
        for i, ln in enumerate(lens.tolist()):
            s = int(torch.randint(0, genome.shape[0] - ln + 1, (1,),
                                  generator=gen))
            true = genome[s:s + ln]
            if bool(torch.rand(1, generator=gen) < 0.5):
                true = (3 - true).flip(0)
            err = torch.rand(ln, generator=gen) < ERR_RATE
            shift = torch.randint(1, 4, (ln,), generator=gen,
                                  dtype=torch.int8)
            codes = torch.where(err, (true + shift) % 4, true)
            low = torch.rand(ln, generator=gen) < LOW_Q_RATE
            qual = bytes(33 + 2 if q else 33 + 40 for q in low.tolist())
            seq = bytes(acgt[c] for c in codes.tolist())
            f.write(b"@m%06d\n%s\n+\n%s\n" % (i, seq, qual))
    return lens.tolist()


def mixed_outputs(prefix: str):
    """A stage-2 run's records of the mixed reads by index (m<6 digits>):
    {i: .fa record with its newline}, {i: .log line with its newline}."""
    with open(prefix + ".fa", "rb") as f:
        lines = f.read().split(b"\n")
    fa = {int(h[2:8]): h + b"\n" + q + b"\n"
          for h, q in zip(lines[0::2], lines[1::2]) if h}
    with open(prefix + ".log", "rb") as f:
        log = {int(ln[9:15]): ln + b"\n" for ln in f.read().split(b"\n")
               if ln}
    return fa, log


def closed_loop(port: int, jobs: list, n_clients: int, check_fn) -> dict:
    """`jobs` (body bytes, want_log, tag) posted by `n_clients` closed-loop
    clients; `check_fn(tag, result)` returns an error string or None.
    Returns {"requests", "errors": [first few], "statuses"}."""
    import threading

    from quorum_tpu_torch.serve.client import ServeClient

    nxt = [0]
    lock = threading.Lock()
    errors: list = []
    statuses: dict = {}

    def worker():
        client = ServeClient(port=port, timeout=300)
        while True:
            with lock:
                if nxt[0] >= len(jobs) or len(errors) > 8:
                    return
                body, want_log, tag = jobs[nxt[0]]
                nxt[0] += 1
            try:
                r = client.correct(body, want_log=want_log)
            except OSError as e:
                with lock:
                    errors.append(f"{tag}: {e!r}")
                continue
            err = (f"{tag}: status {r.status} {r.error}" if r.status != 200
                   else check_fn(tag, r))
            with lock:
                statuses[r.status] = statuses.get(r.status, 0) + 1
                if err:
                    errors.append(err)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"requests": len(jobs), "errors": errors[:4],
            "statuses": statuses}


def hist_median(before: dict, after: dict):
    """Median of the values an exact-count histogram took between two
    snapshots of its counts ({value: n})."""
    delta = sorted((int(v), n - before.get(v, 0)) for v, n in after.items()
                   if n - before.get(v, 0) > 0)
    total = sum(n for _v, n in delta)
    if not total:
        return None
    seen = 0
    for v, n in delta:
        seen += n
        if 2 * seen >= total:
            return v
    return None


# quorum-serve-bench in a process of its own, started at the serve
# phase's start (its imports overlap the parity part): one bench_main
# argv a line on stdin, its metric lines then {"rc": N} on stdout
SERVE_BENCH = """
import json, sys
from quorum_tpu_torch.serve.client import bench_main
for line in sys.stdin:
    rc = bench_main(json.loads(line))
    print(json.dumps({"rc": rc}), flush=True)
"""


def serve_bench(bench, port: int, fastq: str, conc: int, reads: int, n: int,
                reg, spans: str) -> dict:
    """quorum-serve-bench (the port's bench_main, in the client process
    `bench`: SERVE_BENCH) at -c conc -r reads -n n under DeviceBusy: its
    metric lines, the card's busy share, the medians of
    serve_dispatch_us / serve_wait_us and of the serve_render span over
    the run, the request parse's median on these bodies, and the peak
    device memory."""
    import torch

    from quorum_tpu_torch.serve.server import parse_fastq_text

    def counts(name):
        return dict(reg.histogram(name).counts)

    before = {h: counts(h) for h in ("serve_dispatch_us", "serve_wait_us")}
    with open(spans) as f:
        span0 = sum(1 for _ in f)
    torch.cuda.reset_peak_memory_stats()
    lines: dict = {}
    with DeviceBusy() as busy:
        bench.stdin.write(json.dumps(["--port", str(port), "-c", str(conc),
                                      "-r", str(reads), "-n", str(n),
                                      fastq]) + "\n")
        bench.stdin.flush()
        while True:
            ln = bench.stdout.readline()
            check(ln, f"quorum-serve-bench -c {conc} -r {reads} ended "
                      f"(rc {bench.poll()})")
            o = json.loads(ln)
            if "rc" in o:
                break
            lines[o["metric"]] = o
    check(o["rc"] == 0, f"quorum-serve-bench -c {conc} -r {reads} rc "
                        f"{o['rc']}")
    b = lines["serve_bench"]
    check(b["ok"] == n and b["reads"] == n * reads,
          f"bench -c {conc} -r {reads}: {b}")
    with open(spans) as f:
        renders = sorted(o["dur"] for o in
                         (json.loads(ln) for ln in list(f)[span0:])
                         if o["span"] == "serve_render")
    with open(fastq, "rb") as f:
        body = f.read(reads * FASTQ_REC)
    parse = []
    for _ in range(15):
        t0 = time.perf_counter()
        parse_fastq_text(body)
        parse.append(time.perf_counter() - t0)
    return {"concurrency": conc, "reads_per_request": reads,
            "requests": n, "client": "a process of its own",
            "latency_ms": [b["latency_p50_ms"], b["latency_p90_ms"],
                           b["latency_p99_ms"]],
            "reads_per_s": b["reads_per_s"],
            "served_gbases_per_hour": round(
                b["reads_per_s"] * READ_LEN * 3600 / 1e9, 4),
            "wall_s": b["wall_s"],
            # the share of the bench's own window (the profiled window
            # also holds the bench's parse of its input, with no traffic)
            "busy_s": round(busy.busy_s, 4), "profiled_s": round(
                busy.wall_s, 4),
            "busy_share": round(busy.busy_s / b["wall_s"], 4),
            "serve_dispatch_us_median": hist_median(
                before["serve_dispatch_us"], counts("serve_dispatch_us")),
            "serve_wait_us_median": hist_median(
                before["serve_wait_us"], counts("serve_wait_us")),
            "serve_render_ms_median": (round(renders[len(renders) // 2]
                                             * 1e3, 3) if renders else None),
            "steps": len(renders),
            "parse_ms_median_request": round(sorted(parse)[7] * 1e3, 3),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "phases": lines.get("serve_bench_phases")}


def phase_serve(card: str, full: dict) -> dict:
    """quorum-serve of the port, booted in-process through cli/serve.main
    (--device cuda, the quorum driver's stage-2 correction flags: none,
    so the cutoff resolves from the file as the driver's does; --max-batch
    1024, --warmup-lengths over every bucket sent, --step-timeout-ms,
    --verify-db sample so boots, rebuilds and reloads digest the header,
    the bucket index and a 16th of the entry chunks, --metrics and
    --trace-spans) on full's v5 file, then: (1) full's first 65,536
    reads from 8 closed-loop clients in seeded requests of 1-512 reads,
    every 200 byte-equal to full's .fa records (one request in 8 with
    ?log=1, its log equal to full's .log lines); (2) 2,048 seeded reads
    of 40-300 bp from full's genome in 64-read requests (every batch
    crosses buckets 64 to 384), byte-equal to quorum_error_correct_reads
    --device cpu on the same reads and file (a subprocess, started at
    the phase's start; the answers held to it after the drain); (3)
    engine_compiles after the warmup equal to its value after that
    traffic and the load; (4) quorum-serve-bench
    at -c 8 -r 256 -n 512 and -c 1 -r 1 -n 256, in a client process of
    its own started at the phase's start (latency, reads/s, the card's
    busy share, dispatch/wait medians, the render span and the request
    parse apart, peak memory); (5) a hang fault at
    serve.engine.step under the watchdog (500, engine_restarts_total 1,
    the next request 200 and byte-equal; the peak device memory of the
    rebuild, two tables), POST /reload to a copy of the file (generation
    2, byte-equal) and to a copy with a bucket-index byte flipped (400,
    rolled back, reload_failures_total 1, the old engine byte-equal);
    (6) /metrics lint-clean, /healthz 200, POST /quiesce drains and the
    final document is a serve document missing no name; (7) every engine
    the server built (boot, rebuild, reload) warmed on the representative
    read with no fallback to all-A, the read equal to the same walk over
    the boot table's rows brought back to the host. Launch counts are
    reset before the boot and read after the drain (before (7)'s host
    walk)."""
    import socket
    import threading

    import torch

    from quorum_tpu_torch import serve as serve_pkg
    from quorum_tpu_torch.cli import serve as serve_cli
    from quorum_tpu_torch.io import fastq
    from quorum_tpu_torch.kernels.loader import STATS
    from quorum_tpu_torch.serve.client import ServeClient
    from quorum_tpu_torch.telemetry import contract
    from quorum_tpu_torch.telemetry import export as export_mod
    from quorum_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "serve")
    os.makedirs(d, exist_ok=True)
    gen = torch.Generator().manual_seed(SEED + 180)
    # (2)'s reference first, on the host beside everything else
    mixed = os.path.join(d, "mixed.fastq")
    lens = mixed_reads(full["genome"], mixed)
    cpu_ref = subprocess.Popen(
        [sys.executable, "-m", "quorum_tpu_torch.cli.error_correct_reads",
         "--device", "cpu", "--verify-db", "sample", "--batch-size",
         str(SERVE_MIXED[0]), "-o",
         os.path.join(d, "mixed_cpu"), full["db"], mixed],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="4"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    # the load's client process (SERVE_BENCH), starting meanwhile
    bench_err = open(os.path.join(d, "bench.err"), "w")
    bench = subprocess.Popen(
        [sys.executable, "-c", SERVE_BENCH], cwd=ROOT,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=bench_err,
        text=True)
    # every engine the server builds (boot, the watchdog's rebuild, the
    # reload), for the check of its warmup read
    engines: list = []
    engine_cls = serve_pkg.CorrectionEngine

    class Recorded(engine_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    serve_pkg.CorrectionEngine = Recorded
    metrics = os.path.join(d, "serve.json")
    spans = os.path.join(d, "spans.jsonl")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["--device", "cuda", "--port", str(port), "--max-batch",
            str(SERVE_ROWS), "--warmup-lengths",
            ",".join(map(str, SERVE_WARM)), "--step-timeout-ms",
            str(SERVE_STEP_TIMEOUT_MS), "--verify-db", "sample",
            "--metrics", metrics, "--trace-spans", spans, full["db"]]
    box: dict = {}
    STATS.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    server = threading.Thread(
        target=lambda: box.setdefault("rc", serve_cli.main(argv)),
        name="serve-phase", daemon=True)
    server.start()
    client = ServeClient(port=port, timeout=300)
    res: dict = {}
    try:
        while True:
            try:
                h0 = client.healthz()
                break
            except OSError:
                check(server.is_alive() and time.perf_counter() - t0 < 300,
                      f"quorum-serve did not come up (rc {box.get('rc')})")
                time.sleep(0.05)
        res["boot_s"] = round(time.perf_counter() - t0, 3)
        reg = next(r for r in export_mod.live_registries()
                   if r.meta.get("stage") == "serve")
        compiles0 = reg.counter("engine_compiles").value
        check(compiles0 == len(SERVE_WARM) == h0["engine_compiles"],
              f"warmup saw {compiles0} shapes, want {len(SERVE_WARM)}")
        res["boot_memory_allocated"] = torch.cuda.max_memory_allocated() \
            - resident

        # (1) parity with full's own output
        fa, log, _s = read_outputs(full["prefix"])
        with open(full["fastq"], "rb") as f:
            raw = f.read(SERVE_PARITY_READS * FASTQ_REC)
        sizes = torch.randint(1, 513, (SERVE_PARITY_READS,),
                              generator=gen).tolist()
        jobs, a = [], 0
        for size in sizes:
            if a >= SERVE_PARITY_READS:
                break
            b = min(a + size, SERVE_PARITY_READS)
            want_log = len(jobs) % 8 == 7
            jobs.append((raw[a * FASTQ_REC:b * FASTQ_REC], want_log,
                         (a, b, want_log)))
            a = b

        def expect(a, b):
            return (b"".join(fa[i] + b"\n" for i in range(a, b) if i in fa),
                    b"".join(log[i] + b"\n" for i in range(a, b)
                             if i in log))

        def parity(tag, r):
            a, b, want_log = tag
            want_fa, want_lg = expect(a, b)
            if r.reads != b - a or r.fa.encode() != want_fa:
                return f"reads {a}-{b}: .fa records differ"
            if want_log and r.log.encode() != want_lg:
                return f"reads {a}-{b}: .log lines differ"
            return None

        t1 = time.perf_counter()
        p = closed_loop(port, jobs, SERVE_CLIENTS, parity)
        p.update(reads=SERVE_PARITY_READS, s=round(time.perf_counter() - t1,
                                                   3),
                 log_requests=sum(1 for j in jobs if j[1]))
        res["parity"] = p
        check(not p["errors"] and p["statuses"] == {200: len(jobs)},
              f"serve parity with full: {p['errors']} {p['statuses']}")
        del raw

        # (2) mixed lengths, served now and held to the CPU's plain
        # versions after the drain (the reference runs meanwhile)
        with open(mixed, "rb") as f:
            recs = f.read().split(b"\n")
        n_mix = SERVE_MIXED[0]
        bodies = [b"\n".join(recs[4 * i:4 * i + 4]) + b"\n"
                  for i in range(n_mix)]
        mjobs = [(b"".join(bodies[i:i + SERVE_MIXED_REQ]), True,
                  (i, min(i + SERVE_MIXED_REQ, n_mix)))
                 for i in range(0, n_mix, SERVE_MIXED_REQ)]
        served: dict = {}

        def keep(tag, r):
            served[tag] = (r.fa.encode(), r.log.encode())
            return None

        m = closed_loop(port, mjobs, SERVE_CLIENTS, keep)
        m.update(reads=n_mix, lengths=[min(lens), max(lens)],
                 request_buckets=sorted({fastq.bucket_for(max(lens[a:b]))
                                         for _x, _y, (a, b) in mjobs}))
        res["mixed"] = m
        check(not m["errors"] and m["statuses"] == {200: len(mjobs)},
              f"mixed lengths: {m['errors']} {m['statuses']}")

        # (4) load, closed loop
        load_fq = os.path.join(d, "load.fastq")
        with open(full["fastq"], "rb") as f, open(load_fq, "wb") as g:
            g.write(f.read(max(r * n for _c, r, n in SERVE_LOAD)
                           * FASTQ_REC))
        res["load"] = [serve_bench(bench, port, load_fq, c, r, n, reg,
                                   spans) for c, r, n in SERVE_LOAD]
        bench.stdin.close()
        check(bench.wait(timeout=60) == 0, "the bench's client process "
                                           f"rc {bench.returncode}")

        # (3) warm means warm: no new shape past the warmup
        res["engine_compiles"] = [compiles0,
                                  reg.counter("engine_compiles").value,
                                  client.healthz()["engine_compiles"]]
        check(len(set(res["engine_compiles"])) == 1,
              f"engine_compiles moved: {res['engine_compiles']}")

        # (5) resilience on the card, on one request of (1)
        probe = jobs[3]
        want_probe = expect(*probe[2][:2])[0]
        del fa, log

        def same(r):
            return r.status == 200 and r.fa.encode() == want_probe

        torch.cuda.reset_peak_memory_stats()
        faults.install(faults.FaultPlan.parse(
            {"site": "serve.engine.step", "action": "hang"}), "serve-hang")
        t1 = time.perf_counter()
        hung = client.correct(probe[0])
        hang_s = time.perf_counter() - t1
        faults.reset()  # releases the abandoned step
        restarts = reg.counter("engine_restarts_total").value
        after = client.correct(probe[0])
        torch.cuda.synchronize()
        res["watchdog"] = {
            "status": hung.status, "error": hung.error[:80],
            "answer_s": round(hang_s, 3), "restarts": restarts,
            "timeouts": reg.counter("engine_step_timeouts").value,
            "next_status": after.status, "next_equal": same(after),
            "rebuild_peak_memory_allocated":
                torch.cuda.max_memory_allocated() - resident,
            "generation": client.healthz()["engine_generation"]}
        check(hung.status == 500 and restarts == 1 and same(after),
              f"watchdog on the card: {res['watchdog']}")
        copy = os.path.join(d, "copy.jf")
        shutil.copyfile(full["db"], copy)
        t1 = time.perf_counter()
        code, doc = client.reload({"db": copy})
        reload_s = time.perf_counter() - t1
        swapped = client.correct(probe[0])
        bad = os.path.join(d, "flipped.jf")
        shutil.copyfile(full["db"], bad)
        with open(bad, "r+b") as f:
            off = len(f.readline()) + 100  # inside the bucket index
            f.seek(off)
            byte = f.read(1)
            f.seek(off)
            f.write(bytes([byte[0] ^ 0xFF]))
        bcode, bdoc = client.reload({"db": bad})
        kept = client.correct(probe[0])
        res["reload"] = {
            "status": code, "generation": doc.get("generation"),
            "s": round(reload_s, 3), "equal_after": same(swapped),
            "flipped_status": bcode, "rolled_back": bdoc.get("rolled_back"),
            "flipped_error": str(bdoc.get("error"))[:100],
            "failures": reg.counter("reload_failures_total").value,
            "kept_equal": same(kept),
            "generation_after": client.healthz()["engine_generation"]}
        r = res["reload"]
        check(code == 200 and r["generation"] == 2 and r["equal_after"]
              and bcode == 400 and r["rolled_back"] and r["failures"] == 1
              and r["kept_equal"] and r["generation_after"] == 2,
              f"reload on the card: {r}")
        os.unlink(copy)
        os.unlink(bad)

        # (6) exposition and drain
        text = client.metrics_text()
        lint = export_mod.lint_prometheus_text(text)
        hcode, _h = client.healthz_full()
        check(not lint and hcode == 200, f"/metrics lint {lint[:3]}, "
              f"/healthz {hcode}")
        check(client.quiesce()["status"] == "draining", "/quiesce")
        server.join(timeout=120)
        check(not server.is_alive() and box.get("rc") == 0,
              f"quorum-serve drain rc {box.get('rc')}")
        with open(metrics) as f:
            final = json.load(f)
        missing = contract.missing_names(final)
        check(final["meta"]["stage"] == "serve" and not missing
              and final["meta"].get("drained") is True,
              f"final serve document: stage {final['meta'].get('stage')},"
              f" missing {missing[:4]}")

        # (2) the mixed reads' answers against the CPU's plain versions
        t1 = time.perf_counter()
        rc = cpu_ref.wait(timeout=900)
        res["cpu_reference_s"] = round(time.perf_counter() - t_phase, 3)
        res["cpu_reference_waited_s"] = round(time.perf_counter() - t1, 3)
        check(rc == 0, "the --device cpu reference run failed: "
              + cpu_ref.stderr.read().decode()[-800:])
        cfa, clog = mixed_outputs(os.path.join(d, "mixed_cpu"))
        differ = [f"mixed reads {a}-{b}" for (a, b), (got_fa, got_log)
                  in sorted(served.items())
                  if got_fa != b"".join(cfa.get(i, b"") for i in range(a, b))
                  or got_log != b"".join(clog.get(i, b"")
                                         for i in range(a, b))]
        m.update(cpu_corrected=len(cfa), cpu_skipped=len(clog),
                 differing=differ[:4])
        check(len(served) == len(mjobs) and not differ,
              f"mixed lengths against the CPU: {len(served)} answers, "
              f"{differ[:4]} differ")
    finally:
        faults.reset()
        serve_pkg.CorrectionEngine = engine_cls
        if bench.poll() is None:
            bench.kill()
            bench.wait()
        bench_err.close()
        if server.is_alive():
            try:
                client.quiesce()
            except OSError:
                pass
            server.join(timeout=60)
        if cpu_ref.poll() is None:
            cpu_ref.kill()
            cpu_ref.wait()
    launches = dict(STATS.launches)
    # each engine's warmup walked the table on the card (HK3 counted its
    # candidates): no fallback to all-A, and the boot engine's read equal
    # to the same walk over its rows brought back to the host
    from quorum_tpu_torch.ops import ctable
    from quorum_tpu_torch.serve.engine import representative_read

    boot = engines[0]
    host = ctable.TileState(boot.state.rows.cpu())
    want_read = representative_read(host, boot.meta, max(SERVE_WARM))
    res["warmup"] = {
        "engines": len(engines),
        "fallbacks": [e.warmup_fallbacks for e in engines],
        "read_eq_host_walk": [e.warmup_read == want_read for e in engines]}
    del host, boot, engines
    check(res["warmup"]["engines"] == 3
          and not any(res["warmup"]["fallbacks"])
          and all(res["warmup"]["read_eq_host_walk"]),
          f"serve warmup reads: {res['warmup']}")
    # the engines (a second table was on the card during the rebuild and
    # the reload) go before later phases measure free memory
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    res.update(final_counters={k: final["counters"].get(k) for k in (
        "requests_accepted", "requests_completed", "requests_failed",
        "reads_in", "reads_corrected", "batches", "engine_compiles",
        "engine_restarts_total", "reload_total", "reload_failures_total")})
    emit({"phase": "serve", "card": card, "port": port,
          "max_batch": SERVE_ROWS, "warmup_lengths": list(SERVE_WARM),
          "phase_s": round(time.perf_counter() - t_phase, 3), **res,
          "metrics_lines": len(text.splitlines()), "launches": launches})
    for name in PATH_KERNELS["serve"]:
        check(launches[name] > 0, f"{name} was not launched on the serve "
                                  "path")
    return launches


RESUME_FREE_BYTES = 10 << 30  # the resume phase's snapshot, its tmp, room
RESUME_KILL = 100  # the batch both killed runs die at
RESUME_EVERY = (64, 16)  # --checkpoint-every of stage 1 and of stage 2
# the resumed stage 1 in a process of its own: its launch counts are set
# to 0 just before the run and printed (the last stdout line) just after
RESUMED_STAGE1 = """
import json, sys, time
from quorum_tpu_torch.cli import create_database
from quorum_tpu_torch.kernels.loader import STATS
STATS.reset()
t0 = time.perf_counter()
rc = create_database.main(sys.argv[1:])
print(json.dumps({"rc": rc, "seconds": time.perf_counter() - t0,
                  "launches": dict(STATS.launches)}))
"""


def fault_env(site: str, batch: int, action: str = "exit") -> dict:
    """This process's environment with a one-fault plan in
    QUORUM_FAULT_PLAN (`exit` is the hard kill, os._exit(41))."""
    return dict(os.environ, QUORUM_FAULT_PLAN=json.dumps(
        [{"site": site, "batch": batch, "action": action}]))


def run_events(metrics: str, kind: str) -> list:
    """The `kind` events of a run's metrics event stream."""
    with open(metrics[:-len(".json")] + ".events.jsonl") as f:
        return [e for e in map(json.loads, f) if e.get("event") == kind]


def resume_stage1_start(full: dict) -> dict:
    """Start the resume phase's stage 1 (a) on a thread of its own, right
    after the full run: quorum_create_database --checkpoint-dir
    --checkpoint-every 64 -t 1 on the full run's FASTQ at its -s, killed
    (its own process, a hard-exit fault plan) at stage1.insert batch
    100, then the same command with --resume in a second process
    (RESUMED_STAGE1). Their ~400 s are mostly one host core computing
    the 4 GiB snapshot's CRC32C (the save, then the load's check), so
    they run beside the phases up to `legacy`, one parse thread each;
    phase_resume joins them. At least RESUME_FREE_BYTES must be free
    first. Returns the chain's state (stop_chain ends it)."""
    import threading

    d = os.path.join(WORK, "resume")
    os.makedirs(d, exist_ok=True)
    free = shutil.disk_usage(d).free
    check(free >= RESUME_FREE_BYTES,
          f"resume: {free} B free, {RESUME_FREE_BYTES} B needed")
    chain = {"ck": os.path.join(d, "ck"), "db": os.path.join(d, "db.jf"),
             "m0": os.path.join(d, "killed.json"),
             "m1": os.path.join(d, "stage1.json"), "proc": None,
             "stop": False, "error": None}
    argv = ["-s", str(full["size"]), "-m", str(K), "-b", "7", "-q", str(QT),
            "-t", "1", "--batch-size", str(BATCH), "-o", chain["db"],
            "--device", "cuda", "--checkpoint-dir", chain["ck"]]

    def step(cmd, env):
        if chain["stop"]:
            raise RuntimeError("stopped")
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
        chain["proc"] = p
        out, err = p.communicate()
        return p.returncode, out, err, time.perf_counter() - t0

    def work():
        try:
            # the killed run's event stream is unbuffered: its snapshot's
            # `checkpoint` event (bytes, D2H, CRC32C, write seconds)
            # survives the kill
            chain["killed"] = step(
                [sys.executable, "-m", "quorum_tpu_torch.cli.create_database",
                 *argv, "--checkpoint-every", str(RESUME_EVERY[0]),
                 "--metrics", chain["m0"], "--metrics-interval", "3600",
                 full["fastq"]],
                fault_env("stage1.insert", RESUME_KILL))
            ckpt = os.path.join(chain["ck"], "stage1.ckpt")
            chain["snapshot_bytes"] = (os.path.getsize(ckpt)
                                       if os.path.exists(ckpt) else 0)
            # the resumed run takes no snapshot of its own
            # (--checkpoint-every 0): a second 4 GiB save would add ~170 s
            chain["resumed"] = step(
                [sys.executable, "-c", RESUMED_STAGE1, *argv,
                 "--checkpoint-every", "0", "--resume", "--metrics",
                 chain["m1"], "--metrics-interval", "3600", full["fastq"]],
                dict(os.environ))
        except BaseException as e:  # noqa: BLE001 - phase_resume reports it
            chain["error"] = e

    chain["thread"] = threading.Thread(target=work, name="resume-stage1",
                                       daemon=True)
    chain["thread"].start()
    return chain


def stop_chain(chain) -> None:
    """End resume_stage1_start's processes (a failed run) and join."""
    if chain is None:
        return
    chain["stop"] = True
    p = chain["proc"]
    if p is not None and p.poll() is None:
        p.kill()
    chain["thread"].join()


def phase_resume(card: str, full: dict, chain: dict) -> dict:
    """Crash safety on the card, on the full run's data: (a)
    resume_stage1_start's kill and resume, joined here: the payload equal
    to the full run's; the snapshot's bytes, its save seconds (D2H,
    CRC32C, write with fsync; the killed run's `checkpoint` event), its
    load seconds (read, digest check, H2D; the `resume` event) and the
    resumed stage 1's seconds; (b) quorum_error_correct_reads -o P
    --checkpoint-every 16 on the full run's database killed at
    stage2.correct batch 100 (RESUME_KILL, RESUME_EVERY), then --resume
    in this process: .fa/.log equal to the full run's, the journal
    commits' seconds; (c) the golden stage 2 (64-read batches) with a
    `hang` at stage2.correct batch 1 and --stall-timeout-s 2: rc 75.
    Launch counts reset before and read after each resumed run."""
    from quorum_tpu_torch.cli import error_correct_reads as ec
    from quorum_tpu_torch.io import checkpoint, db_format
    from quorum_tpu_torch.kernels.loader import STATS

    d = os.path.join(WORK, "resume")
    prefix = os.path.join(d, "s2")
    argv = ["--device", "cuda", "-t", str(full["report"]["threads"]),
            "--batch-size", str(BATCH), "--checkpoint-every",
            str(RESUME_EVERY[1]), "-o", prefix, full["db"], full["fastq"]]
    cursor2 = RESUME_KILL // RESUME_EVERY[1] * RESUME_EVERY[1]
    t0 = time.perf_counter()
    killed = subprocess.run(
        [sys.executable, "-m", "quorum_tpu_torch.cli.error_correct_reads",
         *argv], cwd=ROOT, env=fault_env("stage2.correct", RESUME_KILL),
        capture_output=True, text=True, timeout=600)
    kill2_s = time.perf_counter() - t0
    check(killed.returncode == 41, f"killed stage 2 rc {killed.returncode}: "
                                   f"{killed.stderr[-500:]}")
    check(checkpoint.Stage2Journal(prefix).batches_done() == cursor2,
          f"the killed stage 2 left no journal at batch {cursor2}")
    report: dict = {}
    STATS.reset()
    t0 = time.perf_counter()
    rc = ec.main(argv[:-2] + ["--resume", *argv[-2:]], report=report)
    s2 = time.perf_counter() - t0
    launches2 = dict(STATS.launches)
    check(rc == 0, f"resumed stage 2 rc {rc}")
    for name in PATH_KERNELS["resume_stage2"]:
        check(launches2[name] > 0, f"{name} was not launched by the "
                                   "resumed stage 2")
    same_out = same_fa_log(prefix, full["prefix"])
    st = report["stats"]

    # batch 1 of the golden reads' four: the watchdog arms at the first
    # beat, which follows batch 0's fault site
    t0 = time.perf_counter()
    stall = subprocess.run(
        [sys.executable, "-m", "quorum_tpu_torch.cli.error_correct_reads",
         "-p", "4", "--batch-size", "64", "--device", "cuda",
         "--stall-timeout-s", "2", "-o", os.path.join(d, "stall"),
         os.path.join(WORK, "golden", "db.jf"),
         os.path.join(GOLDEN, "reads.fastq")],
        cwd=ROOT, env=fault_env("stage2.correct", 1, "hang"),
        capture_output=True, text=True, timeout=300)
    stall_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    chain["thread"].join()
    chain_wait_s = time.perf_counter() - t0
    check(chain["error"] is None, f"resume stage 1: {chain['error']!r}")
    rc1, _out, err1, kill1_s = chain["killed"]
    check(rc1 == 41, f"killed stage 1 rc {rc1}: {err1[-500:]}")
    rc1, out1, err1, resumed1_s = chain["resumed"]
    res1 = json.loads(out1.strip().splitlines()[-1]) if out1.strip() else {}
    check(rc1 == 0 and res1.get("rc") == 0,
          f"resumed stage 1 rc {rc1}/{res1.get('rc')}: {err1[-500:]}")
    launches1 = res1["launches"]
    for name in PATH_KERNELS["resume_stage1"]:
        check(launches1[name] > 0, f"{name} was not launched by the "
                                   "resumed stage 1")
    cursor1 = RESUME_KILL // RESUME_EVERY[0] * RESUME_EVERY[0]
    (resume,) = run_events(chain["m1"], "resume")
    saves = run_events(chain["m0"], "checkpoint")
    check(len(saves) == 1 and resume["cursor"] == cursor1,
          f"stage 1 events: resume {resume}, {len(saves)} saves")
    same_payload = (db_format.db_payload_bytes(chain["db"])
                    == db_format.db_payload_bytes(full["db"]))
    shutil.rmtree(d, ignore_errors=True)
    (save,) = saves
    emit({"phase": "resume", "card": card,
          "stage1": {"killed_at_batch": RESUME_KILL, "threads": 1,
                     "killed_run_s": round(kill1_s, 3),
                     "resumed_from_batch": resume["cursor"],
                     "snapshot_file_bytes": chain["snapshot_bytes"],
                     "snapshot_bytes": save["bytes"],
                     "save_d2h_s": round(save["d2h_s"], 3),
                     "save_crc32c_s": round(save["crc_s"], 3),
                     "save_write_fsync_s": round(save["write_s"], 3),
                     "load_s": round(resume["load_s"], 3),
                     "resumed_stage1_s": round(res1["seconds"], 3),
                     "resumed_process_s": round(resumed1_s, 3),
                     "waited_for_s": round(chain_wait_s, 3),
                     "payload_equal_full": same_payload},
          "stage2": {"killed_at_batch": RESUME_KILL,
                     "killed_run_s": round(kill2_s, 3),
                     "resumed_from_batch": cursor2, "commits": st.commits,
                     "commit_s": round(st.commit_s, 4),
                     "commit_s_each": round(st.commit_s / max(st.commits, 1),
                                            4),
                     "resumed_stage2_s": round(s2, 3),
                     "fa_log_equal_full": same_out},
          "stall": {"rc": stall.returncode, "seconds": round(stall_s, 3),
                    "soft_abort": "aborting the stalled step" in stall.stderr,
                    "hard_exit": "still wedged" in stall.stderr},
          "launches_stage1": launches1, "launches_stage2": launches2})
    check(same_payload, "the resumed stage 1's payload differs from full's")
    check(same_out, "the resumed stage 2's .fa/.log differ from full's")
    check(stall.returncode == 75, f"the stalled stage 2 rc "
                                  f"{stall.returncode}: {stall.stderr[-500:]}")
    return {"resume_stage1": launches1, "resume_stage2": launches2}


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    try:
        import quorum_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a quorum-tpu checkout "
              f"({e})", file=sys.stderr)
        return 2
    global START
    START = time.perf_counter()
    card = card_line()
    os.makedirs(WORK, exist_ok=True)
    chain = None
    try:
        # the golden drivers' CPU references run beside the build
        drivers_cpu = golden_cpu_start("drivers")
        phase_build()
        stage2_cpu = golden_stage1()
        stats = phase_kernels(card)
        phase_golden(drivers_cpu, stage2_cpu)
        full = phase_full(card)
        serve = phase_serve(card, full)
        chain = resume_stage1_start(full)
        serial = phase_serial(card, full)
        telemetry = phase_telemetry(card, full)
        phase_parser(card, full)
        two = phase_two_binary(card, full)
        paired = phase_paired(card, full)
        ref_format = phase_ref_format(card, full)
        legacy = phase_legacy(card)
        resume = phase_resume(card, full, chain)
        full["wires"] = full_wires(full)
        prefilter, two_pass = phase_prefilter(card, full, two)
        partitions = phase_partitions(card, full, two_pass, two)
        phase_pending(card, full, two["rb_start"])
        for name, v in phase_loaded(card, full).items():
            stats.setdefault(name, {}).update(v)
        contam = phase_contaminant(card, full)
        for name, v in phase_table(card, full, contam).items():
            stats.setdefault(name, {}).update(v)
        event = phase_event(card, full, contam, two["db"])
        for name, v in event["kernels"].items():
            stats.setdefault(name, {}).update(v)
        devices = phase_devices(card, full, two)
        for name, v in devices["kernels"].items():
            stats.setdefault(name, {}).update(v)
        dev_parts = phase_devices_partitions(card, full)
        routed = phase_devices_routed(card, full)
        flat = phase_flat(card, full)
        minim = phase_minimizer(card, full)
        unpacked = phase_devices_unpacked(card, full)
        for part in (flat, minim):
            for name, v in part["kernels"].items():
                stats.setdefault(name, {}).update(v)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        stop_chain(chain)
        stop_children()
        shutil.rmtree(WORK, ignore_errors=True)
    by_path = {"full": full["launches"], "pipeline": serial, **telemetry,
               "two_binary": two["launches"],
               **prefilter, **partitions, **contam["launches"],
               "devices": devices["launches"],
               "devices_single": devices["single_launches"],
               "devices_grow": devices["grow_launches"],
               "devices_routed_cap": devices["cap_launches"],
               "devices_partitions": dev_parts,
               "devices_routed": routed["launches"],
               "devices_routed_manifest": routed["manifest_launches"],
               **event["launches"], "flat": flat["launches"],
               "minimizer": minim["launches"],
               "devices_unpacked": unpacked["launches"],
               "paired": paired["paired"],
               "paired_unpaired": paired["unpaired"],
               **ref_format, "legacy": legacy, **resume, "serve": serve}
    def bound_ms(nbytes):
        return round(nbytes / H100_BYTES_PER_S * 1e3, 5)

    rows = []
    for name, (src, replaces) in SOURCES.items():
        v = stats[name]
        # a second entry of the same kernel, timed apart
        entries = {e: {"ms": round(v[e]["ms"], 5),
                       "plain_ms": round(v[e]["plain_ms"], 5),
                       "bound_ms": bound_ms(v[e]["bound_bytes"]),
                       **({"library_ms": round(v[e]["library_ms"], 5)}
                          if "library_ms" in v[e] else {})}
                   for e in ("query", "inline", "partition",
                             "contaminant", "contaminant_trim", "overflow",
                             "dense", "no_n", "handoff")
                   if e in v}
        # HK4's event entry on the first quarter of its batch
        quarter = {e: (round(v[e], 5) if isinstance(v[e], float) else v[e])
                   for e in ("quarter_b", "ms_quarter", "cut_b") if e in v}
        equal = v["equal"] and all(v[e].get("equal", True) for e in entries)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": sum(p[name] for p in by_path.values()),
                     "launches_by_path": {k: p[name]
                                          for k, p in by_path.items()},
                     "max_abs_err": 0 if equal else None,
                     "ms": round(v["ms"], 5),
                     "plain_ms": round(v["plain_ms"], 5),
                     "bound_ms": bound_ms(v["bound_bytes"]),
                     "bound_by": "bytes",
                     "library_ms": (round(v["library_ms"], 5)
                                    if "library_ms" in v else None),
                     **entries, **quarter})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(run())
