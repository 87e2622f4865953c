#!/usr/bin/env python3
"""Where the time of one warm run of a path of the PyTorch port goes, on
one NVIDIA GPU.

    python3 tools/torch_q1_profile.py
        [--query q1|q16_part|q3|q18|q2|q11|join_sort|skew|q1_parquet|
                 parquet_scan] [--rows N]
        [--adaptive] [--leg static|adaptive|adaptive_bcast] [--trace PATH]

Runs TPC-H Q1 (the default), the part stage of TPC-H Q16, TPC-H Q3,
TPC-H Q18, TPC-H Q2 or TPC-H Q11 through ``spark_rapids_tpu_torch.entry``
over the input ``chip_smoke.py`` gives it (the SF10 lineitem table, the
SF100 part table, the SF10 customer, orders and lineitem tables, Q18 under
its 1 GiB device budget, or the SF100 part, supplier, partsupp, nation and
region tables), in its slices and shuffle partitions: once to warm up,
three times on the host clock, then once under
``torch.profiler`` (CPU and CUDA activities). Prints the card, the warm
wall time, the time the Arrow upload alone takes, each operator's metrics
(rows, batches, ``opTime``; the whole tree, children indented), the device
busy time of the profiled run (the union of its kernel and copy intervals)
and the idle share (against the profiled run's wall, which the profiler
lengthens, and against the unprofiled warm wall), the device time per
operator (the profiler range of the
innermost operator, or of the join's build, count or expand step, around
each launch), the device time by kernel or copy (the port's own kernels
always listed), and the device time by kind (sorts, gathers, group sums,
other).

For Q1 and Q16 it then takes the PARTIAL aggregate of the first slice
apart: the update over the filtered slice, the re-merge of its output at
the slice's capacity (as the exec runs it), the same re-merge over that
output cut to its row-count bucket, and the exchange's write over each of
the two. For each piece: device time by kind from the profiler, its time on
CUDA events, and the device memory it allocates at its peak beyond what was
allocated before it. For Q3 it times each join's build, count and expand
steps on CUDA events over partition 0's inputs. For Q18 it reports the
spill copies of the profiled run in each direction (the catalog's bytes
over the device time of the pinned copies, against the PCIe bound) and the
grace join's split (host time of its ranges and the device time under
them). For Q11 it prints the smallest relative margin of a group's value
to the HAVING threshold.

``--adaptive`` builds Q3 or Q18 under the JAX Session's default adaptive
conf (``entry.q3_plan(..., adaptive=True)``) and prints the decisions of
the profiled run. ``--query skew`` runs the skew bench's query at
``chip_smoke.py``'s size (67,108,864 fact rows, 2,097,152 dim rows) in one
leg (``--leg``) or, by default, in each of its three legs in turn, with the
decisions of each profiled run.

``--query join_sort`` runs the bench's join+sort stage at
``chip_smoke.py``'s two sizes (2^21 x 2^18 rows, and 59,986,052 x
15,000,000), inputs on the card, through the iterator path and through the
fused stage captured in a CUDA graph, side by side: each mode's warm wall, the device
busy time and idle share of one profiled warm run, and the device time
under each operator range of the iterator path.
``--query q1_parquet`` runs Q1 from the SF10 lineitem written to 8
Parquet files, ``--query parquet_scan`` the bench's scan over them
(MULTITHREADED): the warm wall, the host decode alone beside the upload
alone, and one profiled warm run whose device busy time splits into H2D
copies and compute, with its idle share.
``--trace`` also writes the Chrome trace. Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root is on the path above)

#: the operators' and the join steps' profiler ranges
RANGES = chip_smoke.PROFILER_RANGES


def _owner(evt) -> str:
    """The innermost operator or join-step range around a CPU event."""
    e = evt
    while e is not None:
        if e.name in RANGES:
            return e.name
        e = e.cpu_parent
    return "(outside operators: collect)"


def _per_operator(prof) -> collections.Counter:
    """Device us of the profiled call under each operator's range; the
    kernels ``chip_smoke.capture`` launches around the call are left out."""
    import torch
    per_op = collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        owner, p = _owner(e), e
        while p is not None and p.name != chip_smoke.CALL_RANGE:
            p = p.cpu_parent
        if p is not None:
            for k in getattr(e, "kernels", []):
                per_op[owner] += k.duration
    return per_op


def _kind(name: str) -> str:
    """The kind of a device kernel or copy, from its name."""
    low = name.lower()
    if "sort" in low:
        return "sort"
    if "indexfunc" in low:          # index_add_: the group sums
        return "group sums"
    if "gather" in low or "index_elementwise" in low:
        return "gather"
    return "other"


def _by_kind(device) -> collections.Counter:
    ms = collections.Counter()
    for e in device:
        ms[_kind(e.name)] += e.time_range.elapsed_us() / 1e3
    return ms


def _piece(fn, dev):
    """(result, device ms by kind, device bytes allocated at the peak of
    ``fn`` beyond what was allocated before it) of one warm call. The
    kinds also hold "events": the call's time on CUDA events, a second
    warm call, against which the profiler's sum can be checked."""
    import torch
    fn()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _, _, out, device = chip_smoke.capture(fn, dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    kinds = _by_kind(device)
    kinds["events"] = chip_smoke.time_cuda_ms(fn, reps=1, warmup=0)
    return out, kinds, peak


def _kinds_line(ms) -> str:
    line = ", ".join(f"{k} {ms[k]:.3f}" for k in
                     ("sort", "gather", "group sums", "other"))
    if "events" in ms:
        line += f" (on CUDA events {ms['events']:.3f})"
    return line


def partial_pieces(plan, dev, run_kinds, run_peak) -> None:
    """The PARTIAL aggregate of slice 0, piece by piece (see the module
    docstring), against the whole run's device time by kind and peak."""
    import torch
    from spark_rapids_tpu_torch.batch import bucket_capacity
    from spark_rapids_tpu_torch.exec.common import gather
    from spark_rapids_tpu_torch.shuffle.exchange import partition_pieces
    exchange = plan.child.child
    partial = exchange.child
    n_slices = partial.child.num_partitions
    [batch] = list(partial.child.execute_partition(0))
    out, upd, upd_peak = _piece(lambda: partial._update_kernel(batch), dev)
    rows = int(out.num_rows)
    cut = gather(out, torch.arange(bucket_capacity(rows), device=dev), rows)
    n = exchange.partitioning.num_partitions

    def write(b):
        pids = exchange.partitioning.partition_ids(b, exchange.ctx)
        return list(partition_pieces(b, pids, n))

    print(f"PARTIAL aggregate of slice 0 of {n_slices} (device ms by kind;"
          f" peak = device memory allocated beyond what was before):")
    print(f"  update over {int(batch.num_rows)} rows at capacity "
          f"{batch.capacity} -> {rows} groups at capacity {out.capacity}: "
          f"{_kinds_line(upd)}; peak {upd_peak / 2**30:.3f} GiB")
    for label, b in ((f"padded to {out.capacity}", out),
                     (f"cut to {cut.capacity}", cut)):
        _, mrg, mrg_peak = _piece(
            lambda: partial._merge_kernel(b, final=False), dev)
        _, wr, wr_peak = _piece(lambda: write(b), dev)
        print(f"  re-merge of the output {label}: {_kinds_line(mrg)}; peak "
              f"{mrg_peak / 2**30:.3f} GiB")
        print(f"  exchange write of the output {label}: {_kinds_line(wr)}; "
              f"peak {wr_peak / 2**30:.3f} GiB")
        if b is out:
            both = mrg + wr
            print(f"    x{n_slices} slices, share of the profiled run: "
                  + ", ".join(f"{k} {n_slices * both[k] / run_kinds[k]:.1%}"
                              for k in ("sort", "gather") if run_kinds[k])
                  + f"; re-merge peak {mrg_peak / run_peak:.1%} and write "
                  f"peak {wr_peak / run_peak:.1%} of the run's peak")


def join_steps(plan, dev) -> None:
    """Each join's build, count and expand over partition 0's inputs, on
    CUDA events (median of 5 warm calls)."""
    import torch
    from spark_rapids_tpu_torch.batch import bucket_capacity
    from spark_rapids_tpu_torch.exec.common import concat_all
    for join in chip_smoke._execs(plan, "HashJoinExec"):
        # an exchange's piece goes with its last read: start each join
        # from fresh exchanges, laid out as the run laid them out
        plan.close()
        join.num_partitions
        build = concat_all(list(join.right.execute_partition(0)),
                           join.right.output_schema, dev)
        [stream] = list(join.left.execute_partition(0))
        table, sbuild = join._build_kernel(build)
        dense = table.dense is not None and bool(table.dense)
        lo, counts, offsets = join._count_kernel(stream, table, dense)
        total, most = [int(v) for v in (offsets[-1], counts.max())]
        out_cap = bucket_capacity(max(total, 1))
        matched = torch.zeros(sbuild.capacity, dtype=torch.bool,
                              device=dev)
        ms = [chip_smoke.time_cuda_ms(fn, reps=5) for fn in (
            lambda: join._build_kernel(build),
            lambda: join._count_kernel(stream, table, dense),
            lambda: join._expand_kernel(stream, sbuild, lo, counts, offsets,
                                        total, most <= 1, matched, out_cap))]
        keys = ", ".join(k.name for k in join.left_keys)
        print(f"join on {keys}, partition 0: build {int(build.num_rows)} "
              f"rows at capacity {build.capacity} (dense {dense}) "
              f"{ms[0]:.3f} ms; count over {int(stream.num_rows)} probe "
              f"rows at capacity {stream.capacity} {ms[1]:.3f} ms; expand "
              f"to {total} pairs at capacity {out_cap} (1:1 path "
              f"{most <= 1 and out_cap >= stream.capacity}) {ms[2]:.3f} ms")
    plan.close()
    plan.close()


def spill_and_grace(plan, prof, device) -> None:
    """The profiled Q18 run's spill copies, each direction's catalog bytes
    over the device time of its pinned copies, and the grace join's split
    ranges, host and device time."""
    import torch
    cat = plan.catalog
    copies = {"d2h": ("DtoH", "Pinned"), "h2d": ("HtoD", "Pinned")}
    for way, nbytes in (("d2h", cat.spilled_to_host),
                        ("h2d", cat.unspilled)):
        marks = copies[way]
        evs = [e for e in device if all(m in e.name for m in marks)]
        us = sum(e.time_range.elapsed_us() for e in evs)
        rate = nbytes / (us * 1e-6) / 1e9 if us else float("nan")
        print(f"spill copies {way}: {nbytes} B in {len(evs)} pinned copies, "
              f"{us / 1e3:.3f} ms of device time, {rate:.2f} GB/s "
              f"(PCIe Gen5 x16 bound {chip_smoke.PCIE_BYTES_PER_S / 1e9:.0f}"
              f" GB/s)")
    host_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.name == "HashJoinExec.grace_split")
    dev_us = sum(k.duration for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and _owner(e) == "HashJoinExec.grace_split"
                 for k in getattr(e, "kernels", []))
    buckets = sum(j.metrics["graceBuckets"].total()
                  for j in chip_smoke._execs(plan, "HashJoinExec"))
    print(f"grace split: {buckets} buckets; host {host_us / 1e3:.2f} ms in "
          f"its ranges, device {dev_us / 1e3:.2f} ms under them; catalog "
          f"spilled {cat.spilled_to_host} B to host, "
          f"{cat.spilled_to_disk} B to disk")


def _tree_metrics(node, depth=0) -> None:
    """Each operator's metrics, children indented (opTime includes the
    operator's children)."""
    m = {k: v.total() for k, v in node.metrics.items()}
    print(f"  {'  ' * depth}{node.name}: rows {m['numOutputRows']}, batches "
          f"{m['numOutputBatches']}, opTime {m['opTime'] / 1e6:.2f} ms")
    for c in node.children:
        _tree_metrics(c, depth + 1)


def parquet_profile(args, dev) -> int:
    """Q1 from Parquet (``--query q1_parquet``) or the bench's scan
    (``--query parquet_scan``, MULTITHREADED) over the SF10 lineitem
    (``--rows``) in ``chip_smoke.py``'s 8 files, written to a temporary
    directory and removed after: the warm wall (median of three), the
    decode alone on the host (``read_split``, nothing uploaded), the
    upload of those tables alone, and one profiled warm run whose device
    busy time splits into the H2D copies and the compute (kernels, other
    copies), with its idle share, device time per operator and the scan's
    prefetch metrics."""
    import shutil
    import tempfile
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.batch import from_arrow
    from spark_rapids_tpu_torch.exec import collect
    rows = args.rows or chip_smoke.SF10_LINEITEM_ROWS
    table = entry.lineitem_table(rows, chip_smoke.DATA_SEED)
    tmp = tempfile.mkdtemp(prefix="torch_q1_profile_")
    try:
        t0 = time.perf_counter()
        paths = entry.parquet_files(table, tmp, chip_smoke.PARQUET_FILES)
        print(f"{rows} lineitem rows written to {len(paths)} files in "
              f"{time.perf_counter() - t0:.2f} s")
        if args.query == "q1_parquet":
            expected = entry.q1_reference(table)

            def make():
                return entry.q1_parquet_plan(
                    paths, chip_smoke.PARQUET_SLICES,
                    chip_smoke.PARQUET_PARTITIONS, device=dev)

            def run():
                plan = make()
                chip_smoke.check_q1_result(collect(plan), expected)
                return plan
        else:
            def make():
                return entry.parquet_scan_plan(paths, device=dev)

            def run():
                plan = make()
                for _ in plan.execute():
                    pass
                return plan
        del table
        run()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        plan = make()
        scan = plan
        while scan.children:
            scan = scan.children[0]
        src = scan.source
        t0 = time.perf_counter()
        tables = list(src.read_split(src.files))
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for t in tables:
            from_arrow(t, schema=scan.output_schema, device=dev)
        torch.cuda.synchronize(dev)
        upload_s = time.perf_counter() - t0
        del tables
        plan.close()
        print(f"{args.query} warm wall {wall:.4f} s (median of "
              f"{[round(w, 4) for w in walls]}), {rows / wall:,.0f} rows/s;"
              f" decode alone {decode_s:.4f} s on the host, upload alone "
              f"{upload_s:.4f} s")
        torch.cuda.reset_peak_memory_stats(dev)
        state = {}
        prof, prof_us, busy, device = chip_smoke.profiled(
            lambda: state.update(plan=run()), dev)
        h2d = sum(e.time_range.elapsed_us() for e in device
                  if "HtoD" in e.name)
        other = sum(e.time_range.elapsed_us() for e in device
                    if "HtoD" not in e.name)
        print(f"profiled run: wall {prof_us / 1e3:.2f} ms, device busy "
              f"{busy / 1e3:.2f} ms, idle share {1 - busy / prof_us:.1%} "
              f"(against the unprofiled warm wall "
              f"{1 - busy / (wall * 1e6):.1%}); device time in H2D copies "
              f"{h2d / 1e3:.2f} ms, in compute (kernels and other copies) "
              f"{other / 1e3:.2f} ms; device memory peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")
        _tree_metrics(state["plan"])
        scan = state["plan"]
        while scan.children:
            scan = scan.children[0]
        m = {k: v.total() for k, v in scan.metrics.items()}
        print(f"  scan prefetch: overlapTime {m['overlapTime'] / 1e6:.2f} "
              f"ms, prefetchWaitTime {m['prefetchWaitTime'] / 1e6:.2f} ms"
              f" (MULTITHREADED pipelines in its decode window instead)")
        for name, us in _per_operator(prof).most_common():
            print(f"  device time under {name}: {us / 1e3:.2f} ms "
                  f"({us / busy:.1%} of busy)")
        print(f"  device ms by kind: {_kinds_line(_by_kind(device))}")
        if args.trace:
            pathlib.Path(args.trace).parent.mkdir(parents=True,
                                                  exist_ok=True)
            prof.export_chrome_trace(args.trace)
            print(f"trace written to {args.trace}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


def join_sort_profile(args, dev) -> int:
    """The join_sort stage through the iterator path and through the
    captured graph, side by side: warm wall, device busy time and idle
    share of one profiled warm run each, and the iterator path's device
    time under each operator range."""
    from spark_rapids_tpu_torch import entry
    for n_stream, n_build in chip_smoke.JOIN_SORT_SIZES:
        stream, build = entry.join_sort_tables(n_stream, n_build)
        plan = entry.join_sort_plan(stream, build, dev)
        del stream, build
        _join_sort_modes(args, dev, plan, n_stream, n_build)
        plan.close()
    return 0


def _join_sort_modes(args, dev, plan, n_stream, n_build) -> None:
    import torch
    from spark_rapids_tpu_torch import entry
    for mode in ("iterator", "graph"):
        run = entry.join_sort_runner(plan, mode)
        run()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        prof, prof_us, busy, device = chip_smoke.profiled(run, dev)
        print(f"join_sort {n_stream} x {n_build} {mode}: warm wall "
              f"{wall * 1e3:.3f} ms (median of "
              f"{[round(w * 1e3, 3) for w in walls]}), {len(device)} "
              f"device kernels and copies, busy {busy / 1e3:.3f} ms, idle "
              f"share {1 - busy / prof_us:.1%} of the profiled wall "
              f"{prof_us / 1e3:.3f} ms ({1 - busy / (wall * 1e6):.1%} of "
              f"the warm wall)")
        if mode == "iterator":
            for name, us in _per_operator(prof).most_common():
                print(f"  device time under {name}: {us / 1e3:.3f} ms "
                      f"({us / busy:.1%} of busy)")
        print(f"  device ms by kind: {_kinds_line(_by_kind(device))}")
        if args.trace:
            path = pathlib.Path(f"{args.trace}.{n_stream}.{mode}.json")
            path.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(path))
            print(f"trace written to {path}")


def profile_run(args, dev, label, make_plan, tables, slices, parts, rows,
                expected, check, table=None):
    """One path's warm walls, upload time, operator metrics and one
    profiled run (device time per operator, per kernel and by kind).
    Returns (plan, profile, device events, device ms by kind, peak)."""
    import torch
    from spark_rapids_tpu_torch import adaptive, entry
    from spark_rapids_tpu_torch.batch import from_arrow
    from spark_rapids_tpu_torch.exec import collect

    def run():
        plan = make_plan(table, slices, parts, device=dev)
        out = collect(plan)
        torch.cuda.synchronize(dev)
        return plan, out

    check(run()[1], expected)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        plan, _ = run()
        walls.append(time.perf_counter() - t0)
    ups = []
    for _ in range(3):
        t0 = time.perf_counter()
        for t in tables:
            step = max(1, -(-t.num_rows // slices))
            # supplier's strings scan at their own width
            width = (entry.SUPPLIER_STRING_MAX_LEN
                     if "s_comment" in t.column_names
                     else entry.STRING_MAX_LEN)
            for off in range(0, t.num_rows, step):
                from_arrow(t.slice(off, step), string_max_len=width,
                           device=dev)
        torch.cuda.synchronize(dev)
        ups.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"{label} warm wall {wall:.4f} s (median of "
          f"{[round(w, 4) for w in walls]}), {rows / wall:,.0f} rows/s;"
          f" Arrow upload alone {statistics.median(ups):.4f} s")
    _tree_metrics(plan)

    # the last warm run's plan holds its exchanges' pieces: drop it, so the
    # peak below is the profiled run's own
    plan = None
    torch.cuda.reset_peak_memory_stats(dev)
    mark = adaptive.reason_mark()
    prof, prof_wall_us, (plan, _), device = chip_smoke.capture(run, dev)
    decided = adaptive.reasons(since=mark)
    if decided:
        print(f"{label} decisions of the profiled run: {decided}")
    run_peak = torch.cuda.max_memory_allocated(dev)
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    busy = chip_smoke.busy_us([(e.time_range.start, e.time_range.end)
                     for e in device])
    print(f"profiled run: wall {prof_wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share {1 - busy / prof_wall_us:.1%} "
          f"(against the unprofiled warm wall "
          f"{1 - busy / (wall * 1e6):.1%}), device memory peak "
          f"{run_peak / 2**30:.3f} GiB")

    for name, us in _per_operator(prof).most_common():
        print(f"  device time under {name}: {us / 1e3:.2f} ms "
              f"({us / busy:.1%} of busy)")
    per_kernel = collections.Counter()
    counts = collections.Counter()
    for e in device:
        per_kernel[e.name] += e.time_range.elapsed_us()
        counts[e.name] += 1
    top = [name for name, _ in per_kernel.most_common(14)]
    top += [name for name in per_kernel if name not in top and
            ("murmur3" in name or "window_match" in name)]
    for name in top:
        print(f"  {per_kernel[name] / 1e3:9.3f} ms  x{counts[name]:<5d} "
              f"{name[:100]}")
    run_kinds = _by_kind(device)
    print(f"  device ms by kind: {_kinds_line(run_kinds)}")
    if args.trace:
        pathlib.Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")
    return plan, prof, device, run_kinds, run_peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--query",
                    choices=("q1", "q16_part", "q3", "q18", "q2", "q11",
                             "join_sort", "skew", "q1_parquet",
                             "parquet_scan"),
                    default="q1")
    ap.add_argument("--adaptive", action="store_true",
                    help="q3, q18: the tree under the default adaptive conf")
    ap.add_argument("--leg", default=None,
                    choices=("static", "adaptive", "adaptive_bcast"),
                    help="skew: one leg (default: each in turn)")
    ap.add_argument("--rows", type=int, default=None,
                    help="input rows of Q1, Q16 or the Parquet queries "
                         "(default: chip_smoke's SF10 lineitem or SF100 "
                         "part count)")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("torch_q1_profile: CUDA is not available", file=sys.stderr)
        return 1
    from spark_rapids_tpu_torch import entry
    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line())
    if args.query == "join_sort":
        return join_sort_profile(args, dev)
    if args.query in ("q1_parquet", "parquet_scan"):
        return parquet_profile(args, dev)
    if args.query == "skew":
        fact, dim = entry.skew_tables(chip_smoke.SKEW_ROWS,
                                      chip_smoke.SKEW_KEYS,
                                      chip_smoke.SKEW_HOT_FRAC,
                                      chip_smoke.SKEW_SEED)
        expected = entry.skew_reference(fact, dim)

        def check(got, exp):
            if not got.equals(exp):
                raise AssertionError("skew differs from its oracle")
        for leg in ([args.leg] if args.leg else entry.SKEW_LEGS):
            print(f"skew leg {leg}")

            def make_plan(_, slices, parts, device, leg=leg):
                return entry.skew_plan(
                    fact, dim, leg, split_rows=chip_smoke.SKEW_SPLIT_ROWS,
                    device=device)
            profile_run(args, dev, f"skew {leg}", make_plan, [fact, dim],
                        entry.SKEW_SLICES, entry.SKEW_PARTITIONS,
                        fact.num_rows, expected, check)
        return 0
    if args.query == "q1":
        rows = args.rows or chip_smoke.SF10_LINEITEM_ROWS
        slices, parts = chip_smoke.Q1_SLICES, chip_smoke.Q1_SHUFFLE_PARTITIONS
        table = entry.lineitem_table(rows, chip_smoke.DATA_SEED)
        expected = entry.q1_reference(table)
        make_plan, check = entry.q1_plan, chip_smoke.check_q1_result
        tables = [table]
    elif args.query == "q3":
        slices = chip_smoke.Q3_SLICES
        parts = chip_smoke.Q3_SHUFFLE_PARTITIONS
        tables = entry.tpch_q3_tables(chip_smoke.Q3_SF, chip_smoke.Q3_SEED)
        rows = tables[2].num_rows
        expected = entry.q3_reference(*tables)
        check = chip_smoke.check_q3_result

        def make_plan(_, slices, parts, device):
            return entry.q3_plan(*tables, slices, parts, device=device,
                                 adaptive=args.adaptive)
        table = None
    elif args.query == "q18":
        slices = chip_smoke.Q18_SLICES
        parts = chip_smoke.Q18_SHUFFLE_PARTITIONS
        tables = entry.tpch_q18_tables(chip_smoke.Q18_SF,
                                       chip_smoke.Q18_SEED)
        rows = tables[2].num_rows
        expected = entry.q18_reference(*tables)
        check = chip_smoke.check_q18_result

        def make_plan(_, slices, parts, device):
            return entry.q18_plan(*tables, slices, parts,
                                  device_limit=chip_smoke.Q18_BUDGET,
                                  device=device, adaptive=args.adaptive)
        table = None
    elif args.query in ("q2", "q11"):
        slices = chip_smoke.Q2_SLICES
        parts = chip_smoke.Q2_SHUFFLE_PARTITIONS
        part, supplier, partsupp, nation, region = entry.tpch_q2_tables(
            chip_smoke.Q2_SF, chip_smoke.Q2_SEED)
        rows = partsupp.num_rows
        if args.query == "q2":
            inputs = [part, supplier, partsupp, nation, region]
            expected = entry.q2_reference(*inputs)

            def make_plan(_, slices, parts, device):
                return entry.q2_plan(*inputs, slices, parts, device=device)

            def check(got, exp):
                if not got.equals(exp):
                    raise AssertionError("q2 differs from its oracle")
        else:
            inputs = [partsupp, supplier, nation]
            fraction = entry.q11_fraction(chip_smoke.Q2_SF)
            expected = entry.q11_reference(*inputs, fraction)
            groups, total = entry.q11_groups_reference(*inputs)
            v = groups.column("value").to_numpy()
            margin = float(abs(v - total * fraction).min()
                           / (total * fraction))

            def make_plan(_, slices, parts, device):
                return entry.q11_plan(*inputs, fraction, slices, parts,
                                      device=device)

            def check(got, exp):
                print("q11 matches its oracle"
                      + chip_smoke.check_q11_result(got, exp, margin))
        # the upload measure below scans each table once, as the plan
        # prunes it (Q2 and Q11 scan partsupp twice)
        columns = (entry.Q2_COLUMNS if args.query == "q2"
                   else entry.Q11_COLUMNS)
        names = (("part", "supplier", "partsupp", "nation", "region")
                 if args.query == "q2" else ("partsupp", "supplier",
                                             "nation"))
        tables = [entry._prune(t, columns.get(n))
                  for t, n in zip(inputs, names)]
        table = None
    else:
        rows = args.rows or chip_smoke.SF100_PART_ROWS
        slices = chip_smoke.Q16_SLICES
        parts = chip_smoke.Q16_SHUFFLE_PARTITIONS
        table = entry.part_table(rows, chip_smoke.PART_SEED)
        expected = entry.q16_part_reference(table)
        make_plan = entry.q16_part_plan
        tables = [table]

        def check(got, exp):
            if not got.equals(exp):
                raise AssertionError("q16_part differs from its oracle")

    label = args.query + (" aqe" if args.adaptive else "")
    plan, prof, device, run_kinds, run_peak = profile_run(
        args, dev, label, make_plan, tables, slices, parts, rows, expected,
        check, table)
    if args.query == "q3":
        join_steps(plan, dev)
    elif args.query == "q18":
        spill_and_grace(plan, prof, device)
    elif args.query in ("q1", "q16_part"):
        partial_pieces(plan, dev, run_kinds, run_peak)
    return 0


if __name__ == "__main__":
    sys.exit(main())
