"""Run one cell of the benchmark once.

    python -m mapbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`mapbench/configs/<config>.json`: the genome and the CLI options of one
SHRiMP2 deployment) and a traffic mix (`mapbench/traffic/<traffic>.json`:
the reads). From the seed the harness makes the genome, writes it as
FASTA, and makes a pool of reads; read n of the stream is pool entry
n % pool, named `n` (a pair: `n/1`, `n/2`). It starts the port's `map`
CLI in a child process (`mapbench.child`), feeds it the reads on its
standard input without end, and reads its SAM back from its standard
output. The SAM is in input order, so the highest read number seen says
how many reads are complete, mapped or not. The CLI maps its input in
windows of 32,768 reads (records: 16,384 pairs) and drains its pipeline
at the end of each, so the rate is taken between the ends of whole CLI
windows.

Set-up runs from process start until `warmup_reads` reads are complete
(child start, CUDA, kernels from the build cache, genome, index, two
CLI windows of reads). Then the window opens for `--seconds`:
`reads_per_s` is the reads of the CLI windows that ended inside the
window after the first one that did, over the time between the ends of
the first and the last of them; `host_memory_peak_mib` is the largest
resident memory of the CLI sampled in the window (an end-to-end metric
`<quantity>.<suffix>` reads `<quantity>`: the same number under a bound
of its own, for cells that spread differently). With `--trace 1` the
line carries the per-layer metrics (`mapbench/metrics/<metric>.py`)
instead: the host stages are read over the window, untraced; then the
child starts the profiler and the benchmark's launch recorder, and the
device is read over a second span of `--seconds`.

After the window the child is ended, and the NumPy reference
(`mapbench/reference/`) maps the reads of a sample of pool entries drawn
from the seed; every occurrence of a sampled entry that completed inside
the window must have exactly the reference's SAM records.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import fcntl  # noqa: E402
import importlib  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

from mapbench.metrics import load as metrics_load  # noqa: E402
from mapbench.trace import summarize as trace_summary  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_WINDOW_READS = 32768   # cli.py: max(8 * B, 32768) records, -B 4096
SETUP_LIMIT_S = 900
PIPE_BYTES = 1 << 20
SAMPLE_S = 0.1           # the host sampler's period in the window
FEED_BYTES = 1 << 18
NAME_DIGITS = 10          # read n is named by n, zero-padded to this width
JAX_NAMES = ("jax", "jaxlib", "flax", "shrimp_tpu")
_LS_CHARS = np.frombuffer(b"ACGTUMRWSYKVHDBN", np.uint8)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------- the cell
def load_cell(workload: str) -> dict:
    """The cell's entry, its configuration and its traffic, by name."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"mapbench: no workload {workload!r}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "mapbench", "traffic",
                           f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    metrics = [m for m in bench["end_to_end"]
               if workload in m.get("workloads", [workload])]
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return dict(cell=cell, config=config, traffic=traffic,
                end_to_end=metrics, per_layer=per_layer)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of one input stream of a seed (any whole number)."""
    return np.random.default_rng([seed & ((1 << 64) - 1), stream])


def make_inputs(config: dict, traffic: dict, seed: int) -> dict:
    """Genome, read pool and correctness sample from the seed."""
    g = config["genome"]
    genome = importlib.import_module(f"mapbench.gen.{g['generator']}").make(
        g, rng_for(seed, 1))
    pool = importlib.import_module(
        f"mapbench.gen.{traffic['generator']}").make(
        traffic, config["mode"], genome, rng_for(seed, 2))
    sample = np.sort(rng_for(seed, 3).choice(
        len(pool), size=min(int(traffic["sample_reads"]), len(pool)),
        replace=False))
    return dict(genome=genome, pool=pool, sample=sample)


def write_fasta(path: str, name: str, codes: np.ndarray,
                width: int = 80) -> None:
    """The genome as FASTA, `width` bases a line."""
    n = len(codes)
    rows = -(-n // width)
    body = np.full((rows, width + 1), ord("\n"), np.uint8)
    chars = np.full(rows * width, ord("\n"), np.uint8)
    chars[:n] = _LS_CHARS[codes]
    body[:, :width] = chars.reshape(rows, width)
    out = body.tobytes()
    tail = rows * width - n          # short last line: drop its padding
    if tail:
        out = out[:-(tail + 1)] + b"\n"
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(out)


# ---------------------------------------------------------- the child's IO
def fasta_template(pool: list, paired: bool):
    """The pool as one FASTA buffer, an entry a record (a pair: two), each
    name `NAME_DIGITS` digits to be written over; and the index of every
    name digit in the buffer, [records, NAME_DIGITS]."""
    parts, offs, pos = [], [], 0
    blank = b"0" * NAME_DIGITS
    for item in pool:
        for j, seq in enumerate(item if paired else (item,)):
            head = b">" + blank + (b"/%d" % (j + 1) if paired else b"") \
                + b"\n"
            offs.append(pos + 1)
            parts += (head, seq, b"\n")
            pos += len(head) + len(seq) + 1
    buf = np.frombuffer(b"".join(parts), np.uint8).copy()
    return buf, np.asarray(offs, np.int64)[:, None] + np.arange(NAME_DIGITS)


def name_digits(nums: np.ndarray) -> np.ndarray:
    """Read numbers as `NAME_DIGITS` ASCII digits each, zero-padded."""
    out = np.empty((len(nums), NAME_DIGITS), np.uint8)
    x = nums.astype(np.int64)
    for j in range(NAME_DIGITS - 1, -1, -1):
        out[:, j] = x % 10 + 48
        x //= 10
    return out


class Feeder(threading.Thread):
    """Writes the reads, pool entry n % pool as read n, without end: the
    pool's FASTA is encoded once, and each pass over it only writes the
    pass's read numbers into the names."""

    def __init__(self, fd: int, pool: list, paired: bool):
        super().__init__(daemon=True)
        self.fd, self.P = fd, len(pool)
        self.mates = 2 if paired else 1
        self.buf, self.name_at = fasta_template(pool, paired)
        self.stop = threading.Event()
        self.error = None

    def run(self) -> None:
        view = memoryview(self.buf)
        first = np.arange(self.P, dtype=np.int64)
        try:
            for n0 in itertools.count(0, self.P):
                self.buf[self.name_at] = name_digits(
                    np.repeat(first + n0, self.mates))
                off = 0
                while off < len(self.buf):
                    if self.stop.is_set():
                        return
                    off += os.write(self.fd, view[off:off + FEED_BYTES])
        except OSError as exc:
            if not self.stop.is_set():
                self.error = repr(exc)


class Collector(threading.Thread):
    """Reads the SAM: the arrival time of each piece with the highest
    read number complete after it, and every record of a sampled read.
    Names are the feed's `NAME_DIGITS` digits, so a piece's read numbers
    are read as one array."""

    def __init__(self, fd: int, pool_size: int, sample: np.ndarray):
        super().__init__(daemon=True)
        self.fd = fd
        self.P = pool_size
        self.sampled = np.zeros(pool_size, bool)
        self.sampled[sample] = True
        self.pieces = []          # (perf_counter, highest read number)
        self.records = {}         # read number -> [record without QNAME]
        self.top = -1
        self.lock = threading.Lock()
        self.error = None

    def run(self) -> None:
        rest = b""
        W = NAME_DIGITS
        cols = np.arange(W)
        scale = 10 ** np.arange(W - 1, -1, -1, dtype=np.int64)
        try:
            while True:
                data = os.read(self.fd, 4 * PIPE_BYTES)
                if not data:
                    return
                t = time.perf_counter()
                data = rest + data
                cut = data.rfind(b"\n") + 1
                rest = data[cut:]
                if not cut:
                    continue
                arr = np.frombuffer(data, np.uint8, cut)
                ends = np.flatnonzero(arr == 10)
                starts = np.concatenate(([0], ends[:-1] + 1))
                rec = arr[starts] != ord("@")
                starts, ends = starts[rec], ends[rec]
                if not len(starts):
                    continue
                if (ends - starts <= W).any() or \
                        (arr[starts + W] != ord("\t")).any():
                    raise ValueError("a SAM record whose QNAME is not "
                                     f"{W} digits")
                n = (arr[starts[:, None] + cols].astype(np.int64) - 48) \
                    @ scale
                for i in np.flatnonzero(self.sampled[n % self.P]):
                    self.records.setdefault(int(n[i]), []).append(
                        data[starts[i] + W + 1:ends[i]].decode())
                with self.lock:
                    self.top = int(n[-1])
                    self.pieces.append((t, self.top))
        except Exception as exc:    # reported by the harness
            self.error = repr(exc)

    def done(self) -> int:
        with self.lock:
            return self.top


def window_ends(pieces, per_window: int, t0: float, t1: float):
    """(time, CLI window k) of each CLI window whose last SAM arrived in
    [t0, t1]: the arrival of the last piece whose highest read number
    lies in [k * per_window, (k + 1) * per_window). The CLI maps its
    input in windows of `per_window` reads (pairs) and writes each
    window's SAM in order, so that piece completes window k; a window
    counts once a later window's SAM has been seen (its last reads may
    write nothing)."""
    ends = {}
    for t, top in pieces:
        ends[top // per_window] = t
    last = max(ends, default=-1)
    return sorted((t, k) for k, t in ends.items()
                  if k < last and t0 <= t <= t1)


class HostSampler:
    """Samples, while the window runs, what the host gives the map CLI:
    its CPU seconds and resident memory (/proc/<pid>), the machine's CPU
    time stolen by the hypervisor and left idle (/proc/stat), and the
    harness's own CPU seconds (its feed and SAM reading)."""

    def __init__(self, pid: int):
        self.pid = pid
        self.tick = os.sysconf("SC_CLK_TCK")
        # (t, child cpu s, rss MiB, steal, idle, all, harness cpu s)
        self.rows = []

    def sample(self) -> None:
        try:
            with open(f"/proc/{self.pid}/stat") as f:
                st = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{self.pid}/statm") as f:
                rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
            with open("/proc/stat") as f:
                cpu = [int(x) for x in f.readline().split()[1:]]
        except (OSError, IndexError, ValueError):
            return
        self.rows.append((time.perf_counter(),
                          (int(st[11]) + int(st[12])) / self.tick,
                          rss / 2**20, cpu[7] if len(cpu) > 7 else 0,
                          cpu[3], sum(cpu[:8]), time.process_time()))

    def memory_peak_mib(self) -> "float | None":
        """The CLI's largest resident memory sampled in the window, in
        MiB (`/proc/<pid>/statm`, every `SAMPLE_S`; not every kernel
        gives a process's VmHWM, and it would hold the set-up's peak)."""
        return max((r[2] for r in self.rows), default=None)

    def quarters(self) -> list:
        """Per quarter of the window: (the CLI's CPUs busy, steal %,
        idle %, resident MiB at its end, the harness's CPUs busy)."""
        r = self.rows
        if len(r) < 5:
            return []
        cut = [r[round(i * (len(r) - 1) / 4)] for i in range(5)]
        out = []
        for a, b in zip(cut, cut[1:]):
            tot = max(b[5] - a[5], 1)
            dt = b[0] - a[0]
            out.append((round((b[1] - a[1]) / dt, 3),
                        round(100 * (b[3] - a[3]) / tot, 2),
                        round(100 * (b[4] - a[4]) / tot, 2), round(b[2]),
                        round((b[6] - a[6]) / dt, 3)))
        return out


def power_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                            "clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


# ---------------------------------------------------------------- one run
def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             child_module: str = "mapbench.child") -> dict:
    """One run of one cell. `device`, `overrides` (keys of the
    configuration's genome and of the traffic) and `child_module` are for
    the tests, which drive a run on the CPU at a small size."""
    spec = load_cell(workload)
    config, traffic = spec["config"], dict(spec["traffic"])
    config = dict(config, genome=dict(config["genome"]))
    for k, v in (overrides or {}).items():
        (config["genome"] if k in config["genome"] else traffic)[k] = v
    paired = "insert" in traffic
    per_read = 2 if paired else 1
    work = tempfile.mkdtemp(prefix="mapbench-")
    all_cpus, child_cpus, own_cpus = split_cpus()
    child = feeder = None
    try:
        t0 = time.perf_counter()
        inp = make_inputs(config, traffic, seed)
        fa = os.path.join(work, "genome.fa")
        write_fasta(fa, config["contig"], inp["genome"])
        log(f"mapbench: inputs made in {time.perf_counter() - t0:.3f} s "
            f"({len(inp['genome'])} bp genome, pool of {len(inp['pool'])})")
        report = os.path.join(work, "report.json")
        ctl_r, ctl_w = os.pipe()
        args = [sys.executable, "-m", child_module, "--report", report,
                "--control", str(ctl_r)]
        if trace:
            args += ["--trace", work]
        args += ["--", "--device", device, "--no-autodetect-input",
                 *config["cli"], *traffic["cli"], "-", fa]
        env = dict(os.environ, PYTHONPATH=ROOT, USE_FLAX="0",
                   USE_TF="0", USE_JAX="0")
        err_path = os.path.join(work, "child.err")
        with open(err_path, "wb") as err:
            os.sched_setaffinity(0, child_cpus)     # the child inherits it
            try:
                child = subprocess.Popen(args, cwd=ROOT, env=env,
                                         stdin=subprocess.PIPE,
                                         stdout=subprocess.PIPE, stderr=err,
                                         pass_fds=(ctl_r,))
            finally:
                os.sched_setaffinity(0, own_cpus)
        log(f"mapbench: map CLI on CPUs {sorted(child_cpus)}, the harness "
            f"on {sorted(own_cpus)}")
        os.close(ctl_r)
        ctl = os.fdopen(ctl_w, "w")
        for f in (child.stdin, child.stdout):
            try:
                fcntl.fcntl(f.fileno(), 1031, PIPE_BYTES)  # F_SETPIPE_SZ
            except OSError:
                pass
        feeder = Feeder(child.stdin.fileno(), inp["pool"], paired)
        coll = Collector(child.stdout.fileno(), len(inp["pool"]),
                         inp["sample"])
        feeder.start()
        coll.start()

        def alive() -> None:
            if child.poll() is not None or coll.error or feeder.error:
                raise RuntimeError(
                    f"the map CLI ended (rc {child.poll()}, "
                    f"{coll.error or feeder.error}):\n{_tail(err_path)}")

        def command(cmd: str) -> None:
            ctl.write(cmd + "\n")
            ctl.flush()

        def wait_for(path: str, limit: float) -> None:
            """Until the child writes `path`, or its report (which it
            writes at once on a failure)."""
            deadline = time.perf_counter() + limit
            while not (os.path.exists(path) or os.path.exists(report)):
                alive()
                if time.perf_counter() > deadline:
                    raise RuntimeError(f"the child wrote no {path}")
                time.sleep(0.02)

        warm = int(traffic["warmup_reads"]) // per_read
        deadline = time.perf_counter() + SETUP_LIMIT_S
        while coll.done() + 1 < warm:
            alive()
            if time.perf_counter() > deadline:
                raise RuntimeError(f"warm-up not done in {SETUP_LIMIT_S} s")
            time.sleep(0.02)
        command("open")
        t_open = time.perf_counter()
        setup_s = t_open - T_START
        host = HostSampler(child.pid)
        while time.perf_counter() < t_open + seconds:
            alive()
            if not host.rows or \
                    time.perf_counter() > host.rows[-1][0] + SAMPLE_S:
                host.sample()
            time.sleep(0.02)
        host.sample()
        t_close = time.perf_counter()
        memory_peak_mib = host.memory_peak_mib()
        if memory_peak_mib is None:
            raise RuntimeError("the map CLI's resident memory could not "
                               "be read")
        if trace:
            # a second span of `seconds` under the profiler, once it runs:
            # the host stages are read from the first, untraced span
            command("trace")
            wait_for(report + ".traced", 240)
            t_traced = time.perf_counter()
            while time.perf_counter() < t_traced + seconds:
                alive()
                time.sleep(0.02)
        command("close")
        wait_for(report, 240)
        with open(report) as f:
            rep = json.load(f)
        feeder.stop.set()
        _end(child, feeder)
        child = None
        coll.join(30)
        os.sched_setaffinity(0, all_cpus)
        if "error" in rep:
            raise RuntimeError(f"child: {rep['error']}")
        per_window = CLI_WINDOW_READS // per_read
        win = window_ends(coll.pieces, per_window, t_open, t_close)
        if len(win) < 2:
            raise RuntimeError(f"{len(win)} CLI windows ended in the "
                               "window: too few to time")
        (t_a, k_a), (t_b, k_b) = win[0], win[-1]
        reads = (k_b - k_a) * per_window * per_read
        pieces = sum(1 for t, _ in coll.pieces if t_a < t <= t_b)
        out = dict(workload=workload, seed=seed, setup_s=setup_s,
                   reads_per_s=reads / (t_b - t_a), reads=reads,
                   host_memory_peak_mib=memory_peak_mib,
                   cli_windows=len(win), pieces=pieces,
                   window_ends=[t - t_a for t, _ in win],
                   host=host.quarters(),
                   window=((k_a + 1) * per_window, (k_b + 1) * per_window),
                   report=rep,
                   inputs=inp, config=config, traffic=traffic,
                   err_path=err_path, spec=spec, work=work,
                   trace=trace, records=coll.records)
        out["child_log"] = _tail(err_path, 400)
        return out
    finally:
        if child is not None:
            _end(child, feeder)
        os.sched_setaffinity(0, all_cpus)
        if not trace:
            shutil.rmtree(work, ignore_errors=True)


def split_cpus():
    """(all, the map CLI's, the harness's) CPU sets: the harness takes
    one CPU of its own where there are four or more, so that its feed and
    SAM reading never take time from the program's threads."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 4:
        return set(cpus), set(cpus), set(cpus)
    return set(cpus), set(cpus[:-1]), {cpus[-1]}


def _end(child, feeder=None) -> None:
    """End the child and wait for it, and for the feeder before its pipe
    is closed."""
    if child.poll() is None:
        child.kill()
    if feeder is not None:
        feeder.stop.set()
        feeder.join(30)
    try:
        child.stdin.close()
    except OSError:
        pass
    child.wait(60)


def _tail(path: str, n: int = 25) -> str:
    try:
        with open(path, "rb") as f:
            lines = f.read().decode(errors="replace").splitlines()
        return "\n".join(lines[-n:])
    except OSError:
        return ""


# ------------------------------------------------------------ correctness
def check_output(run: dict) -> dict:
    """Judge every occurrence, inside the window, of the sampled pool
    entries against the reference's records: how many were seen, how
    many differ, and the first that differs."""
    from mapbench import reference
    inp, P = run["inputs"], len(run["inputs"]["pool"])
    lo, hi = run["window"]
    want = reference.expected_records(run["config"], run["traffic"],
                                      inp["genome"],
                                      [inp["pool"][i] for i in inp["sample"]])
    want = dict(zip(inp["sample"].tolist(), want))
    bad = seen = 0
    first_bad = None
    for n in range(lo, hi):
        k = n % P
        if k not in want:
            continue
        seen += 1
        got = run["records"].get(n, [])
        if got != want[k]:
            bad += 1
            if first_bad is None:
                first_bad = (n, got, want[k])
    return dict(seen=seen, bad=bad, first_bad=first_bad)


# ----------------------------------------------------------- trace reading
def layer_metrics(run: dict, summary: dict) -> dict:
    """The per-layer metrics: host stages over the untraced window
    (`open` to `host_close`), the device over the traced span."""
    rep = run["report"]
    ctx = dict(open=rep["open"], close=rep["host_close"], trace=summary,
               config=run["config"], traffic=run["traffic"],
               reads_per_s=run["reads_per_s"])
    out = {}
    for m in run["spec"]["per_layer"]:
        mod = metrics_load(m["name"])
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mapbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch
    spec = load_cell(a.workload)
    need = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"mapbench: the cell needs {need} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, "
            f"count: {torch.cuda.device_count()}")
        return 2
    log(f"mapbench: card {power_line()}")
    run = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    return finish(run)


def finish(run: dict) -> int:
    """Judge the run, print the stderr lines and the result line."""
    rep = run["report"]
    o, c = rep["open"], rep["close"]
    d_reads = c["stats"]["reads"] - o["stats"]["reads"]
    d_win = c["stats"]["vec_invocs"] - o["stats"]["vec_invocs"]
    for line in run["child_log"].splitlines():
        if line.startswith("Loaded genome in"):
            log(f"mapbench: index build (the CLI's genome load): {line}")
    log(f"mapbench: SAM chunks in the window {run['pieces']} over "
        f"{run['cli_windows'] - 1} whole CLI windows, read numbers "
        f"{run['window'][0]}..{run['window'][1] - 1} ({run['reads']} "
        f"reads)")
    log("mapbench: CLI window ends, s after the first: "
        + " ".join(f"{t:.3f}" for t in run["window_ends"][1:]))
    log("mapbench: host by quarter of the window (the CLI's CPUs busy, "
        "steal %, idle %, the CLI's resident MiB, the harness's CPUs "
        f"busy): {run['host']}")
    log(f"mapbench: windows per read {d_win / max(d_reads, 1):.3f} "
        f"({d_win} vector-SW windows, {d_reads} reads in the window)")
    log(f"mapbench: peak device memory {rep['device']['memory_peak_bytes']}"
        f" bytes; the CLI's largest resident memory sampled in the window "
        f"{run['host_memory_peak_mib']} MiB")
    metrics, breakdown, device = {}, None, dict(platform="gpu",
                                                **rep["device"])
    if run["trace"]:
        summary = trace_summary(run["report"])
        for line in summary["notes"]:
            log(f"mapbench: {line}")
        metrics = layer_metrics(run, summary)
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = summary["breakdown"]
        shutil.rmtree(run["work"], ignore_errors=True)
    else:
        for m in run["spec"]["end_to_end"]:
            metrics[m["name"]] = {"value": run[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    jax_here = sorted({m.split(".")[0] for m in list(sys.modules)
                       if m.split(".")[0] in JAX_NAMES})
    jax_child = rep.get("jax_modules", [])
    if jax_here or jax_child:
        log(f"mapbench: JAX modules loaded: harness {jax_here}, "
            f"map CLI {jax_child}")
        return 4
    t0 = time.perf_counter()
    try:
        res = check_output(run)
    except NotImplementedError as exc:
        log(f"mapbench: no reference: {exc}")
        res = dict(seen=0, bad=0, first_bad=None)
    log(f"mapbench: reference over {res['seen']} sampled reads in "
        f"{time.perf_counter() - t0:.1f} s")
    if res["first_bad"] is not None:
        n, got, want = res["first_bad"]
        log(f"mapbench: read {n} differs:\n  got  {got}\n  want {want}")
    checks = {"sampled_reads_wrong": {"value": res["bad"], "limit": 0},
              "sampled_reads_seen": {"value": res["seen"], "limit": 1}}
    correct = res["bad"] == 0 and res["seen"] >= 1
    for k, v in checks.items():
        rel = "<=" if k.endswith("wrong") else ">="
        log(f"check {k} {v['value']} {rel} {v['limit']}")
    line = {"correct": correct, "attempted": run["reads"],
            "failed": res["bad"], "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
