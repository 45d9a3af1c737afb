"""One run of one cell: set-up, the measured window, the traced numbers
and the reference's verdict.

A job is ``fastga_tpu_torch.cli.fastga.main(argv)``, the in-process form
of ``fastga A B`` (or ``fastga A`` for a mix of one genome a job): the
traffic mix's flags and the FASTA files that set-up wrote under TMPDIR,
PAF from stdout into a file, ``-1:`` to a .1aln file.
The window is a closed loop: jobs run back to back, each on the next of
the mix's pairs, until ``seconds`` have passed; the job running then is
finished and counted.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import time
import traceback

from . import gen, spec, trace

GIB = float(1 << 30)
INDEX_SUFFIXES = (".1gdb", ".gix", ".1ano", ".bps")
FORBIDDEN = ("jax", "jaxlib", "flax", "fastga_tpu")


def log(msg):
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Runner:
    """Set-up state of a run: the pairs' files and the job loop."""

    def __init__(self, workload, seed, device, root):
        self.cell, self.config, self.traffic, self.bench = spec.cell(
            root, workload)
        self.workload, self.seed = workload, int(seed)
        self.device = device
        self.work = tempfile.mkdtemp(prefix="fastga_bench_",
                                     dir=tempfile.gettempdir())
        self.inputs = os.path.join(self.work, "in")
        self.outs = os.path.join(self.work, "out")
        os.makedirs(self.inputs)
        os.makedirs(self.outs)
        self.pairs = []
        self.njobs = 0

    def close(self):
        shutil.rmtree(self.work, ignore_errors=True)

    def write_pairs(self):
        gen_cfg = self.config["generator"]
        for k in range(int(self.traffic["pairs"])):
            p = gen.make_pair(gen_cfg, self.seed, k)
            self.pairs.append(gen.write_pair(p, self.inputs, f"p{k}"))
        warm = gen.make_pair(self.config["warmup"], self.seed, 1 << 20)
        self.warm = gen.write_pair(warm, self.inputs, "warm")

    def truth(self, k):
        return gen.make_pair(self.config["generator"], self.seed, k)

    def job(self, files, name):
        """Run one job; returns its record (start, end, output file)."""
        from fastga_tpu_torch.cli import fastga
        form = self.traffic["output"]
        out = os.path.join(self.outs, name)
        argv = list(self.config.get("options", [])) + list(
            self.traffic.get("flags", []))
        if form == "1aln":
            argv.append(f"-1:{out}.1aln")
        argv += list(files)[:int(self.traffic.get("genomes", 2))]
        stdout_file = out + (".paf" if form == "paf" else ".stdout")
        c0 = time.process_time()
        t0 = time.perf_counter()
        with open(stdout_file, "w") as f, contextlib.redirect_stdout(f):
            rc = fastga.main(argv, device=self.device)
        self.sync()
        t1 = time.perf_counter()
        cpu = time.process_time() - c0
        stray = [n for n in os.listdir(self.inputs)
                 if n.endswith(INDEX_SUFFIXES)]
        return dict(start=t0, end=t1, cpu=cpu, rc=rc, stray=len(stray),
                    form=form,
                    out=out + (".1aln" if form == "1aln" else ".paf"))

    def sync(self):
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()


def run(root, workload, seed, seconds, traced, device=None, t_start=None):
    """Run the cell; returns the result dict (the JSON line) and whether
    it may be printed (False: a forbidden module was loaded)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device is None
    dev = torch.device("cuda" if on_card else device)
    from fastga_tpu_torch.cli import fastga  # noqa: F401  (the program)
    if on_card:
        from fastga_tpu_torch import native
        from fastga_tpu_torch.ops import cuda_build
        cuda_build.build_kernels()
        native.get_tracerec()
    r = Runner(workload, seed, None if on_card else device, root)
    try:
        return _run(r, seconds, traced, dev, on_card, t_start)
    finally:
        r.close()


def _run(r, seconds, traced, dev, on_card, t_start):
    import torch
    r.write_pairs()
    power = _power_limit() if on_card else "not measured (no card)"
    log(f"bench: {r.workload} seed {r.seed}: {len(r.pairs)} pairs, "
        f"card {torch.cuda.get_device_name(0) if on_card else 'none'}, "
        f"power limit {power}")
    warm = r.job(r.warm, "warm")
    if warm["rc"]:
        raise RuntimeError(f"warm-up job exited {warm['rc']}")
    r.sync()
    setup_s = time.perf_counter() - t_start

    rec = kb = prof = None
    if traced:
        mods = {m["name"]: spec.metric(m["name"])
                for m in r.bench["per_layer"]}
        rec, kb = trace.Recorder(), trace.KernelBounds(mods)
        rec.install()
        kb.install()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    host0 = None
    if traced and on_card:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        torch.cuda.synchronize()
        host0 = time.perf_counter()
        torch.cuda._sleep(1000)          # the window's first device event
        torch.cuda.synchronize()
    jobs, failed = [], 0
    w0 = time.perf_counter()
    deadline = w0 + seconds
    while time.perf_counter() < deadline:
        k = r.njobs % len(r.pairs)
        try:
            if rec is not None:
                with rec.span(trace.JOB):
                    j = r.job(r.pairs[k], f"job{r.njobs}")
            else:
                j = r.job(r.pairs[k], f"job{r.njobs}")
        except Exception:                # a job that fails ends the window
            log(traceback.format_exc())
            failed += 1
            r.njobs += 1
            break
        j["pair"] = k
        jobs.append(j)
        r.njobs += 1
        if j["rc"]:
            failed += 1
            break
    r.sync()
    w1 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    if rec is not None:
        rec.remove()
        kb.remove()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    n = len(jobs)
    walls = [j["end"] - j["start"] for j in jobs]
    log(f"bench: {n} jobs, walls " + " ".join(f"{w:.3f}" for w in walls)
        + "; host cpu s " + " ".join(f"{j['cpu']:.3f}" for j in jobs))
    first = jobs[0]["start"] if jobs else w0
    last = jobs[-1]["end"] if jobs else w1

    metrics = {}
    device = dict(platform="gpu" if on_card else "cpu",
                  kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                  count=int(r.cell["chips"]), memory_peak_bytes=int(peak),
                  power_limit=power)
    breakdown = None
    if not traced and n:
        e2e = dict(job_s=(last - first) / n, peak_dev_gib=peak / GIB,
                   setup_s=setup_s)
        for m in r.bench["end_to_end"]:
            if m["name"] in e2e:
                metrics[m["name"]] = dict(value=e2e[m["name"]],
                                          unit=m["unit"])
    elif traced and n:
        summ = None
        if prof is not None:
            summ = trace.summarize(prof, host0, (first, last), rec,
                                   kb.patterns())
            del prof
        ctx = Context(n, rec, kb, summ, first, last)
        for m in r.bench["per_layer"]:
            v = mods[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        if summ is not None:
            device.update(busy_s=summ["busy_s"], window_s=last - first)
            breakdown = dict(device_ops=summ["device_ops"],
                             idle_gaps=summ["idle_gaps"])

    # the reference, once the window has closed and the peak is read
    if on_card:
        torch.cuda.empty_cache()
    checks, info = verdict(r, jobs, dev)
    lim = spec.limits()
    ok = (n > 0 and failed == 0
          and all(checks[k] <= lim[k] for k in checks))
    result = dict(correct=bool(ok), attempted=n + failed, failed=failed,
                  metrics=metrics, device=device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    log(f"bench: reference: {info}")
    result["checks"] = {k: dict(value=v, limit=lim[k])
                        for k, v in checks.items()}
    for k, v in checks.items():
        log(f"check {k} {v} limit {lim[k]}")
    return result


def verdict(r, jobs, dev):
    """The reference's numbers over every job of the window."""
    from reference import judge
    t0 = time.perf_counter()
    rules = dict(options=list(r.config.get("options", []))
                 + list(r.traffic.get("flags", [])), seed=r.seed,
                 self=int(r.traffic.get("genomes", 2)) == 1)
    todo = [dict(pair=j["pair"], a_fa=r.pairs[j["pair"]][0],
                 b_fa=r.pairs[j["pair"]][0 if rules["self"] else 1],
                 out=j["out"], form=j["form"]) for j in jobs]
    num, info = judge.judge(todo, rules, r.truth, dev)
    num["stray_files"] = sum(j["stray"] for j in jobs)
    info["seconds"] = round(time.perf_counter() - t0, 3)
    return num, info


class Context:
    """What a per-layer metric reader reads."""

    def __init__(self, jobs, rec, kb, summ, first, last):
        self.jobs = jobs
        self.rec = rec
        self.least_s = kb.least if kb is not None else {}
        self.kernel_s = summ["kernel_s"] if summ else {}
        self.busy_s = summ["busy_s"] if summ else None
        self.window_s = last - first

    def span_s(self, *names):
        """Seconds a job under the spans ``names`` (None if none ran)."""
        if not any(self.rec.count(n) for n in names):
            return None
        return self.rec.total(names) / self.jobs

    def roofline(self, metric):
        """Percent of the device time of the metric's kernel that its least
        time takes."""
        dev_s = self.kernel_s.get(metric)
        least = self.least_s.get(metric)
        if not dev_s or not least:
            return None
        return 100.0 * least / dev_s


def _power_limit():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"
