"""Driver of the ConAN training cells: set-up, the checked steps, the
measured window and the correctness check of ``conan_fgw_tpu_torch``'s
two-stage runner in stage 2 (``conan_fgw``).

Set-up: the configuration's YAML through ``train.config.load_config``, the
model and settings from ``train.runner.build_model`` / ``build_settings``,
the weights written over the model's from the benchmark's own draw
(``references/<reference>.py::make_weights``), the traffic generated from
the seed, one ``StepGraphs`` from ``train.loop.step_graphs``, and warm
epochs of ``train.loop._train_epoch`` until an epoch captures no new graph.

The checked steps go through ``StepGraphs.train`` fed by
``train.loop.step_batches`` (the native packer on its prefetch thread,
pinned slots), from the weights and Adam's state set back to the draw (in
place, so the captured graphs stay valid): a sequence of three steps, on
the first batches of the epoch's buckets in turn, every row a different
molecule (their losses and the weights' change after the third), then
first steps, each from the reset state on a batch of its own, up to
``FIRST_PER_BUCKET`` of every bucket (their losses, and of each bucket's
first one the gradient from Adam's first moment). The same object then
runs the window.

The window: ``_train_epoch`` back to back, each epoch the native packer,
pinned slots, a graph replay per batch and a synchronise at each bucket's
end, until the first step boundary after ``seconds``, closed by a
synchronise. ``StepGraphs.train`` is wrapped: the wrapper takes the host
times around each call and records a CUDA event after it, and nothing is
synchronised per step. With ``trace``, ``torch.profiler`` covers
``TRACE_EPOCHS`` whole epochs after 40% of the window.

After the window the program's state is freed and the plain reference
follows the checked steps from the same weights and molecules.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import core, traffic as traffic_lib

CHECK_STEPS = 3
FIRST_PER_BUCKET = 4
TRACE_AFTER = 0.4  # share of the window before the traced epochs
TRACE_EPOCHS = 3
MARGIN_S = 0.05    # the profiler loses its window's first records


class StopWindow(Exception):
    pass


def yaml_text(raw: dict) -> str:
    """The configuration's YAML keys as the subset ``parse_yaml`` reads."""
    def scalar(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, float):
            s = repr(v)
            return s if "e" not in s else f"{v:.12f}".rstrip("0")
        if isinstance(v, str):
            return f"'{v}'" if any(c in v for c in ":#[]{},") else v
        return str(v)
    lines = []
    for k, v in raw.items():
        if isinstance(v, list):
            lines.append(f"{k}: [{', '.join(scalar(x) for x in v)}]")
        elif isinstance(v, dict):
            lines.append(f"{k}: {{{', '.join(f'{a}: {scalar(b)}' for a, b in v.items())}}}")
        else:
            lines.append(f"{k}: {scalar(v)}")
    return "\n".join(lines) + "\n"


class Session:
    """The program's objects of one run and the benchmark's inputs."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, mols=None):
        from conan_fgw_tpu_torch.data.datasets import class_weight_ratio
        from conan_fgw_tpu_torch.data.packing import MoleculeRecord
        from conan_fgw_tpu_torch.ops.cuda import launches
        from conan_fgw_tpu_torch.train import loop, runner
        from conan_fgw_tpu_torch.train.config import load_config

        self.cfg, self.seed = cfg, seed
        self.dev = torch.device(device)
        self.launches = launches
        self.ref = core.module("references", cfg["reference"])
        self.counts = core.module("counts", cfg["counts"])
        self.phases = {}
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / f"{cfg['name']}.yaml"
            path.write_text(yaml_text(cfg["yaml"]))
            config = load_config(str(path))
        self.mols = mols if mols is not None else traffic_lib.generate(
            traffic, seed, cfg["yaml"]["num_conformers"], self.dev)
        self.records = [MoleculeRecord(z=m.z, pos=m.pos, x2d=m.x2d, bonds=m.bonds,
                                       bond_attr=m.bond_attr, y=m.y) for m in self.mols]
        self.phases["data_s"] = time.perf_counter() - t
        t = time.perf_counter()
        task = config.spec.task
        self.scale = None
        if task == "classification":
            self.scale = class_weight_ratio([{"y": r.y} for r in self.records])
        self.model = runner.build_model(config, seed=0, device=self.dev)
        self.settings = runner.build_settings(config, runner.STAGE_BC, self.scale)
        if task != cfg["task"] or not self.settings.use_barycenter:
            raise ValueError(f"{cfg['name']}: the runner builds a {task} model"
                             f" (barycenter {self.settings.use_barycenter})")
        self.phases["model_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.weights = self.ref.make_weights(cfg, seed, self.dev)
        self._check_weights()
        self.load_weights()
        self.optimizer = loop.make_optimizer(self.model, self.settings)
        self.graphs = loop.step_graphs(self.model, self.optimizer, self.settings, self.dev)
        self.max_atoms = self.settings.max_atoms or loop.dataset_max_atoms(self.records)
        self.batches = traffic_lib.epoch_batches(self.mols, self.settings.batch_size)
        self.phases["weights_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.edges = self.counts.edges(self.mols, cfg, self.dev)
        self.phases["counts_s"] = time.perf_counter() - t
        self.loop = loop

    def _check_weights(self):
        have = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
        want = {n: tuple(w.shape) for n, w in self.weights.items()}
        if have != want:
            raise ValueError(f"{self.cfg['name']}: the program's parameters differ from the"
                             f" reference's: {sorted(set(have.items()) ^ set(want.items()))[:8]}")

    def load_weights(self):
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(self.weights[name])

    def reset(self):
        """Weights and Adam's state back to the draw, in place."""
        self.load_weights()
        with torch.no_grad():
            for state in self.optimizer.state.values():
                for key in ("exp_avg", "exp_avg_sq", "step"):
                    state[key].zero_()

    def epoch(self, epoch: int):
        return self.loop._train_epoch(self.graphs, self.records, self.settings, self.max_atoms,
                                      self.dev, epoch)

    def captured(self) -> int:
        return sum(step.graph is not None for step in self.graphs.steps.values())

    def warm(self):
        """Epochs until one captures no new graph; the first one's batches
        are checked against the batching rule of ``traffic.epoch_batches``."""
        t = time.perf_counter()
        seen, orig = [], self.graphs.train

        def spy(pb):
            seen.append((pb.max_atoms, pb.y[pb.mol_mask].copy()))
            return orig(pb)

        self.graphs.train = spy
        try:
            self.epoch(0)
        finally:
            self.graphs.train = orig
        want = [(N, np.asarray([self.mols[i].y for i in idx], np.float32)) for N, idx in self.batches]
        if len(seen) != len(want) or any(a[0] != b[0] or not np.array_equal(a[1], b[1])
                                         for a, b in zip(seen, want)):
            raise RuntimeError("the program's batches differ from the benchmark's batching rule")
        epoch = 1
        while True:
            before = self.captured()
            self.epoch(epoch)
            epoch += 1
            if self.captured() == before:
                break
        self.sync()
        self.phases["warm_s"] = time.perf_counter() - t
        return epoch

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # ------------------------------------------------------------ checked steps
    def check_plan(self):
        """The checked steps' batches, each a batch of the unshuffled epoch:
        the sequence (the first batches of the buckets in the epoch's order,
        then their second ones, to ``CHECK_STEPS``), and for first steps up
        to ``FIRST_PER_BUCKET`` batches of every bucket."""
        by: dict = {}
        for b in self.batches:
            by.setdefault(b[0], []).append(b)
        seq = [bs[j] for j in range(CHECK_STEPS) for bs in by.values() if j < len(bs)]
        order = list(by)
        # the loader groups a feed's molecules by bucket, in first-seen order
        seq = sorted(seq[:CHECK_STEPS], key=lambda b: order.index(b[0]))
        return seq, [b for bs in by.values() for b in bs[:FIRST_PER_BUCKET]]

    @contextlib.contextmanager
    def _feed(self, batches):
        """The window's feed over ``batches``' molecules, each packed batch
        checked against the plan (its bucket and labels)."""
        records = [self.records[i] for _, idx in batches for i in idx]
        with self.loop.step_batches(records, self.settings, self.max_atoms, self.graphs) as it:
            def checked():
                for k, pb in enumerate(it):
                    N, idx = batches[k]
                    want = np.asarray([self.mols[i].y for i in idx], np.float32)
                    if pb.max_atoms != N or not np.array_equal(pb.y[pb.mol_mask], want):
                        raise RuntimeError(f"checked step {k}: the program's batch differs"
                                           " from the plan")
                    yield pb
            yield checked()

    def first_grad(self, names) -> dict:
        """Leaf norms of the first gradient as Adam got it: its first moment
        after one step over 1 - beta1."""
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        out = {names[id(p)]: float(torch.linalg.vector_norm(state["exp_avg"]) / (1.0 - beta1))
               for p, state in self.optimizer.state.items()}
        return {n: out.get(n, 0.0) for n in names.values()}

    def checked_steps(self) -> dict:
        """Through the window's call and feed, from the reset state: the
        sequence's three steps (their losses, the leaves' change after the
        third), then the first steps, each from the reset state on its own
        batch (their losses, and per bucket the first gradient's leaf
        norms of its first step)."""
        seq, first = self.check_plan()
        names = dict((id(p), n) for n, p in self.model.named_parameters())
        out = {"losses": [], "change": {}, "first_losses": [], "grads": {}}
        self.reset()
        with self._feed(seq) as it:
            for pb in it:
                loss, _ = self.graphs.train(pb)
                out["losses"].append(float(loss))
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                out["change"][name] = float(torch.linalg.vector_norm(p - self.weights[name]))
        with self._feed(first) as it:
            for pb in it:
                self.reset()
                loss, _ = self.graphs.train(pb)
                out["first_losses"].append(float(loss))
                if pb.max_atoms not in out["grads"]:
                    out["grads"][pb.max_atoms] = self.first_grad(names)
        if (len(out["losses"]), len(out["first_losses"])) != (CHECK_STEPS, len(first)):
            raise RuntimeError(f"{len(out['losses'])} + {len(out['first_losses'])} checked steps,"
                               f" want {CHECK_STEPS} + {len(first)}")
        self.sync()
        return out

    def check_inputs(self):
        """The checked steps' molecules as the reference takes them:
        ``(sequence, first steps)``, each ``[(N, molecules), ...]``."""
        return tuple([(N, [self.mols[i] for i in idx]) for N, idx in part]
                     for part in self.check_plan())

    def free(self):
        """Drop the program's state before the reference runs."""
        for name in ("graphs", "optimizer", "model"):
            setattr(self, name, None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


# ------------------------------------------------------------------ the window
class Recorder:
    """Wraps ``StepGraphs.train`` for the window: host time inside each call
    and between calls, an event after each call, and the batch's position
    in its epoch and real molecules."""

    def __init__(self, graphs, dev, seconds: float, trace: bool):
        self.orig, self.dev, self.seconds, self.trace = graphs.train, dev, seconds, trace
        self.cuda = dev.type == "cuda"
        self.host, self.wait, self.pos, self.real, self.losses = [], [], [], [], []
        self.events, self.ends = [], []
        self.position = 0
        self.hold = False  # no stop before and inside the traced epochs
        self.t_return = None
        self._wait_range = None
        self.t0 = None

    def start(self):
        if self.cuda:
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()
        self.t0 = time.perf_counter()
        self.ends.append(self.t0)

    def gap(self):
        """Leave the time to the next call out of ``wait`` (the profiler's
        start and stop between epochs)."""
        self.t_return = None
        self._close_wait()

    def _close_wait(self):
        if self._wait_range is not None:
            self._wait_range.__exit__(None, None, None)
            self._wait_range = None

    def __call__(self, pb):
        t_call = time.perf_counter()
        if self.t_return is not None:
            self.wait.append(t_call - self.t_return)
        self._close_wait()
        self.real.append(int(pb.mol_mask.sum()))
        self.pos.append(self.position)
        self.position += 1
        rf = torch.profiler.record_function("perfbench.step") if self.trace else contextlib.nullcontext()
        with rf:
            out = self.orig(pb)
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        self.losses.append(out[0])
        self.t_return = time.perf_counter()
        self.ends.append(self.t_return)
        self.host.append(self.t_return - t_call)
        if self.trace:
            self._wait_range = torch.profiler.record_function("perfbench.wait")
            self._wait_range.__enter__()
        if not self.hold and self.t_return - self.t0 >= self.seconds:
            self._close_wait()
            raise StopWindow
        return out

    def intervals_ms(self) -> list[float]:
        """Milliseconds between consecutive steps' completions on the device
        (the host's returns on the CPU)."""
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
        return [1e3 * (b - a) for a, b in zip(self.ends, self.ends[1:])]


def run_window(s: Session, seconds: float, trace: bool, first_epoch: int):
    """The window over ``s``; returns ``(recorder, window seconds, trace or
    None)``, the trace ``(chrome trace path, launch-counter deltas)`` of
    ``TRACE_EPOCHS`` whole epochs."""
    rec = Recorder(s.graphs, s.dev, seconds, trace)
    s.graphs.train = rec
    prof = traced = None
    epoch = first_epoch
    rec.hold = trace  # a traced run's window closes after its traced epochs
    rec.start()
    try:
        while True:
            rec.position = 0
            if trace and traced is None and time.perf_counter() - rec.t0 >= TRACE_AFTER * seconds:
                from torch.profiler import ProfilerActivity, profile
                rec.gap()
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
                time.sleep(MARGIN_S)
                before = collections.Counter(s.launches)
                with torch.profiler.record_function("perfbench.epoch"):
                    for _ in range(TRACE_EPOCHS):
                        rec.position = 0
                        s.epoch(epoch)
                        epoch += 1
                rec.hold = False
                rec.gap()
                after = collections.Counter(s.launches)
                time.sleep(MARGIN_S)
                prof.__exit__(None, None, None)
                traced = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            else:
                s.epoch(epoch)
                epoch += 1
    except StopWindow:
        pass
    finally:
        s.graphs.train = rec.orig
    s.sync()
    window_s = time.perf_counter() - rec.t0
    trace_out = None
    if trace:
        path = Path(tempfile.mkdtemp()) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace_out = (path, traced)
    return rec, window_s, trace_out


# ------------------------------------------------------------ the comparison
def step_gaps(prog: dict, ref: dict) -> list:
    """Each first step's loss gap over the larger of its reference loss and
    the median first step's."""
    floor = float(np.median([abs(r) for r in ref["first_losses"]]))
    return [abs(p - r) / max(abs(r), floor) for p, r in zip(prog["first_losses"], ref["first_losses"])]


def gaps(prog: dict, ref: dict, buckets: list) -> dict:
    """The numbers the check can compare. ``loss_q25``: the lower quartile
    over all first steps of a step's loss gap (over the larger of its
    reference loss and the median first step's); ``loss_med.<N>``: bucket N's
    median over its first steps (``buckets``, the N of each) of that gap;
    ``grad_med``: the worst bucket's median leaf of its first
    gradient's norm gap over the larger of the leaf's reference norm and
    the median leaf's; ``change_med``: the median leaf of the change after
    the sequence, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (the others move under Adam by
    rounding alone; the first bucket's gradients decide). Read, not
    compared: ``loss_gap``, the worst first step; ``grad_gap`` and
    ``change_gap``, the worst leaf; ``grad_med.<N>`` of each bucket."""
    def leaves(p: dict, r: dict, keys) -> list:
        med = float(np.median([r[k] for k in keys]))
        return [abs(p[k] - r[k]) / max(r[k], med) for k in keys]

    out = {}
    first = step_gaps(prog, ref)
    grad_all = []
    for N in dict.fromkeys(buckets):
        out[f"loss_med.{N}"] = float(np.median([g for b, g in zip(buckets, first) if b == N]))
        grad = leaves(prog["grads"][N], ref["grads"][N], list(ref["grads"][N]))
        out[f"grad_med.{N}"] = float(np.median(grad))
        grad_all += grad
    g_ref = ref["grads"][buckets[0]]
    med = float(np.median(list(g_ref.values())))
    kept = [k for k, g in g_ref.items() if g >= 1e-3 * med]
    change = leaves(prog["change"], ref["change"], kept)
    out.update(loss_q25=statistics.quantiles(first, n=4)[0], grad_med=max(v for k, v in out.items() if k.startswith("grad_med.")),
               change_med=float(np.median(change)), loss_gap=max(first), grad_gap=max(grad_all),
               change_gap=max(change))
    return out


def reference_steps(s: Session, *, dtype=torch.float64, tf32=False, half=()) -> dict:
    """The plain reference over the checked steps' molecules from the
    benchmark's weights: in ``dtype``, with TF32 products where ``tf32``
    (the control), on the first half of each batch of the buckets in
    ``half`` (a fault: half of the batch left out, the mean over the
    rest)."""
    seq, first = s.check_inputs()
    seq, first = ([(N, mols[: max(1, len(mols) // 2)] if N in half else mols) for N, mols in part]
                  for part in (seq, first))
    scale = 1.0
    if s.cfg["task"] == "classification":
        scale = s.ref.class_scale([m.y for m in s.mols])
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    kw = dict(device=s.dev, dtype=dtype, scale=scale)
    try:
        out = s.ref.train(s.weights, seq, s.cfg, **kw)
        out["first_losses"], out["grads"] = [], {}
        for N, mols in first:
            if N in out["grads"]:
                out["first_losses"] += s.ref.first_losses(s.weights, [(N, mols)], s.cfg, **kw)
                continue
            step = s.ref.train(s.weights, [(N, mols)], s.cfg, **kw)
            out["first_losses"].append(step["losses"][0])
            out["grads"][N] = step["grad"]
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def first_buckets(s: Session) -> list:
    """The bucket N of each first step."""
    return [N for N, _ in s.check_plan()[1]]


# ------------------------------------------------------------------ one run
def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of a cell: set-up, checked steps, window, reference, numbers.
    Returns what the metric readers and the result line need."""
    from conan_fgw_tpu_torch.data import native
    from conan_fgw_tpu_torch.ops.cuda import _build

    if torch.device(device).type == "cuda":
        _build.load_library()
    native.load_library()
    load_s = time.perf_counter() - t_start
    s = Session(cfg, traffic, seed, device)
    s.phases = {"load_s": load_s, **s.phases}
    first = s.warm()
    t = time.perf_counter()
    prog = s.checked_steps()
    s.phases["check_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    rec, window_s, trace_out = run_window(s, seconds, trace, first)
    peak = torch.cuda.max_memory_allocated(s.dev) if s.dev.type == "cuda" else 0
    losses = torch.stack(rec.losses).float().cpu() if rec.losses else torch.zeros(0)
    failed = int((~torch.isfinite(losses)).sum())
    s.free()
    ref = reference_steps(s)
    numbers = gaps(prog, ref, first_buckets(s))
    return dict(session=s, recorder=rec, window_s=window_s, setup_s=setup_s, peak_bytes=peak,
                trace=trace_out, numbers=numbers, attempted=len(rec.losses), failed=failed,
                phases=s.phases)


def batch_counts(s: Session) -> list:
    """Per batch of the epoch: ``[(n, bonds, conformer edges), ...]`` of its
    real molecules, as the counts take them."""
    return [[(s.mols[i].n, len(s.mols[i].bonds), s.edges[i]) for i in idx] for _, idx in s.batches]
