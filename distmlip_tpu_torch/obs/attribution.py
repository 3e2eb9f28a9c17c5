"""Scope-level device-time attribution (``distmlip_tpu/obs/attribution.py``).

Maps where a step's device time went, bucketed into the categories the
partitioned potentials are built from:

- ``halo_exchange``        the halo copies between partitions
- ``interior_aggregation`` per-partition message aggregation (segment
                           sums, gathers, the dense edge MLP work)
- ``scatter``              force/feature scatter-adds back onto nodes
- ``custom_kernel``        the port's hand-written CUDA kernels (the JAX
                           package's ``pallas_kernel`` bucket)
- ``gradient_transpose``   backward-pass work (force/stress autograd)
- ``other``                everything else (elementwise glue, copies)

The source is a ``torch.profiler`` capture exported as a Chrome trace
(``prof.export_chrome_trace``, or ``telemetry.device_trace``). CUDA kernel
names carry no scope, so each device event (kernel, memcpy, memset) is
placed by what contains it:

- the ``gpu_user_annotation`` ranges over it on the device timeline (the
  GPU copies of the ``record_function`` ranges that ``telemetry.annotate``
  and ``telemetry.scope`` open);
- the host call stack at its launch, found through the launch's
  ``correlation`` id: the ``user_annotation`` ranges, and autograd's
  ``autograd::engine::evaluate_function: ...Backward0`` range when the
  backward launched it. A backward kernel takes the scope of the forward op
  its node came from (the ``Sequence number`` both carry) with
  ``/backward`` appended, so the by-scope table splits the backward by
  layer too.

A kernel whose name is one of the port's (``PORT_KERNEL_RE``) goes to
``custom_kernel`` whatever its scope; every other event is classified by
the JAX package's rules over its scope, then its name. A trace in the JAX
package's shape (XLA op events with their ``named_scope`` stack in
``args``) is read as the JAX package reads it, ``pallas_kernel`` becoming
``custom_kernel``.

The JAX package's second source, the analytic cost model over a jaxpr
(``attribute_cost_model``), waits for the port's program analysis
(ROADMAP.md A13) and raises until then.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

CATEGORIES = (
    "halo_exchange",
    "interior_aggregation",
    "scatter",
    "custom_kernel",
    "gradient_transpose",
    "other",
)

# the __global__ names of the port's kernels (kernels/csrc/*.cu)
PORT_KERNEL_RE = re.compile(
    r"segment_sum_(kernel|bf16_row_kernel)|tensornet_(embed|interaction|interaction_bwd)_kernel"
    r"|chgnet_(atom_conv|line_conv|row_projection)(_bf16)?_kernel|so2_conv(_bf16)?_kernel")

# classification rules, first match wins (the JAX package's, with its
# pallas_kernel bucket named custom_kernel and the port's kernel names added
# to it). Applied to the lowercased scope, then the lowercased name.
_RULES: tuple[tuple[str, re.Pattern], ...] = (
    ("halo_exchange", re.compile(
        r"ppermute|collective.?permute|halo|all.?to.?all|all.?gather")),
    ("custom_kernel", re.compile(r"pallas|tpu.?custom.?call|mosaic|" + PORT_KERNEL_RE.pattern)),
    ("gradient_transpose", re.compile(
        r"transpose\b|backward|vjp|grad|jvp_transpose")),
    ("scatter", re.compile(r"scatter")),
    ("interior_aggregation", re.compile(
        r"interior|aggregat|segment|unsorted_segment|edge_mlp|message"
        r"|gather|dot_general|dot\b|conv|einsum|reduce_sum|psum")),
)


def classify(name: str, scope: str = "") -> str:
    """Category for one event given its name and scope stack (the scope is
    checked FIRST, as in the JAX package)."""
    for text in (scope.lower(), name.lower()):
        if not text:
            continue
        for cat, pat in _RULES:
            if pat.search(text):
                return cat
    return "other"


def is_port_kernel(name: str) -> bool:
    """Whether a device event is one of the port's hand-written kernels."""
    return PORT_KERNEL_RE.search(name) is not None


@dataclass
class ScopeBreakdown:
    """Per-category / per-scope device-time breakdown for one program."""

    total_s: float
    by_category: dict = field(default_factory=dict)   # category -> seconds
    by_scope: dict = field(default_factory=dict)      # scope str -> seconds
    source: str = "cost_model"                        # "trace" | "cost_model"
    program: str = ""
    n_events: int = 0

    def fraction(self, category: str) -> float:
        if self.total_s <= 0:
            return 0.0
        return self.by_category.get(category, 0.0) / self.total_s

    def as_dict(self) -> dict:
        return {
            "program": self.program,
            "source": self.source,
            "total_s": self.total_s,
            "n_events": self.n_events,
            "by_category": dict(self.by_category),
            "by_scope": dict(self.by_scope),
        }

    def render(self, top_scopes: int = 8) -> str:
        head = self.program or "device time"
        lines = [f"{head}  [{self.source}]  total {self.total_s:.6f}s",
                 f"  {'category':<22} {'seconds':>12} {'frac':>7}"]
        for cat in CATEGORIES:
            s = self.by_category.get(cat, 0.0)
            if s <= 0 and cat != "other":
                continue
            lines.append(
                f"  {cat:<22} {s:>12.6f} {self.fraction(cat):>6.1%}")
        if self.by_scope:
            lines.append(f"  top scopes ({min(top_scopes, len(self.by_scope))}"
                         f" of {len(self.by_scope)}):")
            ranked = sorted(self.by_scope.items(), key=lambda kv: -kv[1])
            for scope, s in ranked[:top_scopes]:
                lines.append(f"    {scope:<40.40} {s:>12.6f}")
        return "\n".join(lines)


def by_layer(bd: ScopeBreakdown) -> dict:
    """Device seconds per named layer scope (``"<family>/<layer>"`` and
    ``"halo/exchange"``, their ``/backward`` shares folded in), from a
    breakdown's ``by_scope``; events under no layer scope go to
    ``"(unscoped)"``."""
    out: dict[str, float] = {}
    for scope, s in bd.by_scope.items():
        parts = [p for p in scope.split("/") if p]
        layer = "(unscoped)"
        for i in range(len(parts) - 1):
            if parts[i] in _LAYER_FAMILIES:
                layer = f"{parts[i]}/{parts[i + 1]}"
        out[layer] = out.get(layer, 0.0) + s
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# the first part of the models' scope names (telemetry.scope call sites)
_LAYER_FAMILIES = ("mace", "tensornet", "chgnet", "escn", "escn_md", "halo")


# ---------------------------------------------------------------------------
# reading a capture
# ---------------------------------------------------------------------------

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_TORCH_CATS = _DEVICE_CATS + _LAUNCH_CATS + ("cpu_op", "user_annotation")

# trace event names that are profiler bookkeeping, not device work (JAX shape)
_TRACE_NOISE = re.compile(
    r"^(process_|thread_|trace_|args\b)|^\$|^Steps?$|^MemcpyD?2?[HD]?$",
    re.IGNORECASE)


def _load(trace) -> list:
    """``trace``: a path to a JSON file (``.gz`` too), a parsed
    ``{"traceEvents": [...]}`` dict, or a bare list of events."""
    if isinstance(trace, str):
        if trace.endswith(".gz"):
            import gzip

            with gzip.open(trace, "rt") as f:
                trace = json.load(f)
        else:
            with open(trace) as f:
                trace = json.load(f)
    if isinstance(trace, dict):
        trace = trace.get("traceEvents", [])
    return [ev for ev in trace if isinstance(ev, dict)]


def _containing(ranges, points):
    """For each point ``(t, key)``, the ranges ``(t0, t1, name, payload)``
    that contain ``t``, outermost first — ranges on one timeline nest, so
    one sweep with a stack serves all points. Returns ``{key: [range]}``."""
    items = [(r[0], 0, -(r[1] - r[0]), i) for i, r in enumerate(ranges)]
    items += [(t, 1, 0.0, key) for t, key in points]
    items.sort(key=lambda x: (x[0], x[1], x[2]))
    stack, out = [], {}
    for t, kind, _, ref in items:
        while stack and ranges[stack[-1]][1] < t:
            stack.pop()
        if kind == 0:
            stack.append(ref)
        else:
            out[ref] = [ranges[i] for i in stack]
    return out


def _torch_events(events):
    """Yield ``(name, dur_s, scope)`` per device event of a torch.profiler
    Chrome trace."""
    device = [ev for ev in events if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS]
    # device-timeline annotations, per device (pid)
    gpu_ann: dict = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "gpu_user_annotation":
            gpu_ann.setdefault(ev.get("pid"), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)),
                 str(ev.get("name", "")), None))
    gpu_scope = {}
    for pid, ranges in gpu_ann.items():
        pts = [(float(ev["ts"]), i) for i, ev in enumerate(device) if ev.get("pid") == pid]
        for i, rs in _containing(ranges, pts).items():
            gpu_scope[i] = [r[2] for r in rs]
    # host call stacks at each launch, through the correlation ids
    launch_at = {}
    for ev in events:
        if ev.get("cat") in _LAUNCH_CATS and "correlation" in (ev.get("args") or {}):
            launch_at[ev["args"]["correlation"]] = ev
    host_ranges: dict = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("cpu_op", "user_annotation"):
            host_ranges.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)),
                 str(ev.get("name", "")), ev))
    points: dict = {}
    for i, ev in enumerate(device):
        corr = (ev.get("args") or {}).get("correlation")
        launch = launch_at.get(corr)
        if launch is not None:
            points.setdefault((launch.get("pid"), launch.get("tid")), []).append(
                (float(launch["ts"]), i))
    host_stack = {}
    for key, ranges in host_ranges.items():
        host_stack.update(_containing(ranges, points.get(key, [])))
    # the forward scope of each autograd node, by its sequence number
    fwd_scope = {}
    for key, ranges in host_ranges.items():
        fwd = [(r[0], id(r[3])) for r in ranges
               if r[3].get("cat") == "cpu_op" and "evaluate_function" not in r[2]
               and (r[3].get("args") or {}).get("Sequence number") is not None]
        by_id = {id(r[3]): r[3] for r in ranges}
        for ref, rs in _containing(ranges, fwd).items():
            seq = by_id[ref]["args"]["Sequence number"]
            names = [r[2] for r in rs if r[3].get("cat") == "user_annotation"]
            if names and seq not in fwd_scope:
                fwd_scope[seq] = names
    for i, ev in enumerate(device):
        stack = host_stack.get(i, [])
        names = [r[2] for r in stack if r[3].get("cat") == "user_annotation"]
        bwd = [r for r in stack if "evaluate_function" in r[2]]
        if bwd:
            seq = (bwd[-1][3].get("args") or {}).get("Sequence number")
            names = (fwd_scope.get(seq) or names or [bwd[-1][2]]) + ["backward"]
        elif not names:
            names = gpu_scope.get(i, [])
        yield str(ev.get("name", "")), float(ev.get("dur", 0.0)) * 1e-6, "/".join(names)


def _event_scope(ev) -> str:
    """The named_scope stack of an XLA op event (JAX shape), from its HLO
    metadata in ``args``."""
    args = ev.get("args") or {}
    for key in ("long_name", "tf_op", "op_name", "name"):
        val = args.get(key)
        if isinstance(val, str) and val:
            return val
    return ""


def _jax_events(events):
    """Yield ``(name, dur_s, scope)`` per op event of a trace in the JAX
    package's shape."""
    for ev in events:
        if ev.get("ph") != "X":
            continue
        name = str(ev.get("name", ""))
        if not name or _TRACE_NOISE.search(name):
            continue
        yield name, float(ev.get("dur", 0.0)) * 1e-6, _event_scope(ev)


def attribute_trace(trace, program: str = "") -> ScopeBreakdown:
    """Per-category and per-scope breakdown of a profiler capture."""
    events = _load(trace)
    # a torch.profiler capture (its events carry categories); a CPU-only one
    # has no device events and gives an empty breakdown
    torch_shape = any(ev.get("cat") in _TORCH_CATS for ev in events)
    by_cat: dict[str, float] = {}
    by_scope: dict[str, float] = {}
    total = 0.0
    n = 0
    for name, dur_s, scope in (_torch_events(events) if torch_shape else _jax_events(events)):
        if dur_s <= 0:
            continue
        cat = ("custom_kernel" if torch_shape and is_port_kernel(name)
               else classify(name, scope))
        by_cat[cat] = by_cat.get(cat, 0.0) + dur_s
        key = scope or name
        by_scope[key] = by_scope.get(key, 0.0) + dur_s
        total += dur_s
        n += 1
    return ScopeBreakdown(total_s=total, by_category=by_cat, by_scope=by_scope,
                          source="trace", program=program, n_events=n)


def attribute_cost_model(program_ir, total_s: float, program: str = "") -> ScopeBreakdown:
    """Apportion a measured step time by analytic weights over a traced
    program (the JAX package walks a jaxpr). Not ported: it waits for the
    program analysis over FX graphs (ROADMAP.md A13)."""
    raise NotImplementedError(
        "attribution by cost model walks a traced program; the port's program "
        "analysis is not ported yet (ROADMAP.md A13): pass trace= (a "
        "torch.profiler Chrome trace) instead")


def attribute(total_s: float, trace=None, jaxpr=None, program: str = "") -> ScopeBreakdown:
    """One entry point: the trace when a capture exists (the cost-model
    source raises until A13)."""
    if trace is not None:
        bd = attribute_trace(trace, program=program)
        if bd.n_events:
            return bd
    if jaxpr is not None:
        return attribute_cost_model(jaxpr, total_s, program=program)
    return ScopeBreakdown(total_s=total_s, source="cost_model", program=program)


__all__ = [
    "CATEGORIES",
    "PORT_KERNEL_RE",
    "ScopeBreakdown",
    "attribute",
    "attribute_cost_model",
    "attribute_trace",
    "by_layer",
    "classify",
    "is_port_kernel",
]
