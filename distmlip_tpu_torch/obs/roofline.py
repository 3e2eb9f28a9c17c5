"""Roofline accounting: arithmetic intensity + achieved vs peak FLOP/s
(``distmlip_tpu/obs/roofline.py``).

Per-program :class:`RooflineRow` entries from the telemetry records:

- **intensity** = flops / bytes (FLOP per device-memory byte);
- **achieved** = flops / time_s when a measured step time exists
  (telemetry records' ``device_s``); 0.0 otherwise;
- **mfu** = achieved / peak, with peak from
  :func:`~distmlip_tpu_torch.utils.flops.peak_flops_per_device` (0.0 on
  the CPU — rows still render, utilization just reads n/a).

The JAX package also walks a traced program's jaxpr for its FLOPs
(``jaxpr_flop_estimate``, over ``analysis.ir.iter_sites``); the port's
program-level analysis over FX graphs is ROADMAP.md A13, and until then
that entry point raises. Consumed by the telemetry report's roofline
section. Host-side only.
"""

from __future__ import annotations

from dataclasses import dataclass


def jaxpr_flop_estimate(closed_jaxpr) -> float:
    """FLOPs of one execution of a traced program (the JAX package walks
    its jaxpr). Not ported: the program walk waits for the static analysis
    over FX graphs (ROADMAP.md A13)."""
    raise NotImplementedError(
        "jaxpr_flop_estimate walks a traced program; the port's program "
        "analysis is not ported yet (ROADMAP.md A13)")


def bytes_touched(plan) -> int:
    """Minimum HBM traffic of one step from a :class:`MemoryPlan`."""
    return int(getattr(plan, "arg_bytes", 0)
               + getattr(plan, "const_bytes", 0)
               + getattr(plan, "out_bytes", 0))


@dataclass
class RooflineRow:
    """One program's position on the roofline."""

    program: str
    flops: float = 0.0            # analytic FLOPs per step
    bytes: float = 0.0            # minimum HBM bytes per step
    time_s: float = 0.0           # measured step device time (0 = none)
    peak_flops: float = 0.0       # per-device peak x n_devices (0 = unknown)
    n_devices: int = 1
    source: str = "cost_model"    # "measured" when time_s came from a run

    @property
    def intensity(self) -> float:
        return self.flops / self.bytes if self.bytes > 0 else 0.0

    @property
    def achieved_flops(self) -> float:
        """Aggregate achieved FLOP/s across the devices that ran it."""
        return self.flops / self.time_s if self.time_s > 0 else 0.0

    @property
    def mfu(self) -> float:
        total_peak = self.peak_flops * max(self.n_devices, 1)
        if total_peak <= 0 or self.time_s <= 0:
            return 0.0
        return self.achieved_flops / total_peak

    @property
    def ridge_bound(self) -> str:
        """Which roof limits this program at ``peak_flops`` — "compute"
        when its intensity clears the ridge point, "memory" below it; ""
        when peak is unknown (no basis to place the ridge)."""
        if self.peak_flops <= 0 or self.intensity <= 0:
            return ""
        # ridge = peak_flops / memory rate; the JAX package's 100
        # FLOP/byte watershed, kept so both reports place rows alike
        return "compute" if self.intensity >= 100.0 else "memory"

    def as_dict(self) -> dict:
        return {
            "program": self.program,
            "flops": self.flops,
            "bytes": self.bytes,
            "intensity": round(self.intensity, 3),
            "time_s": self.time_s,
            "achieved_flops": self.achieved_flops,
            "peak_flops": self.peak_flops,
            "n_devices": self.n_devices,
            "mfu": round(self.mfu, 6),
            "ridge_bound": self.ridge_bound,
            "source": self.source,
        }


def _fmt_si(x: float) -> str:
    for div, suf in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(x) >= div:
            return f"{x / div:.2f}{suf}"
    return f"{x:.1f}"


def format_roofline_table(rows, title: str = "roofline") -> str:
    """Fixed-width table over :class:`RooflineRow` entries."""
    lines = [title,
             f"  {'program':<38} {'flops':>9} {'bytes':>9} {'F/B':>8} "
             f"{'time_s':>9} {'achieved':>9} {'mfu':>7} {'bound':>7}"]
    for r in rows:
        mfu = f"{r.mfu:.1%}" if r.mfu > 0 else "n/a"
        ach = _fmt_si(r.achieved_flops) if r.time_s > 0 else "n/a"
        t = f"{r.time_s:.5f}" if r.time_s > 0 else "n/a"
        lines.append(
            f"  {r.program:<38.38} {_fmt_si(r.flops):>9} "
            f"{_fmt_si(r.bytes):>9} {r.intensity:>8.2f} {t:>9} "
            f"{ach:>9} {mfu:>7} {r.ridge_bound or 'n/a':>7}")
    return "\n".join(lines)


def rows_from_records(records) -> list:
    """Roofline rows recoverable from telemetry StepRecords.

    Groups records by ``(kind, bucket_key)``; a group yields a row only
    when some record carries a FLOP estimate (``extra["flops_per_step"]``
    — bench/CLI-stamped; plain serving records don't have one). Bytes
    come from ``est_peak_bytes`` as a traffic PROXY (it is a live-set
    peak, not traffic — rows from records are for trending only). Mixed
    rounds where only some records carry the fields degrade to fewer
    rows, never to a KeyError.
    """
    groups: dict[tuple, list] = {}
    for r in records:
        key = (getattr(r, "kind", ""), getattr(r, "bucket_key", ""))
        groups.setdefault(key, []).append(r)
    rows = []
    for (kind, bucket), recs in sorted(groups.items()):
        flops = 0.0
        nbytes = 0.0
        times = []
        n_dev = 1
        for r in recs:
            extra = getattr(r, "extra", None) or {}
            try:
                f = float(extra.get("flops_per_step", 0.0) or 0.0)
            except (TypeError, ValueError):
                f = 0.0
            flops = max(flops, f)
            nbytes = max(nbytes, float(getattr(r, "est_peak_bytes", 0) or 0))
            t = (getattr(r, "timings", None) or {}).get("device_s", 0.0)
            if t and not getattr(r, "compiled", False):
                times.append(float(t))  # warm steps only — compiles skew
            n_dev = max(n_dev, int(getattr(r, "num_partitions", 0) or 0) or 1)
        if flops <= 0:
            continue
        times.sort()
        t_med = times[len(times) // 2] if times else 0.0
        from ..utils.flops import peak_flops_per_device

        name = kind + (f"[{bucket}]" if bucket else "")
        rows.append(RooflineRow(
            program=name, flops=flops, bytes=nbytes, time_s=t_med,
            peak_flops=peak_flops_per_device(), n_devices=n_dev,
            source="measured" if t_med > 0 else "cost_model"))
    return rows


__all__ = [
    "RooflineRow",
    "bytes_touched",
    "format_roofline_table",
    "jaxpr_flop_estimate",
    "rows_from_records",
]
