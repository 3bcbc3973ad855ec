r"""Reduce a ``jax.profiler`` trace to device time per op and per scope.

Reads the ``.xplane.pb`` that ``jax.profiler.start_trace(dir)`` writes under
``dir/plugins/profile/<time>/`` with ``jax.profiler.ProfileData`` (nothing
beyond JAX).  Device events are those on the planes named ``/device:GPU:*``;
each kernel event carries the ``hlo_module`` and ``hlo_op`` it ran for.
Events are counted once per stream line (derived summary lines such as
"XLA Ops" repeat them and are skipped).

``scope_time`` attributes each event to a ``jax.named_scope`` through the
``op_name`` metadata of the optimized HLO (``compiled.as_text()``), which is
how the engine's ``route_groups`` and ``tile_search`` scopes are found after
XLA renames and fuses their ops.

    python benchmarks/parse_trace.py <trace_dir> [top_n]
"""

from __future__ import annotations

import collections
import glob
import re
import sys

_SKIP_LINES = ("XLA Modules", "XLA Ops", "Steps", "XLA TraceMe")


def latest_xplane(trace_dir: str) -> str:
    files = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return files[-1]


def device_events(xplane_path: str) -> list[dict]:
    r"""Kernel events on the GPU planes: name, module, op, start, duration
    (nanoseconds), plane and line."""
    import jax

    data = jax.profiler.ProfileData.from_file(xplane_path)
    out = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name in _SKIP_LINES:
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                out.append({
                    "name": ev.name,
                    "module": stats.get("hlo_module", ""),
                    "op": stats.get("hlo_op", ev.name),
                    "start_ns": float(ev.start_ns),
                    "dur_ns": float(ev.duration_ns),
                    "plane": plane.name,
                    "line": line.name,
                })
    return out


def busy_ns(events: list[dict]) -> float:
    r"""Length of the union of the events' intervals (device busy time)."""
    spans = sorted((e["start_ns"], e["start_ns"] + e["dur_ns"]) for e in events)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name=\"([^\"]*)\"")


def op_names(hlo_text: str) -> dict[str, str]:
    r"""HLO instruction name -> ``op_name`` metadata, from optimized HLO."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def scope_time(
    events: list[dict], hlo_text: str, scopes: tuple[str, ...]
) -> dict[str, float]:
    r"""Device nanoseconds per scope (first matching scope in ``op_name``),
    over the events whose op appears in ``hlo_text``; ``"total"`` is every
    such event."""
    names = op_names(hlo_text)
    out = collections.Counter()
    for e in events:
        op_name = names.get(e["op"])
        if op_name is None:
            continue
        out["total"] += e["dur_ns"]
        for s in scopes:
            if f"/{s}/" in f"/{op_name}/":
                out[s] += e["dur_ns"]
                break
    return dict(out)


def main() -> None:
    root = sys.argv[1]
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 40
    events = device_events(latest_xplane(root))
    if not events:
        raise SystemExit("no GPU device events in the trace")
    window = max(e["start_ns"] + e["dur_ns"] for e in events) - min(
        e["start_ns"] for e in events
    )
    busy = busy_ns(events)
    by_op = collections.Counter()
    cnt = collections.Counter()
    for e in events:
        by_op[e["op"]] += e["dur_ns"]
        cnt[e["op"]] += 1
    print(f"window {window / 1e6:.3f} ms, busy {busy / 1e6:.3f} ms, "
          f"idle share {1 - busy / window:.4f}")
    print(f"{'ms':>10} {'count':>6}  op")
    for op, d in by_op.most_common(top_n):
        print(f"{d / 1e6:10.3f} {cnt[op]:6d}  {op[:100]}")


if __name__ == "__main__":
    main()
