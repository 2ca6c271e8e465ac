"""Reduce a `jax.profiler` trace and a compiled program to the numbers the
bring-up smoke run reports: device busy/idle time, the top device ops,
device ops per scan step, and full-size state copies inside loop bodies.

`device_events(path)` reads an `.xplane.pb`; `summarize` works on plain
(line, name, start_ns, duration_ns) tuples so it can be checked without a
device.
"""

import collections
import re

# lines of a GPU plane that aggregate other events rather than being
# kernels themselves
_AGGREGATE_LINES = ("XLA Modules", "XLA Ops", "Steps", "XLA TraceMe",
                    "Framework Name Scope", "Framework Ops", "Source code")


def device_events(xplane_path):
    """[(line, name, start_ns, duration_ns)] of the kernel lines of every
    "/device:" plane, plus {line name: event count} of all its lines."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    events, lines = [], collections.Counter()
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] += len(evs)
            if line.name in _AGGREGATE_LINES:
                continue
            events.extend((line.name, e.name, int(e.start_ns),
                           int(e.duration_ns)) for e in evs)
    return events, dict(lines)


def busy_ns(events):
    """Length of the union of the events' [start, start + duration)."""
    total, end = 0, None
    for s, d in sorted((e[2], e[3]) for e in events):
        if end is None or s >= end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total


def summarize(events, window_ns, n_steps, top=10):
    """Top ops by device time, busy/idle over the host-timed window, and
    ops per scan step (n_steps = scan steps executed in the window)."""
    by_name = collections.defaultdict(lambda: [0, 0])
    for _, name, _, dur in events:
        by_name[name][0] += 1
        by_name[name][1] += dur
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    busy = busy_ns(events)
    span = (max(e[2] + e[3] for e in events) - min(e[2] for e in events)) \
        if events else 0
    per_step = [(n, c, t) for n, (c, t) in ranked if c >= n_steps]
    return {
        "top_ops": [{"name": n, "count": c, "total_us": t / 1e3,
                     "mean_us": t / c / 1e3} for n, (c, t) in ranked[:top]],
        "n_events": len(events),
        "busy_us": busy / 1e3,
        "window_us": window_ns / 1e3,
        "idle_share": 1.0 - busy / window_ns if window_ns else None,
        "device_span_us": span / 1e3,
        "idle_share_in_span": 1.0 - busy / span if span else None,
        "ops_per_step": len(events) / n_steps,
        "top_per_step_op": ({"name": per_step[0][0],
                             "count": per_step[0][1],
                             "us_per_step": per_step[0][2] / n_steps / 1e3}
                            if per_step else None),
    }


def full_copies_in_loops(hlo_text, shape):
    """Count `copy` instructions producing `shape` (e.g. "f32[512,3,2304]")
    in the computations that are while-loop bodies of an optimized HLO
    module — a full copy of the carried state on every scan step."""
    bodies = set(re.findall(r"body=%?([\w.\-]+)", hlo_text))
    counts = collections.Counter()
    comp = None
    pat = re.compile(re.escape(shape) + r"\{[^}]*\}\s+copy\(")
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if head and not line.startswith(" "):
            comp = head.group(1)
            continue
        if comp in bodies and pat.search(line):
            counts[comp] += 1
    return sum(counts.values()), dict(counts)
