"""Run reporting: banner, formatted block lines, JSONL metrics.

Capability parity with reference C15 (`Logo`/`Completion` banners
`Ewald/banners.jl:2-44`; the per-block @sprintf report
`Ewald/main.jl:667-679`) plus a structured JSONL metrics stream the
reference lacks.
"""

import json
import sys
import time

BANNER = r"""
 __  __  ___ __  __  ___
|  \/  |/ __|  \/  |/ __|
| |\/| | (__| |\/| | (__
|_|  |_|\___|_|  |_|\___|
 Metropolis Monte Carlo, data-parallel (JAX)
"""


def banner(stream=sys.stdout):
    print(BANNER, file=stream)


def block_line(block, metrics):
    """One human-readable line per block (reference `Ewald/main.jl:667-679`)."""
    parts = [f"blk {block:4d}", f"<E> {metrics.get('energy_mean', float('nan')):14.4f}"]
    for k, label in (("acc_trans", "accT"), ("acc_rot", "accR"),
                     ("acc_vol", "accV")):
        if k in metrics:
            parts.append(f"{label} {metrics[k]:5.3f}")
    parts.append(f"dr {metrics.get('dr_max_mean', float('nan')):6.4f}")
    parts.append(f"drift {metrics.get('drift_max_rel', float('nan')):8.2e}")
    if "pressure_fd_mean" in metrics:
        parts.append(f"P {metrics['pressure_fd_mean']:10.5f}")
    elif "pressure_mean" in metrics:
        parts.append(f"P {metrics['pressure_mean']:10.4f}")
    return "  ".join(parts)


class JsonlLogger:
    """Append-only JSONL metrics writer."""

    def __init__(self, path):
        self.path = path
        self._f = open(path, "a") if path else None

    def write(self, record):
        if self._f:
            record = dict(record, t=time.time())
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
