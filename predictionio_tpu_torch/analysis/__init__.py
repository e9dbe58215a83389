"""`pio check`: PyTorch-aware static analysis for DASE engines and serving code.

The JVM reference leans on scalac to reject a mis-wired engine before
`pio train` runs; this package is the Python port's guardrail.  Three rule
families:

  - PIO-TORCH00x — hot-path device syncs, import-time CUDA work, Python
                  branches in torch.compile'd functions, recompile
                  hazards (rules_torch)
  - PIO-CONC00x — blocking calls in async handlers, busy-wait polls,
                  unlocked mutation of lock-guarded state (rules_concurrency)
  - PIO-LOCK00x — whole-program lock-order inversions and blocking calls
                  held under a lock, over the call/lock graph built by
                  callgraph.py (rules_locks); PIO-TORCH008 rides the same
                  graph for transitive hot-path syncs
  - PIO-RES00x  — network calls without timeouts, silent exception
                  swallowing on serving hot paths (rules_resilience)
  - PIO-OBS00x  — route dispatch that bypasses the request-latency
                  middleware, creating metrics-dark traffic (rules_obs)
  - PIO-DASE00x — DataSource->Preparator->Algorithm->Serving signature /
                  params-dataclass contract checks (contract; import-based,
                  lazily loaded so plain lint runs never import torch)

Suppression is inline (``# pio: ignore[RULE]``) or via a checked-in
baseline with per-entry justifications; `pio check` exits 0 clean /
1 findings / 2 usage-or-parse error.
"""

from predictionio_tpu_torch.analysis.analyzer import (  # noqa: F401
    AnalysisReport,
    analyze_paths,
    analyze_source,
    filter_severity,
    render_json,
    render_sarif,
    render_text,
)
from predictionio_tpu_torch.analysis.baseline import (  # noqa: F401
    DEFAULT_BASELINE_NAME,
    Baseline,
    BaselineError,
)
from predictionio_tpu_torch.analysis.callgraph import (  # noqa: F401
    Program,
    build_program,
)
from predictionio_tpu_torch.analysis.findings import Finding, Severity  # noqa: F401
from predictionio_tpu_torch.analysis.rules import (  # noqa: F401
    ALL_RULES,
    ProgramRule,
    Rule,
)

# importing the rule modules registers them in ALL_RULES
from predictionio_tpu_torch.analysis import rules_concurrency  # noqa: E402,F401
from predictionio_tpu_torch.analysis import rules_locks  # noqa: E402,F401
from predictionio_tpu_torch.analysis import rules_obs  # noqa: E402,F401
from predictionio_tpu_torch.analysis import rules_resilience  # noqa: E402,F401
from predictionio_tpu_torch.analysis import rules_torch  # noqa: E402,F401

__all__ = [
    "ALL_RULES",
    "AnalysisReport",
    "Baseline",
    "BaselineError",
    "DEFAULT_BASELINE_NAME",
    "Finding",
    "Program",
    "ProgramRule",
    "Rule",
    "Severity",
    "analyze_paths",
    "analyze_source",
    "build_program",
    "filter_severity",
    "render_json",
    "render_sarif",
    "render_text",
]
