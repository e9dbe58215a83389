"""Scripted traffic replay: the production-day harness.

``workload`` is the one traffic generator (seeded open-loop schedules,
the closed-loop keep-alive measure loop, and the asyncio concurrent
client); ``scenario`` is the declarative scripted-day format; ``day``
drives the real fleet topology through a scenario and hands the evidence
to :mod:`predictionio_tpu_torch.obs.verdict`; ``tenant_day`` runs the
two-tenant quota-flood day in-process.
"""

from predictionio_tpu_torch.replay.scenario import Scenario, ScenarioError  # noqa: F401
from predictionio_tpu_torch.replay.workload import (  # noqa: F401
    OpenLoopRunner,
    PhaseSchedule,
    build_phase_schedule,
    measure_closed_loop,
    schedule_digest,
)
