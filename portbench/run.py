"""Run one cell of the benchmark of ``predictionio_tpu_torch`` on this
machine's card(s) and print its result as the last line of standard output:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the ``predictionio_tpu_torch`` package.  See ``harness.py``.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
