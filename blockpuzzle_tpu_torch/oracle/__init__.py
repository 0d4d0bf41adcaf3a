"""CPU oracle: the reference-faithful single env and the parity trajectory
recorder, on numpy and Python's ``random``.

The port's own copy of ``blockpuzzle_tpu/oracle``: that package imports
gymnasium, which the card machine lacks, so the port's parity harness
(``cli/parity.py``) records its episodes here.  ``tests/test_torch_oracle.py``
holds every recorded field bit-equal to the JAX package's oracle.
"""

from blockpuzzle_tpu_torch.oracle.env import BlockPuzzleOracleEnv
from blockpuzzle_tpu_torch.oracle.recorder import (
    RecordingOracle,
    Trajectory,
    record_trajectory,
)

__all__ = [
    "BlockPuzzleOracleEnv",
    "RecordingOracle",
    "Trajectory",
    "record_trajectory",
]
