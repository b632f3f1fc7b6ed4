"""The NumPy oracle of the TM step (a copy of `bithtm_tpu/oracle`)."""

from .bami import OracleDecisions, OracleTM, ParityError
from .transplant import extract_decisions, oracle_from_state, tm_stream

__all__ = ["OracleDecisions", "OracleTM", "ParityError",
           "extract_decisions", "oracle_from_state", "tm_stream"]
