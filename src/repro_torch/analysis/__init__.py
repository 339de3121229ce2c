"""Correctness tooling of the port: the happens-before hazard sanitizer.

``HazardSanitizer`` (dynamic, opt-in via ``FLEX_SANITIZE=1``) is a
vector-clock checker threaded through ``FlexDaemon`` dispatch: ``connect()``
builds one a session.  See :mod:`repro_torch.analysis.hazards`.
"""
from repro_torch.analysis.hazards import HazardSanitizer, sanitize_enabled

__all__ = ["HazardSanitizer", "sanitize_enabled"]
