"""repro_torch.analysis — static pre-flight linter + journal invariant sanitizer
(own copy of ``repro.analysis``).

Two halves (see ROADMAP "Analysis & correctness tooling"):

* :func:`validate_app` — every application error decidable from the
  declared PST/flow/dist/staging specs, found BEFORE any task launches
  (codes E1xx/W2xx).  Wired into ``AppManager.run(validate=...)``.
* :class:`JournalSanitizer` / :func:`sanitize_file` — happens-before
  checking of runtime journals against the executor's dynamic invariants
  (codes S3xx).  Wired into ``PilotRuntime(sanitize=True)`` and the CI
  smoke-journal gate.

CLI: ``python -m repro_torch.analysis lint <module[:factory]>``,
``python -m repro_torch.analysis sanitize <journal.jsonl|dir>...`` and
``python -m repro_torch.analysis codes``.
"""
from repro_torch.analysis.diagnostics import (CODES, Diagnostic, DiagnosticError,
                                        Report)
from repro_torch.analysis.sanitizer import JournalSanitizer, sanitize_file
from repro_torch.analysis.validate import validate_app

__all__ = ["CODES", "Diagnostic", "DiagnosticError", "Report",
           "JournalSanitizer", "sanitize_file", "validate_app"]
