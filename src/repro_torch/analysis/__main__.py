"""The contract gate: ``python -m repro_torch.analysis``.

With no flags it runs both passes and exits nonzero on any finding:

  1. **contracts**: the valid kernel-call matrix and every autotuner
     candidate at the main path's shapes must hold, each adversarial
     fixture must trip its invariant (``contracts.run_contracts``), with
     the plans made for ``--sms`` streaming multiprocessors (default 132,
     an H100 SXM; pass the card's own);
  2. **doc sync**: the generated shared-memory table in README.md must
     equal what ``contracts.py`` renders now.

``--contracts-only`` skips the doc check; ``--doc-table`` prints the
generated block; ``--write-docs`` splices it into README.md.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import contracts

REPO_ROOT = Path(__file__).resolve().parents[3]
README = REPO_ROOT / "README.md"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="kernel contract checker (the port's CUDA launch "
                    "plans)")
    parser.add_argument("--sms", type=int, default=contracts.SMS,
                        help="SM count the plans fill (default %(default)s)")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--contracts-only", action="store_true",
                       help="run only the contract sweep")
    group.add_argument("--doc-table", action="store_true",
                       help="print the generated shared-memory table")
    group.add_argument("--write-docs", action="store_true",
                       help="regenerate the table in README.md")
    args = parser.parse_args(argv)

    if args.doc_table:
        print(contracts.doc_table_block())
        return 0
    if args.write_docs:
        contracts.write_doc_table(README)
        print(f"wrote the shared-memory table -> {README}")
        return 0

    found = contracts.run_contracts(args.sms)
    findings = [f"contracts: {f}" for f in found]
    print(f"contracts: {len(contracts.default_matrix())} valid configs, "
          f"{len(contracts.candidate_matrix(args.sms))} tuning candidates, "
          f"{len(contracts.adversarial_fixtures())} adversarial fixtures "
          f"at {args.sms} SMs, {len(found)} findings")
    if not args.contracts_only:
        doc = contracts.check_doc_table(README)
        findings += [f"docs: {f}" for f in doc]
        print(f"docs: shared-memory table {'stale' if doc else 'in sync'}")
    for f in findings:
        print(f, file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
