"""Column provenance queries shared by the specialization passes.

The paper's data-structure specializations all rest on *schema +
statistics knowledge*: which table a column's values range over (PK/FK
declarations) and how large a group key's domain is (load-time stats).
Since PR 6 that knowledge is computed by the static-analysis layer
(`core/analysis/schema.py`) in one bottom-up pass; these wrappers keep
the historical per-column query API for the passes' call sites.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import ir
from repro_torch.core.analysis.schema import schema_of
from repro_torch.relational.loader import Database
from repro_torch.relational.schema import ColKind


def key_parent_table(p: ir.Plan, name: str, db: Database) -> Optional[str]:
    """Table T such that values of column `name` lie in [0, |T|) and index
    T's dense primary key — i.e. `name` is T's PK or a FK referencing T."""
    ci = schema_of(p, db).get(name)
    return ci.parent if ci is not None else None


def col_kind(p: ir.Plan, name: str, db: Database) -> Optional[ColKind]:
    """Schema kind of a (possibly renamed) column, if it is a base column."""
    ci = schema_of(p, db).get(name)
    if ci is None or ci.table is None:
        return None
    return db.table(ci.table).schema.col(ci.col).kind


def col_domain(p: ir.Plan, name: str, db: Database,
               hints: Optional[dict[str, int]] = None) -> Optional[int]:
    """Static key-domain size for a column, if known (for dense lowering)."""
    if hints and name in hints:
        return hints[name]
    ci = schema_of(p, db).get(name)
    return ci.domain if ci is not None else None
