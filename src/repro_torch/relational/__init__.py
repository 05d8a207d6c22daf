from repro_torch.relational.loader import Database
from repro_torch.relational.schema import TPCH_SCHEMAS, days
from repro_torch.relational.table import Table

__all__ = ["Database", "Table", "TPCH_SCHEMAS", "days"]
