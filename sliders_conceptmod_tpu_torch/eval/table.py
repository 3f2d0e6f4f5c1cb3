"""The prompts CSV of the eval CLIs, read and written with the ``csv``
module (the GPU machine has no pandas). The JAX CLIs read it with
``pandas.read_csv`` and write it back with ``to_csv(index=False)``; here each
row keeps its fields as read, and a score column is written as pandas writes
a float64 column: the shortest repr of each value, an empty field for NaN."""

from __future__ import annotations

import csv
import math
from typing import Dict, List, Tuple

from sliders_conceptmod_tpu_torch.core.device import torch_device

Rows = List[Dict[str, str]]


def read_table(path: str) -> Tuple[List[str], Rows]:
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        return list(reader.fieldnames or []), list(reader)


def case_numbers(rows: Rows) -> List[int]:
    """Each row's ``case_number`` as the integer pandas parses it to."""
    return [int(float(r["case_number"])) for r in rows]


def set_column(fields: List[str], rows: Rows, col: str, values: List[float]) -> None:
    """``df[col] = values``: a new column goes last, an existing one is overwritten in place."""
    if col not in fields:
        fields.append(col)
    for row, v in zip(rows, values):
        row[col] = "" if math.isnan(v) else repr(float(v))


def column_mean(values: List[float]) -> float:
    """``Series.mean()``: NaN skipped; NaN when every value is."""
    kept = [v for v in values if not math.isnan(v)]
    return sum(kept) / len(kept) if kept else float("nan")


def write_table(path: str, fields: List[str], rows: Rows) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=fields, lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)


def eval_device(spec: str) -> str:
    """``--device``: as the sweeps take it (``cuda``, a CUDA ordinal or
    ``cpu``); ``tpu`` — the JAX CLI's default, which it ignores — is refused."""
    if str(spec).lower() == "tpu":
        raise ValueError("--device tpu: the port runs on a CUDA device or the CPU (--device cuda or cpu)")
    return torch_device(spec)
