"""k2-style symbol table (phone ↔ integer id).

Parity target: reference ``utils/symbol_table.py`` file format — one
``symbol<space>id`` pair per line, ``<eps>`` reserved at id 0.  This is a
fresh minimal implementation of the same format.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class SymbolTable:
    sym2id: Dict[str, int] = field(default_factory=dict)
    id2sym: Dict[int, str] = field(default_factory=dict)
    eps: str = "<eps>"

    def __post_init__(self):
        if self.eps not in self.sym2id:
            self.sym2id[self.eps] = 0
            self.id2sym[0] = self.eps

    @classmethod
    def from_file(cls, filename: str) -> "SymbolTable":
        table = cls()
        with open(filename, encoding="utf-8") as f:
            for line in f:
                fields = line.split()
                if not fields:
                    continue
                if len(fields) != 2:
                    raise ValueError(f"Expect 'symbol id' per line, got: {line!r}")
                sym, idx = fields[0], int(fields[1])
                table.sym2id[sym] = idx
                table.id2sym[idx] = sym
        return table

    def to_file(self, filename: str) -> None:
        with open(filename, "w", encoding="utf-8") as f:
            for idx in sorted(self.id2sym):
                f.write(f"{self.id2sym[idx]} {idx}\n")

    def add(self, symbol: str) -> int:
        if symbol in self.sym2id:
            return self.sym2id[symbol]
        idx = max(self.id2sym) + 1 if self.id2sym else 0
        self.sym2id[symbol] = idx
        self.id2sym[idx] = symbol
        return idx

    def get(self, key) -> Optional[object]:
        if isinstance(key, str):
            return self.sym2id.get(key)
        return self.id2sym.get(key)

    def __contains__(self, symbol: str) -> bool:
        return symbol in self.sym2id

    def __len__(self) -> int:
        return len(self.sym2id)

    @property
    def symbols(self) -> List[str]:
        return [self.id2sym[i] for i in sorted(self.id2sym)]

    @property
    def ids(self) -> List[int]:
        return sorted(self.id2sym)
