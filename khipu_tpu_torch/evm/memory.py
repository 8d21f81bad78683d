"""EVM byte-addressed memory, word-granular expansion (vm/Memory.scala:18).

Expansion *gas* is charged by the VM before the access (quadratic term,
YP appendix H); this class only tracks the active word count and
zero-extends on demand.
"""

from __future__ import annotations


class Memory:
    __slots__ = ("data", "active_words")

    def __init__(self):
        self.data = bytearray()
        self.active_words = 0

    def _expand(self, offset: int, size: int) -> None:
        if size == 0:
            return
        words = (offset + size + 31) // 32
        if words > self.active_words:
            self.active_words = words
        need = words * 32
        if len(self.data) < need:
            self.data.extend(b"\x00" * (need - len(self.data)))

    def store(self, offset: int, value: bytes) -> None:
        self._expand(offset, len(value))
        self.data[offset : offset + len(value)] = value

    def store_byte(self, offset: int, value: int) -> None:
        self._expand(offset, 1)
        self.data[offset] = value & 0xFF

    def load(self, offset: int, size: int) -> bytes:
        self._expand(offset, size)
        return bytes(self.data[offset : offset + size])

    def size(self) -> int:
        return self.active_words * 32

    def copy(self) -> "Memory":
        m = Memory()
        m.data = bytearray(self.data)
        m.active_words = self.active_words
        return m


def words(nbytes: int) -> int:
    return (nbytes + 31) // 32


def expansion_words(current_words: int, offset: int, size: int) -> int:
    """Word count after touching [offset, offset+size); size 0 never
    expands (YP: zero-size accesses are free)."""
    if size == 0:
        return current_words
    return max(current_words, (offset + size + 31) // 32)


def memory_cost(words_: int, g_memory: int) -> int:
    """C_mem (YP appendix H): linear term + quadratic word term."""
    return g_memory * words_ + (words_ * words_) // 512
