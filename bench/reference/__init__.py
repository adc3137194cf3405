"""The benchmark's plain reference of the DFA period: plain PyTorch, no
hand-written kernel, and nothing imported from the system under test.

:mod:`period` is the period. :mod:`ports` runs every port's reporter at
once and :mod:`homes` every home shard's translator and collector, as
one table each; the rest is a frozen copy of the port's plain versions
(the hash, IAT resolution and Table-I deltas, the log* LUTs, the wire
schema and checksum, routing, feature derivation).
"""
