"""svbench's plain references: straightforward dynamic programs in
PyTorch, written from the recurrences (delly's edit distance modes,
LCS, and the profile Gotoh of delly's gotoh.h with its walk), that
decide whether the port's outputs are correct.

They import nothing of the measured program (nor of the JAX package):
`svbench/tests/test_svbench_reference.py` walks their imports. They
take the same raw inputs that the benchmark hands the program (byte
sequences, alignment rows) and derive everything else (profiles, score
tables) themselves.
"""
