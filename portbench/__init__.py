"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
defines the yardstick lives here and imports nothing of the program: the
traffic generators (``generators.py``), the FLOP and byte formulas and the
table of peaks (``formulas.py``), the plain reference and the comparisons
that decide ``correct`` (``reference.py``), and the reduction of the
profiler's trace (``trace.py``). The program enters only through the
drivers (``drivers/<driver>.py``), one per entry kind.
"""
