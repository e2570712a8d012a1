# Test tiers, on the CPU with 8 virtual devices (tests/conftest.py):
#   make check        — default tier (pytest.ini deselects slow and heavy)
#   make check-heavy  — compile-heavy numerics and contract tests
#   make check-slow   — slow contract tests (trajectory match vs the CPU
#                       oracle, PBF quality bars)
#   make check-all    — every test
# On a GPU machine:
#   make smoke        — chip_smoke.py: the main path end to end on one card
#   make bench        — bench.py: the benchmark headline
PY ?= python
CPU := JAX_PLATFORMS=cpu

check:
	$(CPU) $(PY) -m pytest tests/ -x -q

check-heavy:
	$(CPU) $(PY) -m pytest tests/ -q -m heavy

check-slow:
	$(CPU) $(PY) -m pytest tests/ -q -m slow

check-all:
	$(CPU) $(PY) -m pytest tests/ -q -m ''

smoke:
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

.PHONY: check check-heavy check-slow check-all smoke bench
