# Developer targets. Tests run on the CPU backend with a virtual 8-device
# mesh (tests/conftest.py sets both), so the sharded paths run without a GPU.
# The benchmarks and chip_smoke.py need an NVIDIA GPU.

.PHONY: install lint test test-fast bench smoke native

install:
	pip install -e .[dev]

lint:
	python tools/lint.py

test-fast:
	python -m pytest tests/ -m "not slow" -q -n auto

test:
	python -m pytest tests/ -q -n auto

bench:
	python bench.py

smoke:
	python chip_smoke.py

native:
	$(MAKE) -C native
