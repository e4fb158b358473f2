# Build/test/bench entry points (capability twin of the reference Makefile).

.PHONY: test test-fast bench native examples clean chip-smoke

# The main path once at full size on one NVIDIA GPU: every kernel compiled
# for the card and checked against the XLA route, 10 EM iterations at the
# headline shape, and the other routed paths (chip_smoke.py).  Exits
# non-zero without a GPU.
chip-smoke:
	python chip_smoke.py

# -n 4 (pytest-xdist): the suite compiles ~hundreds of XLA:CPU programs;
# in ONE process the accumulated compiler state can segfault the XLA:CPU
# compiler near the end of the run.  Four worker processes isolate the
# state and are also faster end to end.
test:
	python -m pytest tests/ -q -n 4

test-fast:
	python -m pytest tests/ -x -q -k "not sharding"

native:
	python -c "from ppca_rs_tpu.native import packing; assert packing._get_lib() is not None, 'native build failed'; print('native packing library built')"

bench:
	python bench.py

examples:
	for f in examples/*.py; do echo "== $$f"; PYTHONPATH=.:$$PYTHONPATH python $$f || exit 1; done

clean:
	rm -f ppca_rs_tpu/native/*.so ppca_rs_tpu/native/*.so.tmp
	find . -name __pycache__ -type d -exec rm -rf {} +

install:
	pip install -e .
