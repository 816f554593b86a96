# Convenience targets (no installation required; run from the repo root).

.PHONY: test test-fast test-goldens bench smoke demos native docs clean

docs:
	python tools/gen_api_docs.py

# full suite = fast lane + parity/goldens lane
test:
	python -m pytest tests/ -q

# <3-min default CI lane (unit/behavioural tests)
test-fast:
	python -m pytest tests/ -q -m "not goldens"

# full C-reference parity + heavy equivalence lane (~15 min)
test-goldens:
	python -m pytest tests/ -q -m goldens

bench:
	python bench.py

smoke:
	python chip_smoke.py

demos:
	python examples/demo_binaural_rendering.py
	python examples/demo_room_acoustics.py
	python examples/demo_hades.py

native:
	g++ -O2 -std=c++17 -shared -fPIC -pthread native/saf_runtime.cpp \
	    -o native/libsaf_runtime-linux.so

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; true
	rm -f native/*.so
