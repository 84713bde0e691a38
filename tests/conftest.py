import gc
import os
import sys

import pytest

# tests run on the single real CPU device (the dry-run, and only the dry-run,
# forces 512 placeholder devices — keep that flag OUT of here)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Every cached jitted executable pins its captured constants as live device
# buffers, each a separate anonymous mmap; across the full suite the process
# can accumulate tens of thousands of maps and cross vm.max_map_count
# (default 65530), at which point XLA's next compile segfaults instead of
# raising.  Dropping the executable caches between modules bounds the
# accumulation — but it also recompiles everything the next module shares,
# which is pure waste on machines nowhere near the limit.  So the drop is
# GATED on actual proximity to the limit (see _near_map_count_limit;
# DESIGN.md §16 documents the mechanism), overridable for debugging:
#
#   REPRO_JAX_CACHE_DROP=always  drop after every module (the old behavior)
#   REPRO_JAX_CACHE_DROP=never   never drop (reproduce the segfault)
#   REPRO_JAX_CACHE_DROP=auto    drop only when near the map-count limit
#                                (default)
_DROP_FRACTION = 0.5  # drop once the process holds > 50% of max_map_count


def _read_int(path):
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _count_maps():
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return None


def _near_map_count_limit() -> bool:
    limit = _read_int("/proc/sys/vm/max_map_count")
    maps = _count_maps()
    if limit is None or maps is None:
        # no /proc (non-Linux): mmap exhaustion manifests differently and
        # the workaround has nothing to measure — keep the caches
        return False
    return maps > _DROP_FRACTION * limit


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_executable_caches():
    yield
    mode = os.environ.get("REPRO_JAX_CACHE_DROP", "auto")
    if mode == "never":
        return
    if mode != "always" and not _near_map_count_limit():
        return
    import jax

    jax.clear_caches()
    gc.collect()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason elsewhere")
