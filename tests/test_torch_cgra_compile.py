"""The port's compile half of the CGRA flow (``repro_torch.core`` and
``repro_torch.frontend``: tracer, mapper, router, config_gen, toolchain)
against the JAX package's: for each kernel of the verification set (six
Table-I kernels at small dims, four DSL kernels) and full-size
CONV-U-C-1, equal cache keys, equal canonical DFGs, and artifacts that
serialize byte for byte alike; the stacked-verification cohort's fabrics
serialize alike too."""
import pytest

from repro.core.kernels_lib import table1_kernels as ref_table1
from repro.core.mapper import MapperOptions as RefMapperOptions
from repro.core.toolchain import Toolchain as RefToolchain
from repro.core.toolchain import spec_cache_key as ref_cache_key
from repro.dse import ArchPoint, kernel_suite
from repro.frontend.library import dsl_kernels as ref_dsl
from repro_torch.bench import RF_COHORT, rf_cohort_arch
from repro_torch.core import Toolchain, table1_kernels
from repro_torch.core.mapper import MapperOptions
from repro_torch.core.toolchain import spec_cache_key
from repro_torch.frontend.library import dsl_kernels

SET = ["GEMM", "GEMM-U", "GEMM-U-C", "CONV", "CONV-U-C-1", "CONV-U-C-2",
       "dwconv", "avgpool2x2", "gemm-bias-relu", "requant-int8"]
FULL = "CONV-U-C-1 full"


def _specs(table1, dsl):
    out = {**table1(small=True), **dsl()}
    out[FULL] = table1(small=False)["CONV-U-C-1"]
    return out


@pytest.fixture(scope="module")
def specs():
    return (_specs(ref_table1, ref_dsl), _specs(table1_kernels, dsl_kernels))


@pytest.mark.parametrize("name", SET + [FULL])
def test_cache_keys_and_dfgs_agree(specs, name):
    ref, port = specs[0][name], specs[1][name]
    assert port.dfg.canonical_dict() == ref.dfg.canonical_dict()
    assert spec_cache_key(port, MapperOptions()) == \
        ref_cache_key(ref, RefMapperOptions())


@pytest.mark.parametrize("name", SET + [FULL])
def test_artifacts_serialize_byte_for_byte(specs, name):
    ref = RefToolchain(cache_dir="").compile(specs[0][name])
    port = Toolchain(cache_dir="").compile(specs[1][name])
    assert port.to_json() == ref.to_json()
    assert port.cache_key == ref.cache_key


@pytest.mark.parametrize("rf", RF_COHORT)
def test_rf_cohort_fabrics_and_artifacts_agree(rf):
    point = ArchPoint(rows=4, cols=4, torus=False, regfile_size=rf,
                      bank_kb=4, banks_per_col=2, het="none")
    ref_arch, arch = point.build(), rf_cohort_arch(rf)
    assert arch.to_json() == ref_arch.to_json()
    for name in ("dwconv", "requant-int8"):
        ref = RefToolchain(cache_dir="").compile(kernel_suite(ref_arch)[name])
        port = Toolchain(cache_dir="").compile(dsl_kernels(arch)[name])
        assert port.to_json() == ref.to_json(), name
