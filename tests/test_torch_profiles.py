"""ROLE_PROFILE_OVERRIDE_PATH in the port (`core/profiles.py`): every
`configs/*.yaml` read through it equals the port's named profile of that
name and the JAX package's reading of the same file; bad files are refused
as the reference's pydantic `Profile` refuses them; the file comes before
PIPELINE_ROLE_PROFILE and the role default; without `yaml` the refusal
names it."""

import glob
import os
import sys

import pytest

from rag_inference_pipeline_tpu.core.config import Settings as JSettings
from rag_inference_pipeline_tpu.core.profiles import load_role_profile as j_profile
from rag_inference_pipeline_tpu_torch.core.config import Settings
from rag_inference_pipeline_tpu_torch.core.profiles import (
    load_role_profile,
    named_profile,
    profile_names,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _names(path):
    return os.path.splitext(os.path.basename(path))[0]


def test_every_config_is_a_named_profile():
    assert [_names(p) for p in CONFIGS] == [n for n in profile_names() if n in map(_names, CONFIGS)]
    assert len(CONFIGS) == 22


@pytest.mark.parametrize("path", CONFIGS, ids=_names)
def test_override_file_equals_the_named_profile(path):
    over = load_role_profile(Settings(role_profile_override_path=path,
                                      pipeline_role_profile="gateway_default"))
    assert over == named_profile(_names(path))
    jp = j_profile(JSettings(role_profile_override_path=path))
    assert over.name == jp.name and over.description == jp.description
    assert list(over.routes) == jp.routes and over.batch_overrides == jp.batch_overrides
    assert [(c.type.value, c.alias, c.config) for c in over.components] == [
        (c.type.value, c.alias, c.config) for c in jp.components]


_BAD = {
    "unknown_route": "components:\n  - type: index\nroutes: [retrieval, storage]\n",
    "duplicate_route": "components:\n  - type: index\nroutes: [retrieval, retrieval]\n",
    "not_a_mapping": "- retrieval\n- generation\n",
    "missing_component": "components:\n  - type: embedder\nroutes: [retrieval]\n",
    "duplicate_alias": "components:\n  - type: index\n  - type: index\nroutes: [retrieval]\n",
    "unknown_type": "components:\n  - type: gpu_magic\nroutes: []\n",
    "routes_not_a_list": "components: []\nroutes: retrieval\n",
}
_MESSAGE = {
    "unknown_route": "unknown routes", "duplicate_route": "duplicate routes",
    "not_a_mapping": "did not parse to a mapping", "missing_component": "requires components",
    "duplicate_alias": "duplicate component aliases", "unknown_type": "gpu_magic",
    "routes_not_a_list": "routes",
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_bad_files_are_refused_as_the_reference_refuses_them(tmp_path, case):
    path = tmp_path / f"{case}.yaml"
    path.write_text(_BAD[case])
    with pytest.raises(ValueError) as ref:
        j_profile(JSettings(role_profile_override_path=str(path)))
    with pytest.raises(ValueError, match=_MESSAGE[case]):
        load_role_profile(Settings(role_profile_override_path=str(path)))
    assert _MESSAGE[case] in str(ref.value)


def test_name_defaults_to_the_file_stem_and_unknown_keys_are_ignored(tmp_path):
    path = tmp_path / "my_node.yaml"
    path.write_text("components:\n  - type: index\n    alias: idx\n    config: {kind: flat}\n"
                    "  - type: doc_store\nroutes: [retrieval]\nextra: 1\n")
    p = load_role_profile(Settings(role_profile_override_path=str(path), total_nodes=1))
    jp = j_profile(JSettings(role_profile_override_path=str(path), total_nodes=1))
    assert p.name == jp.name == "my_node"
    assert [(c.type.value, c.alias, c.config) for c in p.components] == [
        (c.type.value, c.alias, c.config) for c in jp.components]
    assert p.components[0].name == "idx"


def test_missing_yaml_is_refused_by_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError
    with pytest.raises(RuntimeError, match="yaml"):
        load_role_profile(Settings(role_profile_override_path=CONFIGS[0]))
    # without the override nothing needs yaml
    assert load_role_profile(Settings(pipeline_role_profile="retrieval_ivf")).name == "retrieval_ivf"
