"""The inverse weight map of the port (``convert.export_flax_params``)
against the JAX initialisers' variables: for every model of the acoustic
stage (the training-only MRD, mel style encoder and posterior encoder
included), the two other inference models and the SLM, the flax params
and batch stats loaded into the port and exported again give back every
name, shape (0-d spectral-norm sigmas and DenseGeneral kernels too) and
value exactly.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from stylish_tts_tpu.utils.synthetic import tiny_model_config as jax_tiny
from stylish_tts_tpu_torch.convert import export_flax_params, load_flax_params
from stylish_tts_tpu_torch.utils.synthetic import tiny_model_config
from test_torch_port_helpers import flatten

KEYS = ("speech_predictor", "pitch_energy_predictor", "pe_text_encoder",
        "pe_mel_style_encoder", "mrd", "duration_predictor",
        "pe_text_style_encoder")


@pytest.fixture(scope="module")
def jax_variables():
    """Flat flax params and batch stats of the acoustic stage's models, the
    other inference models and the SLM, from the JAX initialisers."""
    from stylish_tts_tpu.models import build_models
    from stylish_tts_tpu.train.init import init_model_variables, init_slm_params

    mc = jax_tiny()
    variables = init_model_variables(build_models(mc), mc,
                                     jax.random.PRNGKey(0), keys=list(KEYS))
    flat = {k: {n: a for coll in v.values() for n, a in flatten(coll).items()}
            for k, v in variables.items()}
    flat["slm"] = flatten(init_slm_params(jax.random.PRNGKey(1), mc))
    return flat


@pytest.mark.parametrize("model", KEYS + ("slm",))
def test_export_inverts_load_flax_params(jax_variables, model):
    from stylish_tts_tpu_torch.models.slm import SLMFeatureExtractor
    from stylish_tts_tpu_torch.train.init import build_training_models

    mc = tiny_model_config()
    module = (SLMFeatureExtractor(n_layers=mc.slm.layers) if model == "slm"
              else build_training_models(mc)[model])
    flat = jax_variables[model]
    module.load_state_dict(load_flax_params(model, flat, module))
    got = export_flax_params(model, module)
    assert got.keys() == flat.keys()
    for name, want in flat.items():
        assert got[name].shape == want.shape, name  # flax shapes, 0-d too
        assert got[name].dtype == want.dtype, name
        assert np.array_equal(got[name], want), name
