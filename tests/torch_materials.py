"""Material descriptions of every type the port compiles, and their tables
in both packages, shared by the BSDF and material parity tests."""
import warnings

import jax.numpy as jnp
import numpy as np

from tests.torch_parity import tt

# one desc per type and variant; the tests pick rows by name
MATERIALS = [
    {"type": "diffuse", "name": "lambert", "param": {"color": [0.7, 0.5, 0.3]}},
    {"type": "diffuse", "name": "oren_nayar",
     "param": {"color": [0.6, 0.6, 0.2], "sigma": 25.0}},
    {"type": "mirror", "name": "mirror_rough",
     "param": {"color": [0.9, 0.8, 0.7], "roughness": 0.35}},
    {"type": "mirror", "name": "mirror_smooth", "param": {"roughness": 0.001}},
    {"type": "metal", "name": "metal_cu_aniso",
     "param": {"material_name": "Cu", "roughness": 0.4, "anisotropic": 0.5}},
    {"type": "metal", "name": "metal_au",
     "param": {"material_name": "Au", "roughness": [0.2, 0.05]}},
    {"type": "metallic", "name": "metallic",
     "param": {"color": [0.8, 0.6, 0.3], "edge_tint": [1.0, 0.9, 0.8],
               "roughness": 0.3}},
    {"type": "glass", "name": "glass_bk7",
     "param": {"material_name": "BK7", "roughness": 0.2,
               "color": [1.0, 0.95, 0.9]}},
    {"type": "glass", "name": "glass_ior",
     "param": {"ior": 1.33, "roughness": 0.05, "remapping_roughness": False}},
    {"type": "substrate", "name": "substrate",
     "param": {"color": [0.3, 0.5, 0.7], "spec": [0.08, 0.06, 0.04],
               "roughness": 0.4}},
    {"type": "plastic", "name": "plastic",
     "param": {"color": [0.8, 0.2, 0.2], "roughness": 0.3, "ior": 1.6}},
    {"type": "principled_bsdf", "name": "principled",
     "param": {"color": [0.75, 0.6, 0.35], "roughness": 0.45,
               "anisotropic": -0.3, "metallic": 0.2, "spec_trans": 0.3,
               "spec_tint": 0.4, "ior": 1.45, "sheen": 0.7, "sheen_tint": 0.5,
               "sheen_roughness": 0.3, "clearcoat": 0.8,
               "clearcoat_alpha": 0.15}},
    {"type": "emission", "name": "emission", "param": {}},
    {"type": "black_body", "name": "black_body", "param": {}},
    {"type": "mix", "name": "mix",
     "param": {"frac": 0.3,
               "mat0": {"type": "diffuse", "param": {"color": [0.9, 0.9, 0.9]}},
               "mat1": {"type": "glass", "param": {"ior": 1.5,
                                                   "roughness": 0.1}}}},
    {"type": "add", "name": "add",
     "param": {"mat0": {"type": "diffuse", "param": {"color": [0.4, 0.4, 0.4]}},
               "mat1": {"type": "mirror", "param": {"color": [0.3, 0.3, 0.3],
                                                    "roughness": 0.3}}}},
    {"type": "multi_layered", "name": "multi_layered",
     "param": {"bottom": {"type": "substrate",
                          "param": {"color": [0.2, 0.6, 0.3]}},
               "top": {"type": "principled_bsdf",
                       "param": {"color": [0.9, 0.9, 0.9], "clearcoat": 0.5}}}},
    {"type": "velvet_unknown", "name": "unknown", "param": {}},
    # node trees of constants fold on the host in both packages
    {"type": "diffuse", "name": "const_nodes",
     "param": {"color": {"type": "lerp", "param": {
         "t": 0.25, "A": [0.2, 0.4, 0.6],
         "B": {"type": "multiply", "param": {"lhs": [0.5, 0.5, 0.5],
                                             "rhs": 1.5}}}}}},
]
NAMES = [m["name"] for m in MATERIALS]


def build_tables():
    """(JAX MaterialTable, port MaterialTable, name -> row id)."""
    from vision_tpu.scene.texture import AtlasBuilder
    from vision_tpu.shading.materials import MaterialCompiler as JMC
    from vision_tpu_torch.scene.texture import AtlasBuilder as TA
    from vision_tpu_torch.shading.materials import MaterialCompiler as TMC
    jmc, tmc = JMC(AtlasBuilder()), TMC(TA())
    ids = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for m in MATERIALS:
            ids[m["name"]] = jmc.compile(m)
            assert tmc.compile(m) == ids[m["name"]]
    return jmc.build(), tmc.build("cpu"), ids


def gather_both(jt, pt_, mid, uv, atlas_j=None, atlas_t=None):
    """Both packages' gather_params on the same ids and uvs."""
    from vision_tpu.scene.texture import AtlasBuilder as JA
    from vision_tpu.shading.materials import gather_params as jg
    from vision_tpu_torch.scene.texture import AtlasBuilder as TA
    from vision_tpu_torch.shading.materials import gather_params as tg
    atlas_j = atlas_j or JA().build()
    atlas_t = atlas_t or TA().build("cpu")
    pa, _ = jg(jt, atlas_j, jnp.asarray(mid), jnp.asarray(uv))
    pb, disp = tg(pt_, atlas_t, tt(mid), tt(uv))
    assert not disp.any()
    return pa, pb


def unit(n, seed, upper=False):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    if upper:
        v[:, 2] = np.abs(v[:, 2])
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def uniform(n, k, seed):
    return np.random.default_rng(seed).random((n, k), dtype=np.float32)
