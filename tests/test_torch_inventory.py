"""Nothing public of the JAX package is left without a port counterpart or
a stated reason.

Every public top-level ``def`` or ``class`` of ``onedc_tpu/`` (by ``ast``,
nothing imported) must either be defined (a ``def``, ``class`` or
assignment) under the same name in the same file of ``onedc_tpu_torch/``,
or appear in ``COUNTERPARTS`` (a port ``file:name`` that exists) or in
``REASONS`` (why it has none). A new public JAX name without an entry
fails here, and so does an entry that no longer names anything.
``OPTION_REASONS`` names the parameters of a ported JAX function that its
counterpart leaves out, each with its reason.
"""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "onedc_tpu"
PORT = ROOT / "onedc_tpu_torch"

# JAX file:name -> the port's file:name that does its work
COUNTERPARTS = {
    "data/datasets.py:load_image": "data/images.py:load_image",
    "data/datasets.py:save_image": "data/images.py:save_image",
    "data/datasets.py:ImageFolderDataset":
        "data/images.py:ImageFolderDataset",
    "data/datasets.py:resize": "data/crops.py:resize",
    "data/datasets.py:resize_if_small": "data/crops.py:resize_if_small",
    "data/datasets.py:random_crop": "data/crops.py:random_crop",
    "data/datasets.py:MultiResolutionCrop":
        "data/crops.py:MultiResolutionCrop",
    "entropy/bound.py:add_uniform_noise": "entropy/bound.py:uniform_noise",
    "nn/attention.py:flash_attention_tpu":
        "ops/flash_attention.py:flash_attention",
    "nn/blocks.py:upsample2x_conv3x3": "nn/blocks.py:UpsampleConv2x",
    "nn/blocks.py:Conv": "nn/blocks.py:Conv2d",
    "nn/blocks.py:group_norm": "nn/blocks.py:group_norm_affine",
    "nn/quant.py:w8a8_methods": "nn/quant.py:w8a8_scope",
    "nn/quant.py:quant_methods": "nn/quant.py:scoped",
    "nn/unet_sd.py:CrossAttnDownBlock2D": "nn/unet_sd.py:DownBlock2D",
    "nn/unet_sd.py:PlainDownBlock2D": "nn/unet_sd.py:DownBlock2D",
    "nn/unet_sd.py:CrossAttnUpBlock2D": "nn/unet_sd.py:UpBlock2D",
    "nn/unet_sd.py:PlainUpBlock2D": "nn/unet_sd.py:UpBlock2D",
    "ops/pallas_conv.py:supports_pallas_conv": "ops/conv3x3.py:_check_conv",
    "ops/pallas_conv.py:conv3x3_same": "ops/conv3x3.py:conv3x3_dx",
    "ops/pallas_conv.py:conv3x3": "nn/blocks.py:conv3x3",
    "ops/pallas_conv.py:affine_silu_conv3x3":
        "ops/conv3x3.py:affine_silu_conv3x3",
    "ops/pallas_conv.py:gn_silu_conv3x3": "nn/vae.py:fused_norm_silu_conv",
    "ops/rans.py:get_native_lib": "ops/rans.py:native_lib",
    "ops/rans.py:NativeRansEncoder": "ops/rans.py:RansEncoder",
    "ops/rans.py:NativeRansDecoder": "ops/rans.py:RansDecoder",
    "parallel/fsdp.py:fsdp_shardings": "parallel/fsdp.py:spec_for",
    "parallel/fsdp.py:shard_state": "parallel/fsdp.py:shard_model",
    "parallel/mesh.py:batch_sharding": "parallel/mesh.py:rank_rows",
    "parallel/mesh.py:shard_batch": "parallel/mesh.py:rank_rows",
    "parallel/spatial.py:spatial_anchor": "parallel/spatial.py:Band",
    "train/step.py:make_frozen_labels": "train/step.py:split_frozen",
    "train/step.py:make_masked_optimizer": "train/step.py:create_train_state",
    "train/step.py:grad_accum_scan": "train/step.py:make_train_step",
    "train/step.py:make_unrolled_accum_step": "train/step.py:make_train_step",
    "train/trainer_stage2.py:create_stage2_states":
        "train/step.py:create_stage2_states",
    "utils/aot.py:load_exported": "serving/bundle.py:load_exported",
    "utils/checkpoint.py:flatten_params":
        "utils/convert.py:flat_jax_from_state_dict",
    "utils/checkpoint.py:unflatten_params":
        "utils/safetensors.py:unflatten_params",
    "utils/checkpoint.py:save_safetensors":
        "utils/safetensors.py:save_safetensors",
    "utils/checkpoint.py:load_safetensors":
        "utils/safetensors.py:load_safetensors",
}

# JAX file:name -> why the port has no counterpart
REASONS = {
    "entropy/fourpart.py:StepResult":
        "the named result of a jitted four-part step; the port's steps "
        "return plain tuples",
    "entropy/fourpart.py:decompress_step_scales":
        "the host-scale decode path; the port's decode ships device indexes "
        "(entropy/gaussian.py:build_indexes), as JAX's serving path does",
    "entropy/framing.py:get_downsampled_shape":
        "exported but called nowhere in the JAX package; get_padding_size "
        "gives the padded size the port uses",
    "entropy/framing.py:write_uints":
        "file-object helper of JAX's encode_i; the port's encode_i packs "
        "with struct in one call",
    "entropy/framing.py:write_uchars": "as write_uints",
    "entropy/framing.py:read_uints":
        "file-object helper of JAX's decode_i; the port's decode_i unpacks "
        "with struct from the bytes",
    "entropy/framing.py:read_uchars": "as read_uints",
    "entropy/framing.py:write_bytes": "as write_uints",
    "entropy/framing.py:read_bytes": "as read_uints",
    "entropy/framing.py:write_ushorts": "as write_uints",
    "entropy/framing.py:read_ushorts": "as read_uints",
    "nn/blocks.py:upsample_nearest_2x":
        "a TPU-only rewrite of the nearest upsample (gathers are slow "
        "there); the port's UpsampleConv2x upsamples with "
        "torch.nn.functional.interpolate",
    "nn/blocks.py:pixel_shuffle":
        "torch's own torch.nn.functional.pixel_shuffle (NCHW)",
    "nn/blocks.py:leaky_relu": "torch's own torch.nn.functional.leaky_relu",
    "nn/vae.py:Conv2dParams":
        "a flax container of a raw (kernel, bias) pair; the port's convs "
        "are nn.Conv2d modules whose weight K2 reads",
    "ops/rans.py:PyRansEncoder":
        "a fallback the port must not have: the port raises if its library "
        "does not build",
    "ops/rans.py:PyRansDecoder": "as PyRansEncoder",
    "parallel/mesh.py:replicated":
        "GSPMD's replicated NamedSharding; a port tensor outside FSDP is "
        "whole on every rank",
    "parallel/mesh.py:replicate_params":
        "GSPMD placement of a replicated tree; DDP and the port's FSDP "
        "(parallel/fsdp.py:shard_model) keep the unsharded parameters whole "
        "on every rank",
}

# JAX file:function:parameter -> why the port's counterpart has no such
# parameter
OPTION_REASONS = {
    "train/step.py:make_unrolled_accum_step:micro_grads_dtype":
        "a memory lever no trainer, config or CLI sets; to be ported with "
        "the first configuration that needs bf16 micro-gradients",
    "train/step.py:make_unrolled_accum_step:accum_dtype":
        "as micro_grads_dtype",
}


def _functions(root: Path, rel: str):
    """name -> its top-level def in ``root / rel``."""
    tree = ast.parse((root / rel).read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _params(fn: ast.FunctionDef):
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}


def _jax_names():
    names = {}
    for f in sorted(JAX.rglob("*.py")):
        rel = f.relative_to(JAX).as_posix()
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) \
                    and not node.name.startswith("_"):
                names[f"{rel}:{node.name}"] = node.lineno
    return names


def _port_defined():
    """Every ``file:name`` the port defines at its top level."""
    out = set()
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(PORT).as_posix()
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out.add(f"{rel}:{node.name}")
            elif isinstance(node, ast.Assign):
                out.update(f"{rel}:{t.id}" for t in node.targets
                           if isinstance(t, ast.Name))
    return out


def test_every_public_jax_name_has_a_counterpart_or_a_reason():
    jax_names, port = _jax_names(), _port_defined()
    assert len(jax_names) > 250 and len(port) > 250
    assert not set(COUNTERPARTS) & set(REASONS)
    unmapped = [k for k in jax_names if k not in port
                and k not in COUNTERPARTS and k not in REASONS]
    assert unmapped == [], ("public JAX names with no port counterpart or "
                            f"reason: {unmapped}")
    missing = {k: v for k, v in COUNTERPARTS.items() if v not in port}
    assert missing == {}, f"counterparts that do not exist: {missing}"
    assert all(len(r) > 10 for r in REASONS.values())
    # entries that name nothing, or a name the port now defines in place
    stale = [k for k in list(COUNTERPARTS) + list(REASONS)
             if k not in jax_names or k in port]
    assert stale == [], f"stale entries: {stale}"


def test_every_jax_module_has_a_port_module():
    """Each JAX file with public names has its file in the port, but for
    the TPU-only ones whose names all moved (``ops/pallas_conv.py``: the
    K2 / K3 wrappers are ``ops/conv3x3.py``)."""
    jax_files = {k.split(":")[0] for k in _jax_names()}
    port_files = {f.relative_to(PORT).as_posix() for f in PORT.rglob("*.py")}
    assert sorted(jax_files - port_files) == ["ops/pallas_conv.py"]


def test_left_out_options_are_jax_options_the_port_lacks():
    """Each entry of ``OPTION_REASONS`` is a parameter of its JAX function,
    and its port counterpart (same name, or ``COUNTERPARTS``) does not
    take it: an option ported later makes its entry stale."""
    assert all(len(r) > 10 for r in OPTION_REASONS.values())
    for key in OPTION_REASONS:
        rel, name, param = key.split(":")
        assert param in _params(_functions(JAX, rel)[name]), key
        prel, pname = COUNTERPARTS.get(f"{rel}:{name}",
                                       f"{rel}:{name}").split(":")
        assert param not in _params(_functions(PORT, prel)[pname]), key
