"""flashattn_tpu: a JAX (XLA/Pallas) framework with the capabilities of the
reference CUDA/minitorch FlashAttention project
(Yogesh352/llmsys-project-flashattn), run on NVIDIA GPUs.

Layer map (reference -> here, see SURVEY.md §1):

* L0 operators            -> :mod:`flashattn_tpu.operators` (jnp prelude)
* L1 tensor_data          -> jax.Array / XLA layouts (no hand-rolled strides)
* L2 ops backends         -> XLA under ``jax.jit`` + Pallas kernels in
                             :mod:`flashattn_tpu.ops`
* L3 CUDA kernels         -> flash attention and paged decode as Pallas
                             kernels compiled through Triton, cuDNN's
                             fused attention; softmax, layernorm and
                             dropout as XLA-fused ops
* L4 Tensor/autodiff      -> jax.grad + jax.custom_vjp;
                             :mod:`flashattn_tpu.autodiff` for grad_check
* L5 modules              -> :mod:`flashattn_tpu.module`, :mod:`...nn`
* L6 transformer          -> :mod:`flashattn_tpu.models.transformer`
* L7 training pipeline    -> :mod:`flashattn_tpu.training`
* L8 harness              -> :mod:`flashattn_tpu.utils.timing`, tests/, bench.py
* (new) parallelism       -> :mod:`flashattn_tpu.parallel` (mesh, TP/DP
                             shardings, ring attention)
"""

from . import operators
from .module import Module, Parameter
from .optim import SGD, Adafactor, Adam, AdamW
from .nn import functional as F
from .nn.basic import Dropout, Embedding, LayerNorm1d, Linear
from .ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_attention_varlen,
)
from .ops.dropout import (
    fused_dropout,
    fused_dropout_act_bias,
    fused_dropout_res_bias,
)
from .ops.layernorm import layernorm, layernorm_reference
from .ops.softmax import attn_softmax, attn_softmax_reference
from .models.transformer import (
    DecoderLM,
    FeedForward,
    MultiHeadAttention,
    TransformerLayer,
)
from .models.seq2seq import (
    CrossDecoderLayer,
    EncoderDecoderLM,
    EncoderLayer,
)
from .models.moe import MoEFeedForward

__version__ = "0.1.0"

__all__ = [
    "operators",
    "Module",
    "Parameter",
    "SGD",
    "Adafactor",
    "Adam",
    "AdamW",
    "F",
    "Dropout",
    "Embedding",
    "LayerNorm1d",
    "Linear",
    "flash_attention",
    "flash_attention_reference",
    "flash_attention_varlen",
    "layernorm",
    "layernorm_reference",
    "attn_softmax",
    "attn_softmax_reference",
    "DecoderLM",
    "FeedForward",
    "MultiHeadAttention",
    "TransformerLayer",
    "CrossDecoderLayer",
    "EncoderDecoderLM",
    "EncoderLayer",
    "MoEFeedForward",
]
