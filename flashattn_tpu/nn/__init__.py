from . import functional
from .basic import Dropout, Embedding, LayerNorm1d, Linear
