from .convnet import (ChannelsLastConv1d, ConvBlock, ConvNet, ConvNetDouble,
                      ConvNetDoubleLayer, ConvStack, ResidualBlockStack,
                      MaxPoolMiddle, StridedConvMiddle, get_activation)
from .dropout import Draws, dropout, in_dtype, train_draws
from .layers import LayerNorm, Linear, gelu_tanh, layer_norm, linear, product_then_bias
from .embedding import SinePositionalEmbedding, TokenEmbedding, sinusoidal_table
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer, attend)
