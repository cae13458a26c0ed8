"""The plain reference of RawFormer: fp32 PyTorch, no kernel, no cache.

A frozen copy of the canonical RawFormer oracle (``tests/torch_oracle.py``,
``RawFormerOracle``: the RawFomer_WFB_FFAB U-Net wiring with the
channel-attention Conv_Transformer, reference-compatible parameter names,
which the port's ``state_dict`` shares). The benchmark holds the port's
outputs against it; it imports nothing of the port, and a change to the
oracle in ``tests/`` does not move this copy.

Call it with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False): ``port_bench.reference.fp32``
does that.
"""
import torch
import torch.nn as nn
import torch.nn.functional as F


class Attention(nn.Module):
    """Reference RawFomer_WFB_FFAB/model.py:338-370."""

    def __init__(self, dim, num_heads, bias=True):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=bias)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1, groups=dim * 3, bias=bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=bias)

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = self.qkv_dwconv(self.qkv(x))
        q, k, v = qkv.chunk(3, dim=1)
        ch = c // self.num_heads

        def reshape(t):
            return t.reshape(b, self.num_heads, ch, h * w)

        q, k, v = reshape(q), reshape(k), reshape(v)
        q = F.normalize(q, dim=-1)
        k = F.normalize(k, dim=-1)
        attn = (q @ k.transpose(-2, -1)) * self.temperature
        attn = attn.softmax(dim=-1)
        out = (attn @ v).reshape(b, c, h, w)
        return self.project_out(out)


class ConvFFN(nn.Module):
    """Reference conv_ffn, RawFomer_WFB_FFAB/model.py:319-336."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.pointwise1 = nn.Conv2d(dim, hidden, 1)
        self.depthwise = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.pointwise2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        return self.pointwise2(F.gelu(self.depthwise(self.pointwise1(x))))


class ChannelLayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.body = nn.LayerNorm(dim)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.body(x.permute(0, 2, 3, 1))
        return y.permute(0, 3, 1, 2)


class TransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, ffn_expansion):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = ChannelLayerNorm(dim)
        self.ffn = ConvFFN(dim, dim * ffn_expansion)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        x = x + self.ffn(self.norm2(x))
        return x


class ConvTransformer(nn.Module):
    """Commented original, RawFomer_WFB_FFAB/model.py:394-412."""

    def __init__(self, dim, num_heads=8, ffn_expansion=2):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)
        self.Transformer = TransformerBlock(dim, num_heads, ffn_expansion)
        self.channel_reduce = nn.Conv2d(dim * 2, dim, 1)
        self.Conv_out = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        conv = F.leaky_relu(self.conv(x), 0.2)
        trans = self.Transformer(x)
        y = self.channel_reduce(torch.cat([conv, trans], 1))
        return F.leaky_relu(self.Conv_out(y), 0.2)


class Downsample(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(dim, dim // 2, 3, padding=1, bias=False))

    def forward(self, x):
        return F.pixel_unshuffle(self.body(x), 2)


class RawFormerOracle(nn.Module):
    """Canonical RawFormer (RawFomer_WFB_FFAB/model.py:437-508 wiring)."""

    def __init__(self, inp_channels=1, out_channels=3, dim=48, num_heads=(8, 8, 8, 8), ffn_expansion=2):
        super().__init__()
        self.embedding = nn.Conv2d(inp_channels * 4, dim, 3, padding=1)
        self.conv_tran1 = ConvTransformer(dim, num_heads[0], ffn_expansion)
        self.down1 = Downsample(dim)
        self.conv_tran2 = ConvTransformer(dim * 2, num_heads[1], ffn_expansion)
        self.down2 = Downsample(dim * 2)
        self.conv_tran3 = ConvTransformer(dim * 4, num_heads[2], ffn_expansion)
        self.down3 = Downsample(dim * 4)
        self.conv_tran4 = ConvTransformer(dim * 8, num_heads[3], ffn_expansion)
        self.up1 = nn.ConvTranspose2d(dim * 8, dim * 4, 2, stride=2)
        self.channel_reduce1 = nn.Conv2d(dim * 8, dim * 4, 1)
        self.conv_tran5 = ConvTransformer(dim * 4, num_heads[2], ffn_expansion)
        self.up2 = nn.ConvTranspose2d(dim * 4, dim * 2, 2, stride=2)
        self.channel_reduce2 = nn.Conv2d(dim * 4, dim * 2, 1)
        self.conv_tran6 = ConvTransformer(dim * 2, num_heads[1], ffn_expansion)
        self.up3 = nn.ConvTranspose2d(dim * 2, dim, 2, stride=2)
        self.channel_reduce3 = nn.Conv2d(dim * 2, dim, 1)
        self.conv_tran7 = ConvTransformer(dim, num_heads[0], ffn_expansion)
        self.conv_out = nn.Conv2d(dim, out_channels * 4, 3, padding=1)

    def forward(self, x):
        x = torch.clamp(x, 0, 1)
        x = F.pixel_unshuffle(x, 2)
        x = self.embedding(x)
        c1 = self.conv_tran1(x)
        p1 = self.down1(c1)
        c2 = self.conv_tran2(p1)
        p2 = self.down2(c2)
        c3 = self.conv_tran3(p2)
        p3 = self.down3(c3)
        c4 = self.conv_tran4(p3)
        u1 = self.up1(c4)
        c5 = self.conv_tran5(self.channel_reduce1(torch.cat([u1, c3], 1)))
        u2 = self.up2(c5)
        c6 = self.conv_tran6(self.channel_reduce2(torch.cat([u2, c2], 1)))
        u3 = self.up3(c6)
        c7 = self.conv_tran7(self.channel_reduce3(torch.cat([u3, c1], 1)))
        out = F.pixel_shuffle(F.leaky_relu(self.conv_out(c7), 0.2), 2)
        return torch.clamp(out, 0, 1)
