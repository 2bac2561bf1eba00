"""OCR recognition (``paddle_tpu/models/ocr.py``, PaddleCV's
``ocr_recognition`` CRNN-CTC): a conv feature extractor, the image's
columns as time steps, a bidirectional GRU encoder, per-frame vocabulary
logits, the CTC loss and greedy decoding (``ops.crf``)."""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.models.common import ZooModel
from paddle_tpu_torch.models.resnet import ConvBNLayer
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.nn.rnn import BiRNN, GRUCell
from paddle_tpu_torch.ops import crf as crf_ops
from paddle_tpu_torch.ops import nn as ops_nn

__all__ = ["CRNN"]


class CRNN(ZooModel):
    """``x`` (B, H, W, C) text-line images; the width becomes time (T = W
    // 4). Vocabulary index 0 is the CTC blank."""

    def __init__(self, vocab_size, *, in_ch=1, width=32, hidden=48,
                 img_h=32, device="cuda", seed: int = 0):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBNLayer(in_ch, width, 3, act="relu"),
            ConvBNLayer(width, width * 2, 3, act="relu"),
            ConvBNLayer(width * 2, width * 2, 3, act="relu"),
        ])
        self._pools = [(2, 2), (2, 2), (2, 1)]   # h / 8, w / 4
        feat_dim = width * 2 * (img_h // 8)
        self.rnn = BiRNN(GRUCell(feat_dim, hidden), GRUCell(feat_dim, hidden))
        self.head = Linear(2 * hidden, vocab_size, sharding=None)
        self._finish(device, seed)

    def logits(self, x):
        """-> (B, T, V) per-column logits."""
        for conv, (ph, pw) in zip(self.convs, self._pools):
            x = ops_nn.pool2d(conv(x), kernel=(ph, pw), stride=(ph, pw),
                              pool_type="max")
        b, h, w, c = x.shape
        seq = x.transpose(1, 2).reshape(b, w, h * c)     # columns = time
        enc, _ = self.rnn(seq)
        return self.head(enc)

    def loss(self, image, label, label_lengths):
        logits = self.logits(image)
        frames = torch.full((image.shape[0],), logits.shape[1],
                            dtype=torch.int32, device=logits.device)
        return crf_ops.ctc_loss(logits, frames, label,
                                label_lengths).mean(), {}

    def recognize(self, image):
        """Greedy CTC decoding -> (tokens (B, T), lengths (B,))."""
        logits = self.logits(image)
        frames = torch.full((image.shape[0],), logits.shape[1],
                            dtype=torch.int32, device=logits.device)
        return crf_ops.ctc_greedy_decoder(torch.softmax(logits, -1), frames)
