"""Recurrent ops: Caffe's RNN and LSTM over time-major sequences (port of
``caffe_escoin_tpu/ops/recurrent.py``).

Reference: `src/caffe/layers/recurrent_layer.cpp`, `lstm_layer.cpp` and
`rnn_layer.cpp`. Caffe unrolls the recurrence into a static graph and the
JAX package into a ``lax.scan``; here it is a Python loop over the time
steps, each one matmul with the recurrent weight (the input projection of
every step is one matmul up front). Inputs are time-major [T, N, D] with a
continuation indicator cont [T, N]: 0 at a sequence start resets the state
(`recurrent_layer.cpp:23-38`).

LSTM (lstm_layer.cpp:180-240), gate order i, f, o, g:
  [i, f, o, g] = x_t W_x + h_{t-1} W_h + b;  c_t = f*c + i*g;  h = o*tanh(c)
RNN (rnn_layer.cpp): h_t = tanh(x_t W_x + h_{t-1} W_h + b)
"""

from __future__ import annotations

import torch


def rnn_forward(x, cont, wx, wh, b, h0=None):
    """x: [T,N,D], cont: [T,N], wx: [D,H], wh: [H,H], b: [H] -> [T,N,H]."""
    t, n, _ = x.shape
    h = h0 if h0 is not None else x.new_zeros((n, wx.shape[1]))
    xw = x @ wx + b
    cont = cont.to(x.dtype)
    hs = []
    for s in range(t):
        h = torch.tanh(xw[s] + (h * cont[s][:, None]) @ wh)
        hs.append(h)
    return torch.stack(hs)


def lstm_step(c_prev, gates):
    """One LSTM cell step from pre-activation gates [N, 4H] (order i, f, o,
    g): (c, h)."""
    i, f, o, g = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def lstm_forward(x, cont, wx, wh, b, h0=None, c0=None):
    """x: [T,N,D], wx: [D,4H], wh: [H,4H], b: [4H]. Returns (h_seq [T,N,H],
    (h_T, c_T))."""
    t, n, _ = x.shape
    hidden = wh.shape[0]
    h = h0 if h0 is not None else x.new_zeros((n, hidden))
    c = c0 if c0 is not None else x.new_zeros((n, hidden))
    xw = x @ wx + b
    cont = cont.to(x.dtype)
    hs = []
    for s in range(t):
        m = cont[s][:, None]
        c, h = lstm_step(c * m, xw[s] + (h * m) @ wh)
        hs.append(h)
    return torch.stack(hs), (h, c)
