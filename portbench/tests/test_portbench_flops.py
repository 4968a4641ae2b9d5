"""The operation count against hand counts."""

import torch
from torch import nn

from portbench.flops import layer_flops, model_flops, train_step_flops


def test_layer_counts_by_hand():
    conv = nn.Conv2d(8, 16, 3, padding=1, groups=4)
    x = torch.zeros(2, 8, 5, 5)
    assert layer_flops(conv, x, conv(x)) == 2 * 2 * 16 * 25 * 2 * 9
    up = nn.ConvTranspose2d(6, 4, 2, stride=2)
    x = torch.zeros(1, 6, 3, 3)
    assert layer_flops(up, x, up(x)) == 2 * 9 * 6 * 4 * 4
    fc = nn.Linear(5, 7)
    x = torch.zeros(2, 3, 5)
    assert layer_flops(fc, x, fc(x)) == 2 * 6 * 5 * 7


def test_backward_counts_weight_and_input_gradients():
    model = nn.Sequential(nn.Conv2d(1, 4, 3, padding=1),
                          nn.Conv2d(4, 4, 1))
    x = torch.zeros(1, 1, 4, 4)
    first = 2 * 16 * 4 * 1 * 9
    second = 2 * 16 * 4 * 4
    assert model_flops(model, x) == first + second
    # the image takes no gradient: the first conv's weight gradient only
    assert model_flops(model, x, backward=True) == 2 * first + 3 * second


def test_step_count_scales_with_the_batch(tiny):
    cfg = tiny("mitonet").config
    two = train_step_flops(cfg, 2, 128, 16)
    assert two > 0 and train_step_flops(cfg, 6, 128, 16) == 3 * two
