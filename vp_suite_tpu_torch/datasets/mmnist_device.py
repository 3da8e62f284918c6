r"""Moving MNIST training batches synthesised on the card.

The digit bank goes to the device once; each batch is drawn there from an
explicit ``torch.Generator`` on that device, so the host touches no frame
data. A batch is the JAX package's ``generate_batch``
(``datasets/mmnist_device.py``) split in two:

- :func:`sample`: the template ids ``[b, d]``, start positions ``pos0``
  ``[b, d, 2]`` (uniform in ``[0, S - ds)``) and speeds ``speed0``
  ``[b, d, 2]`` (uniform over ``±[min_speed, max_speed]``);
- :func:`render`: the bounce trajectories (:func:`simulate`, a loop over T on
  int tensors with the numpy path's physics) and the frames, each digit put
  at its integer position by a gather and the digits summed, then clipped to
  [0, 1] and broadcast over the channels.

The draws are torch's, not ``jax.random``'s: the same distributions and
physics, other samples. Given the same draws, :func:`render` gives the JAX
package's frames exactly. No Pallas kernel is involved, so this is plain
PyTorch.
"""
import numpy as np
import torch


def sample_speed(generator, shape, min_speed, max_speed):
    r"""Uniform over ``{±min_speed, ..., ±max_speed}`` (over
    ``{-max_speed..max_speed}`` where ``min_speed <= 0``), which is what the
    numpy path's rejection loop gives."""
    device = generator.device
    if min_speed <= 0:
        return torch.randint(-max_speed, max_speed + 1, shape, generator=generator,
                             device=device)
    n_mag = max_speed - min_speed + 1
    r = torch.randint(0, 2 * n_mag, shape, generator=generator, device=device)
    mag = min_speed + r % n_mag
    return torch.where(r < n_mag, mag, -mag)


def sample(generator, n_templates, batch, num_digits, img_size, digit_size, min_speed,
           max_speed):
    r"""One batch's draws: ``(ids [b, d], pos0 [b, d, 2], speed0 [b, d, 2])``,
    int64 on the generator's device."""
    device = generator.device
    ids = torch.randint(0, n_templates, (batch, num_digits), generator=generator, device=device)
    pos0 = torch.randint(0, img_size - digit_size, (batch, num_digits, 2), generator=generator,
                         device=device)
    speed0 = sample_speed(generator, (batch, num_digits, 2), min_speed, max_speed)
    return ids, pos0, speed0


def simulate(pos0, speed0, seq_len, img_size, digit_size):
    r"""Integer bounce trajectories ``[T, b, d, 2]``; frame 0 has already
    moved once, as in the numpy path."""
    far = img_size - digit_size
    pos, speed, traj = pos0, speed0, []
    for _ in range(seq_len):
        nxt = pos + speed
        hi = nxt + digit_size > img_size    # past the far wall: put against it
        lo = nxt < 0                        # past the near wall: mirror
        nxt = torch.where(hi, torch.full_like(nxt, far), torch.where(lo, -nxt, nxt))
        nxt = nxt.clamp(0, far)
        speed = torch.where(hi | lo, -speed, speed)
        traj.append(nxt)
        pos = nxt
    return torch.stack(traj)


def render(templates, ids, pos0, speed0, *, seq_len, img_size, num_channels,
           value_range=(0.0, 1.0)):
    r"""Frames ``[b, T, S, S, c]`` float32 in ``value_range`` from
    ``templates`` (float32 ``[n, ds, ds]`` in [0, 1]) and one batch's draws."""
    ds = templates.shape[-1]
    b, d = ids.shape
    digits = templates[ids]                                      # [b, d, ds, ds]
    traj = simulate(pos0, speed0, seq_len, img_size, ds)         # [T, b, d, 2]
    grid = torch.arange(img_size, device=ids.device)
    ry = grid - traj[..., 0:1]                                   # [T, b, d, S]: y - pos_y
    rx = grid - traj[..., 1:2]
    inside = (((ry >= 0) & (ry < ds))[..., :, None]
              & ((rx >= 0) & (rx < ds))[..., None, :])           # [T, b, d, S, S]
    bi = torch.arange(b, device=ids.device)[None, :, None, None, None]
    di = torch.arange(d, device=ids.device)[None, None, :, None, None]
    placed = digits[bi, di, ry.clamp(0, ds - 1)[..., :, None], rx.clamp(0, ds - 1)[..., None, :]]
    frames = torch.where(inside, placed, 0.0).sum(2).clamp(0.0, 1.0)   # [T, b, S, S]
    frames = frames.transpose(0, 1)[..., None].expand(-1, -1, -1, -1, num_channels)
    lo, hi = value_range
    if (lo, hi) != (0.0, 1.0):
        frames = frames * (hi - lo) + lo
    return frames.contiguous()


class DeviceBatchIterator:
    r"""Iterator over ``n_steps`` batches ``{"frames", "actions"}`` made on
    ``device`` (``actions``: zeros ``[b, T, action_size]``), in place of the
    host loader and its copies to the device."""

    def __init__(self, templates_u8, *, batch_size, seq_len, img_size, num_channels,
                 num_digits, min_speed, max_speed, value_range, n_steps, seed, device,
                 action_size=1):
        templates = np.asarray(templates_u8, dtype=np.float32) / 255.0
        self.device = torch.device(device)
        self._templates = torch.from_numpy(templates).to(self.device)
        self._draw = dict(batch=batch_size, num_digits=num_digits, img_size=img_size,
                          digit_size=templates.shape[-1], min_speed=min_speed,
                          max_speed=max_speed)
        self._render = dict(seq_len=seq_len, img_size=img_size, num_channels=num_channels,
                            value_range=tuple(float(v) for v in value_range))
        self.n_steps = n_steps
        self.seed = seed
        self._actions = torch.zeros((batch_size, seq_len, action_size), dtype=torch.float32,
                                    device=self.device)

    def __len__(self):
        return self.n_steps

    def __iter__(self):
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        for _ in range(self.n_steps):
            ids, pos0, speed0 = sample(generator, len(self._templates), **self._draw)
            frames = render(self._templates, ids, pos0, speed0, **self._render)
            yield {"frames": frames, "actions": self._actions}
