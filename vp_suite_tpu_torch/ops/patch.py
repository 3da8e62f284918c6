r"""Space-to-depth patches, PredRNN's ``reshape_patch`` on channels-last
tensors; the packed channels are ordered ``(p_h, p_w, c)``, as in the JAX
package and the reference, so carried weights line up."""


def patchify(x, patch_size: int):
    r"""``[b, t, h, w, c]`` -> ``[b, t, h/p, w/p, p*p*c]``."""
    b, t, h, w, c = x.shape
    p = patch_size
    x = x.reshape(b, t, h // p, p, w // p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t, h // p, w // p, p * p * c)


def unpatchify(x, patch_size: int):
    r"""``[b, t, hp, wp, p*p*c]`` -> ``[b, t, hp*p, wp*p, c]``."""
    b, t, hp, wp, cpp = x.shape
    p = patch_size
    x = x.reshape(b, t, hp, wp, p, p, cpp // (p * p)).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t, hp * p, wp * p, cpp // (p * p))
