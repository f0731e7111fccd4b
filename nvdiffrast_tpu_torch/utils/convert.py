"""numpy -> port tensors.

The JAX package's tests build their inputs as numpy arrays; this turns
the same arrays into tensors of the port's layout and dtypes (float ->
float32, integer -> int32) on a named device, so both packages see the
same values.
"""

import numpy as np
import torch


def inputs_from_numpy(*arrays, device="cpu"):
    """Convert arrays (numpy or array-likes, None passes through).

    Returns a tuple of tensors, one per argument, in the same order.
    """
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32, copy=False)
        elif np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int32, copy=False)
        else:
            raise TypeError(f"inputs_from_numpy: unsupported dtype {a.dtype}")
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:  # e.g. a view of a JAX array
            a = a.copy()
        out.append(torch.from_numpy(a).to(device))
    return tuple(out)
