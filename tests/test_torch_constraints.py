"""The port's constraint energies (``drag/constraints.py``) against the JAX
package's, on the CPU, on random batched contexts made with numpy: each
energy (rtol 1e-5, atol 1e-6) and its gradient with respect to
positions, world quaternions and the global root position (rtol 1e-5,
atol 1e-6·max(1, max|g|): ``head_hips_forward`` divides by ground-plane
norms down to ~0, where its gradient reaches ~18), batched lanes against
one lane at a time (1e-7), and ``parse_spec``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
NAMES = ["feet_floor", "head_hips_forward", "head_hips_colinear",
         "hips_feet_colinear"]
B, J = 64, 22


def _contexts(seed=0):
    """Random positions (B, J, 3), unit world quaternions (B, J, 4) and
    root positions (B, 3): about half the lanes' heads look near straight
    up or down, so ``head_hips_forward``'s gate is both on and off."""
    rng = np.random.default_rng(seed)
    pos = (0.5 * rng.standard_normal((B, J, 3))).astype(np.float32)
    q = rng.standard_normal((B, J, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    gp = rng.standard_normal((B, 3)).astype(np.float32)
    return pos, q, gp


def _jax_value_and_grads(name, pos, q, gp):
    import jax
    import jax.numpy as jnp

    from dragposer_tpu.drag import constraints as jcons
    from dragposer_tpu.drag.engine import ConstraintContext

    fn = getattr(jcons, name)()

    def one(p, w, g):
        ctx = ConstraintContext(
            latent=jnp.zeros(24), pose=jnp.zeros(J * 4), positions=p,
            world_quats=w, rotmats=jnp.zeros((J, 3, 3)), global_pos=g,
            world_displacement=jnp.zeros(3))
        return fn(ctx)

    vals = jax.vmap(one)(pos, q, gp)
    grads = jax.grad(lambda p, w, g: jax.vmap(one)(p, w, g).sum(),
                     argnums=(0, 1, 2))(pos, q, gp)
    return np.asarray(vals), [np.asarray(g) for g in grads]


def _port_value_and_grads(name, pos, q, gp):
    from dragposer_tpu_torch.drag import constraints as tcons
    from dragposer_tpu_torch.drag.engine import ConstraintContext

    fn = getattr(tcons, name)()
    leaves = [torch.tensor(a, requires_grad=True) for a in (pos, q, gp)]
    n = pos.shape[0]
    ctx = ConstraintContext(
        latent=torch.zeros(n, 24), pose=torch.zeros(n, J * 4),
        positions=leaves[0], world_quats=leaves[1],
        rotmats=torch.zeros(n, J, 3, 3), global_pos=leaves[2],
        world_displacement=torch.zeros(n, 3))
    vals = fn(ctx)
    grads = torch.autograd.grad(vals.sum(), leaves, allow_unused=True,
                                materialize_grads=True)
    return vals.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("name", NAMES)
def test_energy_and_gradient_match_jax(name):
    pos, q, gp = _contexts()
    jv, jg = _jax_value_and_grads(name, pos, q, gp)
    tv, tg = _port_value_and_grads(name, pos, q, gp)
    assert tv.shape == (B,)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    for t, j, leaf in zip(tg, jg, ("positions", "world_quats",
                                   "global_pos")):
        np.testing.assert_allclose(t, j, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(j).max()),
                                   err_msg=leaf)
    if name == "head_hips_forward":   # the gate is both on and off
        assert 0 < (jv == 0).sum() < B


@pytest.mark.parametrize("name", NAMES)
def test_batched_equals_per_lane(name):
    pos, q, gp = _contexts(seed=1)
    tv, tg = _port_value_and_grads(name, pos, q, gp)
    for b in range(0, B, 9):
        v, g = _port_value_and_grads(name, pos[b:b + 1], q[b:b + 1],
                                     gp[b:b + 1])
        np.testing.assert_allclose(v, tv[b:b + 1], rtol=1e-7, atol=1e-7)
        for a, full in zip(g, tg):
            np.testing.assert_allclose(a, full[b:b + 1], rtol=1e-7,
                                       atol=1e-7)


def test_parse_spec():
    from dragposer_tpu.drag import constraints as jcons
    from dragposer_tpu_torch.drag import constraints as tcons

    spec = "feet_floor:0.5, head_hips_colinear ,hips_feet_colinear:2"
    got, ref = tcons.parse_spec(spec), jcons.parse_spec(spec)
    assert [w for _, w in got] == [w for _, w in ref] == [0.5, 1.0, 2.0]
    assert tcons.parse_spec("") == tcons.parse_spec("  ") == ()
    assert tcons.parse_spec(None) == ()
    with pytest.raises(ValueError, match="unknown constraint 'toes'"):
        tcons.parse_spec("feet_floor:1,toes:0.1")
    assert [w for _, w in tcons.REFERENCE_BUNDLE] == [1.0] * 4
    # each parsed term is the named energy
    pos, q, gp = _contexts(seed=2)
    for (fn, _), name in zip(got, ("feet_floor", "head_hips_colinear",
                                   "hips_feet_colinear")):
        from dragposer_tpu_torch.drag.engine import ConstraintContext

        ctx = ConstraintContext(
            latent=None, pose=None, positions=torch.as_tensor(pos),
            world_quats=torch.as_tensor(q), rotmats=None,
            global_pos=torch.as_tensor(gp), world_displacement=None)
        np.testing.assert_array_equal(
            fn(ctx).numpy(), getattr(tcons, name)()(ctx).numpy())
