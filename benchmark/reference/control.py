"""The reference itself run in the program's place: the control that the
judge must refuse when it computes in the precision just below the
configuration's (TF32 products for a float32 configuration).

It produces what the program produces, from the same inputs, and hands it to
the same judge: the offline batch's stored outputs, or a session's states
and replies.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference.drag import Frame, shift
from benchmark.reference.model import qmatrix, to_local


@contextlib.contextmanager
def tf32(on: bool = True):
    """Matrix products in TF32 (or not) while inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def offline(frame: Frame, inp: dict) -> dict:
    """The lanes of ``inp`` (as :func:`judge.follow_offline` takes them)
    reconstructed by the reference, in the form of the program's outputs."""
    h = frame.h
    lengths = inp["lengths"]
    B, T = inp["dqs"].shape[:2]
    z = frame.initial_latent(inp["dqs"][:, 0], inp["noise"])
    out = dict(initial_latent=z.clone(),
               latent=torch.zeros(B, T, z.shape[1], device=z.device),
               global_pos=torch.zeros(B, T, 3, device=z.device),
               global_rot=torch.zeros(B, T, 4, device=z.device),
               iterations=torch.zeros(B, T, dtype=torch.long,
                                      device=z.device))
    lat_buf, disp_buf, h_buf = frame.initial_buffers(z, inp["heights0"])
    pos, rot = inp["global_pos"][:, 0], inp["global_rot"][:, 0]
    for f in range(T):
        live = f < lengths
        slot = 0 if h.window == 0 else f % h.window
        if slot == 0:
            tbuf = frame.rollout(lat_buf, disp_buf, h_buf)
        tpos, trot = frame.targets_from_motion(
            inp["dqs"][:, f], inp["global_pos"][:, f], inp["global_rot"][:, f],
            pos)
        r = frame.optimize(z, rot, tpos, trot, tbuf[:, slot], live)
        pos_new, rot_new, disp, heights = frame.finish(pos, r["aux"], tpos)
        keep = live[:, None]
        out["latent"][:, f] = r["decoded"]
        out["global_pos"][:, f] = pos_new
        out["global_rot"][:, f] = rot_new
        out["iterations"][:, f] = r["steps"]
        z = torch.where(keep, r["latent"], z)
        pos = torch.where(keep, pos_new, pos)
        rot = torch.where(keep, rot_new, rot)
        k3 = keep[:, :, None]
        lat_buf = torch.where(k3, shift(lat_buf, r["decoded"]), lat_buf)
        disp_buf = torch.where(k3, shift(disp_buf, disp), disp_buf)
        h_buf = torch.where(k3, shift(h_buf, heights), h_buf)
    pose_n, _ = frame.vae.decode(out["latent"])
    out["pose"] = torch.cat((frame.root_pose(out.pop("global_rot")),
                             pose_n[..., 4:]), dim=-1)
    return out


def session(frame: Frame, start: dict, targets) -> list:
    """A session's frames from its state ``start`` (one lane, as the
    program keeps it) for ``targets``, a function of (frame index, last root
    position) → (positions (E, 3), rotations (E, 4)) of the tracked joints.
    Returns, per frame, (state before, (positions, rotations), local
    quaternions (J, 4), root position (3,), state after), as the session
    driver records the program's."""
    h = frame.h
    ee = torch.nonzero(frame.mask).flatten()
    J = frame.sk.n_joints
    state = {k: v[None] for k, v in start.items()}
    root = state["global_pos"][0].clone()
    frames = []
    i = 0
    while True:
        got = targets(i, root)
        if got is None:
            return frames
        p, r = (torch.as_tensor(x, device=root.device) for x in got)
        tpos = torch.zeros(1, J, 3, device=root.device)
        trot = torch.zeros(1, J, 4, device=root.device)
        trot[..., 0] = 1.0
        tpos[0, ee], trot[0, ee] = p, r
        tbuf = state["target_buffer"]
        if h.window == 0 or int(state["current_index"]) == 0:
            tbuf = frame.rollout(state["latent_buffer"],
                                 state["displacement_buffer"],
                                 state["heights_buffer"])
        slot = int(state["current_index"])
        res = frame.optimize(state["latent"], state["global_rot"], tpos,
                             qmatrix(trot), tbuf[:, slot],
                             torch.ones(1, dtype=torch.bool,
                                        device=root.device))
        pos, rot, disp, heights = frame.finish(state["global_pos"],
                                               res["aux"], tpos)
        q = frame.vae.quats(res["aux"]["pose_n"])
        local = to_local(frame.sk, torch.cat((rot[:, None], q[:, 1:]), 1))
        after = dict(
            latent=res["latent"], global_pos=pos, global_rot=rot,
            latent_buffer=shift(state["latent_buffer"], res["decoded"]),
            displacement_buffer=shift(state["displacement_buffer"], disp),
            heights_buffer=shift(state["heights_buffer"], heights),
            target_buffer=tbuf,
            current_index=(state["current_index"] + 1) % max(h.window, 1))
        frames.append(({k: v[0] for k, v in state.items()}, (p, r),
                       local[0], pos[0], {k: v[0] for k, v in after.items()}))
        state = after
        root = pos[0].clone()
        i += 1

