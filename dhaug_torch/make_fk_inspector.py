"""Write a self-contained interactive DH-skeleton inspector (HTML + JS).

Port of ``scripts/make_fk_inspector.py``, the replacement for the
reference's PyQt slider tool (models_Fk_GAN/visual_Fk_DH_byQt.py:109 and
main_qt_visual.py): per-DOF angle sliders with a live skeleton replot, bone
length sliders, global rotation and view controls, as ONE static HTML file
that opens in any browser, which works on a headless machine where a Qt
display does not.

The DH angle tables, scatter map and bone-slot rewrites are taken from
``dhaug_torch.ops.fk`` (the FK's own tables), the initial link lengths
from ``LINK_LENGTHS`` below, and the page embeds four
golden poses computed here: on load the page's JS forward kinematics
re-evaluates them and shows the largest deviation, so a drifting JS copy is
visible at once (the "self-test" banner).  The goldens go through one
``ops/fk_cuda.fk_world_pose_16`` call on ``--device``: on the card one
launch of the FK kernel B1, on the CPU the plain FK.

    python -m dhaug_torch.make_fk_inspector --out fk_inspector.html
    python -m dhaug_torch.make_fk_inspector --device cpu

Runs on CUDA unless ``--device cpu`` is given; ``--device cuda`` without a
card raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.ops import fk, fk_cuda
from dhaug_torch.utils.viz import _LEFT_EDGES, SKELETON_EDGES_16

# The reference's initial link lengths a and d in metres
# (forward_kinematics_DH_model.py:234-261), shown on the page.  The JS FK
# overwrites every nonzero entry with a bone length (``fk.BONE_REWRITES``)
# before it walks a chain, as the plain FK does, so no pose depends on them;
# the shoulders' 0.3 is not the canonical 0.4.
LINK_LENGTHS = {
    "right_leg": ((0.25, 0.0, 0.0, 0.6, 0.5), (0.0,) * 5),
    "left_leg": ((-0.25, 0.0, 0.0, 0.6, 0.5), (0.0,) * 5),
    "body": ((0.0,) * 12 + (0.15,),
             (0.0, 0.0, 0.0, 0.25, 0.0, 0.0, 0.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)),
    "right_hand": ((-0.3, 0.0, 0.0, 0.4, 0.35), (0.0,) * 5),
    "left_hand": ((0.3, 0.0, 0.0, 0.4, 0.35), (0.0,) * 5),
}


def golden_inputs():
    """The four goldens' (angles (4, 33), bone lengths (4, 15), global
    rotations (4, 3)): the zero pose, then random poses drawn from
    ``np.random.default_rng(0)``, the last two with random bone lengths."""
    rng = np.random.default_rng(0)
    angles, bone_len, global_rot = [], [], []
    for i in range(4):
        angles.append(np.zeros(33, np.float32) if i == 0 else
                      rng.uniform(-120, 120, 33).astype(np.float32))
        bone_len.append(np.asarray(fk.CANONICAL_BONE_LEN, np.float32) if i < 2 else
                        rng.uniform(0.15, 0.6, 15).astype(np.float32))
        global_rot.append(np.zeros(3, np.float32) if i == 0 else
                          rng.uniform(-90, 90, 3).astype(np.float32))
    return np.stack(angles), np.stack(bone_len), np.stack(global_rot)


def build_spec(device) -> dict:
    """All constants the JS FK needs, from ``dhaug_torch.ops.fk``, and the
    goldens computed on ``device``."""
    chains = {name: dict(alpha=alpha, a=LINK_LENGTHS[name][0], d=LINK_LENGTHS[name][1],
                         theta=theta, angle_slice=list(span))
              for name, (alpha, theta, span) in fk.CHAINS.items()}
    scatter16 = []
    for slot16, slot32 in enumerate(fk.H36M_32_TO_16_TABLE):
        for s, chain, joint in fk._SCATTER:
            if s == slot32:
                scatter16.append([slot16, chain, joint])
                break

    angles, bone_len, global_rot = golden_inputs()
    with torch.no_grad():
        poses = fk_cuda.fk_world_pose_16(
            *(torch.as_tensor(x, device=device) for x in (angles, bone_len, global_rot)),
            torch.zeros((len(angles), 3), device=device)).cpu().numpy()
    goldens = [dict(angles=a.tolist(), bone_len=b.tolist(), global_rot=g.tolist(),
                    pose=np.round(p, 6).tolist())
               for a, b, g, p in zip(angles, bone_len, global_rot, poses)]
    return dict(chains=chains, rewrites=fk.BONE_REWRITES, scatter16=scatter16,
                edges=SKELETON_EDGES_16, left_edges=sorted(_LEFT_EDGES),
                canonical_bone_len=list(fk.CANONICAL_BONE_LEN),
                bone_names=list(fk.BONE_NAMES), goldens=goldens)


_HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>DH-AUG FK inspector</title>
<style>
 body { font-family: sans-serif; margin: 0; display: flex; }
 #panel { width: 430px; height: 100vh; overflow-y: auto; padding: 10px;
          background: #f4f4f4; font-size: 12px; }
 #panel h3 { margin: 8px 0 2px; }
 .row { display: flex; align-items: center; gap: 4px; }
 .row label { width: 150px; }
 .row input[type=range] { flex: 1; }
 .row span { width: 52px; text-align: right; }
 #view { flex: 1; position: relative; }
 canvas { display: block; }
 #selftest { position: absolute; top: 6px; left: 10px; padding: 4px 8px;
             border-radius: 4px; font-size: 13px; }
 .ok { background: #c9f7c9; } .bad { background: #f7c9c9; }
 button { margin: 4px 2px; }
</style></head><body>
<div id="panel">
 <h2>DH-AUG FK inspector</h2>
 <button onclick="resetAll()">reset pose</button>
 <button onclick="randomPose()">random pose</button>
 <div id="sliders"></div>
</div>
<div id="view"><canvas id="c"></canvas><div id="selftest"></div></div>
<script>
const SPEC = __SPEC_JSON__;
const D2R = Math.PI / 180;

// ---- FK: the (R, p) chain walk of dhaug_torch.ops.fk ----
function linkQT(alphaDeg, a, d, thetaDeg) {
  const al = alphaDeg * D2R, th = thetaDeg * D2R;
  const ca = Math.cos(al), sa = Math.sin(al);
  const ct = Math.cos(th), st = Math.sin(th);
  return [[[ct, -st, 0], [st*ca, ct*ca, -sa], [st*sa, ct*sa, ca]],
          [a, -sa*d, ca*d]];
}
function matmul(A, B) {
  const C = [[0,0,0],[0,0,0],[0,0,0]];
  for (let i=0;i<3;i++) for (let j=0;j<3;j++)
    C[i][j] = A[i][0]*B[0][j] + A[i][1]*B[1][j] + A[i][2]*B[2][j];
  return C;
}
function matvec(A, v) {
  return [A[0][0]*v[0]+A[0][1]*v[1]+A[0][2]*v[2],
          A[1][0]*v[0]+A[1][1]*v[1]+A[1][2]*v[2],
          A[2][0]*v[0]+A[2][1]*v[1]+A[2][2]*v[2]];
}
function eulerXYZ(deg) {
  const [x,y,z] = deg.map(v => v*D2R);
  const cx=Math.cos(x), sx=Math.sin(x), cy=Math.cos(y), sy=Math.sin(y),
        cz=Math.cos(z), sz=Math.sin(z);
  return [[cy*cz, -cy*sz, sy],
          [sx*sy*cz+cx*sz, -sx*sy*sz+cx*cz, -sx*cy],
          [-cx*sy*cz+sx*sz, cx*sy*sz+sx*cz, cx*cy]];
}
function walkChain(name, angles33, boneLen, start) {
  const ch = SPEC.chains[name];
  const a = ch.a.slice(), d = ch.d.slice();
  for (const [param, link, bone, sign] of SPEC.rewrites[name])
    (param === "a" ? a : d)[link] = sign * boneLen[bone];
  const [s, e] = ch.angle_slice;
  let R = start ? start[0] : null, p = start ? start[1] : null;
  const positions = [], rotations = [];
  for (let i = 0; i < ch.alpha.length; i++) {
    const [Q, t] = linkQT(ch.alpha[i], a[i], d[i],
                          ch.theta[i] + angles33[s + i]);
    if (R === null) { R = Q; p = t; }
    else { const tr = matvec(R, t);
           p = [p[0]+tr[0], p[1]+tr[1], p[2]+tr[2]];
           R = matmul(R, Q); }
    positions.push(p); rotations.push(R);
  }
  return [positions, rotations];
}
function fkPose16(angles33, boneLen, globalRot) {
  const chains = {};
  const [rl] = walkChain("right_leg", angles33, boneLen, null);
  const [ll] = walkChain("left_leg", angles33, boneLen, null);
  const [bodyP, bodyR] = walkChain("body", angles33, boneLen, null);
  const start = [bodyR[8], bodyP[8]];
  const [rh] = walkChain("right_hand", angles33, boneLen, start);
  const [lh] = walkChain("left_hand", angles33, boneLen, start);
  chains.right_leg = rl; chains.left_leg = ll; chains.body = bodyP;
  chains.right_hand = {}; chains.left_hand = {};
  rh.forEach((p, i) => chains.right_hand[9 + i] = p);
  lh.forEach((p, i) => chains.left_hand[9 + i] = p);
  const Rg = eulerXYZ(globalRot);
  const pose = [];
  for (const [slot, chain, joint] of SPEC.scatter16)
    pose[slot] = matvec(Rg, chains[chain][joint]);
  return pose;
}

// ---- state + UI ----
const state = { angles: new Array(33).fill(0),
                bones: SPEC.canonical_bone_len.slice(),
                grot: [0, 0, 0], az: 30, el: 15, zoom: 160 };
const chainDofNames = [];
for (const name of ["right_leg","left_leg","body","right_hand","left_hand"]) {
  const ch = SPEC.chains[name];
  for (let i = 0; i < ch.alpha.length; i++)
    chainDofNames.push(name + " θ" + (i + 1));
}
function slider(parent, label, min, max, step, get, set) {
  const row = document.createElement("div"); row.className = "row";
  const lab = document.createElement("label"); lab.textContent = label;
  const inp = document.createElement("input");
  inp.type = "range"; inp.min = min; inp.max = max; inp.step = step;
  inp.value = get();
  const val = document.createElement("span"); val.textContent = (+get()).toFixed(2);
  inp.oninput = () => { set(+inp.value); val.textContent = (+inp.value).toFixed(2); draw(); };
  row.append(lab, inp, val); parent.append(row);
  return inp;
}
const inputs = [];
function buildPanel() {
  const p = document.getElementById("sliders");
  let h = document.createElement("h3"); h.textContent = "view"; p.append(h);
  slider(p, "azimuth", -180, 180, 1, () => state.az, v => state.az = v);
  slider(p, "elevation", -90, 90, 1, () => state.el, v => state.el = v);
  h = document.createElement("h3"); h.textContent = "global rotation (deg)"; p.append(h);
  ["x","y","z"].forEach((ax, i) =>
    inputs.push(slider(p, "rot " + ax, -180, 180, 1,
                       () => state.grot[i], v => state.grot[i] = v)));
  h = document.createElement("h3"); h.textContent = "joint angles (deg)"; p.append(h);
  for (let i = 0; i < 33; i++)
    inputs.push(slider(p, chainDofNames[i], -180, 180, 1,
                       () => state.angles[i], v => state.angles[i] = v));
  h = document.createElement("h3"); h.textContent = "bone lengths (m)"; p.append(h);
  for (let i = 0; i < 15; i++)
    inputs.push(slider(p, SPEC.bone_names[i], 0.05, 1.0, 0.01,
                       () => state.bones[i], v => state.bones[i] = v));
}
function syncSliders() {
  const vals = [...state.grot, ...state.angles, ...state.bones];
  inputs.forEach((inp, i) => { inp.value = vals[i];
    inp.dispatchEvent(new Event("input")); });
}
function resetAll() {
  state.angles.fill(0); state.grot = [0,0,0];
  state.bones = SPEC.canonical_bone_len.slice(); syncSliders(); draw();
}
function randomPose() {
  state.angles = state.angles.map(() => Math.round((Math.random()*2-1)*90));
  state.grot = state.grot.map(() => Math.round((Math.random()*2-1)*45));
  syncSliders(); draw();
}

// ---- rendering ----
const canvas = document.getElementById("c"), ctx = canvas.getContext("2d");
function project(p) {
  const az = state.az * D2R, el = state.el * D2R;
  const x = p[0]*Math.cos(az) + p[1]*Math.sin(az);
  const y = -p[0]*Math.sin(az)*Math.sin(el) + p[1]*Math.cos(az)*Math.sin(el)
            + p[2]*Math.cos(el);
  return [canvas.width/2 + x*state.zoom, canvas.height/2 - y*state.zoom];
}
function draw() {
  canvas.width = document.getElementById("view").clientWidth;
  canvas.height = window.innerHeight;
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  const pose = fkPose16(state.angles, state.bones, state.grot);
  const leftSet = new Set(SPEC.left_edges.map(e => e.join(",")));
  for (const [a, b] of SPEC.edges) {
    const [x1, y1] = project(pose[a]), [x2, y2] = project(pose[b]);
    ctx.strokeStyle = leftSet.has(a + "," + b) ? "#2878b5" : "#c82423";
    ctx.lineWidth = 3; ctx.beginPath();
    ctx.moveTo(x1, y1); ctx.lineTo(x2, y2); ctx.stroke();
  }
  ctx.fillStyle = "#222";
  for (const p of pose) {
    const [x, y] = project(p);
    ctx.beginPath(); ctx.arc(x, y, 3.5, 0, 7); ctx.fill();
  }
}

// ---- in-page self test against Python-computed goldens ----
function selfTest() {
  let maxErr = 0;
  for (const g of SPEC.goldens) {
    const pose = fkPose16(g.angles, g.bone_len, g.global_rot);
    for (let j = 0; j < 16; j++) for (let k = 0; k < 3; k++)
      maxErr = Math.max(maxErr, Math.abs(pose[j][k] - g.pose[j][k]));
  }
  const el = document.getElementById("selftest");
  const ok = maxErr < 1e-4;
  el.className = ok ? "ok" : "bad";
  el.textContent = (ok ? "self-test OK" : "SELF-TEST FAILED") +
    " — max |JS−Python| = " + maxErr.toExponential(2) + " m";
  return maxErr;
}
buildPanel(); draw(); selfTest();
window.onresize = draw;
</script></body></html>
"""


def generate(out_path: str, device) -> str:
    html = _HTML.replace("__SPEC_JSON__", json.dumps(build_spec(torch.device(device))))
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def main(argv=None) -> dict:
    """Write the page; returns its path and the B1 launches made."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="fk_inspector.html")
    ap.add_argument("--device", default="cuda", type=str, help="cuda or cpu")
    args = ap.parse_args(argv)
    device = dhaug_torch.resolve_device(args.device)
    before = fk_cuda.FWD_LAUNCHES
    path = generate(args.out, device)
    launches = fk_cuda.FWD_LAUNCHES - before
    print(f"wrote {path} ({os.path.getsize(path)} bytes; goldens on {device}, "
          f"{launches} B1 launch(es)) - open in a browser")
    return {"path": path, "launches": launches}


if __name__ == "__main__":
    main(sys.argv[1:])
