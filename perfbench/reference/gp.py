"""Plain GP pieces of the reference: the asset's arrays, the kernels, and
the posterior that a configuration's cells deploy, worked out again from
the trained parameters in float64: the exact posterior, a sparse model's
own SGPR posterior, an exact model's SGPR distillation, or its
compressed posterior (``posterior``).

Nothing here imports the program: the arrays come from the checkpoint
file itself (``numpy.load``), and every factor is computed anew; of a
persisted deployment only its key, a distillation's inducing inputs and
a compressed entry's ranks are read, never a factor.  The
per-frame products take a precision: ``'float64'``, or ``'tf32'``, the
control, which computes in float32 with every product's operands rounded
to TF32's 10-bit mantissa (what the card's tensor cores do with float32
under ``allow_tf32``), from factors made in float64 and deployed in
float32.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

PARAMS = ("y_log_lengthscales", "y_log_lambdas", "y_log_sigma_n", "x_log_lengthscales",
          "x_log_lambdas", "x_log_sigma_n", "x_log_lin_coeff", "X")
SPARSE_PARAMS = PARAMS + ("Zy", "Zx")

#: Jitters of the configuration's objective and posterior, by its dtype:
#: the SGPR noise jitter, Kuu's jitter for a float32 model, and the
#: relative floor of a float32 Cholesky (a share of the mean diagonal).
#: A float32 exact model's distillation takes the same two SGPR jitters:
#: the program factors it with the sparse model's own formulas, keyed on
#: the model's dtype, so no constant differs.
SGPR_NOISE_JITTER = 1e-6
KUU_JITTER_F32 = 1e-4
REL_FLOOR_F32 = 1e-5


def load_asset(path) -> dict:
    """The checkpoint's meta, parameters, Adam state, observation sequences
    and persisted deployments, as numpy (parameters, moments and inducing
    inputs widened to float64; the observations as stored)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode("utf-8"))
        fields = meta["param_fields"]
        params = {f: np.asarray(z[f"param_{f}"], dtype=np.float64) for f in fields}
        params_f32 = {f: np.asarray(z[f"param_{f}"]) for f in fields}
        seqs = [[np.asarray(z[f"obs_{c}_{i}"]) for i in range(n)]
                for c, n in enumerate(meta["n_sequences_per_class"])]
        opt = [np.asarray(z[f"opt_{i}"]) for i in range(meta.get("n_opt_leaves", 0))]
        entries = _entries(z, meta)
    return {"meta": meta, "cfg": meta["config"], "fields": fields, "params": params,
            "params_f32": params_f32, "seqs": seqs, "opt": opt, "entries": entries}


def _entries(z, meta: dict) -> dict:
    """The persisted deployments of an exact model, by the keys the
    checkpoint's meta holds (``<name>_keys``, each entry's arrays
    ``<prefix>_<j>_<field>`` with j from ``<name>_entry_idx``):
    'sparsified', each with its key (M, Mx or None, method) and its
    inducing inputs Zy (My, d) and Zx (C, Mx, din); 'compressed', each
    with its key (rank_y or None, rank_x or None, tol) and the ranks it
    holds, its eigenbases' widths, read from the arrays' headers."""
    def keyed(name):
        keys = meta.get(f"{name}_keys") or []
        return zip(keys, meta.get(f"{name}_entry_idx", range(len(keys))))

    sparsified = [{"key": (int(k[0]), None if k[1] is None else int(k[1]),
                           k[2] if len(k) > 2 else "stride"),
                   "Zy": np.asarray(z[f"sparsified_{j}_Zy"], dtype=np.float64),
                   "Zx": np.asarray(z[f"sparsified_{j}_Zx"], dtype=np.float64)}
                  for k, j in keyed("sparsified")]
    compressed = [{"key": (k[0], k[1], float(k[2])),
                   "rank_y": _npz_shape(z, f"comp_{j}_Uy")[1],
                   "rank_x": _npz_shape(z, f"comp_{j}_Uxc")[2]}
                  for k, j in keyed("compressed")]
    return {"sparsified": sparsified, "compressed": compressed}


def _npz_shape(z, name: str) -> tuple:
    """The shape of the array ``name`` of an open npz, from its header."""
    with z.zip.open(f"{name}.npy") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        return read(f)[0]


def sparsified_entry(asset: dict, cfg: dict) -> dict:
    """The persisted distillation that the configuration states: ``My``
    inducing inputs for the observation GP, ``Mx`` for each class's
    dynamics GP, chosen by ``method``."""
    for e in asset["entries"]["sparsified"]:
        M, _, method = e["key"]
        if (M, e["Zx"].shape[1], method) == (cfg["My"], cfg["Mx"], cfg["method"]):
            return e
    raise RuntimeError(f"{cfg['name']}: the asset holds no distillation with My = {cfg['My']}, "
                       f"Mx = {cfg['Mx']}, method {cfg['method']!r}")


def compressed_entry(asset: dict, cfg: dict) -> dict:
    """The persisted compressed posterior of the ranks the configuration
    states (``rank_y``, ``rank_x``)."""
    for e in asset["entries"]["compressed"]:
        if (e["rank_y"], e["rank_x"]) == (cfg["rank_y"], cfg["rank_x"]):
            return e
    raise RuntimeError(f"{cfg['name']}: the asset holds no compressed posterior of ranks "
                       f"{cfg['rank_y']}, {cfg['rank_x']}")


def class_pairs(asset: dict) -> list:
    """Per class, the (x(t), x(t+1)) row pairs of its sequences into the
    class-major row axis: (rows_in, rows_out) integer arrays (back step 1,
    target 'full', which the reference implements)."""
    cfg = asset["cfg"]
    if cfg["dyn_back_step"] != 1 or cfg["dyn_target"] != "full":
        raise NotImplementedError("the reference implements dyn_back_step 1, target 'full'")
    out, start = [], 0
    for seqs in asset["seqs"]:
        rin, rout = [], []
        for s in seqs:
            n = s.shape[0]
            rin.append(start + np.arange(n - 1))
            rout.append(start + np.arange(1, n))
            start += n
        out.append((np.concatenate(rin), np.concatenate(rout)))
    return out


def class_row_offsets(asset: dict) -> np.ndarray:
    """(C + 1,) offsets of each class's block of observation rows."""
    counts = [sum(s.shape[0] for s in seqs) for seqs in asset["seqs"]]
    return np.concatenate([[0], np.cumsum(counts)])


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest on TF32's 10-bit mantissa."""
    bits = a.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """A product at ``prec``: float64, or TF32's rounded operands with a
    float32 sum."""
    if prec == "tf32":
        return tf32(a) @ tf32(b)
    return a @ b


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor, NaN where K is not positive definite (so
    a loss that needs it reads NaN instead of raising)."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info > 0)[..., None, None], torch.full_like(L, float("nan")), L)


def rbf(X1: torch.Tensor, X2: torch.Tensor, inv_ls: torch.Tensor,
        prec: str = "float64") -> torch.Tensor:
    """exp(-|(x1 - x2) / ls|^2), summed by per-dimension differences; at
    TF32 by the norm expansion |a|^2 + |b|^2 - 2 a.b with the product on
    TF32 operands, as a float32 program's kernel computes it."""
    if prec == "tf32":
        A, B = X1 * inv_ls, X2 * inv_ls
        sq = (A * A).sum(1)[:, None] + (B * B).sum(1)[None, :] - 2.0 * mm(A, B.T, prec)
        return torch.exp(-torch.clamp(sq, min=0.0))
    sq = torch.zeros(X1.shape[0], X2.shape[0], dtype=X1.dtype, device=X1.device)
    for k in range(X1.shape[1]):
        diff = (X1[:, k, None] - X2[None, :, k]) * inv_ls[k]
        sq = sq + diff * diff
    return torch.exp(-sq)


def x_kernel(X1, X2, inv_ls, lin_w2, prec: str = "float64"):
    """The dynamics kernel: RBF plus [x1, 1] diag(w^2) [x2, 1]^T."""
    return rbf(X1, X2, inv_ls, prec) + mm(X1 * lin_w2[:-1], X2.T, prec) + lin_w2[-1]


def x_diag(X, lin_w2):
    return 1.0 + torch.sum(X * X * lin_w2[:-1], dim=1) + lin_w2[-1]


class Hypers:
    """The trained hyperparameters, in linear space, as tensors of one
    dtype on one device."""

    def __init__(self, params: dict, cfg: dict, dtype, device):
        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)

        self.y_inv_ls = t(np.exp(-params["y_log_lengthscales"]))
        self.y_lam2 = t(np.exp(2 * params["y_log_lambdas"]))
        self.y_log_lambdas_sum = float(np.sum(params["y_log_lambdas"]))
        self.y_sn2 = float(np.exp(params["y_log_sigma_n"])) ** 2 + cfg["sigma_n_num_Y"] ** 2
        self.x_inv_ls = t(np.exp(-params["x_log_lengthscales"]))
        self.x_lam2 = t(np.exp(2 * params["x_log_lambdas"]))
        self.x_lin_w2 = t(np.exp(2 * params["x_log_lin_coeff"]))
        self.x_sn2 = float(np.exp(params["x_log_sigma_n"])) ** 2 + cfg["sigma_n_num_X"] ** 2


def exact_grams(asset: dict, device):
    """The exact model's Grams in float64, from its hyperparameters: the
    latents X, the observations Y, Ky with the noise on its diagonal, and
    per class (Xin, Xout, Kc), Kc with the noise and the class jitter on
    its diagonal."""
    cfg, p = asset["cfg"], asset["params"]
    f64 = dict(dtype=torch.float64, device=device)
    h64 = Hypers(p, cfg, torch.float64, device)
    X = torch.as_tensor(p["X"], **f64)
    Y = torch.as_tensor(np.concatenate([s for seqs in asset["seqs"] for s in seqs]), **f64)
    Ky = rbf(X, X, h64.y_inv_ls) + h64.y_sn2 * torch.eye(X.shape[0], **f64)
    grams = []
    for rin, rout in class_pairs(asset):
        Xin = X[torch.as_tensor(rin, device=device)]
        Xout = X[torch.as_tensor(rout, device=device)]
        n = Xin.shape[0]
        Kc = (x_kernel(Xin, Xin, h64.x_inv_ls, h64.x_lin_w2)
              + (h64.x_sn2 + cfg["class_jitter"]) * torch.eye(n, **f64))
        grams.append((Xin, Xout, Kc))
    return X, Y, Ky, grams


class ExactPosterior:
    """The exact GPMDM's predictive posteriors.  Factors in float64
    (Ky^-1, Ky^-1 Y; per class (K_c + jitter I)^-1 and its weights),
    deployed in the compute dtype of ``prec``."""

    def __init__(self, asset: dict, device, prec: str = "float64"):
        self.prec = prec
        self.dtype = torch.float64 if prec == "float64" else torch.float32
        self.h = Hypers(asset["params"], asset["cfg"], self.dtype, device)
        X, Y, Ky, grams = exact_grams(asset, device)
        cast = lambda a: a.to(self.dtype).contiguous()  # noqa: E731
        self.X, self.Ky_inv, self.Ay = cast(X), cast(torch.linalg.inv(Ky)), cast(
            torch.linalg.solve(Ky, Y))
        self.classes = [(cast(Xin), cast(torch.linalg.inv(Kc)), cast(torch.linalg.solve(Kc, Xout)))
                        for Xin, Xout, Kc in grams]
        self.D = Y.shape[1]

    def dynamics(self, x: torch.Tensor):
        """Every class's predictive mean (C, P, d) and per-dimension
        variance (C, P, d) at the particles x (P, d), unclamped."""
        h, means, variances = self.h, [], []
        kss = x_diag(x, h.x_lin_w2)
        for Xin, Kinv, A in self.classes:
            ks = x_kernel(Xin, x, h.x_inv_ls, h.x_lin_w2)  # (n, P)
            means.append(mm(ks.T, A, self.prec))
            quad = torch.sum(ks * mm(Kinv, ks, self.prec), dim=0)
            variances.append((kss - quad)[:, None] / h.x_lam2[None, :])
        return torch.stack(means), torch.stack(variances)

    def log_lik(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """(B, Pb) observation log-likelihood of the particles x (B, Pb, d)
        against each bank's z (B, D): the noisy predictive Gaussian, its
        common variance clamped at 1e-12."""
        B, Pb, d = x.shape
        h = self.h
        xf = x.reshape(-1, d)
        ks = rbf(self.X, xf, h.y_inv_ls)
        mean = mm(ks.T, self.Ay, self.prec).reshape(B, Pb, -1)
        quad = torch.sum(ks * mm(self.Ky_inv, ks, self.prec), dim=0).reshape(B, Pb)
        var_c = torch.clamp(1.0 + h.y_sn2 - quad, min=1e-12)
        qres = torch.sum(h.y_lam2 * (mean - z[:, None, :]) ** 2, dim=2)
        logdet = self.D * torch.log(var_c) - 2.0 * h.y_log_lambdas_sum
        return -0.5 * qres / var_c - 0.5 * logdet - 0.5 * self.D * math.log(2 * math.pi)


class SparsePosterior:
    """The sparse GPMDM's SGPR predictive posteriors (Titsias 2009), from
    its trained parameters and inducing inputs: per GP, Lm = chol(Kmm +
    jitter I), A = Lm^-1 Kmn / sigma, LB = chol(I + A A^T), beta =
    Lm^-T LB^-T LB^-1 A Y / sigma; at x*, mean k*m beta and common variance
    k** - |Lm^-1 km*|^2 + |LB^-1 Lm^-1 km*|^2, clamped at 1e-12.  Factors
    in float64; the variance by products with the two inverses.

    ``inducing`` (Zy, Zx) replaces the parameters' inducing inputs: an
    exact model's distillation is its own hyperparameters, latents and
    observations with the inducing inputs that the deployment chose."""

    def __init__(self, asset: dict, device, prec: str = "float64", inducing=None):
        cfg, p = asset["cfg"], asset["params"]
        Zy_all, Zx_all = inducing if inducing is not None else (p["Zy"], p["Zx"])
        if cfg["dtype"] != "float32":
            raise NotImplementedError("the reference takes a float32 model's jitters")
        f64 = dict(dtype=torch.float64, device=device)
        self.prec = prec
        self.dtype = torch.float64 if prec == "float64" else torch.float32
        self.h = Hypers(p, cfg, self.dtype, device)
        h64 = Hypers(p, cfg, torch.float64, device)
        X = torch.as_tensor(p["X"], **f64)
        Y = torch.as_tensor(np.concatenate([s for seqs in asset["seqs"] for s in seqs]), **f64)
        cast = lambda a: a.to(self.dtype).contiguous()  # noqa: E731

        def sgpr(Kmm, Kmn, Yd, sigma2):
            M = Kmm.shape[0]
            eye = torch.eye(M, **f64)
            Lm = torch.linalg.cholesky(Kmm + KUU_JITTER_F32 * eye)
            A = torch.linalg.solve_triangular(Lm, Kmn, upper=False) / math.sqrt(sigma2)
            LB = torch.linalg.cholesky(eye + A @ A.T)
            c = torch.linalg.solve_triangular(LB, A @ Yd, upper=False)
            beta = torch.linalg.solve_triangular(
                Lm.T, torch.linalg.solve_triangular(LB.T, c, upper=True), upper=True)
            Vi = torch.linalg.solve_triangular(Lm, eye, upper=False)
            Wi = torch.linalg.solve_triangular(LB, Vi, upper=False)
            return cast(beta / math.sqrt(sigma2)), cast(Vi), cast(Wi)

        Zy = torch.as_tensor(Zy_all, **f64)
        self.Zy = cast(Zy)
        self.y = sgpr(rbf(Zy, Zy, h64.y_inv_ls), rbf(Zy, X, h64.y_inv_ls), Y,
                      h64.y_sn2 + SGPR_NOISE_JITTER)
        self.classes = []
        for c, (rin, rout) in enumerate(class_pairs(asset)):
            Zx = torch.as_tensor(Zx_all[c], **f64)
            Xin = X[torch.as_tensor(rin, device=device)]
            Xout = X[torch.as_tensor(rout, device=device)]
            self.classes.append((cast(Zx),) + sgpr(
                x_kernel(Zx, Zx, h64.x_inv_ls, h64.x_lin_w2),
                x_kernel(Zx, Xin, h64.x_inv_ls, h64.x_lin_w2), Xout,
                h64.x_sn2 + SGPR_NOISE_JITTER))
        self.D = Y.shape[1]

    def _predict(self, ks, kss, beta, Vi, Wi):
        mean = mm(ks.T, beta, self.prec)
        s1 = torch.sum(mm(Vi, ks, self.prec) ** 2, dim=0)
        s2 = torch.sum(mm(Wi, ks, self.prec) ** 2, dim=0)
        return mean, torch.clamp(kss - s1 + s2, min=1e-12)

    def dynamics(self, x: torch.Tensor):
        h, means, variances = self.h, [], []
        kss = x_diag(x, h.x_lin_w2)
        for Zx, beta, Vi, Wi in self.classes:
            mean, var_c = self._predict(x_kernel(Zx, x, h.x_inv_ls, h.x_lin_w2), kss,
                                        beta, Vi, Wi)
            means.append(mean)
            variances.append(var_c[:, None] / h.x_lam2[None, :])
        return torch.stack(means), torch.stack(variances)

    def log_lik(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        B, Pb, d = x.shape
        h = self.h
        xf = x.reshape(-1, d)
        kss = torch.full((xf.shape[0],), 1.0 + h.y_sn2, dtype=xf.dtype, device=xf.device)
        mean, var_c = self._predict(rbf(self.Zy, xf, h.y_inv_ls), kss, *self.y)
        var = torch.clamp(var_c[:, None] / h.y_lam2[None, :], min=1e-12).reshape(B, Pb, -1)
        resid = z[:, None, :] - mean.reshape(B, Pb, -1)
        return (-0.5 * torch.sum(resid ** 2 / var, dim=2) - 0.5 * torch.sum(torch.log(var), dim=2)
                - 0.5 * self.D * math.log(2 * math.pi))


class CompressedPosterior:
    """An exact model's compressed posterior: the exact mean, and each
    Gram's quad through its top eigenpairs, K = U diag(mu) U^T, q kept:

        quad(k) = sum_{i<=q} (u_i^T k)^2 / mu_i + |k - U_q U_q^T k|^2 / s,

    s the Gram's shift on its diagonal (the noise; for the dynamics also
    the class jitter).  The residual is a vector, k less its projection,
    squared and summed: the equal scalar form |k|^2 / s - ... cancels
    catastrophically.  Each Gram keeps the pairs that the entry's ``key``
    (rank_y, rank_x, tol) picks: a pinned rank, at most the Gram's size,
    or else those with (mu - s) / mu > tol, largest first, at least one;
    an eigenvalue below s counts as s.  The common variance is clamped at
    1e-9.  Grams, eigenpairs and weights in float64 from the
    hyperparameters; ``ranks`` (rank_y, rank_x), the ranks the
    configuration states, must come out (rank_x: the largest class's)."""

    def __init__(self, asset: dict, device, prec: str, key, ranks):
        self.prec = prec
        self.dtype = torch.float64 if prec == "float64" else torch.float32
        self.h = Hypers(asset["params"], asset["cfg"], self.dtype, device)
        X, Y, Ky, grams = exact_grams(asset, device)
        cast = lambda a: a.to(self.dtype).contiguous()  # noqa: E731
        rank_y, rank_x, tol = key
        self.X, self.Ay = cast(X), cast(torch.linalg.solve(Ky, Y))
        h = self.h
        self.s_y = h.y_sn2
        self.s_x = h.x_sn2 + asset["cfg"]["class_jitter"]
        self.Uy, self.inv_mu_y = (cast(a) for a in _top_pairs(Ky, self.s_y, rank_y, tol))
        self.classes = []
        for Xin, Xout, Kc in grams:
            U, inv_mu = _top_pairs(Kc, self.s_x, rank_x, tol)
            self.classes.append((cast(Xin), cast(torch.linalg.solve(Kc, Xout)), cast(U),
                                 cast(inv_mu)))
        got = (self.Uy.shape[1], max(U.shape[1] for _, _, U, _ in self.classes))
        if got != tuple(ranks):
            raise RuntimeError(f"the compressed reference keeps ranks {got}, not {tuple(ranks)}")
        self.D = Y.shape[1]

    def _quad(self, ks, U, inv_mu, s):
        UK = mm(U.T, ks, self.prec)  # (q, P)
        resid = ks - mm(U, UK, self.prec)
        return torch.sum(inv_mu[:, None] * UK * UK, dim=0) + torch.sum(resid * resid, dim=0) / s

    def dynamics(self, x: torch.Tensor):
        h, means, variances = self.h, [], []
        kss = x_diag(x, h.x_lin_w2)
        for Xin, A, U, inv_mu in self.classes:
            ks = x_kernel(Xin, x, h.x_inv_ls, h.x_lin_w2)  # (n, P)
            means.append(mm(ks.T, A, self.prec))
            var_c = torch.clamp(kss - self._quad(ks, U, inv_mu, self.s_x), min=1e-9)
            variances.append(var_c[:, None] / h.x_lam2[None, :])
        return torch.stack(means), torch.stack(variances)

    def log_lik(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        B, Pb, d = x.shape
        h = self.h
        xf = x.reshape(-1, d)
        ks = rbf(self.X, xf, h.y_inv_ls)
        mean = mm(ks.T, self.Ay, self.prec).reshape(B, Pb, -1)
        var_c = torch.clamp(1.0 + h.y_sn2 - self._quad(ks, self.Uy, self.inv_mu_y, self.s_y),
                            min=1e-9)
        var = torch.clamp(var_c[:, None] / h.y_lam2[None, :], min=1e-12).reshape(B, Pb, -1)
        resid = z[:, None, :] - mean
        return (-0.5 * torch.sum(resid ** 2 / var, dim=2) - 0.5 * torch.sum(torch.log(var), dim=2)
                - 0.5 * self.D * math.log(2 * math.pi))


def _top_pairs(K: torch.Tensor, s: float, rank, tol: float):
    """(U (N, q), 1 / mu (q,)): the top eigenpairs of the float64 Gram K
    with the shift s on its diagonal, as ``CompressedPosterior`` keeps
    them."""
    mu, U = torch.linalg.eigh(K)
    mu, U = mu.flip(0), U.flip(1)
    if rank is None:
        share = torch.clamp((mu - s) / torch.clamp(mu, min=1e-300), 0.0, 1.0)
        q = int((share > tol).sum())
    else:
        q = min(int(rank), K.shape[0])
    q = max(q, 1)
    return U[:, :q], 1.0 / torch.clamp(mu[:q], min=s)


def posterior(asset: dict, device, prec: str, cfg: dict):
    """The posterior that the configuration's cells deploy, by its
    ``family``: 'exact'; 'sparse', a sparse model's own; 'sparsified', the
    exact model's distillation on the inducing inputs of the persisted
    entry that the configuration states; 'compressed', the exact model's
    compressed posterior, truncated as the stated entry was."""
    family = cfg["family"]
    if family == "exact":
        return ExactPosterior(asset, device, prec)
    if family == "sparse":
        return SparsePosterior(asset, device, prec)
    if family == "sparsified":
        e = sparsified_entry(asset, cfg)
        return SparsePosterior(asset, device, prec, inducing=(e["Zy"], e["Zx"]))
    if family == "compressed":
        return CompressedPosterior(asset, device, prec, compressed_entry(asset, cfg)["key"],
                                   (cfg["rank_y"], cfg["rank_x"]))
    raise ValueError(f"{cfg['name']}: unknown family {family!r}")
