"""PoseNet trainer (torch port of ``pylidar_slam_tpu.training.trainer``).

The optimizer zoo (adam / adamw / sgd / rmsprop, with optax's semantics), a
learning rate halved every ``optimizer_scheduler_milestones`` epochs and set
once per epoch, per-epoch train and eval loops with average meters and NaN
guards, the checkpoint restored on ``init``, and ``config.yaml`` stamped
with the git hash.

A train step -- the rasterization of the padded point-cloud pair, the
ResNet forward, the loss, the backward and the optimizer update -- runs on
the device with no host sync: the loss stays a device tensor, fetched only
every ``average_meter_frequency`` iterations.  Windows are loaded, padded
and pinned by background threads, in the order a seeded numpy generator
gives (the JAX package's order).

The checkpoint (``{train_dir}/checkpoint.ckp``) the port writes is its
own, a ``torch.save`` of the state dicts and counters.  It also resumes
from the JAX trainer's pickled checkpoint, read without JAX
(``models.from_jax``): the weights, ``exp_s``, optax's moments carried
into the optimizer, the injected learning rate and the counters.

``data_parallel`` and ``tensor_parallel`` > 1 run one step on the global
batch across the ranks of a ``torch.distributed`` process group (under
``torchrun``, or one a caller set up), as the JAX package's jit over a
sharded batch does: each dp rank takes its contiguous slice of the same
batch, BatchNorm takes its statistics over the whole batch, gradients are
averaged over dp, and ``tensor_parallel`` splits the weights over ``tp``
(``parallel.tp``).  With one rank either is the plain step.
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import subprocess
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pylidar_slam_tpu_torch.config import dump_yaml
from pylidar_slam_tpu_torch.models import from_jax
from pylidar_slam_tpu_torch.models.resnet import BatchNorm2d
from pylidar_slam_tpu_torch.ops import projection
from pylidar_slam_tpu_torch.parallel import tp as tpm
from pylidar_slam_tpu_torch.parallel.mesh import (init_from_env, is_main_rank, make_mesh,
                                                  rank_device)
from pylidar_slam_tpu_torch.slam.odometry_runner import resolve_device
from pylidar_slam_tpu_torch.training import loss_modules
from pylidar_slam_tpu_torch.training.prediction_modules import (
    PoseNetPredictionModule, PredictionConfig, relative_ground_truth)
from pylidar_slam_tpu_torch.utils import assert_debug

logger = logging.getLogger(__name__)


@dataclass
class ATrainerConfig:
    train_dir: str = ".train"
    num_epochs: int = 100
    batch_size: int = 4
    eval_batch_size: int = 4
    optimizer_type: str = "adamw"  # adam | adamw | sgd | rmsprop
    optimizer_learning_rate: float = 1.0e-4
    optimizer_beta: float = 0.9
    optimizer_weight_decay: float = 1.0e-3  # important for PoseNet stability
    optimizer_momentum: float = 0.9
    optimizer_scheduler_decay: float = 0.5
    optimizer_scheduler_milestones: int = 20  # epochs between LR decays
    num_workers: int = 2  # threads loading windows
    device: str = "tpu"  # the card unless `cpu`
    do_train: bool = True
    do_eval: bool = True
    average_meter_frequency: int = 20
    num_points_padded: int = 131072
    data_parallel: bool = False  # the batch split over the ranks (dp)
    tensor_parallel: int = 1  # the weights split over this many ranks (tp)
    seed: int = 0
    # TensorBoard logging, when torch.utils.tensorboard imports: per-kind
    # frequencies; 0 disables a kind
    with_tensorboard: bool = True
    tensorboard_scalar_frequency: int = 20
    tensorboard_histogram_frequency: int = 200
    tensorboard_image_frequency: int = 500
    visualize: bool = False  # range images as PNGs under train_dir/viz (+ cv2 window)


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += value * n
        self.count += n

    @property
    def average(self) -> float:
        return self.sum / max(self.count, 1)


def _git_hash() -> str:
    try:
        return subprocess.check_output(["git", "rev-parse", "HEAD"],
                                       stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return "unknown"


class RMSProp(torch.optim.Optimizer):
    """``optax.rmsprop(lr, momentum=m)``: nu = d nu + (1 - d) g^2, the step
    g / sqrt(nu + eps) (eps inside the root, unlike ``torch.optim.RMSprop``)
    scaled by the learning rate BEFORE the momentum trace."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 momentum: float = 0.9):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay, eps, lr, mom = group["decay"], group["eps"], group["lr"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    state["trace"] = torch.zeros_like(p)
                g, nu, trace = p.grad, state["nu"], state["trace"]
                nu.mul_(decay).add_((1.0 - decay) * (g * g))
                trace.mul_(mom).add_(lr * (g * torch.rsqrt(nu + eps)))
                p.sub_(trace)


def lr_for_epoch(cfg: ATrainerConfig, epoch: int) -> float:
    """MultiStepLR: x decay every `optimizer_scheduler_milestones` epochs."""
    decays = epoch // max(cfg.optimizer_scheduler_milestones, 1)
    return cfg.optimizer_learning_rate * (cfg.optimizer_scheduler_decay ** decays)


def make_optimizer(cfg: ATrainerConfig, params) -> torch.optim.Optimizer:
    """The optimizer with optax's semantics: adam and adamw (decaying every
    parameter, the BatchNorm scales and exp_s included) b2 = 0.999 and
    eps = 1e-8; sgd with momentum and no dampening; rmsprop by hand."""
    lr, kind = cfg.optimizer_learning_rate, cfg.optimizer_type
    if kind == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(cfg.optimizer_beta, 0.999), eps=1e-8)
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(cfg.optimizer_beta, 0.999), eps=1e-8,
                                 weight_decay=cfg.optimizer_weight_decay)
    if kind == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.optimizer_momentum)
    if kind == "rmsprop":
        return RMSProp(params, lr=lr, momentum=cfg.optimizer_momentum)
    raise KeyError(f"Unknown optimizer {kind}")


class PoseNetTrainer:
    """Trains PoseNet supervised or unsupervised on windowed scan pairs."""

    def __init__(self, config: ATrainerConfig, prediction_config: PredictionConfig,
                 loss_config: Any, dataset_loader,
                 proj: Optional[projection.SphericalProjection] = None):
        self.config = config
        self.device = resolve_device(config.device)
        self._mesh = None  # the dp (x tp) layout of a parallel step
        self._split = None  # tp-split parameter names, once distributed
        tp = max(1, int(config.tensor_parallel or 1))
        if bool(config.data_parallel) or tp > 1:
            if init_from_env(self.device):
                self.device = rank_device(self.device)
            world = dist.get_world_size() if dist.is_initialized() else 1
            if tp > 1 and world > 1:
                assert_debug(world % tp == 0,
                             f"tensor_parallel={tp} does not divide {world} ranks")
                self._mesh = make_mesh([("dp", world // tp), ("tp", tp)])
            elif bool(config.data_parallel) and world > 1:
                self._mesh = make_mesh([("dp", world)])
        self._image_visualizer = None
        self.dataset_loader = dataset_loader
        self.proj = proj if proj is not None else dataset_loader.projector()
        self.prediction = PoseNetPredictionModule(prediction_config, seed=config.seed,
                                                  device=self.device)
        self.loss_config = loss_config
        self.is_supervised = getattr(loss_config, "mode", "supervised") == "supervised"

        self.train_dir = Path(config.train_dir)
        self.train_dir.mkdir(parents=True, exist_ok=True)

        self.exp_s: Optional[torch.nn.Parameter] = None  # learned uncertainty weights
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.num_train_epochs = 0
        self.train_iter = 0
        self.eval_iter = 0
        self._tb_writer = None

    @property
    def module(self) -> torch.nn.Module:
        return self.prediction.module

    # ------------------------------------------------------------------
    # TensorBoard (lazy and optional)
    # ------------------------------------------------------------------

    def _tensorboard(self):
        if not self.config.with_tensorboard or self.config.tensorboard_scalar_frequency <= 0:
            return None
        if self._tb_writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb_writer = SummaryWriter(log_dir=str(self.train_dir / "tensorboard"))
            except ImportError:
                self.config.with_tensorboard = False
                return None
        return self._tb_writer

    def _log_scalars(self, prefix: str, logs: dict, step: int):
        writer = self._tensorboard()
        if writer is None:
            return
        for key, value in logs.items():
            writer.add_scalar(f"{prefix}/{key}", float(value), step)

    def _log_histograms(self, prefix: str, step: int):
        writer = self._tensorboard()
        if writer is None:
            return
        for name, p in self.module.named_parameters():
            writer.add_histogram(f"{prefix}/{name}", p.detach().cpu().numpy().ravel(), step)

    def _log_images(self, prefix: str, points: np.ndarray, masks: np.ndarray, step: int):
        """Colormapped range images of the first window pair: to TensorBoard,
        and with `visualize` as PNGs under train_dir/viz (and a cv2 window
        where one can open)."""
        writer = self._tensorboard()
        want_viz = bool(self.config.visualize)
        if (writer is None and not want_viz) or not is_main_rank():
            return
        from pylidar_slam_tpu_torch.viz.color_map import tensor_to_image
        for si in range(min(2, points.shape[1])):
            vm = projection.build_vertex_map(torch.from_numpy(points[0, si]), self.proj,
                                             mask=torch.from_numpy(masks[0, si])).numpy()
            rng_img = np.linalg.norm(vm, axis=-1)
            if writer is not None:
                writer.add_image(f"{prefix}/vertex_map_{si}", tensor_to_image(rng_img), step,
                                 dataformats="HWC")
            if want_viz:
                if self._image_visualizer is None:
                    from pylidar_slam_tpu_torch.viz.visualizer import ImageVisualizer
                    self._image_visualizer = ImageVisualizer(
                        output_dir=str(self.train_dir / "viz"), use_window=True)
                self._image_visualizer.update(rng_img, tag=f"{prefix[1:]}_vm{si}")

    # ------------------------------------------------------------------
    # Initialization / checkpointing: {train_dir}/checkpoint.ckp and
    # config.yaml, read by the PoseNet odometry and initialization
    # ------------------------------------------------------------------

    def _init_state(self):
        """exp_s (supervised with learned weights) and the optimizer over
        the network's weights as they stand."""
        self.exp_s = None
        if self.is_supervised and getattr(self.loss_config, "with_exp_weights", False):
            self.exp_s = torch.nn.Parameter(torch.tensor(
                [float(v) for v in self.loss_config.init_weights], dtype=torch.float32,
                device=self.device))
        self.optimizer = make_optimizer(self.config, self._trainable())

    def init(self):
        self._init_state()
        ckpt = self.train_dir / "checkpoint.ckp"
        if ckpt.exists():
            self.load_checkpoint(str(ckpt))
            logger.info("Restored checkpoint at epoch %d", self.num_train_epochs)
        if is_main_rank():
            (self.train_dir / "config.yaml").write_text(dump_yaml({
                "git_hash": _git_hash(),
                "trainer": _plain(self.config),
                "prediction": _plain(self.prediction.config),
                "loss": _plain(self.loss_config),
                "projector": {"height": self.proj.height, "width": self.proj.width,
                              "up_fov": self.proj.up_fov, "down_fov": self.proj.down_fov},
            }))
        logger.info("Training on %s", self.device)

    def _named_trainable(self) -> list:
        """(name, parameter) in the optimizer's order."""
        return list(self.module.named_parameters()) + (
            [("exp_s", self.exp_s)] if self.exp_s is not None else [])

    def _trainable(self) -> list:
        return [p for _, p in self._named_trainable()]

    def _whole_state(self):
        """The module's and the optimizer's state dicts, with every
        tp-split weight and its moments gathered whole (all ranks call
        this), so the checkpoint is the one-rank layout."""
        model, opt = self.module.state_dict(), self.optimizer.state_dict()
        if not self._split:
            return model, opt
        group = self._mesh.groups["tp"]
        model = {k: tpm.gather_slices(v, self._split[k][1], group) if k in self._split else v
                 for k, v in model.items()}
        named = self._named_trainable()
        for idx, st in opt["state"].items():
            name, param = named[idx]
            if name in self._split:
                dim = self._split[name][1]
                opt["state"][idx] = {
                    k: tpm.gather_slices(v, dim, group)
                    if torch.is_tensor(v) and v.shape == param.shape else v
                    for k, v in st.items()}
        return model, opt

    def save_checkpoint(self):
        model, opt = self._whole_state()
        if not is_main_rank():
            return
        torch.save({
            "model": model,
            "exp_s": None if self.exp_s is None else self.exp_s.detach(),
            "optimizer": opt,
            "num_train_epochs": self.num_train_epochs,
            "train_iter": self.train_iter,
            "eval_iter": self.eval_iter,
        }, self.train_dir / "checkpoint.ckp")

    def load_checkpoint(self, path: str):
        """The port's checkpoint (a ``torch.save`` zip) or the JAX
        trainer's (a pickle), told apart by their bytes."""
        if not zipfile.is_zipfile(path):
            return self._load_jax_checkpoint(path)
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.module.load_state_dict(state["model"])
        if state.get("exp_s") is not None:
            with torch.no_grad():
                self.exp_s.copy_(state["exp_s"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.num_train_epochs = state["num_train_epochs"]
        self.train_iter = state.get("train_iter", 0)
        self.eval_iter = state.get("eval_iter", 0)

    def _load_jax_checkpoint(self, path: str):
        """The JAX trainer's checkpoint: weights, exp_s, counters, and
        optax's state (JAX trainer.py's ``inject_hyperparams`` over the
        optimizer) as this optimizer's: adam / adamw ``mu``, ``nu`` and
        ``count``, sgd's momentum ``trace``, rmsprop's ``nu`` and momentum
        ``trace`` (optax's holds the negated, lr-scaled steps), and the
        injected learning rate."""
        state = from_jax.read_jax_checkpoint(path)
        params, stats = state["params"], state["batch_stats"]
        from_jax.load_jax_variables(self.module, params, stats)
        if state["exp_s"] is not None and self.exp_s is not None:
            with torch.no_grad():
                self.exp_s.copy_(torch.as_tensor(np.asarray(state["exp_s"], np.float32)))
        self.num_train_epochs = state["num_train_epochs"]
        self.train_iter = state["train_iter"]
        self.eval_iter = state["eval_iter"]
        opt_state = state["opt_state"]
        if opt_state is None:
            return
        for group in self.optimizer.param_groups:
            group["lr"] = float(np.asarray(opt_state.hyperparams["learning_rate"]))
        inner = {type(s).__name__: s for s in opt_state.inner_state}

        def moments(tree) -> list:
            """An optax moment tree ({"params", "exp_s"}) in _named_trainable order."""
            by_name = from_jax.param_tensors(self.module, tree["params"], stats)
            if self.exp_s is not None:
                by_name["exp_s"] = torch.as_tensor(np.asarray(tree["exp_s"], np.float32))
            return [by_name[name].to(self.device) for name, _ in self._named_trainable()]

        kind = self.config.optimizer_type
        want = {"adam": "ScaleByAdamState", "adamw": "ScaleByAdamState",
                "sgd": "TraceState", "rmsprop": "ScaleByRmsState"}[kind]
        assert_debug(want in inner, f"the JAX checkpoint's optimizer state "
                                    f"({list(inner)}) is not {kind}'s")
        params = self._trainable()
        if kind in ("adam", "adamw"):
            adam = inner["ScaleByAdamState"]
            step = float(np.asarray(adam.count))
            for p, mu, nu in zip(params, moments(adam.mu), moments(adam.nu)):
                self.optimizer.state[p] = {"step": torch.tensor(step), "exp_avg": mu,
                                           "exp_avg_sq": nu}
        elif kind == "sgd":
            for p, trace in zip(params, moments(inner["TraceState"].trace)):
                self.optimizer.state[p] = {"momentum_buffer": trace}
        else:
            nus = moments(inner["ScaleByRmsState"].nu)
            traces = moments(inner["TraceState"].trace)
            for p, nu, trace in zip(params, nus, traces):
                self.optimizer.state[p] = {"nu": nu, "trace": -trace}

    # ------------------------------------------------------------------
    # The train step
    # ------------------------------------------------------------------

    def _loss_fn(self, points, masks, gt, train: bool):
        """points (B, 2, N, 3), masks (B, 2, N), gt (B, 2, 4, 4)."""
        vmaps = projection.build_vertex_map(points, self.proj, mask=masks)  # (B, 2, H, W, 3)
        vmaps = vmaps.permute(0, 1, 4, 2, 3)  # (B, 2, 3, H, W)
        pose_params, _ = self.prediction.apply(vmaps, train=train)
        if self.is_supervised:
            return loss_modules.supervised_loss(pose_params, relative_ground_truth(gt),
                                                self.loss_config, exp_s=self.exp_s)
        scheme_cfg = dict(getattr(self.loss_config, "least_square_scheme", {}) or {})
        return loss_modules.point_to_plane_loss(
            vmaps, pose_params, self.proj,
            scheme=scheme_cfg.get("scheme", "geman_mcclure"),
            sigma=float(scheme_cfg.get("sigma", 0.5)))

    def _train_step(self, points, masks, gt):
        """One step on device tensors of the global batch; returns the loss
        and the logs (over the global batch), still on the device."""
        if self._mesh is not None:
            return self._parallel_train_step(points, masks, gt)
        self.optimizer.zero_grad(set_to_none=True)
        loss, logs = self._loss_fn(points, masks, gt, True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in logs.items()}

    @torch.no_grad()
    def _eval_step(self, points, masks, gt):
        if self._mesh is None:
            return self._loss_fn(points, masks, gt, False)
        self._distribute()
        loss, logs = self._loss_fn(*self._local_batch(points, masks, gt), False)
        return self._global_mean(loss, logs)

    # ------------------------------------------------------------------
    # The parallel step: dp slices of the global batch, tp-split weights
    # ------------------------------------------------------------------

    def _distribute(self):
        """Once, before the first parallel step (after any checkpoint or
        carried weights are in): BatchNorm statistics over the dp group, and
        with tp > 1 this rank's weight slices, the optimizer rebuilt over
        them with its state sliced alike."""
        if self._split is not None:
            return
        mesh = self._mesh
        dp_group = mesh.groups["dp"] if mesh.shape["dp"] > 1 else None
        for m in self.module.modules():
            if isinstance(m, BatchNorm2d):
                m.group = dp_group
        self._split = {}
        if mesh.shape.get("tp", 1) <= 1:
            return
        group = mesh.groups["tp"]
        old = self._named_trainable()
        old_state = [self.optimizer.state.get(p, {}) for _, p in old]
        lr = self.optimizer.param_groups[0]["lr"]
        self._split = tpm.shard_module(self.module, group)
        self.optimizer = make_optimizer(self.config, self._trainable())
        self.optimizer.param_groups[0]["lr"] = lr
        for (name, param), (_, before), st in zip(self._named_trainable(), old, old_state):
            if name in self._split:
                dim = self._split[name][1]
                st = {k: tpm.take_slice(v, dim, group)
                      if torch.is_tensor(v) and v.shape == before.shape else v
                      for k, v in st.items()}
            if st:
                self.optimizer.state[param] = st

    def _local_batch(self, *batch):
        """This dp rank's contiguous slice of each global-batch tensor."""
        dp, index = self._mesh.shape["dp"], self._mesh.coords["dp"]
        b = batch[0].shape[0]
        assert_debug(b % dp == 0, f"batch {b} does not split over {dp} dp ranks")
        return [t[index * b // dp:(index + 1) * b // dp] for t in batch]

    def _global_mean(self, loss, logs):
        """The loss and logs over the global batch: the mean of the ranks'
        (the tp ranks of a dp slice hold the same values), one all-reduce."""
        keys = list(logs)
        flat = torch.stack([loss.detach()] + [logs[k].detach() for k in keys])
        dist.all_reduce(flat)
        flat = flat / dist.get_world_size()
        return flat[0], dict(zip(keys, flat[1:]))

    def _parallel_train_step(self, points, masks, gt):
        self._distribute()
        mesh = self._mesh
        tp = mesh.shape.get("tp", 1)
        self.optimizer.zero_grad(set_to_none=True)
        loss, logs = self._loss_fn(*self._local_batch(points, masks, gt), True)
        # activations are replicated over tp: each rank backpropagates its
        # share, and the collectives' backward passes add the shares up
        (loss / tp).backward()
        named = self._named_trainable()
        whole = [p for n, p in named if n not in self._split]  # on every rank
        split = [p for n, p in named if n in self._split]  # replicated over dp
        syncs = [(whole, None)]  # the world: dp copies of tp shares
        if mesh.shape["dp"] > 1:
            syncs.append((split, mesh.groups["dp"]))
        for params, group in syncs:
            if not params:
                continue
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            flat /= mesh.shape["dp"]
            start = 0
            for p in params:
                p.grad = flat[start:start + p.numel()].view_as(p)
                start += p.numel()
        self.optimizer.step()
        return self._global_mean(loss, logs)

    # ------------------------------------------------------------------
    # Data pipeline: windowed pairs, padded, pinned, prefetched
    # ------------------------------------------------------------------

    def _pad(self, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        cap = self.config.num_points_padded
        pts = points[:, :3].astype(np.float32)
        pts = pts[~np.isnan(pts).any(axis=1)]
        n = min(len(pts), cap)
        out = np.zeros((cap, 3), np.float32)
        msk = np.zeros((cap,), bool)
        out[:n] = pts[:n]
        msk[:n] = True
        return out, msk

    def _batches(self, sequences, batch_size: int, shuffle: bool, rng):
        """Yields host batches (points (B,2,N,3), masks (B,2,N), gt
        (B,2,4,4)) in the order of `rng`'s permutation of the windows."""
        windows = [(seq, i) for seq in sequences for i in range(len(seq) - 1)]
        order = rng.permutation(len(windows)) if shuffle else np.arange(len(windows))

        def load_window(idx):
            seq, i = windows[idx]
            d0, d1 = seq[i], seq[i + 1]
            p0, m0 = self._pad(d0["numpy_pc"])
            p1, m1 = self._pad(d1["numpy_pc"])
            gt0 = np.asarray(d0.get("absolute_pose_gt", np.eye(4)))
            gt1 = np.asarray(d1.get("absolute_pose_gt", np.eye(4)))
            return (np.stack([p0, p1]), np.stack([m0, m1]),
                    np.stack([gt0, gt1]).astype(np.float32))

        q: queue.Queue = queue.Queue(maxsize=4)
        n_batches = len(order) // batch_size
        stop = threading.Event()  # the consumer left early

        def worker():
            try:
                with ThreadPoolExecutor(max(1, int(self.config.num_workers))) as pool:
                    for bi in range(n_batches):
                        if stop.is_set():
                            break
                        idxs = order[bi * batch_size:(bi + 1) * batch_size]
                        items = list(pool.map(load_window, idxs))
                        q.put(tuple(np.stack(z) for z in zip(*items)))
            except Exception as e:  # raised again on the consumer's thread
                q.put(e)
                return
            q.put(None)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # frees a worker blocked on the full queue
                q.get_nowait()

    def _upload(self, *arrays: np.ndarray) -> list:
        """Host batch -> device tensors: pinned, non-blocking copies."""
        out = []
        for a in arrays:
            host = torch.from_numpy(a)
            if self.device.type == "cuda":
                host = host.pin_memory()
            out.append(host.to(self.device, non_blocking=True))
        return out

    # ------------------------------------------------------------------
    # Epoch loops
    # ------------------------------------------------------------------

    def _set_epoch_lr(self) -> float:
        lr = lr_for_epoch(self.config, self.num_train_epochs)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr

    def train_epoch(self, sequences, rng) -> float:
        lr = self._set_epoch_lr()
        meter = AverageMeter()
        cfg = self.config
        for points, masks, gt in self._batches(sequences, cfg.batch_size, shuffle=True, rng=rng):
            loss, logs = self._train_step(*self._upload(points, masks, gt))
            self.train_iter += 1
            if self.train_iter % cfg.average_meter_frequency == 0:
                loss_val = float(loss)  # the periodic host sync + NaN guard
                assert_debug(np.isfinite(loss_val), f"NaN/Inf loss at iter {self.train_iter}")
                meter.update(loss_val)
                logger.info("epoch %d iter %d lr %.2e loss %.6f",
                            self.num_train_epochs, self.train_iter, lr, loss_val)
            if cfg.tensorboard_scalar_frequency > 0 and \
                    self.train_iter % cfg.tensorboard_scalar_frequency == 0:
                self._log_scalars(".train", {**logs, "lr": lr}, self.train_iter)
            if cfg.tensorboard_histogram_frequency > 0 and \
                    self.train_iter % cfg.tensorboard_histogram_frequency == 0:
                self._log_histograms(".train", self.train_iter)
            if cfg.tensorboard_image_frequency > 0 and \
                    self.train_iter % cfg.tensorboard_image_frequency == 0:
                self._log_images(".train", points, masks, self.train_iter)
        return meter.average

    def evaluate_epoch(self, sequences) -> float:
        """The mean loss over the eval windows, summed on the device and
        fetched every `average_meter_frequency` iterations (NaN guard) and
        at the end."""
        cfg = self.config
        total, count = torch.zeros((), device=self.device), 0
        rng = np.random.default_rng(0)
        for points, masks, gt in self._batches(sequences, cfg.eval_batch_size,
                                               shuffle=False, rng=rng):
            loss, logs = self._eval_step(*self._upload(points, masks, gt))
            total = total + loss
            count += 1
            self.eval_iter += 1
            if count % cfg.average_meter_frequency == 0:
                assert_debug(bool(torch.isfinite(total)),
                             f"NaN/Inf eval loss at iter {self.eval_iter}")
            if cfg.tensorboard_scalar_frequency > 0 and \
                    self.eval_iter % cfg.tensorboard_scalar_frequency == 0:
                self._log_scalars(".eval", logs, self.eval_iter)
            if cfg.tensorboard_image_frequency > 0 and \
                    self.eval_iter % cfg.tensorboard_image_frequency == 0:
                self._log_images(".eval", points, masks, self.eval_iter)
        return float(total) / max(count, 1)

    def train(self, num_epochs: Optional[int] = None):
        num_epochs = num_epochs or self.config.num_epochs
        (train_data, _), (eval_data, _), _, _ = self.dataset_loader.sequences()
        rng = np.random.default_rng(self.config.seed)
        for _ in range(num_epochs):
            if self.config.do_train:
                avg = self.train_epoch(train_data, rng)
                logger.info("epoch %d train loss %.6f", self.num_train_epochs, avg)
            self.num_train_epochs += 1
            self.save_checkpoint()
            if self.config.do_eval and eval_data:
                eval_avg = self.evaluate_epoch(eval_data)
                logger.info("epoch %d eval loss %.6f", self.num_train_epochs, eval_avg)


def _plain(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)
