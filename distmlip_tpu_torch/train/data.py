"""Training data: labelled structures -> packed, prefetched batches
(``distmlip_tpu/train/data.py``).

Every micro-batch packs ``B`` structures block-diagonally into one padded
graph (``partition.pack_structures``), so a micro-batch moves through the
card as one pass of the model. On top of the packer:

- **deterministic seeded shuffling** — the epoch order is a pure function
  of ``(seed, epoch)`` (:func:`epoch_permutation`), so a resumed run
  replays the stream an unbroken run would have seen;
- **frozen shapes** — the training set is known up front, so the loader
  computes worst-case micro-batch capacities once
  (``partition.fixed_caps_for_batches``) and packs every batch of the run
  at them;
- **cost-model packing** (``packing="cost_model"``) — per-structure cost
  census, 2-3 frozen capacity tiers and edge-balanced bins per epoch
  (``train/packing.py``); the number of distinct shapes stays at most the
  tier count and the cursor gains a derived tier coordinate;
- **target packing** — energies, forces and stresses in the padded layout
  of the graph they train against (:func:`pack_targets`);
- **host-side prefetch** — a background thread builds batch k + 1 (neighbor
  lists and packing) while the card runs step k.

Batches are host numpy, as in the JAX loader; ``TrainBatch.to(device)``
uploads one explicitly. The cursor (``state()`` / ``set_state()``) is
(seed, epoch, step[, tier]); ``train/checkpoint.py`` keeps it beside the
model state. Only the single-device placement is ported: ``batch_parts``
or ``spatial_parts`` above 1 raise (ROADMAP.md A4).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np

from ..neighbors import neighbor_list
from ..partition import (BucketPolicy, bucket_key, fixed_caps_for_batches,
                         pack_structures)
from ..partition.partitioner import build_plan
from .packing import CostCensus, assign_tiers, plan_epoch, tier_caps


class Sample(NamedTuple):
    """One labeled structure: geometry + regression targets."""

    atoms: Any                 # calculators.Atoms (positions/cell/pbc/numbers)
    energy: float              # total energy (eV)
    forces: np.ndarray         # (n, 3) eV/Å
    stress: np.ndarray | None = None  # (3, 3) eV/Å^3, optional


def labelled_dataset(structures, energies, forces, stresses=None):
    """Zip parallel lists into a ``list[Sample]`` dataset."""
    if stresses is None:
        stresses = [None] * len(structures)
    if not (len(structures) == len(energies) == len(forces)
            == len(stresses)):
        raise ValueError(
            f"dataset lists disagree: {len(structures)} structures, "
            f"{len(energies)} energies, {len(forces)} forces, "
            f"{len(stresses)} stresses")
    return [Sample(a, float(e), np.asarray(f), s)
            for a, e, f, s in zip(structures, energies, forces, stresses)]


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """The deterministic visit order of epoch ``epoch``: a pure function
    of (seed, epoch) — no hidden generator state — so any consumer
    (loader, resume, tests) recomputes the identical permutation."""
    return np.random.default_rng([int(seed), int(epoch)]).permutation(n)


def structure_needs(atoms_list, cutoff: float, bond_cutoff: float = 0.0,
                    use_bond_graph: bool = False,
                    num_threads=None) -> list[dict]:
    """Per-structure capacity needs (single-partition plan counts) — the
    dataset census the frozen-cap AND cost-model packers both build from.
    Module-level so tools (pack_audit) can census a dataset without
    constructing a loader."""
    needs = []
    b_r = bond_cutoff if use_bond_graph else 0.0
    for a in atoms_list:
        nl = neighbor_list(a.positions, a.cell, a.pbc, cutoff,
                           bond_r=b_r, num_threads=num_threads)
        plan = build_plan(nl, a.cell, a.pbc, 1, cutoff, b_r,
                          use_bond_graph)
        need = {"nodes": len(a.positions),
                "edges": len(plan.src_local[0])}
        if use_bond_graph:
            need.update(
                bonds=int(plan.bond_markers[0][-1]),
                lines=len(plan.line_src[0]),
                bond_map=len(plan.bond_mapping_edge[0]))
        needs.append(need)
    return needs


@dataclass
class TrainBatch:
    """One optimizer step's worth of data: ``accum_steps`` packed
    micro-batches, ``graphs[a]`` a host ``PartitionedGraph`` and
    ``targets[a]`` its target dict (:func:`pack_targets`), in the order the
    step accumulates them."""

    graphs: list               # A host PartitionedGraphs (numpy arrays)
    targets: list              # A target dicts of numpy arrays
    meta: dict = field(default_factory=dict)

    def to(self, device) -> "TrainBatch":
        """The same batch with every graph and target array as a torch
        tensor on ``device`` (the explicit upload)."""
        import torch

        return TrainBatch(
            graphs=[g.to(device) for g in self.graphs],
            targets=[{k: torch.as_tensor(np.asarray(v)).to(device) for k, v in t.items()}
                     for t in self.targets],
            meta=dict(self.meta))


def pack_targets(graph, host, samples, dtype=np.float32) -> dict:
    """Pack per-structure targets into ``graph``'s padded local layout.

    Returns the target dict the packed loss (train/step.py) consumes:

    - ``energy`` (B_total,): per-slot total energies (0 on empty slots);
    - ``forces`` (P, N_cap, 3): owned-row force targets, packed exactly
      like positions (halo/padded rows 0);
    - ``atom_slot`` (P, N_cap) int32: each row's flat energy slot, with
      the B_total sentinel on halo/padded rows — the loss derives its
      owned-row force mask AND the per-structure 1/(3n) normalization
      from this one array;
    - ``n_atoms`` (B_total,): real atoms per slot (1 on empty slots so
      divisions stay finite; the mask zeroes their contribution);
    - ``struct_mask`` (B_total,): 1.0 on slots holding a real structure;
    - ``stress`` (B_total, 3, 3) + ``inv_volume`` (B_total,): present
      only when EVERY sample carries a stress target (the runtime's
      strain gradient divides by volume per structure).
    """
    B_total = graph.batch_size
    slots = host.structure_slots
    energy = np.zeros(B_total, dtype=dtype)
    n_atoms = np.ones(B_total, dtype=dtype)
    struct_mask = np.zeros(B_total, dtype=dtype)
    for i, s in enumerate(samples):
        energy[slots[i]] = s.energy
        n_atoms[slots[i]] = max(len(s.forces), 1)
        struct_mask[slots[i]] = 1.0
    targets = {
        "energy": energy,
        "forces": host.scatter_per_atom([s.forces for s in samples],
                                        dtype=dtype),
        "atom_slot": host.atom_slots(),
        "n_atoms": n_atoms,
        "struct_mask": struct_mask,
    }
    if all(s.stress is not None for s in samples):
        stress = np.zeros((B_total, 3, 3), dtype=dtype)
        inv_vol = np.zeros(B_total, dtype=dtype)
        for i, s in enumerate(samples):
            stress[slots[i]] = s.stress
            inv_vol[slots[i]] = 1.0 / max(float(host.volumes[i]), 1e-12)
        targets["stress"] = stress
        targets["inv_volume"] = inv_vol
    return targets


class PackedBatchLoader:
    """Deterministic, resumable, prefetching loader of packed train batches.

    Each :meth:`next_batch` returns one :class:`TrainBatch`: ``accum_steps``
    micro-batches of ``micro_batch_size`` structures, each packed
    block-diagonally (``pack_structures``) at FROZEN worst-case capacities
    so every batch of the run has the same shapes, in the order the step
    accumulates them. Epoch order is :func:`epoch_permutation`; tail
    structures that don't fill a full accumulation window are dropped
    (shape stability — grad-accumulation parity needs equal-B windows).

    ``batch_parts``/``spatial_parts`` (the 2-D mesh placement of the JAX
    loader) must be 1: the port packs for one device (ROADMAP.md A4).
    Shapes are frozen via :func:`fixed_caps_for_batches`.

    ``packing`` selects the micro-batch assembly policy:

    - ``"naive"`` (default): contiguous permutation
      slices packed at ONE frozen worst-case capacity set;
    - ``"cost_model"``: the train/packing.py pipeline — per-structure
      cost census (``cost_fn``; default edge count, or
      :func:`~distmlip_tpu_torch.train.packing.model_cost_fn` for the
      analytic FLOP model), up to ``num_tiers`` frozen capacity tiers
      clustered from the cost histogram, and seed-stable edge-balanced
      bin-packing per epoch. Every accumulation window stays within one
      tier, so the run steps at most ``num_tiers`` distinct shapes.

    The cursor is ``state() -> {"seed", "epoch", "step"[, "tier"]}`` (the
    tier coordinate is DERIVED from the plan — recorded for validation
    and observability, not an independent degree of freedom);
    ``set_state`` repositions the stream EXACTLY (the prefetcher restarts
    from the new cursor). ``close()`` stops the background builder.
    """

    def __init__(self, samples, cutoff: float, micro_batch_size: int,
                 accum_steps: int = 1, bond_cutoff: float = 0.0,
                 use_bond_graph: bool = False, caps=None, species_fn=None,
                 seed: int = 0, shuffle: bool = True, batch_parts: int = 1,
                 spatial_parts: int = 1, system: dict | None = None,
                 num_threads: int | None = None, prefetch: int = 2,
                 dtype=np.float32, precomputed_needs=None,
                 packing: str = "naive", num_tiers: int = 2,
                 cost_fn=None):
        if not samples:
            raise ValueError("PackedBatchLoader needs at least one sample")
        B, A = int(micro_batch_size), int(accum_steps)
        if B < 1 or A < 1:
            raise ValueError(
                f"micro_batch_size/accum_steps must be >= 1, got {B}/{A}")
        if int(batch_parts) != 1 or int(spatial_parts) != 1:
            raise NotImplementedError(
                f"PackedBatchLoader(batch_parts={batch_parts}, spatial_parts="
                f"{spatial_parts}): training across several cards is not ported "
                "(ROADMAP.md A4); the port packs every micro-batch for one device")
        if len(samples) < B * A:
            raise ValueError(
                f"dataset has {len(samples)} structures but one optimizer "
                f"step consumes micro_batch_size * accum_steps = {B * A}")
        self.samples = list(samples)
        self.cutoff = float(cutoff)
        self.bond_cutoff = float(bond_cutoff)
        self.use_bond_graph = bool(use_bond_graph)
        self.micro_batch_size = B
        self.accum_steps = A
        self.species_fn = species_fn
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.batch_parts = int(batch_parts)
        self.spatial_parts = int(spatial_parts)
        self.system = system
        self.num_threads = num_threads
        self.dtype = dtype
        self._epoch = 0
        self._step = 0
        if packing not in ("naive", "cost_model"):
            raise ValueError(
                f"packing must be 'naive' or 'cost_model', got {packing!r}")
        self.packing = packing
        ladder = caps or BucketPolicy()
        # per-structure capacity needs: computed once (or handed in by a
        # caller probing several micro-batch sizes over one dataset —
        # Trainer's memory-aware auto-sizing) and frozen into the caps
        self.needs = precomputed_needs
        self.census = None
        self.tier_of = None
        self.tier_caps = {}
        # the prefetch thread (building ahead) and the consumer (cursor/
        # state queries) both read this cache; plans are deterministic so
        # duplicate computation is benign, but eviction needs the lock
        self._plan_cache: dict[int, list] = {}
        self._plan_lock = threading.Lock()
        if packing == "cost_model":
            if self.needs is None:
                self.needs = self.structure_needs()
            self.census = CostCensus.from_needs(self.needs, cost_fn)
            # every tier must fill at least one whole accumulation window
            self.tier_of, self.tier_thresholds = assign_tiers(
                self.census.costs, num_tiers, min_members=B * A)
            self.tier_caps = tier_caps(self.needs, self.tier_of, B,
                                       self.batch_parts, policy=ladder,
                                       accum_steps=A,
                                       costs=self.census.costs)
            # eval packs (arbitrary held-out subsets, outside the plan's
            # round guarantee) keep the dataset-wide worst-case caps the
            # naive loader uses
            self.caps = fixed_caps_for_batches(
                self.needs, -(-B // self.batch_parts), policy=ladder)
        else:
            if self.needs is None:
                self.needs = self.structure_needs()
            self.caps = fixed_caps_for_batches(
                self.needs,
                -(-B // self.batch_parts),  # per batch shard
                policy=ladder)
        self._depth = max(int(prefetch), 0)
        self._prefetcher = None

    # ---- capacity planning ----

    def structure_needs(self) -> list[dict]:
        """Per-structure capacity needs (single-partition plan counts) —
        computed ONCE at loader construction to freeze the run's shapes."""
        return structure_needs([s.atoms for s in self.samples], self.cutoff,
                               self.bond_cutoff, self.use_bond_graph,
                               self.num_threads)

    # ---- the per-epoch packing plan (cost-model path) ----

    def epoch_plan(self, epoch: int) -> list:
        """The epoch's deterministic packing plan (cost-model packing
        only) — a pure function of ``(seed, epoch)``, cached for the
        couple of epochs the prefetcher may straddle."""
        if self.packing != "cost_model":
            raise ValueError("epoch_plan is only defined under "
                             "packing='cost_model'")
        with self._plan_lock:
            plan = self._plan_cache.get(epoch)
        if plan is None:
            plan = plan_epoch(
                self.census.costs, self.tier_of, seed=self.seed,
                epoch=epoch, micro_batch_size=self.micro_batch_size,
                accum_steps=self.accum_steps,
                batch_parts=self.batch_parts, shuffle=self.shuffle)
            with self._plan_lock:
                self._plan_cache[epoch] = plan
                while len(self._plan_cache) > 4:
                    del self._plan_cache[min(self._plan_cache)]
        return plan

    @property
    def num_tiers(self) -> int:
        """Distinct frozen capacity tiers (1 under naive packing): the
        number of distinct shapes the whole run steps is bounded by this."""
        return len(self.tier_caps) if self.packing == "cost_model" else 1

    def tier_first_steps(self, epoch: int = 0) -> dict:
        """{tier: first step index of ``epoch`` running that tier}: the
        Trainer measures each tier's step peak on exactly these steps."""
        if self.packing != "cost_model":
            return {0: 0}
        firsts: dict[int, int] = {}
        for i, step in enumerate(self.epoch_plan(epoch)):
            firsts.setdefault(step.tier, i)
        return firsts

    def step_tier(self, epoch: int, step: int) -> int:
        """Tier of the (epoch, step) macro-batch (0 under naive packing)."""
        if self.packing != "cost_model":
            return 0
        plan = self.epoch_plan(epoch)
        if step >= len(plan):  # cursor parked on an epoch boundary
            return self.epoch_plan(epoch + 1)[0].tier
        return plan[step].tier

    # ---- cursor ----

    @property
    def steps_per_epoch(self) -> int:
        if self.packing == "cost_model":
            # per-tier window counts are a function of STATIC tier
            # membership, so this is epoch-independent like the naive path
            B_A = self.micro_batch_size * self.accum_steps
            return sum(int(np.sum(self.tier_of == t)) // B_A
                       for t in self.tier_caps)
        return len(self.samples) // (self.micro_batch_size
                                     * self.accum_steps)

    def state(self) -> dict:
        """The resumable cursor: batches CONSUMED so far (not built —
        prefetched-but-undelivered batches are rebuilt on resume). Under
        cost-model packing the cursor grows a ``tier`` coordinate — the
        tier of the NEXT step, derived from the plan — so a resume can
        validate that it rebuilt the same tiering the checkpoint saw."""
        cur = {"seed": self.seed, "epoch": self._epoch, "step": self._step}
        if self.packing == "cost_model":
            cur["tier"] = self.step_tier(self._epoch, self._step)
        return cur

    def set_state(self, state: dict) -> None:
        self.close()
        self.seed = int(state["seed"])
        self._epoch = int(state["epoch"])
        self._step = int(state["step"])
        with self._plan_lock:
            self._plan_cache.clear()
        if self.packing == "cost_model" and "tier" in state:
            want = int(state["tier"])
            have = self.step_tier(self._epoch, self._step)
            if want != have:
                raise ValueError(
                    f"loader cursor tier mismatch: checkpoint says the "
                    f"next step runs tier {want}, this loader's plan says "
                    f"tier {have} — the dataset, seed, micro-batch size "
                    f"or tier configuration changed since the checkpoint "
                    f"was written (resume would not be bitwise)")

    # ---- batch building ----

    def _order(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            return epoch_permutation(len(self.samples), self.seed, epoch)
        return np.arange(len(self.samples))

    def _micro_indices(self, epoch: int, step: int) -> tuple[int, list]:
        """(tier, [A index-lists]) of the (epoch, step) macro-batch under
        the active packing policy."""
        B, A = self.micro_batch_size, self.accum_steps
        if self.packing == "cost_model":
            macro = self.epoch_plan(epoch)[step]
            return macro.tier, [list(m) for m in macro.micro]
        order = self._order(epoch)
        start = step * B * A
        return 0, [list(order[start + a_i * B:start + (a_i + 1) * B])
                   for a_i in range(A)]

    def _build(self, epoch: int, step: int) -> TrainBatch:
        """Build the (epoch, step) macro-batch — a pure function of the
        cursor, which is the whole resume story."""
        tier, micros = self._micro_indices(epoch, step)
        caps = (self.tier_caps[tier] if self.packing == "cost_model"
                else self.caps)
        graphs, targets = [], []
        n_atoms_total = 0
        wastes, balances, edge_totals = [], [], []
        for idx in micros:
            batch_samples = [self.samples[i] for i in idx]
            graph, host = pack_structures(
                [s.atoms for s in batch_samples], self.cutoff,
                bond_cutoff=self.bond_cutoff,
                use_bond_graph=self.use_bond_graph, caps=caps,
                species_fn=self.species_fn, dtype=self.dtype,
                system=self.system, num_threads=self.num_threads)
            graphs.append(graph)
            targets.append(pack_targets(graph, host, batch_samples,
                                        dtype=self.dtype))
            n_atoms_total += int(sum(len(s.forces) for s in batch_samples))
            stats = host.stats or {}
            wastes.append(float(stats.get("padding_waste_frac", 0.0)))
            rows = stats.get("n_edges_per_part") or []
            edge_totals.append(float(sum(rows)))
            if rows and max(rows) > 0:
                balances.append(sum(rows) / len(rows) / max(rows))
        # edge balance: rows within each micro-batch AND micro-batches
        # within the window — 1.0 means no device/scan-slot ever waits on
        # a heavier sibling
        balance = min(balances) if balances else 1.0
        if edge_totals and max(edge_totals) > 0:
            balance = min(balance, sum(edge_totals) / len(edge_totals)
                          / max(edge_totals))
        B, A = self.micro_batch_size, self.accum_steps
        return TrainBatch(
            graphs=graphs,
            targets=targets,
            meta={"epoch": epoch, "step": step, "tier": tier,
                  "bucket_key": bucket_key(graphs[0]),
                  "n_structures": B * A, "n_atoms": n_atoms_total,
                  "padding_waste_frac": (sum(wastes) / len(wastes)
                                         if wastes else 0.0),
                  "edge_balance": balance})

    def _advance(self, epoch: int, step: int) -> tuple[int, int]:
        step += 1
        if step >= self.steps_per_epoch:
            return epoch + 1, 0
        return epoch, step

    def next_batch(self) -> TrainBatch:
        """The next macro-batch in cursor order (prefetched when a depth
        was configured); advances the consumed cursor."""
        if self._depth > 0:
            if self._prefetcher is None:
                self._prefetcher = _Prefetcher(
                    self._build, self._advance,
                    (self._epoch, self._step), self._depth)
            batch, nxt = self._prefetcher.get()
        else:
            batch = self._build(self._epoch, self._step)
            nxt = self._advance(self._epoch, self._step)
        self._epoch, self._step = nxt
        return batch

    def eval_batch(self, samples) -> TrainBatch:
        """One batch (A=1) over ``samples``: the held-out eval surface,
        packed at the train stream's frozen caps when it fits."""
        graph, host = pack_structures(
            [s.atoms for s in samples], self.cutoff,
            bond_cutoff=self.bond_cutoff,
            use_bond_graph=self.use_bond_graph, caps=self.caps,
            species_fn=self.species_fn, dtype=self.dtype,
            system=self.system, num_threads=self.num_threads)
        targets = pack_targets(graph, host, samples, dtype=self.dtype)
        return TrainBatch(
            graphs=[graph], targets=[targets],
            meta={"bucket_key": bucket_key(graph),
                  "n_structures": len(samples)})

    def close(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = None

    def __del__(self):  # pragma: no cover - GC ordering
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


class _Prefetcher:
    """Double-buffered background batch builder.

    Builds batches from its own cursor into a bounded queue; the consumer
    pops ``(batch, next_cursor)`` pairs in order. A builder exception is
    delivered to the consumer at the matching ``get()`` (not swallowed,
    not fatal to the thread's queue discipline)."""

    def __init__(self, build_fn, advance_fn, cursor, depth: int):
        self._build = build_fn
        self._advance = advance_fn
        self._cursor = cursor
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="distmlip-train-prefetch", daemon=True)
        self._thread.start()

    def _run(self):
        cursor = self._cursor
        while not self._stop.is_set():
            try:
                item = (self._build(*cursor), self._advance(*cursor), None)
            except BaseException as e:  # noqa: BLE001 - delivered at get()
                item = (None, self._advance(*cursor), e)
            cursor = item[1]
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self):
        while True:
            try:
                batch, nxt, err = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError(
                        "train prefetch thread died without delivering")
        if err is not None:
            raise err
        return batch, nxt

    def stop(self):
        self._stop.set()
        # unblock a producer stuck on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
