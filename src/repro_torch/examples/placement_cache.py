"""Champion cache demo: cold run -> exact cache hit -> sibling warm hit.

Port of `examples/placement_cache.py`:

    PYTHONPATH=src python -m repro_torch.examples.placement_cache [--budget 40] [--torch-device cpu]

The serving layer's take on the paper's transfer result (SS IV-D,
Table II): a `ChampionStore` attached to the `PlacementScheduler` keys
every harvested champion by the *problem's content signature*
(`fpga.netlist.Problem.signature`), so

  1. a **cold** run on xcvu_test converges normally and writes its
     champion back to the store,
  2. resubmitting the same problem with a reachable `target` is an
     **exact hit**: the store answers in milliseconds with ZERO
     generations and no slot burned,
  3. a job on the sibling device xcvu_test2 (same structural geometry,
     different column layout -- matching `sibling_key`) finds no exact
     entry, so the store auto-migrates the xcvu_test champion
     (`core.transfer.auto_migrate`) into its `init_state`: a **warm hit**
     that reaches the migrated champion's metric in a fraction of the
     cold generations,
  4. the store round-trips through JSON, so a fresh process starts hot.
"""
import argparse
import os
import tempfile
import time

from repro_torch import resolve_device
from repro_torch.core import convert, nsga2
from repro_torch.core import objectives as O
from repro_torch.serve.api import JobRequest
from repro_torch.serve.champion_store import ChampionStore
from repro_torch.serve.scheduler import PlacementScheduler


def run_one(sch, device, pop, budget, target=None, seed=0):
    t0 = time.perf_counter()
    jid = sch.submit(JobRequest(device=device, cfg=nsga2.NSGA2Config(pop_size=pop),
                                seed=seed, budget=budget, target=target))
    (job,) = (j for j in sch.run_all() if j.jid == jid)
    dt = time.perf_counter() - t0
    return job, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pop", type=int, default=16)
    ap.add_argument("--budget", type=int, default=40)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    tdev = resolve_device(args.torch_device)

    store = ChampionStore()
    sch = PlacementScheduler(n_slots=2, gens_per_step=2, store=store,
                             device=tdev)

    print(f"1) cold run on xcvu_test ({args.budget} gens)...")
    cold, dt = run_one(sch, "xcvu_test", args.pop, args.budget)
    r = cold.result
    print(f"   {r.gens} gens in {dt:.2f}s -> metric {r.metric:.3e} "
          "(champion written back)")

    target = r.metric * 1.001
    print(f"2) same problem again, target {target:.3e} (exact hit)...")
    hit, dt = run_one(sch, "xcvu_test", args.pop, args.budget,
                      target=target, seed=1)
    assert hit.cached and hit.result.gens == 0
    print(f"   served from cache in {dt * 1e3:.1f}ms, "
          f"{hit.result.gens} generations, no slot burned")

    print("3) sibling device xcvu_test2 (warm hit via signature match)...")
    prob_sib = sch.problem("xcvu_test2")
    entry, kind = store.lookup(prob_sib)
    assert kind == "sibling"
    seed_g = store.seed_for(prob_sib, entry)   # what the store will inject
    seed_t = convert.genotype_from_numpy(seed_g, tdev)
    target = float(O.combined_metric(O.evaluate(prob_sib, seed_t))) * 1.001
    cold_sch = PlacementScheduler(n_slots=2, gens_per_step=2,
                                  device=tdev)  # no store
    cold2, _ = run_one(cold_sch, "xcvu_test2", args.pop, args.budget,
                       target=target, seed=2)
    warm, dt = run_one(sch, "xcvu_test2", args.pop, args.budget,
                       target=target, seed=2)
    assert warm.warm_from_cache
    rw = warm.result
    cold_note = ("" if cold2.result.metric <= target
                 else " (budget-capped, never reached it)")
    print(f"   warm-started from the migrated xcvu_test champion: "
          f"{rw.gens} gens to target vs {cold2.result.gens} "
          f"cold{cold_note} ({cold2.result.gens / max(rw.gens, 1):.1f}x "
          "fewer)")

    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        path = f.name
    store.save(path)
    hot = ChampionStore(path=path)
    print(f"4) persisted {len(store)} champions -> {path}; a fresh store "
          f"reloads {len(hot)} (fresh processes start hot)")
    print(f"   cache stats: {store.stats()}")
    os.unlink(path)


if __name__ == "__main__":
    main()
