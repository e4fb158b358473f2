"""Time Dataset.pattern_info at the headline shape (N=1M, D=1024, P=32).

Reports the cold call (includes the one-time compiles of the hash and
verification programs) and the warm call on a SECOND dataset with the same
shapes but different contents (detection results are cached on the
Dataset, so re-detecting the same dataset would time the cache).

Usage: python tools/pattern_detect_bench.py [--n 1000000] [--d 1024] [--p 32]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def make(n, d, p, seed):
    import jax
    import jax.numpy as jnp

    from ppca_rs_tpu import Dataset

    ks = jax.random.split(jax.random.PRNGKey(seed), 4)

    @jax.jit
    def gen():
        pats = jax.random.bernoulli(ks[0], 0.5, (p, d))
        pidx = jax.random.randint(ks[1], (n,), 0, p)
        data = jax.random.normal(ks[2], (n, d), jnp.float32)
        mask = pats[pidx]
        return jnp.where(mask, data, 0.0), mask

    data, mask = gen()
    jax.block_until_ready(mask)
    return Dataset.from_parts(data, mask)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--p", type=int, default=32)
    args = ap.parse_args()

    for label, seed in (("cold (incl. compile)", 0), ("warm", 1), ("warm2", 2)):
        ds = make(args.n, args.d, args.p, seed)
        t0 = time.perf_counter()
        info = ds.pattern_info()
        dt = time.perf_counter() - t0
        assert info is not None and info[1].shape[0] == args.p, (
            None if info is None else info[1].shape)
        print(f"pattern_info {label}: {dt:.2f}s "
              f"(N={args.n}, D={args.d}, P={args.p})", flush=True)


if __name__ == "__main__":
    main()
