"""Runner-CLI multi-process worker (spawned by test_distributed.py):
drives ``runner.run`` -- the operational entry point -- across real OS
processes.  With ``jax.process_count() > 1`` the runner takes the
``drain='shard'`` branch (runner.py): each process streams + drains ONLY its
own point columns, writes ``<out>.shardNNNNN.npz`` with a range manifest and
a per-shard checkpoint -- the multi-host deployment path.

Usage: python _mp_runner_worker.py <port> <num_processes> <process_id>
Env: MP_RUN_CFG (config json), MP_RUN_OUT (output base), MP_RUN_CK
(checkpoint base), MP_RUN_T (forecast time string).
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main():
    port, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)
    from roadsurf_tpu import runner
    # MIXED verbose on purpose (the common rank-0-only-logs pattern): the
    # runner's collective screens are process_count-gated, not
    # verbose-gated, so this must not desync/deadlock
    runner.run(os.environ["MP_RUN_CFG"], os.environ.get("MP_RUN_T"),
               output_path=os.environ["MP_RUN_OUT"],
               checkpoint_out=os.environ["MP_RUN_CK"],
               verbose=(pid == 0), engine="pallas")
    print(f"MP_RUNNER_OK {pid}")


if __name__ == "__main__":
    main()
