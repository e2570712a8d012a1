"""CLI: python -m sph_pie_tpu {serve|simulate|verify}."""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="sph_pie_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="run the HTTP service + viewer")
    s.add_argument("--config", default="config/app-config.json")
    s = sub.add_parser("simulate", help="run a scene and print metrics")
    s.add_argument("scene", help="builder name or scene JSON path")
    s.add_argument("--steps", type=int, default=500)
    sub.add_parser("verify", help="run the trajectory contract")
    args = p.parse_args(argv)

    from sph_pie_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.cmd == "serve":
        from sph_pie_tpu.service.api import serve

        serve(args.config)
    elif args.cmd == "simulate":
        from sph_pie_tpu.neighbors import binned as nb
        from sph_pie_tpu.service.metrics import state_metrics
        from sph_pie_tpu.solvers import run as run_lib

        if args.scene.endswith(".json"):
            from sph_pie_tpu.scenes.config import load_scene_file

            scene = load_scene_file(args.scene)
        else:
            from sph_pie_tpu.scenes import builders

            if not hasattr(builders, args.scene):
                p.error(
                    f"unknown scene '{args.scene}' "
                    "(try dam_break_2d, dam_break_3d, emitter_2d, or a JSON path)"
                )
            scene = getattr(builders, args.scene)()
        st, overflow = run_lib.run_scene(scene, args.steps)
        import json

        m = state_metrics(st, scene.params, step=args.steps)
        m["overflow"] = int(overflow)
        print(json.dumps(m, indent=2))
    elif args.cmd == "verify":
        import runpy

        runpy.run_path("scripts/verify_trajectory.py", run_name="__main__")


if __name__ == "__main__":
    sys.exit(main())
