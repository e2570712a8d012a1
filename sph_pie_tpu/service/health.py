"""Health/observability snapshot.

Counterpart of `GET /api/health` in sphereisaiahmin-dev/sph-pie
(`server/index.js:132-144`: status + storage metadata + webhook state +
bound address), extended with the thing an accelerator framework actually needs to
report: the device topology.
"""

from __future__ import annotations

import sph_pie_tpu


def device_info() -> dict:
    try:
        import jax

        devs = jax.devices()
        return {
            "backend": devs[0].platform if devs else "none",
            "deviceCount": len(devs),
            "devices": [str(d) for d in devs[:8]],
        }
    except Exception as e:  # device unreachable should not kill /health
        return {"backend": "unavailable", "error": str(e)[:200]}


def health_snapshot(registry=None, webhook=None, config=None) -> dict:
    out = {
        "status": "ok",
        "version": sph_pie_tpu.__version__,
        "device": device_info(),
    }
    if registry is not None:
        try:
            out["storage"] = registry.get_provider().get_storage_metadata()
        except Exception as e:
            out["storage"] = {"error": str(e)[:200]}
            out["status"] = "degraded"
    if webhook is not None:
        out["webhook"] = webhook.get_status()
    if config is not None:
        out["listen"] = {"host": config.get("host"), "port": config.get("port")}
    return out
