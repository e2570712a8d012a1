"""HTTP API service.

Counterpart of sphereisaiahmin-dev/sph-pie `server/index.js`: a JSON REST
surface with cookie sessions, a forced-password-reset gate (HTTP 423 with
an auth-route allowlist — index.js:38-43,99-111), role guards with admin
bypass (index.js:641-672), hot-swappable storage/webhook config
(index.js:245-260), and a health endpoint. Implemented on the stdlib
``ThreadingHTTPServer`` — no web framework.

Multi-client sync: the reference fans out change notices between browser
tabs over BroadcastChannel and receivers re-fetch authoritative state
(`public/app.js:1884-2006`). The server-side analogue here is the
``/api/events`` SSE stream: mutations push {type} notices; clients
re-fetch rather than trusting payloads.
"""

from __future__ import annotations

import json
import queue
import re
import sys
import threading
import time
from http.cookies import SimpleCookie
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from sph_pie_tpu.service import export as export_lib
from sph_pie_tpu.service import health as health_lib
from sph_pie_tpu.service.config_store import ConfigStore
from sph_pie_tpu.service.rbac import RoleConfig, is_operator_only, user_has_role
from sph_pie_tpu.service.sessions import COOKIE_NAME, SessionStore
from sph_pie_tpu.service.storage import ProviderRegistry
from sph_pie_tpu.service.storage.base import ConflictError, ValidationError, now_ms
from sph_pie_tpu.service.users import UserStore, verify_password
from sph_pie_tpu.service.webhook import WebhookDispatcher

PASSWORD_RESET_ALLOW = (
    "/api/auth/session",
    "/api/auth/login",
    "/api/auth/logout",
    "/api/auth/password",
    "/api/health",
)


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class App:
    """Service wiring: config -> storage/webhook/users/sessions/roles."""

    def __init__(
        self,
        config_path="config/app-config.json",
        data_dir=None,
        env=None,
        access_log=None,
    ):
        self.config_store = ConfigStore(config_path, env=env)
        self.config = self.config_store.load()
        # Per-request access log (the reference's morgan('dev'),
        # server/index.js:70): one line per request with method, path,
        # status and duration. Default OFF for embedded/test use; serve()
        # turns it on (overridable via SPH_PIE_ACCESS_LOG / config
        # "accessLog").
        self.access_log = (
            bool(access_log)
            if access_log is not None
            else bool(self.config.get("accessLog", False))
        )
        self.access_logger = lambda line: print(line, file=sys.stderr, flush=True)
        if data_dir:  # test convenience: redirect all file state
            self.config["sqlite"]["filename"] = f"{data_dir}/sph_pie.sqlite"
            self.config["jsonfile"]["directory"] = f"{data_dir}/runs"
        self.webhook = WebhookDispatcher(self.config.get("webhook"))
        self.registry = ProviderRegistry(on_event=self._on_storage_event)
        self.registry.init_provider(self.config)
        self.roles = RoleConfig()
        users_path = f"{data_dir}/users.json" if data_dir else "data/users.json"
        self.users = UserStore(users_path, role_config=self.roles).init()
        self.sessions = SessionStore()
        from sph_pie_tpu.service.executor import RunExecutor

        self._subscribers: list[queue.Queue] = []
        self._lock = threading.Lock()
        self.executor = RunExecutor(
            self.registry,
            webhook=self.webhook,
            broadcast=self.broadcast,
            checkpoint_dir=f"{data_dir}/checkpoints" if data_dir else "data/checkpoints",
        )
        self._previews: dict[str, dict] = {}
        self._preview_lock = threading.Lock()
        d = self.roles.default_domain["id"]
        self.read_roles = [f"{d}.lead", f"{d}.operator", f"{d}.crew"]
        self.write_roles = [f"{d}.lead"]
        self.step_roles = [f"{d}.lead", f"{d}.operator"]

    # -- live scene previews ----------------------------------------------
    PREVIEW_ARGS = {
        "dam_break_2d": {"n_target": 2048},
        "dam_break_3d": {"n_target": 8000},
        "emitter_2d": {"n_target": 1024},
    }
    PREVIEW_EPOCH = 25  # preview steps quantum (one compiled epoch length)

    def preview_frame(self, scene_id: str, steps: int, res: int = 256) -> bytes:
        """Advance a cached preview simulation to >= ``steps`` and render.

        The simulation state is memoised per scene and only advanced by the
        delta (quantised to PREVIEW_EPOCH so jit reuses one compilation).
        Returns PNG bytes rendered on-device (render/splat.py).
        """
        from sph_pie_tpu.render import png as png_lib
        from sph_pie_tpu.render import splat
        from sph_pie_tpu.scenes import builders
        from sph_pie_tpu.solvers import run as run_lib

        if scene_id not in self.PREVIEW_ARGS:
            raise HttpError(404, f"unknown scene: {scene_id}")
        steps = max(0, (int(steps) // self.PREVIEW_EPOCH) * self.PREVIEW_EPOCH)
        with self._preview_lock:
            entry = self._previews.get(scene_id)
            if entry is None or entry["step"] > steps:
                scene = getattr(builders, scene_id)(**self.PREVIEW_ARGS[scene_id])
                entry = {"scene": scene, "state": scene.state, "step": 0}
                self._previews[scene_id] = entry
            scene = entry["scene"]
            while entry["step"] < steps:
                st, _ = run_lib.run_epochs(
                    scene.params,
                    scene.bgrid,
                    entry["state"],
                    scene.emitter,
                    scene.obstacles,
                    self.PREVIEW_EPOCH,
                    1,
                    start_step=entry["step"],
                )
                entry["state"] = st
                entry["step"] += self.PREVIEW_EPOCH
            import numpy as np

            frame = splat.frame_from_state(
                entry["state"], scene.params, (res, res)
            )
            return png_lib.encode_gray_png(np.asarray(frame))

    # -- events ------------------------------------------------------------
    def _on_storage_event(self, event: str, run: dict, meta=None):
        if event == "run.archived":
            self.webhook.dispatch_archive_event(run, meta)
        else:
            self.webhook.dispatch_run_event(event, run, meta)
        self.broadcast({"type": "runs:changed", "event": event, "runId": run.get("id")})

    def broadcast(self, message: dict):
        with self._lock:
            for q in list(self._subscribers):
                try:
                    q.put_nowait(message)
                except queue.Full:
                    pass

    def subscribe(self) -> queue.Queue:
        q = queue.Queue(maxsize=256)
        with self._lock:
            self._subscribers.append(q)
        return q

    def unsubscribe(self, q):
        with self._lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    # -- config hot swap ---------------------------------------------------
    def apply_config(self, new_cfg: dict) -> dict:
        """PUT /api/config semantics: persist, re-init provider + webhook
        without restart (reference: index.js:245-260)."""
        # GET /api/config masks webhook.secret as '***'; a read-modify-write
        # round trip must not overwrite the real secret with the mask.
        wh = new_cfg.get("webhook")
        if isinstance(wh, dict) and ("secret" not in wh or wh["secret"] == "***"):
            existing = self.config.get("webhook", {}).get("secret")
            if existing:
                wh = dict(wh, secret=existing)
                new_cfg = dict(new_cfg, webhook=wh)
        self.config = self.config_store.save(new_cfg)
        self.registry.init_provider(self.config)
        self.webhook.set_config(self.config.get("webhook"))
        self.broadcast({"type": "config:changed"})
        return self.config


def scene_catalog() -> list[dict]:
    from sph_pie_tpu.scenes import builders

    out = []
    for name in ("dam_break_2d", "dam_break_3d", "emitter_2d"):
        fn = getattr(builders, name)
        out.append({"id": name, "doc": (fn.__doc__ or "").strip().splitlines()[0]})
    return out


def make_handler(app: App):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "sph-pie-tpu"

        # ---- plumbing ----------------------------------------------------
        def log_message(self, *a):
            pass

        def _json_body(self) -> dict:
            length = int(self.headers.get("Content-Length") or 0)
            if length > 2 * 1024 * 1024:  # 2 MB cap (reference index.js:69)
                raise HttpError(413, "payload too large")
            if not length:
                return {}
            try:
                return json.loads(self.rfile.read(length).decode() or "{}")
            except json.JSONDecodeError:
                raise HttpError(400, "invalid JSON body")

        def _send(self, status: int, payload, headers=None, raw=None, ctype="application/json"):
            body = raw if raw is not None else json.dumps(payload).encode()
            self._last_status = status
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            try:
                self.wfile.write(body)
            except BrokenPipeError:
                pass

        def _session_token(self):
            cookie = SimpleCookie(self.headers.get("Cookie", ""))
            if COOKIE_NAME in cookie:
                return cookie[COOKIE_NAME].value
            auth = self.headers.get("Authorization", "")
            if auth.startswith("Bearer "):
                return auth[7:]
            return None

        def _current_user(self):
            token = self._session_token()
            if not token:
                return None
            sess = app.sessions.get(token)
            if not sess:
                return None
            app.sessions.touch(token)
            return app.users.find_by_id(sess["userId"])

        def _require_auth(self):
            user = self._current_user()
            if user is None:
                raise HttpError(401, "authentication required")
            return user

        def _require_roles(self, *roles):
            user = self._require_auth()
            if not user_has_role(user, *roles):
                raise HttpError(403, "insufficient role")
            return user

        def _set_cookie(self, token: str | None):
            if token:
                return {
                    "Set-Cookie": f"{COOKIE_NAME}={token}; HttpOnly; "
                    "SameSite=Lax; Path=/"
                }
            return {"Set-Cookie": f"{COOKIE_NAME}=; Max-Age=0; Path=/"}

        # ---- dispatch ----------------------------------------------------
        def _route(self, method: str):
            parsed = urlparse(self.path)
            path = parsed.path.rstrip("/") or "/"
            qs = parse_qs(parsed.query)

            # forced-password-reset gate (423 + allowlist)
            user = self._current_user()
            if (
                user is not None
                and user.get("needsPasswordReset")
                and path not in PASSWORD_RESET_ALLOW
            ):
                raise HttpError(423, "password reset required")

            for pattern, methods in ROUTES:
                m = re.fullmatch(pattern, path)
                if m and method in methods:
                    return methods[method](self, *m.groups(), qs=qs)
            raise HttpError(404, f"no route for {method} {path}")

        def _handle(self, method):
            t0 = time.time()
            # capture at request START: a slow request must not gain/lose
            # its log line because the flag flipped mid-flight
            log_this = app.access_log
            self._last_status = 0  # updated by _send
            try:
                self._route(method)
            except HttpError as e:
                self._send(e.status, {"error": str(e)})
            except ValidationError as e:
                self._send(400, {"error": str(e)})
            except ConflictError as e:
                self._send(409, {"error": str(e)})
            except KeyError as e:
                self._send(404, {"error": f"not found: {e}"})
            except Exception as e:  # JSON error handler (index.js:526-536)
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                if log_this:
                    dur_ms = (time.time() - t0) * 1e3
                    app.access_logger(
                        f"[http] {method} {self.path} "
                        f"{self._last_status} {dur_ms:.1f} ms"
                    )

        def do_GET(self):
            self._handle("GET")

        def do_POST(self):
            self._handle("POST")

        def do_PUT(self):
            self._handle("PUT")

        def do_DELETE(self):
            self._handle("DELETE")

        # ---- endpoints ---------------------------------------------------
        def ep_health(self, qs):
            self._send(
                200,
                health_lib.health_snapshot(app.registry, app.webhook, app.config),
            )

        def ep_domains(self, qs):
            self._require_auth()
            self._send(
                200,
                {
                    "levels": app.roles.levels,
                    "domains": app.roles.domains,
                    "roleKeys": app.roles.list_role_keys(),
                },
            )

        def ep_session(self, qs):
            user = self._current_user()
            if user is None:
                self._send(200, {"authenticated": False})
            else:
                self._send(
                    200, {"authenticated": True, "user": app.users.sanitize(user)}
                )

        def ep_login(self, qs):
            body = self._json_body()
            user = app.users.authenticate(body.get("email", ""), body.get("password", ""))
            if user is None:
                raise HttpError(401, "invalid credentials")
            token = app.sessions.create(user["id"])
            self._send(
                200,
                {"user": app.users.sanitize(user)},
                headers=self._set_cookie(token),
            )

        def ep_logout(self, qs):
            token = self._session_token()
            if token:
                app.sessions.delete(token)
            self._send(200, {"ok": True}, headers=self._set_cookie(None))

        def ep_password(self, qs):
            """Self-service password change (reference server/index.js:187-204):
            verify the CURRENT password (400 on mismatch), set the new one,
            purge every session the user holds, and issue a fresh cookie so
            a hijacked token cannot silently rotate the account password or
            survive the change."""
            user = self._require_auth()
            body = self._json_body()
            record = app.users.find_by_id(user["id"])
            if record is None:
                raise HttpError(404, "user not found")
            current = body.get("currentPassword", "")
            if not verify_password(
                current if isinstance(current, str) else "", record["password"]
            ):
                raise HttpError(400, "current password is incorrect")
            new_pw = body.get("password", body.get("newPassword", ""))
            app.users.set_password(user["id"], new_pw)
            app.sessions.delete_for_user(user["id"])
            token = app.sessions.create(user["id"])
            self._send(
                200,
                {"user": app.users.sanitize(record)},
                headers=self._set_cookie(token),
            )

        def ep_users_list(self, qs):
            self._require_roles()  # admin only (no roles => admin bypass only)
            # defaultPassword rides along so the admin UI can tell a user
            # their temp password after a reset (ref server/index.js:206-208)
            self._send(
                200,
                {
                    "users": app.users.list_users(),
                    "defaultPassword": app.users.temp_password,
                },
            )

        def ep_users_create(self, qs):
            self._require_roles()
            self._send(201, {"user": app.users.create_user(self._json_body())})

        def ep_users_update(self, user_id, qs):
            self._require_roles()
            self._send(200, {"user": app.users.update_user(user_id, self._json_body())})

        def ep_users_reset(self, user_id, qs):
            self._require_roles()
            user = app.users.reset_password(user_id)
            app.sessions.delete_for_user(user_id)
            self._send(200, {"user": user})

        def ep_staff(self, qs):
            self._require_auth()
            self._send(200, {"directory": app.users.role_directory()})

        def ep_staff_put(self, qs):
            """Deliberate tombstone: the staff directory derives from the
            user directory and is read-only (reference: PUT /api/staff ->
            410 Gone, server/index.js:276)."""
            self._require_auth()
            raise HttpError(
                410, "staff directory is derived from users; manage users instead"
            )

        def ep_config_get(self, qs):
            self._require_auth()
            cfg = dict(app.config)
            wh = dict(cfg.get("webhook", {}))
            if wh.get("secret"):
                wh["secret"] = "***"
            cfg["webhook"] = wh
            self._send(200, {"config": cfg})

        def ep_config_put(self, qs):
            self._require_roles()
            body = self._json_body()
            cfg = app.apply_config(body)
            self._send(200, {"config": cfg, "storage": app.registry.get_active_provider_type()})

        def ep_scenes(self, qs):
            self._require_auth()
            self._send(200, {"scenes": scene_catalog()})

        def ep_runs_list(self, qs):
            self._require_roles(*app.read_roles)
            self._send(200, {"runs": app.registry.get_provider().list_runs()})

        def ep_runs_create(self, qs):
            self._require_roles(*app.write_roles)
            run = app.registry.get_provider().create_run(self._json_body())
            app.broadcast({"type": "runs:changed", "event": "run.created", "runId": run["id"]})
            self._send(201, {"run": run})

        def ep_run_get(self, run_id, qs):
            self._require_roles(*app.read_roles)
            run = app.registry.get_provider().get_run(run_id)
            if run is None:
                raise HttpError(404, "run not found")
            self._send(200, {"run": run})

        def ep_run_put(self, run_id, qs):
            self._require_roles(*app.write_roles)
            run = app.registry.get_provider().update_run(run_id, self._json_body())
            app.broadcast({"type": "runs:changed", "event": "run.updated", "runId": run_id})
            self._send(200, {"run": run})

        def ep_run_delete(self, run_id, qs):
            self._require_roles(*app.write_roles)
            run = app.registry.get_provider().delete_run(run_id)
            self._send(200, {"run": run})

        def ep_run_archive(self, run_id, qs):
            self._require_roles(*app.write_roles)
            run = app.registry.get_provider().archive_run_now(run_id)
            self._send(200, {"run": run})

        def ep_archive_list(self, qs):
            self._require_roles(*app.read_roles)
            self._send(200, {"runs": app.registry.get_provider().list_archived_runs()})

        def ep_archive_analytics(self, qs):
            """Grouped metric series over the archive (chart-engine analogue)."""
            self._require_roles(*app.read_roles)
            from sph_pie_tpu.service import analytics

            def multi(key):
                vals = qs.get(key) or []
                out = []
                for v in vals:
                    out.extend(x for x in v.split(",") if x)
                return out or None

            result = analytics.daily_series(
                app.registry.get_provider().list_archived_runs(),
                metrics=multi("metric"),
                scenes=multi("scene"),
                operators=multi("operator"),
                date_from=(qs.get("from") or [None])[0],
                date_to=(qs.get("to") or [None])[0],
            )
            self._send(200, result)

        def ep_step_create(self, run_id, qs):
            user = self._require_roles(*app.step_roles)
            body = self._json_body()
            if is_operator_only(user, app.roles):
                body["operator"] = user["name"]  # forced identity (index.js:491-493)
            run = app.registry.get_provider().add_step(run_id, body)
            app.broadcast({"type": "runs:changed", "event": "step.added", "runId": run_id})
            self._send(201, {"run": run})

        def ep_step_update(self, run_id, step_id, qs):
            user = self._require_roles(*app.step_roles)
            body = self._json_body()
            if is_operator_only(user, app.roles):
                body["operator"] = user["name"]
            run = app.registry.get_provider().update_step(run_id, step_id, body)
            self._send(200, {"run": run})

        def ep_step_delete(self, run_id, step_id, qs):
            self._require_roles(*app.step_roles)
            run = app.registry.get_provider().delete_step(run_id, step_id)
            self._send(200, {"run": run})

        def ep_run_execute(self, run_id, qs):
            """Queue an actual simulation for this run record (202)."""
            self._require_roles(*app.write_roles)
            body = self._json_body()
            scene_id = body.get("scene")
            run = app.registry.get_provider().get_run(run_id)
            if run is None:
                raise HttpError(404, "run not found")
            scene_id = scene_id or run.get("scene")
            from sph_pie_tpu.service.api import scene_catalog

            if scene_id not in {s["id"] for s in scene_catalog()}:
                raise HttpError(400, f"unknown scene: {scene_id}")
            queued = app.executor.submit(
                run_id,
                scene_id,
                int(body.get("steps", 200)),
                int(body.get("recordEvery", 50)),
            )
            self._send(202, {"run": queued, "pending": app.executor.pending()})

        def ep_run_export(self, run_id, qs):
            self._require_roles(*app.read_roles)
            provider = app.registry.get_provider()
            run = provider.get_run(run_id) or provider.get_archived_run(run_id)
            if run is None:
                raise HttpError(404, "run not found")
            fmt = (qs.get("format") or ["json"])[0]
            if fmt == "csv":
                self._send(
                    200, None, raw=export_lib.run_to_csv(run).encode(), ctype="text/csv"
                )
            else:
                self._send(
                    200,
                    None,
                    raw=export_lib.run_to_json(run).encode(),
                    ctype="application/json",
                )

        def ep_webhook_status(self, qs):
            self._require_auth()
            self._send(200, {"webhook": app.webhook.get_status()})

        def ep_webhook_preview(self, qs):
            """Live payload preview for the webhook modal (reference:
            updateWebhookPreview, public/app.js:5946-6003): the exact
            headers + schema-v2 envelope the dispatcher would send, built
            from the newest real run or a sample."""
            self._require_roles()
            provider = app.registry.get_provider()
            runs = provider.list_runs() or provider.list_archived_runs()
            sample = (
                runs[-1]
                if runs
                else {
                    "id": "sample-run",
                    "name": "sample-run",
                    "scene": "dam_break_2d",
                    "runDate": "2026-01-01",
                    "steps": [
                        {
                            "id": "s1",
                            "step": 50,
                            "kinetic_energy": 1.25,
                            "max_speed": 0.8,
                            "operator": "Operator",
                        }
                    ],
                    "createdAt": now_ms(),
                    "updatedAt": now_ms(),
                }
            )
            headers = dict(app.webhook._headers())
            if headers.get("Authorization"):
                headers["Authorization"] = "Bearer ***"
            self._send(
                200,
                {
                    "headers": headers,
                    "payload": app.webhook.build_payload("run.archived", sample),
                },
            )

        def ep_webhook_simulate(self, qs):
            """Admin fire drill mirroring the reference's simulate-month
            selection exactly (index.js:406-486): candidates are archived
            runs inside a 30-day window with >= 6 recorded steps, the 3
            most recent are replayed, and each sends at most 6 step records
            per run."""
            self._require_roles()
            provider = app.registry.get_provider()
            window_ms = 30 * 24 * 3600 * 1000
            cutoff = now_ms() - window_ms
            candidates = [
                r
                for r in provider.list_archived_runs()  # already newest-first
                if len(r.get("steps", [])) >= 6
                and (r.get("archivedAt") or r.get("createdAt") or 0) >= cutoff
            ][:3]
            results = []
            for r in candidates:
                capped = dict(r, steps=r.get("steps", [])[:6])
                results.append(
                    app.webhook.dispatch_archive_event(
                        capped, {"source": "simulation", "window_days": 30}
                    )
                )
            self._send(
                200,
                {
                    "simulated": len(candidates),
                    "sent": sum(r["sent"] for r in results),
                    "failed": sum(r["failed"] for r in results),
                },
            )

        def ep_preview(self, scene_id, qs):
            """On-device-rendered PNG frame of a cached live preview sim."""
            self._require_auth()
            steps = int((qs.get("steps") or [0])[0])
            res = min(1024, int((qs.get("res") or [256])[0]))
            png = app.preview_frame(scene_id, steps, res)
            self._send(200, None, raw=png, ctype="image/png")

        def ep_calendar(self, qs):
            """Sync-then-list ICS schedule (reference: GET /api/calendar
            always refetches the feed, index.js:293-302)."""
            self._require_auth()
            from sph_pie_tpu.service import calendar_feed

            url = app.config.get("calendar", {}).get("feedUrl", "")
            override = (qs.get("url") or [None])[0]
            if override:
                # SSRF guard: only admins may point the server at an
                # arbitrary feed, and only over http(s) — the reference
                # fetches exclusively its configured CALENDAR_FEED_URL
                # (index.js:53,293-302).
                self._require_roles()  # admin only
                url = override
            provider = app.registry.get_provider()
            if not url:
                self._send(
                    200,
                    {
                        "events": provider.list_calendar_events(),
                        "detail": "no feed configured",
                    },
                )
                return
            if urlparse(url).scheme not in ("http", "https"):
                raise HttpError(400, "calendar feed URL must be http(s)")
            # Sync-then-list with a persisted mirror (reference stores
            # events with upsert+prune, sqlProvider.js:940-968); a feed
            # outage degrades to serving the last good sync.
            try:
                events = calendar_feed.fetch_calendar_feed(url)
            except Exception as e:
                stored = provider.list_calendar_events()
                if override:
                    raise HttpError(502, f"feed fetch failed: {e}")
                self._send(
                    200, {"events": stored, "detail": f"stale (fetch failed: {e})"}
                )
                return
            provider.sync_calendar_events(events)
            self._send(200, {"events": provider.list_calendar_events()})

        def ep_static(self, qs):
            """Static viewer shell (the reference serves public/ + SPA
            fallback, index.js:71,522-524)."""
            from pathlib import Path

            root = Path(__file__).resolve().parents[2] / "public"
            rel = urlparse(self.path).path.lstrip("/") or "index.html"
            target = (root / rel).resolve()
            if not str(target).startswith(str(root)) or not target.is_file():
                target = root / "index.html"  # SPA fallback
            ctype = {
                ".html": "text/html",
                ".js": "text/javascript",
                ".css": "text/css",
                ".png": "image/png",
                ".svg": "image/svg+xml",
            }.get(target.suffix, "application/octet-stream")
            self._send(200, None, raw=target.read_bytes(), ctype=ctype)

        def ep_events(self, qs):
            """SSE change feed (BroadcastChannel analogue)."""
            self._require_auth()
            q = app.subscribe()
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                max_events = int((qs.get("max") or [1000])[0])
                for _ in range(max_events):
                    try:
                        msg = q.get(timeout=15)
                        data = f"data: {json.dumps(msg)}\n\n"
                    except queue.Empty:
                        data = ": keepalive\n\n"
                    self.wfile.write(data.encode())
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                app.unsubscribe(q)
                self.close_connection = True

    ROUTES = [
        (r"/api/health", {"GET": Handler.ep_health}),
        (r"/api/domains", {"GET": Handler.ep_domains}),
        (r"/api/auth/session", {"GET": Handler.ep_session}),
        (r"/api/auth/login", {"POST": Handler.ep_login}),
        (r"/api/auth/logout", {"POST": Handler.ep_logout}),
        (r"/api/auth/password", {"POST": Handler.ep_password}),
        (r"/api/users", {"GET": Handler.ep_users_list, "POST": Handler.ep_users_create}),
        (r"/api/users/([^/]+)/reset-password", {"POST": Handler.ep_users_reset}),
        (r"/api/users/([^/]+)", {"PUT": Handler.ep_users_update}),
        (r"/api/staff", {"GET": Handler.ep_staff, "PUT": Handler.ep_staff_put}),
        (r"/api/config", {"GET": Handler.ep_config_get, "PUT": Handler.ep_config_put}),
        (r"/api/scenes", {"GET": Handler.ep_scenes}),
        (r"/api/runs", {"GET": Handler.ep_runs_list, "POST": Handler.ep_runs_create}),
        (r"/api/runs/archive", {"GET": Handler.ep_archive_list}),
        (r"/api/runs/archive/analytics", {"GET": Handler.ep_archive_analytics}),
        (r"/api/runs/([^/]+)/archive", {"POST": Handler.ep_run_archive}),
        (r"/api/runs/([^/]+)/export", {"GET": Handler.ep_run_export}),
        (r"/api/runs/([^/]+)/execute", {"POST": Handler.ep_run_execute}),
        (
            r"/api/runs/([^/]+)/steps/([^/]+)",
            {"PUT": Handler.ep_step_update, "DELETE": Handler.ep_step_delete},
        ),
        (r"/api/runs/([^/]+)/steps", {"POST": Handler.ep_step_create}),
        (
            r"/api/runs/([^/]+)",
            {
                "GET": Handler.ep_run_get,
                "PUT": Handler.ep_run_put,
                "DELETE": Handler.ep_run_delete,
            },
        ),
        (r"/api/webhook/simulate", {"POST": Handler.ep_webhook_simulate}),
        (r"/api/webhook/status", {"GET": Handler.ep_webhook_status}),
        (r"/api/webhook/preview", {"GET": Handler.ep_webhook_preview}),
        (r"/api/events", {"GET": Handler.ep_events}),
        (r"/api/scenes/([^/]+)/preview\.png", {"GET": Handler.ep_preview}),
        (r"/api/calendar", {"GET": Handler.ep_calendar}),
        (r"/(?!api/).*", {"GET": Handler.ep_static}),
    ]

    return Handler


def make_server(app: App, host: str | None = None, port: int | None = None):
    host = host if host is not None else app.config.get("host", "127.0.0.1")
    port = port if port is not None else int(app.config.get("port", 8411))
    try:
        return ThreadingHTTPServer((host, port), make_handler(app))
    except OSError:
        # listen-address fallback (reference: EADDRNOTAVAIL -> 0.0.0.0,
        # index.js:538-548)
        return ThreadingHTTPServer(("0.0.0.0", port), make_handler(app))


def serve(config_path="config/app-config.json"):
    import os

    from sph_pie_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    # Access log defaults ON when serving (morgan analogue); set
    # SPH_PIE_ACCESS_LOG=0 to silence.
    on = os.environ.get("SPH_PIE_ACCESS_LOG", "1").lower() not in ("0", "false")
    app = App(config_path, access_log=on)
    srv = make_server(app)
    print(f"sph-pie-tpu service on http://{srv.server_address[0]}:{srv.server_address[1]}")
    srv.serve_forever()


if __name__ == "__main__":
    serve()
