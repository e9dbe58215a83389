"""Admin REST API (:7071): app and access-key management over HTTP.

The JAX package's ``server/admin.py`` on the port's storage and commands,
route for route (the JSON bodies are the same):

  GET    /                      {"status": "alive"}
  GET    /cmd/app               list apps
  POST   /cmd/app               create app {"name": ..., ["description"]}
  DELETE /cmd/app/<name>        delete app + keys + events
  GET    /cmd/app/<name>        show app
  DELETE /cmd/app/<name>/data   wipe the app's events
"""

from __future__ import annotations

from predictionio_tpu_torch.data.storage.config import StorageRuntime, get_storage
from predictionio_tpu_torch.obs.http import add_observability_routes
from predictionio_tpu_torch.server.httpd import (
    AppServer,
    HTTPApp,
    Request,
    Response,
    error_response,
    json_response,
)
from predictionio_tpu_torch.tools.commands import (
    AppDescription,
    CommandError,
    app_data_delete,
    app_delete,
    app_list,
    app_new,
    app_show,
)


def create_admin_app(
    storage: StorageRuntime | None = None, access_key: str | None = None
) -> HTTPApp:
    """``access_key`` gates every route but ``/healthz``; TLS comes from the
    AppServer layer."""
    storage = storage or get_storage()
    app = HTTPApp("adminserver", access_key=access_key)

    def _metadata_ready() -> bool:
        storage.access_keys().get("__readyz_probe__")
        return True

    # app-level access_key (when set) gates these; /healthz stays public
    add_observability_routes(app, readiness={"metadata_store": _metadata_ready})

    def describe(d: AppDescription) -> dict:
        return d.to_json_dict()

    @app.route("GET", "/")
    def index(req: Request) -> Response:
        return json_response(200, {"status": "alive"})

    @app.route("GET", "/cmd/app")
    def list_apps(req: Request) -> Response:
        return json_response(200, [describe(d) for d in app_list(storage)])

    @app.route("POST", "/cmd/app")
    def new_app(req: Request) -> Response:
        try:
            payload = req.json() or {}
            name = payload["name"]
        except Exception:
            return error_response(400, "body must be JSON with a 'name' field")
        try:
            d = app_new(
                storage,
                name,
                description=payload.get("description", ""),
                access_key=payload.get("accessKey"),
            )
        except CommandError as e:
            return error_response(409, str(e))
        return json_response(201, describe(d))

    @app.route("GET", "/cmd/app/(?P<name>[^/]+)")
    def show_app(req: Request) -> Response:
        try:
            return json_response(200, describe(app_show(storage, req.params["name"])))
        except CommandError as e:
            return error_response(404, str(e))

    @app.route("DELETE", "/cmd/app/(?P<name>[^/]+)")
    def delete_app(req: Request) -> Response:
        try:
            app_delete(storage, req.params["name"])
        except CommandError as e:
            return error_response(404, str(e))
        return json_response(200, {"message": f"App {req.params['name']} deleted"})

    @app.route("DELETE", "/cmd/app/(?P<name>[^/]+)/data")
    def delete_data(req: Request) -> Response:
        try:
            app_data_delete(storage, req.params["name"])
        except CommandError as e:
            return error_response(404, str(e))
        return json_response(200, {"message": "Data deleted"})

    return app


def create_admin_server(
    host: str = "0.0.0.0",
    port: int = 7071,
    storage: StorageRuntime | None = None,
    access_key: str | None = None,
    ssl_certfile: str | None = None,
    ssl_keyfile: str | None = None,
) -> AppServer:
    return AppServer(
        create_admin_app(storage, access_key=access_key),
        host,
        port,
        ssl_certfile=ssl_certfile,
        ssl_keyfile=ssl_keyfile,
    )
