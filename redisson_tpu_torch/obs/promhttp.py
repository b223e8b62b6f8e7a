"""Prometheus scrape endpoint.

A daemon ``ThreadingHTTPServer`` serving the text exposition at
``/metrics`` (anything else 404s).  Render happens per scrape from a
callable, so callback gauges (queue depth, device memory) are sampled
at scrape time — no background collection thread.

The port's copy of ``redisson_tpu/obs/promhttp.py``.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHTTPServer:
    def __init__(self, render: Callable[[], str], host: str = "127.0.0.1",
                 port: int = 0):
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive between scrapes

            def do_GET(self):
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                try:
                    body = outer._render().encode()
                except Exception as e:  # a dying engine must not 500-loop
                    msg = str(e).encode()
                    self.send_response(500)
                    self.send_header("Content-Length", str(len(msg)))
                    self.end_headers()
                    self.wfile.write(msg)
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes must not spam stderr
                pass

        self._render = render
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="rtpu-metrics-http",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
