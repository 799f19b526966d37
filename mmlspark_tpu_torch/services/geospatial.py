"""Geospatial (Azure-Maps-style) service transformers.

Parity: ``cognitive/.../geospatial/Geocoders.scala`` (``AddressGeocoder``,
``ReverseAddressGeocoder`` — batch POST ``{"batchItems": [...]}`` to the
search endpoints, output the ``batchItems`` array) and
``CheckPointInPolygon.scala`` (GET per point against a stored geofence).
Subscription key rides as the ``subscription-key`` URL param, as Azure Maps
expects (``AzureMapsTraits.scala``).

The port's copy of ``mmlspark_tpu/services/geospatial.py`` (host work).
"""

from __future__ import annotations

from .base import HasAsyncReply, ServiceParam, ServiceTransformer

__all__ = ["AddressGeocoder", "ReverseAddressGeocoder",
           "CheckPointInPolygon", "MapsAsyncReply"]


class MapsAsyncReply(HasAsyncReply):
    """Azure-Maps async convention (``AzureMapsTraits.scala:90-130``),
    expressed as the three ``HasAsyncReply`` hooks: the poll URL comes
    from the ``Location`` header (NOT Operation-Location), it must carry
    the subscription key the initial POST used as a query param (an
    unauthenticated poll 401s forever), and completion is the HTTP
    status flipping from 202 — there is no JSON ``status`` field."""

    _poll_location_header = "location"

    def _poll_url(self, loc: str, request) -> str:
        from urllib.parse import parse_qs, quote, urlparse
        key = parse_qs(urlparse(request.url).query).get(
            "subscription-key", [None])[0]
        if key and "subscription-key=" not in loc:
            sep = "&" if "?" in loc else "?"
            loc = f"{loc}{sep}subscription-key={quote(key)}"
        return loc

    def _poll_done(self, resp) -> bool:
        return resp.status_code != 202  # 200 = done; errors surface as-is


class _MapsBase(ServiceTransformer):
    """Azure-Maps auth: key goes in the query string, not a header."""

    def _headers(self, row):
        from ..io.http.schema import HeaderData
        return [HeaderData("Content-Type", "application/json")]

    def _full_url(self, row: dict) -> str:
        from urllib.parse import quote
        url = super()._full_url(row)
        key = self.get_value_opt(row, "subscription_key")
        if key:
            sep = "&" if "?" in url else "?"
            url = f"{url}{sep}subscription-key={quote(str(key))}"
        return url


class AddressGeocoder(_MapsBase, MapsAsyncReply):
    """Batch forward geocoding: address strings → candidate coordinates.
    Async per the Maps batch convention (``Geocoders.scala:30-75`` with
    ``MapsAsyncReply``)."""

    address = ServiceParam(list, is_required=True,
                           doc="list of address strings per row (a batch)")

    def _payload(self, row: dict):
        addrs = self.get_value_opt(row, "address")
        return {"batchItems": [{"query": f"?query={a}"} for a in addrs]}

    def _parse(self, body):
        if isinstance(body, dict):
            return body.get("batchItems", body)
        return body


class ReverseAddressGeocoder(_MapsBase, MapsAsyncReply):
    """Batch reverse geocoding: (lat, lon) pairs → addresses. Async per
    the Maps batch convention (``Geocoders.scala:79-130``)."""

    coordinates = ServiceParam(list, is_required=True,
                               doc="list of [lat, lon] pairs per row")

    def _payload(self, row: dict):
        pts = self.get_value_opt(row, "coordinates")
        return {"batchItems": [{"query": f"?query={lat},{lon}"}
                               for lat, lon in pts]}

    def _parse(self, body):
        if isinstance(body, dict):
            return body.get("batchItems", body)
        return body


class CheckPointInPolygon(_MapsBase):
    """Point-in-geofence check (GET per row)."""

    lat = ServiceParam(float, is_required=True, is_url_param=True,
                       doc="point latitude")
    lon = ServiceParam(float, is_required=True, is_url_param=True,
                       doc="point longitude")
    user_data_identifier = ServiceParam(str, is_url_param=True,
                                        payload_name="udid",
                                        doc="uploaded polygon id")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._set_default(method="GET")
