"""Face service transformers.

Parity: ``cognitive/.../Face.scala`` (351 LoC) op-for-op: ``DetectFace``,
``FindSimilarFace``, ``VerifyFaces``, ``GroupFaces``, ``IdentifyFaces``.

The port's copy of ``mmlspark_tpu/services/face.py`` (host work).
"""

from __future__ import annotations

from .base import ServiceParam, ServiceTransformer

__all__ = ["DetectFace", "FindSimilarFace", "VerifyFaces", "GroupFaces",
           "IdentifyFaces"]


class DetectFace(ServiceTransformer):
    image_url = ServiceParam(str, is_required=True, payload_name="url",
                             doc="image URL")
    return_face_id = ServiceParam(bool, is_url_param=True,
                                  payload_name="returnFaceId", default=True,
                                  doc="return detected face ids")
    return_face_landmarks = ServiceParam(bool, is_url_param=True,
                                         payload_name="returnFaceLandmarks",
                                         doc="return 27-point landmarks")
    return_face_attributes = ServiceParam(str, is_url_param=True,
                                          payload_name="returnFaceAttributes",
                                          doc="comma-joined attribute list")


class FindSimilarFace(ServiceTransformer):
    """Parity: ``FindSimilarFace`` (``Face.scala:96-182``) — similar-face
    search for one query face against exactly one of ``faceListId`` /
    ``largeFaceListId`` / ``faceIds``; ``mode`` is matchPerson (default)
    or matchFace."""

    face_id = ServiceParam(str, is_required=True, payload_name="faceId",
                           doc="query face id from DetectFace")
    face_list_id = ServiceParam(str, payload_name="faceListId",
                                doc="face list to search")
    large_face_list_id = ServiceParam(str, payload_name="largeFaceListId",
                                      doc="large face list to search")
    face_ids = ServiceParam(list, payload_name="faceIds",
                            doc="candidate face id array (max 1000)")
    max_candidates = ServiceParam(int,
                                  payload_name="maxNumOfCandidatesReturned",
                                  doc="max candidates returned (1-1000)")
    mode = ServiceParam(str, doc="matchPerson or matchFace")

    def _build_request(self, row):
        if self.should_skip(row):  # null required params skip, not 400
            return None
        m = self.get_value_opt(row, "mode")
        if m is not None and m not in ("matchPerson", "matchFace"):
            raise ValueError(
                f"mode must be matchPerson or matchFace, got {m!r}")
        targets = [self.get_value_opt(row, n) is not None
                   for n in ("face_list_id", "large_face_list_id",
                             "face_ids")]
        if sum(targets) != 1:
            raise ValueError(
                "exactly one of face_list_id, large_face_list_id, face_ids "
                "must be set")
        return super()._build_request(row)


class VerifyFaces(ServiceTransformer):
    face_id1 = ServiceParam(str, is_required=True, payload_name="faceId1",
                            doc="first face id")
    face_id2 = ServiceParam(str, is_required=True, payload_name="faceId2",
                            doc="second face id")


class GroupFaces(ServiceTransformer):
    face_ids = ServiceParam(list, is_required=True, payload_name="faceIds",
                            doc="face ids to cluster")


class IdentifyFaces(ServiceTransformer):
    face_ids = ServiceParam(list, is_required=True, payload_name="faceIds",
                            doc="face ids to identify")
    person_group_id = ServiceParam(str, payload_name="personGroupId",
                                   doc="person group to search")
    max_candidates = ServiceParam(int, payload_name="maxNumOfCandidatesReturned",
                                  doc="max candidates per face")
    confidence_threshold = ServiceParam(float, payload_name="confidenceThreshold",
                                        doc="identification threshold")
