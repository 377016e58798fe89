// rray_tpu native host runtime.
//
// The reference's entire runtime is native (a Rust binary: tobj OBJ
// parsing, the `image` crate's PNG codec — Cargo.toml:9-19). The TPU
// build keeps the compute path in XLA and implements the host-side IO
// runtime here in C++: a single-pass OBJ parser emitting flat arrays
// (load_obj.rs:9-139 equivalent) and a zlib-backed PNG encoder
// (canvas.rs:124-131 equivalent). Exposed as a C ABI consumed via
// ctypes (rray_tpu/io/native.py).
//
// Build: g++ -O2 -shared -fPIC -o librray_host.so rray_host.cpp -lz

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parsing
// ---------------------------------------------------------------------------
//
// parse_obj(text, len) scans v/vn/f/g/o records, fan-triangulates faces
// (v0, vi, vi+1) exactly like load_obj.rs:57-76, resolves negative
// indices, and groups triangles per mesh (g/o records split meshes,
// matching the loader's per-model groups). Results are carried in a
// heap-allocated ObjResult fetched field-by-field by the Python side.

struct ObjResult {
  std::vector<double> positions;  // 3 per vertex
  std::vector<double> normals;    // 3 per normal
  // Per-triangle: 3 vertex ids + 3 normal ids (-1 when absent).
  std::vector<int64_t> tri_vertex;
  std::vector<int64_t> tri_normal;
  std::vector<int64_t> mesh_offsets;  // triangle-count prefix per mesh flush
  char error[256] = {0};
};

static bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

static const char* skip_ws(const char* p, const char* end) {
  while (p < end && is_space(*p)) p++;
  return p;
}

ObjResult* obj_parse(const char* text, int64_t len) {
  auto* r = new ObjResult();
  const char* p = text;
  const char* end = text + len;
  int64_t tri_count_at_flush = 0;
  std::vector<std::pair<int64_t, int64_t>> face;  // (vertex, normal)

  auto flush_mesh = [&]() {
    int64_t tris = (int64_t)r->tri_vertex.size() / 3;
    if (tris > tri_count_at_flush) {
      r->mesh_offsets.push_back(tris);
      tri_count_at_flush = tris;
    }
  };

  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    const char* q = skip_ws(p, line_end);

    if (q + 1 < line_end && q[0] == 'v' && is_space(q[1])) {
      char* next = nullptr;
      for (int i = 0; i < 3; i++) {
        double value = strtod(q + 1, &next);
        r->positions.push_back(value);
        q = next - 1;
      }
    } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 'n' &&
               is_space(q[2])) {
      char* next = nullptr;
      q += 1;
      for (int i = 0; i < 3; i++) {
        double value = strtod(q + 1, &next);
        r->normals.push_back(value);
        q = next - 1;
      }
    } else if (q < line_end && (q[0] == 'g' || q[0] == 'o') &&
               (q + 1 == line_end || is_space(q[1]))) {
      flush_mesh();
    } else if (q + 1 < line_end && q[0] == 'f' && is_space(q[1])) {
      face.clear();
      const char* t = q + 1;
      while (t < line_end) {
        t = skip_ws(t, line_end);
        if (t >= line_end) break;
        char* next = nullptr;
        long long vi = strtoll(t, &next, 10);
        if (next == t) break;  // malformed vertex token: stop this face
        t = next;
        long long ni = 0;
        bool has_n = false;
        if (t < line_end && *t == '/') {
          t++;  // texcoord slot (ignored, matching get_faces/get_normals)
          while (t < line_end && *t != '/' && !is_space(*t)) t++;
          if (t < line_end && *t == '/') {
            ni = strtoll(t + 1, &next, 10);
            if (next != t + 1) {
              has_n = true;
              t = next;
            }
          }
        }
        int64_t n_pos = (int64_t)r->positions.size() / 3;
        int64_t n_nrm = (int64_t)r->normals.size() / 3;
        int64_t v_idx = vi > 0 ? vi - 1 : n_pos + vi;
        int64_t nrm_idx = has_n ? (ni > 0 ? ni - 1 : n_nrm + ni) : -1;
        if (v_idx < 0 || v_idx >= n_pos) {
          snprintf(r->error, sizeof(r->error),
                   "vertex index %lld out of range", vi);
          return r;
        }
        if (has_n && (nrm_idx < 0 || nrm_idx >= n_nrm)) {
          snprintf(r->error, sizeof(r->error),
                   "normal index %lld out of range", ni);
          return r;
        }
        face.emplace_back(v_idx, nrm_idx);
      }
      // Fan triangulation (load_obj.rs:57-76).
      for (size_t i = 1; i + 1 < face.size(); i++) {
        r->tri_vertex.push_back(face[0].first);
        r->tri_vertex.push_back(face[i].first);
        r->tri_vertex.push_back(face[i + 1].first);
        r->tri_normal.push_back(face[0].second);
        r->tri_normal.push_back(face[i].second);
        r->tri_normal.push_back(face[i + 1].second);
      }
    }
    p = line_end + 1;
  }
  flush_mesh();
  return r;
}

const char* obj_error(ObjResult* r) { return r->error[0] ? r->error : nullptr; }
int64_t obj_num_vertices(ObjResult* r) { return r->positions.size() / 3; }
int64_t obj_num_normals(ObjResult* r) { return r->normals.size() / 3; }
int64_t obj_num_triangles(ObjResult* r) { return r->tri_vertex.size() / 3; }
int64_t obj_num_meshes(ObjResult* r) { return r->mesh_offsets.size(); }
const double* obj_positions(ObjResult* r) { return r->positions.data(); }
const double* obj_normals(ObjResult* r) { return r->normals.data(); }
const int64_t* obj_tri_vertex(ObjResult* r) { return r->tri_vertex.data(); }
const int64_t* obj_tri_normal(ObjResult* r) { return r->tri_normal.data(); }
const int64_t* obj_mesh_offsets(ObjResult* r) { return r->mesh_offsets.data(); }
void obj_free(ObjResult* r) { delete r; }

// ---------------------------------------------------------------------------
// PNG encoding
// ---------------------------------------------------------------------------
//
// Minimal RGBA8 PNG writer: IHDR + zlib-deflated IDAT (filter 0 rows) +
// IEND. Replaces the reference's `image` crate for canvas output.

static uint32_t crc_table[256];
static bool crc_ready = false;

static void crc_init() {
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = n;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
    crc_table[n] = c;
  }
  crc_ready = true;
}

static uint32_t crc32_update(uint32_t crc, const uint8_t* buf, size_t len) {
  if (!crc_ready) crc_init();
  uint32_t c = crc ^ 0xffffffffu;
  for (size_t i = 0; i < len; i++)
    c = crc_table[(c ^ buf[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

static void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

static void put_chunk(std::vector<uint8_t>& out, const char type[4],
                      const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32_update(0, out.data() + start, out.size() - start);
  put_be32(out, crc);
}

// Encode rgba[h*w*4] -> PNG bytes. Returns malloc'd buffer in *out
// (caller frees with png_free); returns byte count, or -1 on error.
int64_t png_encode(const uint8_t* rgba, int64_t width, int64_t height,
                   uint8_t** out) {
  // Raw stream: each row prefixed by filter byte 0.
  std::vector<uint8_t> raw;
  raw.reserve((size_t)height * ((size_t)width * 4 + 1));
  for (int64_t y = 0; y < height; y++) {
    raw.push_back(0);
    const uint8_t* row = rgba + y * width * 4;
    raw.insert(raw.end(), row, row + width * 4);
  }

  uLongf bound = compressBound(raw.size());
  std::vector<uint8_t> compressed(bound);
  if (compress2(compressed.data(), &bound, raw.data(), raw.size(), 6) != Z_OK)
    return -1;
  compressed.resize(bound);

  std::vector<uint8_t> png;
  static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  png.insert(png.end(), magic, magic + 8);

  uint8_t ihdr[13];
  ihdr[0] = (width >> 24) & 0xff;
  ihdr[1] = (width >> 16) & 0xff;
  ihdr[2] = (width >> 8) & 0xff;
  ihdr[3] = width & 0xff;
  ihdr[4] = (height >> 24) & 0xff;
  ihdr[5] = (height >> 16) & 0xff;
  ihdr[6] = (height >> 8) & 0xff;
  ihdr[7] = height & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 6;   // color type RGBA
  ihdr[10] = 0;  // compression
  ihdr[11] = 0;  // filter
  ihdr[12] = 0;  // interlace
  put_chunk(png, "IHDR", ihdr, 13);
  put_chunk(png, "IDAT", compressed.data(), compressed.size());
  put_chunk(png, "IEND", nullptr, 0);

  *out = (uint8_t*)malloc(png.size());
  memcpy(*out, png.data(), png.size());
  return (int64_t)png.size();
}

void png_free(uint8_t* buf) { free(buf); }

// ---------------------------------------------------------------------------
// Canvas quantization: float RGB -> RGBA8 with the reference's
// `(c * 255.0) as u8` truncate-and-saturate cast (canvas.rs:76-105).
// ---------------------------------------------------------------------------

void quantize_rgba(const float* rgb, int64_t n_pixels, uint8_t* out) {
  for (int64_t i = 0; i < n_pixels; i++) {
    for (int j = 0; j < 3; j++) {
      float v = rgb[i * 3 + j] * 255.0f;
      if (!(v > 0.0f)) v = 0.0f;  // NaN -> 0, matching as-u8 semantics
      if (v > 255.0f) v = 255.0f;
      out[i * 4 + j] = (uint8_t)v;  // truncation toward zero
    }
    out[i * 4 + 3] = 255;
  }
}

}  // extern "C"
