// Native host-side setup + IO for the FEM framework.
//
// Plays the role of the reference's C++ host layer (deal.II DoFHandler
// table construction and DataOut; reference L-14/L-18): building the
// element->global DoF tables, boundary masks, and VTK output files for
// very large structured meshes is O(n_dofs) host work where numpy's
// Python-level overhead shows; these routines are exposed through ctypes
// (see utils/native.py) with a numpy fallback.
//
// Build: make -C csrc   (produces build/libfemsetup.so)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// local_to_global: out[e][(p+1)^3], cell order (ez,ey,ex) x fastest,
// local lexicographic (k,j,i) with i fastest. Matches
// BrickMesh.element_dof_map (mesh.py).
void element_dof_map(int64_t mx, int64_t my, int64_t mz, int64_t p,
                     int32_t* out) {
  const int64_t nx = mx * p + 1;
  const int64_t ny = my * p + 1;
  const int64_t p1 = p + 1;
  int64_t idx = 0;
  for (int64_t ez = 0; ez < mz; ++ez)
    for (int64_t ey = 0; ey < my; ++ey)
      for (int64_t ex = 0; ex < mx; ++ex) {
        const int64_t gx0 = ex * p, gy0 = ey * p, gz0 = ez * p;
        for (int64_t k = 0; k < p1; ++k)
          for (int64_t j = 0; j < p1; ++j) {
            const int64_t base = gx0 + nx * (gy0 + j + ny * (gz0 + k));
            for (int64_t i = 0; i < p1; ++i)
              out[idx++] = static_cast<int32_t>(base + i);
          }
      }
}

// boundary (zero-Dirichlet) mask over the full box surface; out[n_dofs]
void boundary_mask(int64_t nx, int64_t ny, int64_t nz, uint8_t* out) {
  int64_t idx = 0;
  for (int64_t k = 0; k < nz; ++k) {
    const bool bk = (k == 0) | (k == nz - 1);
    for (int64_t j = 0; j < ny; ++j) {
      const bool bj = bk | (j == 0) | (j == ny - 1);
      if (bj) {
        memset(out + idx, 1, nx);
        idx += nx;
      } else {
        out[idx] = 1;
        memset(out + idx + 1, 0, nx - 2);
        out[idx + nx - 1] = 1;
        idx += nx;
      }
    }
  }
}

// Multiplicity of each global DoF (how many elements share it).
void dof_multiplicity(int64_t mx, int64_t my, int64_t mz, int64_t p,
                      float* out) {
  const int64_t nx = mx * p + 1, ny = my * p + 1, nz = mz * p + 1;
  std::vector<float> cx(nx, 1.f), cy(ny, 1.f), cz(nz, 1.f);
  auto fill = [p](std::vector<float>& c, int64_t m) {
    for (int64_t e = 1; e < m; ++e) c[e * p] = 2.f;
  };
  fill(cx, mx);
  fill(cy, my);
  fill(cz, mz);
  int64_t idx = 0;
  for (int64_t k = 0; k < nz; ++k)
    for (int64_t j = 0; j < ny; ++j) {
      const float cjk = cz[k] * cy[j];
      for (int64_t i = 0; i < nx; ++i) out[idx++] = cjk * cx[i];
    }
}

// VTK rectilinear-grid writer (.vtr, appended raw binary): the DataOut /
// ParaView-output equivalent (reference step-64/step-64.cu:560-588).
// coords: per-axis node coordinates; values: [nz*ny*nx] point scalars.
int write_vtr(const char* path, int64_t nx, int64_t ny, int64_t nz,
              const double* xs, const double* ys, const double* zs,
              const double* values, const char* field_name) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const uint64_t nbytes_vals = sizeof(double) * (uint64_t)(nx * ny * nz);
  const uint64_t nbytes_x = sizeof(double) * (uint64_t)nx;
  const uint64_t nbytes_y = sizeof(double) * (uint64_t)ny;
  const uint64_t nbytes_z = sizeof(double) * (uint64_t)nz;
  uint64_t off = 0;
  std::string hdr;
  char buf[1024];
  snprintf(buf, sizeof buf,
           "<?xml version=\"1.0\"?>\n"
           "<VTKFile type=\"RectilinearGrid\" version=\"1.0\" "
           "byte_order=\"LittleEndian\" header_type=\"UInt64\">\n"
           "<RectilinearGrid WholeExtent=\"0 %lld 0 %lld 0 %lld\">\n"
           "<Piece Extent=\"0 %lld 0 %lld 0 %lld\">\n",
           (long long)(nx - 1), (long long)(ny - 1), (long long)(nz - 1),
           (long long)(nx - 1), (long long)(ny - 1), (long long)(nz - 1));
  hdr += buf;
  snprintf(buf, sizeof buf,
           "<PointData Scalars=\"%s\">\n"
           "<DataArray type=\"Float64\" Name=\"%s\" format=\"appended\" "
           "offset=\"%llu\"/>\n</PointData>\n",
           field_name, field_name, (unsigned long long)off);
  hdr += buf;
  off += 8 + nbytes_vals;
  hdr += "<Coordinates>\n";
  const char* names[3] = {"x", "y", "z"};
  const uint64_t sizes[3] = {nbytes_x, nbytes_y, nbytes_z};
  for (int d = 0; d < 3; ++d) {
    snprintf(buf, sizeof buf,
             "<DataArray type=\"Float64\" Name=\"%s\" format=\"appended\" "
             "offset=\"%llu\"/>\n",
             names[d], (unsigned long long)off);
    hdr += buf;
    off += 8 + sizes[d];
  }
  hdr +=
      "</Coordinates>\n</Piece>\n</RectilinearGrid>\n"
      "<AppendedData encoding=\"raw\">\n_";
  fwrite(hdr.data(), 1, hdr.size(), f);
  auto blob = [f](const void* data, uint64_t n) {
    fwrite(&n, 8, 1, f);
    fwrite(data, 1, n, f);
  };
  blob(values, nbytes_vals);
  blob(xs, nbytes_x);
  blob(ys, nbytes_y);
  blob(zs, nbytes_z);
  const char* tail = "\n</AppendedData>\n</VTKFile>\n";
  fwrite(tail, 1, strlen(tail), f);
  fclose(f);
  return 0;
}

}  // extern "C"
